"""The FSE state chain: csrc/fse_chain.cu's design against the plain version.

tests/chainmodel.py models the kernel's cut / candidate walk / resolve /
replay phases; it is held to fse_fields_plain for several window sizes on
the stage-A blocks of tests/test_torch_analyze_pack.py and on synthetic
table sets (no symbol of count 1, RLE, the predefined tables, random
tables, nb_seq 0, 1, 2 and cap). fse_fields_plain is held to the JAX
package's fse_pack_batch on the synthetic sets, and the closed form of a
symbol's candidate count to build_ctable's normalized counts. zstd is an
exact codec: every comparison is exact equality.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from tests.chainmodel import (SYNTHETIC_ROWS, W_KERNEL, chain_fields,
                              p_closed_form, synthetic_batch)
from tests.test_torch_analyze_pack import HASH_LOG, MLS, N, SEQ_CAP, _blocks
from zstd_tpu.ops.fse_enc import fse_pack_batch
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.format import fse
from zstd_tpu_torch.ops.fse_enc import (T_LL, T_ML, T_OF, fse_fields,
                                        fse_fields_plain, fse_fields_stats,
                                        fse_pack)

CAP = 256            # synthetic rows: the model walks in Python
JAX_CAP = 1024


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _assert_model_equals_plain(args, W):
    want_v, want_n = fse_fields_plain(*_torch(args))
    vals, nbits, counts = chain_fields(args, W)
    np.testing.assert_array_equal(vals, want_v.numpy())
    np.testing.assert_array_equal(nbits, want_n.numpy())
    return counts


@pytest.fixture(scope="module")
def corpus_args():
    """fse_fields inputs of the port's stage A and host plan on the
    stage-A blocks of test_torch_analyze_pack (numpy)."""
    blocks, lens = _blocks()
    stats, resident = tpipe._analyze(torch.from_numpy(blocks.copy()),
                                     torch.from_numpy(lens), HASH_LOG, MLS,
                                     SEQ_CAP)
    _, blob, cap, *_ = tpipe.TorchCompressor(level=1, device="cpu") \
        ._build_plans(stats.numpy(), lens, 1, N)
    return tuple(a.numpy() for a in
                 tpipe.fse_inputs(resident, torch.from_numpy(blob), cap))


@pytest.mark.parametrize("W", [1, 2, 7, 64, 256, 1 << 20])
def test_chain_model_matches_plain_on_blocks(corpus_args, W):
    counts = _assert_model_equals_plain(corpus_args, W)
    nb = corpus_args[6]
    assert nb.max() > 256 and (nb == 1).any()   # text rows and the zero row
    walked = counts[nb > 1][:, :, 0]
    assert (walked == -(-(nb[nb > 1] - 1) // W)[:, None] + 1).all()


@pytest.mark.parametrize("W", [1, 2, 7, 64, 256, CAP])
def test_chain_model_matches_plain_on_synthetic_tables(W):
    args = synthetic_batch(CAP, seed=W)
    counts = _assert_model_equals_plain(args, W)
    rows = list(SYNTHETIC_ROWS)
    flat, rle = rows.index("flat"), rows.index("rle")
    if W > 1:     # every cut of the flat tables keeps p candidates
        assert list(counts[flat, :, 2]) == [128, 64, 128]  # LL, OF, ML
    assert not counts[rle].any()                # RLE: no walk at all
    assert list(args[6][[rows.index(r) for r in ("nb0", "nb1", "nb2")]]) \
        == [0, 1, 2]
    assert args[6][rows.index("random_cap")] == CAP


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_on_synthetic_tables(seed):
    args = synthetic_batch(JAX_CAP, seed=seed)
    out_words = 2 * JAX_CAP + 8
    words, bits = fse_pack(*_torch(args), out_words)
    j_words, j_bits, _ = fse_pack_batch(*args, cap=JAX_CAP,
                                        out_words=out_words)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_words, np.int64))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
    assert (bits.numpy() > 0).all()


@pytest.mark.parametrize("table_log", [5, 6, 7, 8, 9])
def test_candidate_count_closed_form(table_log):
    """p from delta_nb alone equals the normalized count (1 for -1, 0 if
    absent); a step with the symbol leaves exactly p next states, the
    smallest x >> nb(x) being p."""
    rng = np.random.default_rng(table_log)
    size = 1 << table_log
    for trial in range(40):
        mx = int(rng.integers(1, 53))
        count = (rng.pareto(0.8, mx + 1) * 20).astype(np.int64)
        count[rng.random(mx + 1) < 0.3] = 0
        count[[0, mx]] += 1
        total = int(count.sum())
        if total < 4 or table_log < fse.min_table_log(total, mx):
            continue
        norm = fse.normalize_count(count, table_log, total, mx,
                                   trial % 2 == 0)
        ct = fse.build_ctable(norm, mx, table_log)
        for s in range(mx + 1):
            dn, df = int(ct.delta_nb_bits[s]), int(ct.delta_find_state[s])
            p = p_closed_form(dn)
            assert p == (1 if norm[s] == -1 else int(norm[s])), (s, norm[s])
            if p == 0:
                continue
            shifted = {x >> ((x + dn) >> 16) for x in range(size, 2 * size)}
            assert min(shifted) == p and len(shifted) == p
            assert len({int(ct.state_table[v + df]) for v in shifted}) == p
    assert p_closed_form(0) > 1 << 9   # RLE tables: handled apart


def test_model_constants_match_the_kernel_source():
    """The model's window and stream slots are the kernel's."""
    src = (pathlib.Path(__file__).resolve().parent.parent / "zstd_tpu_torch"
           / "csrc" / "fse_chain.cu").read_text()
    assert re.search(rf"constexpr int kW = {W_KERNEL};", src)
    assert re.search(rf"constexpr int kLL = {T_LL}, kOF = {T_OF}, "
                     rf"kML = {T_ML};", src)


def test_fse_fields_stats_needs_the_kernel():
    with pytest.raises(ValueError, match="CUDA kernel"):
        fse_fields_stats(*_torch(synthetic_batch(8, rows=("nb2",))))


def test_fse_fields_rejects_other_devices():
    args = [torch.empty(a.shape, dtype=torch.int32, device="meta")
            for a in synthetic_batch(8, rows=("nb2",))]
    with pytest.raises(ValueError, match="unsupported device"):
        fse_fields(*args)
