"""The fused scoring-and-resolve of the lazy and v3 engines on the CPU:
tests/lazymodel.py (csrc/lazy_resolve.cu's tiles, byte compares, halo
gains, chunk-local next-matchable and walk) against
zstd_tpu_torch.ops.fastmatch.select_resolve_plain in both modes, and the
plain chain against zstd_tpu.ops.fastmatch in v3 mode (the lazy mode's
chain is held to the JAX engine by test_torch_fastmatch.py's test_seqstore
and test_analyze). Equality is exact throughout.
"""

import functools

import numpy as np
import pytest
import torch

from tests import lazymodel
from tests.conftest import gen_text
from tests.test_torch_fastmatch import HASH_LOG, MLS, N, _jax_steps, _rows
from zstd_tpu_torch.ops import fastmatch as tfm


def _full_len_rows():
    """valid_len = n, so positions within 32 bytes of n take the kernel's
    byte path and, within 22, compare clamped windows: zeros, text, and text
    whose last 96 bytes repeat bytes 1000-1095."""
    text = np.frombuffer(gen_text(2 * N, seed=4)[:N], np.uint8)
    tail = text.copy()
    tail[-96:] = text[1000:1096]
    blocks = np.stack([np.zeros(N, np.uint8), text, tail])
    return blocks, np.full(3, N, np.int32)


def _odd_len_rows():
    """valid_len not a multiple of 512 (nor of 8)."""
    blocks, _ = _full_len_rows()
    return blocks[1:], np.array([20037, 777 + 5 * 512], np.int32)


def _odd_shape_rows():
    """n = 9,001: a partial last tile, 297 positions past the last chunk,
    and rows that start off the 8-byte grid."""
    n = 9001
    rng = np.random.default_rng(7)
    text = np.frombuffer(gen_text(3 * n, seed=9)[:3 * n], np.uint8)
    blocks = text.reshape(3, n).copy()
    blocks[2, 4000:] = rng.integers(0, 4, n - 4000, dtype=np.uint8)
    return blocks, np.array([n, n - 100, 5000], np.int32)


CASES = {"rows": (_rows, HASH_LOG), "full_len": (_full_len_rows, HASH_LOG),
         "odd_len": (_odd_len_rows, HASH_LOG),
         "hash_log_21": (_rows, 21), "odd_shape": (_odd_shape_rows, HASH_LOG)}


def _candidates(blocks, lens, hash_log, mode):
    """The engine's candidate rows, stacked [R, B, n], from the port's
    plain ops (held to the JAX ones by test_torch_fastmatch.py)."""
    return tfm.engine_rows(torch.from_numpy(blocks), torch.from_numpy(lens),
                           hash_log, MLS, mode)[1]


@functools.cache
def _case(case, mode):
    """(plain (yp, yl, cand, steps), model output) of one case."""
    make, hash_log = CASES[case]
    blocks, lens = make()
    rows = _candidates(blocks, lens, hash_log, mode)
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    steps = torch.empty((tb.shape[0], tb.shape[1] // tfm.RESOLVE_CHUNK),
                        dtype=torch.int32)
    plain = tuple(t.numpy() for t in tfm.select_resolve_plain(
        tb, rows, tl, mode, steps)) + (steps.numpy(),)
    return plain, lazymodel.select_resolve(blocks, rows.numpy(), lens, mode)


@pytest.mark.parametrize("mode", tfm.MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_plain(case, mode):
    """yp, yl, cand and the active steps a chunk, exactly."""
    plain, model = _case(case, mode)
    for name, want, got in zip(("yp", "yl", "cand", "steps"), plain, model):
        np.testing.assert_array_equal(want, got, err_msg=name)
    assert int((plain[1] > 0).sum()) > 0
    assert int(plain[3].max()) <= 131


@pytest.mark.parametrize("mode", tfm.MODES)
def test_byte_path_near_the_end(mode):
    """With valid_len = n, candidates within 32 bytes of n take the byte
    path and some of them match. In lazy mode some clamped windows are
    compared (the zero row's position n - 17: its candidate n - 18 passes
    n - 1 at k = 19); v3's last window is at k = 10, so for a position below
    valid_len - 16 it never clamps. For a candidate c < p the clamp cannot
    change a length: a clamped pass k has run >= k >= n - p + 1 before it,
    which the tail clip cuts to valid_len - p whatever the pass gives."""
    counts = _case("full_len", mode)[1][4]
    assert counts["word"] > 0 and counts["byte_matched"] > 0, counts
    assert (counts["clamped"] > 0) == (mode == "lazy"), counts


def test_halo_gains_cross_tiles():
    """The deferral at a tile's last two positions reads the next tile's
    gains: on these rows some position there is deferred (its own gain is
    positive but its mlen is 0), and test_model_equals_plain[full_len-lazy]
    holds the model's halo to the plain chain."""
    blocks, lens = _full_len_rows()
    rows = _candidates(blocks, lens, HASH_LOG, "lazy")
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    tri, b3, _, _ = tfm.tri_arrays(tb)
    mlen, _ = tfm.lazy_mlen(tri, b3, rows, tl)
    best = torch.full(tb.shape, tfm._NO_GAIN)
    for cand in rows:
        best = torch.maximum(best, tfm.gain(tfm.capped_mlen_at(tri, b3, cand,
                                                               tl), cand))
    edge = torch.arange(N)[None, :] % lazymodel.TILE >= lazymodel.TILE - 2
    deferred = edge & (best > 0) & (mlen == 0)
    assert int(deferred.sum()) > 0


def test_plain_v3_equals_jax():
    """select_resolve_plain in v3 mode against the JAX _capped_mlen,
    _next_matchable and _resolve on test_torch_fastmatch's rows."""
    blocks, lens, out = _jax_steps()
    yp, yl, cand = tfm.select_resolve_plain(
        torch.from_numpy(blocks), torch.from_numpy(out["cand"].copy())[None],
        torch.from_numpy(lens), "v3")
    np.testing.assert_array_equal(out["y"][0], yp.numpy())
    np.testing.assert_array_equal(out["y"][1], yl.numpy())
    np.testing.assert_array_equal(out["cand"], cand.numpy())


def test_select_resolve_takes_the_plain_chain_on_the_cpu_only():
    blocks, lens = _odd_len_rows()
    rows = _candidates(blocks, lens, HASH_LOG, "lazy")
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    got = tfm.select_resolve(tb, rows, tl, "lazy")
    for want, g in zip(tfm.select_resolve_plain(tb, rows, tl, "lazy"), got):
        assert torch.equal(want, g)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.select_resolve(tb.to("meta"), rows.to("meta"), tl.to("meta"),
                           "lazy")
    with pytest.raises(ValueError, match="unknown mode"):
        tfm.select_resolve(tb, rows, tl, "xla")


def test_engine_rows_stack_the_candidate_rows():
    """engine_rows writes, through candidate_rows(..., out=), the rows that
    candidate_rows returns: 8 on the mls hash, then 2 on the 4-byte hash."""
    blocks, lens = _odd_shape_rows()
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    tri, b3, tri3, b6 = tfm.tri_arrays(tb)
    want = tfm.candidate_rows(tfm.hash_f32(tri, tri3, b3, b6, HASH_LOG, MLS),
                              tl, 8) \
        + tfm.candidate_rows(tfm.hash_f32(tri, tri3, b3, b6, HASH_LOG, 4),
                             tl, 2)
    got_tri, rows = tfm.engine_rows(tb, tl, HASH_LOG, MLS, "lazy")
    assert torch.equal(got_tri, tri)
    assert torch.equal(rows, torch.stack(want))
