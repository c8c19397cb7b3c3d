"""zstd_tpu_torch's device stages against zstd_tpu's, on the CPU.

Stage A (`_analyze`) is held to `_analyze_jit(engine="pallas")` with the
Pallas kernel in interpret mode; stage B (`_pack`) is fed the JAX package's
own resident arrays and plan blob, and the entropy ops (FSE fields, Huffman
streams, bit packing) are matched one for one. Exact equality throughout,
with two masks: literal bytes past nb_lit are never written by the Pallas
kernel, so `lits` and the `first_lit` stat (stats[:, 1151]) are compared only
where they are defined; and only the [B, 7] sizes header and the valid
prefix of the compact buffer are compared (the bytes after it differ by
design).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import planform
from tests.conftest import gen_mixed, gen_text
from zstd_tpu import pipeline as jpipe
from zstd_tpu.ops import seqextract
from zstd_tpu.ops.bitpack import pack_bits as jpack_bits
from zstd_tpu.ops.fse_enc import fse_pack_batch
from zstd_tpu.ops.huffman_enc import huf_pack_4x_block
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.ops.bitpack import pack_bits
from zstd_tpu_torch.ops.fse_enc import fse_pack
from zstd_tpu_torch.ops.huffman_enc import huf_pack_4x
from zstd_tpu_torch.params import get_cparams

N = 16384
SEQ_CAP = N // 8
HASH_LOG = get_cparams(1, N).hash_log
MLS = 6


def _blocks():
    rng = np.random.default_rng(6)
    rows = [gen_text(N, seed=1), gen_mixed(N, seed=2, match_prob=0.6),
            bytes(N), rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
            bytes(range(256)) * (N // 256),
            gen_text(200, seed=3) + bytes(N - 200)]
    lens = np.array([N] * 5 + [200], np.int32)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, N), lens


@pytest.fixture(scope="module")
def stage_a():
    """(blocks, lens, JAX stats, JAX resident, port stats, port resident),
    all numpy."""
    blocks, lens = _blocks()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(seqextract, "extract_batch_pallas",
                   functools.partial(seqextract.extract_batch_pallas,
                                     interpret=True))
        j_stats, j_res = jpipe._analyze_jit(
            jnp.asarray(blocks), jnp.asarray(lens), HASH_LOG, MLS, SEQ_CAP,
            engine="pallas")
    t_stats, t_res = tpipe._analyze(torch.from_numpy(blocks.copy()),
                                    torch.from_numpy(lens), HASH_LOG, MLS,
                                    SEQ_CAP)
    return (blocks, lens, np.asarray(j_stats),
            {k: np.array(v) for k, v in j_res.items()},
            t_stats.numpy(), {k: v.numpy() for k, v in t_res.items()})


@pytest.fixture(scope="module")
def plan(stage_a):
    """zstd_tpu's host plan of stage A's stats."""
    _, lens, j_stats, *_ = stage_a
    return jpipe.TpuCompressor()._build_plans(j_stats, lens, 1, N)


def test_analyze_stats_match(stage_a):
    *_, j_stats, _, t_stats, t_res = stage_a
    nb_lit = t_res["nb_lit"]
    defined = np.ones_like(j_stats, bool)
    defined[nb_lit == 0, tpipe._STATS_TAIL + 6] = False
    np.testing.assert_array_equal(t_stats[defined], j_stats[defined])


def test_analyze_resident_match(stage_a):
    *_, j_res, _, t_res = stage_a
    assert set(t_res) == set(j_res) == set(tpipe.RESIDENT_DTYPES)
    for k in ("llc", "mlc", "ofc", "ob", "mlb", "llx", "nb_lit", "nb_seq"):
        np.testing.assert_array_equal(t_res[k], j_res[k], err_msg=k)
    for b, nl in enumerate(j_res["nb_lit"]):
        np.testing.assert_array_equal(t_res["lits"][b, :nl],
                                      j_res["lits"][b, :nl])
    # the zero row is one match of N - 1 bytes, past the xla engine's cap
    assert j_res["nb_seq"][2] == 1


@pytest.mark.parametrize("buffers", ["planned", "tiny"])
def test_pack_header_and_prefix_match(stage_a, plan, buffers):
    *_, j_res, _, _ = stage_a
    (rec, _), blob, cap, ow_fse, seg_cap, ow_huf = planform.port_form(plan)
    if buffers == "tiny":       # overflowing stream buffers: blocks go raw
        ow_fse, ow_huf = 8, 8
    r = j_res
    j_buf, j_sizes = jpipe._pack_impl(
        r["llc"], r["mlc"], r["ofc"], r["llx"], r["mlb"], r["ob"],
        r["nb_seq"], r["lits"], r["nb_lit"], jnp.asarray(blob),
        cap, ow_fse, seg_cap, ow_huf)
    t_buf, t_sizes = tpipe._pack(tpipe.resident_from_numpy(j_res, "cpu"),
                                 torch.from_numpy(blob), cap, ow_fse,
                                 seg_cap, ow_huf)
    j_sizes = np.asarray(j_sizes)
    np.testing.assert_array_equal(t_sizes.numpy(), j_sizes)
    offs, sizes, zeroed, total = tpipe.TorchCompressor._region_metas(
        rec, blob, j_sizes)
    # every piece's offset and size, as zstd_tpu places them
    w_metas, w_total = jpipe.TpuCompressor._region_metas(plan[0], j_sizes)
    assert total == w_total
    assert zeroed.tolist() == [m["zeroed"] for m in w_metas]
    assert np.stack([offs, sizes], axis=2).tolist() == \
        [[list(m["fse"]), *map(list, m["huf"]), list(m["raw"])]
         for m in w_metas]
    valid = len(rec) * 7 * 4 + total
    np.testing.assert_array_equal(t_buf.numpy()[:valid],
                                  np.asarray(j_buf)[:valid])
    overflow = j_sizes[:, 5].astype(bool)
    assert overflow.any() == (buffers == "tiny")
    assert total > 0 or buffers == "tiny"


def test_fse_pack_matches(stage_a, plan):
    *_, j_res, _, _ = stage_a
    _, blob, cap, ow_fse, _, _ = plan
    args = tpipe.fse_inputs(tpipe.resident_from_numpy(j_res, "cpu"),
                            torch.from_numpy(blob), cap)
    words, bits = fse_pack(*args, ow_fse)
    j_words, j_bits, _ = fse_pack_batch(*(a.numpy() for a in args),
                                        cap=cap, out_words=ow_fse)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_words, np.int64))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
    assert (bits.numpy() > 0).all()


@pytest.mark.parametrize("single", ["plan", "all"])
def test_huf_pack_matches(stage_a, plan, single):
    *_, j_res, _, _ = stage_a
    _, blob, _, _, seg_cap, ow_huf = plan
    nb_lut = blob[:, tpipe._PB_NBL:tpipe._PB_VAL]
    val_lut = blob[:, tpipe._PB_VAL:tpipe._PB_SINGLE]
    sgl = blob[:, tpipe._PB_SINGLE] > 0
    if single == "all":
        sgl = np.ones_like(sgl)
    words, bits = huf_pack_4x(torch.from_numpy(j_res["lits"]),
                              torch.from_numpy(j_res["nb_lit"]),
                              torch.from_numpy(nb_lut),
                              torch.from_numpy(val_lut),
                              torch.from_numpy(sgl), seg_cap, ow_huf)
    j_words, j_bits, _ = jax.jit(jax.vmap(
        lambda l, n, nb, v, s: huf_pack_4x_block(l, n, nb, v, seg_cap, ow_huf,
                                                 single=s)))(
        j_res["lits"], j_res["nb_lit"], nb_lut, val_lut, sgl)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_words, np.int64))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))


@pytest.mark.parametrize("out_words", [1, 64, 2048])
def test_pack_bits_matches(out_words):
    rng = np.random.default_rng(out_words)
    values = rng.integers(-2**31, 2**31, (3, 1500), dtype=np.int64
                          ).astype(np.int32)
    nbits = rng.integers(0, 32, (3, 1500)).astype(np.int32)
    nbits[1, :700] = 0          # a run of zero-width fields
    words, bits = pack_bits(torch.from_numpy(values), torch.from_numpy(nbits),
                            out_words)
    j_words, j_bits = jax.vmap(lambda v, n: jpack_bits(v, n, out_words))(
        values, nbits)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_words, np.int64))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits))
