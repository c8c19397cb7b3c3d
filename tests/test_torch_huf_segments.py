"""csrc/huf_decode.cu's design, on the CPU: tests/hufmodel.py (head,
speculative segments, repair rounds, prefix, write pass, closed-form tail)
against the port's huf_decode_plain, symbols and `final`, for segments of 8,
64, 512 (the kernel's), 1024 and more bit positions than the lane; and the
literal pool's plain composition against zstd_tpu's assemble_pool of its
Huffman scan. zstd is exact, so equality is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import hufmodel
from tests.decodecases import adversarial_group, long_code_table
from tests.test_torch_decode import FIXTURES, NAMES, _lanes, _pack
from zstd_tpu.ops import decode_dev as jops
from zstd_tpu_torch import device_decoder as tdec
from zstd_tpu_torch.ops import decode_dev as tops

SEGMENTS = [8, 64, hufmodel.K_KERNEL, 1024, 1 << 20]


def _adversarial(seed):
    """Lanes that the corpus lacks: over-long (fewer symbols asked than the
    stream holds, so final > 0), n_syms 0 with a stream, a one-byte stream,
    random bytes under a long-code table (speculation fails often), a
    stream shorter than one 8-position segment, and the _lanes set."""
    rng = np.random.default_rng(seed)
    lanes, tables = _lanes(seed)
    tables.append(long_code_table())
    long_tab = len(tables) - 1
    full = lanes[2][0]                             # 2500 symbols, table 0
    lanes.append((full, 2000, 0))                  # over-long: final > 0
    lanes.append((full, 0, 0))                     # nothing to decode
    lanes.append((bytes([0x5B]), 2, long_tab))     # one byte, 6 bits
    lanes.append((bytes([0x01]), 3, 0))            # sentinel only
    for k in range(3):
        raw = bytearray(rng.integers(0, 256, 700 + 300 * k, np.uint8))
        raw[-1] |= 0x80
        lanes.append((bytes(raw), (300, 900, 3000)[k], long_tab))
    return lanes, tables


def _held_to_plain(sb, bits, nsy, lut_sym, lut_len, tab, max_syms, K):
    want_syms, want_final = tops.huf_decode_plain(
        *(torch.from_numpy(a) for a in (sb, bits, nsy, lut_sym, lut_len,
                                         tab)), max_syms)
    syms, final, counts = hufmodel.decode_lanes(sb, bits, nsy, lut_sym,
                                                lut_len, tab, max_syms, K)
    np.testing.assert_array_equal(final, want_final.numpy())
    n = np.clip(nsy, 0, max_syms)
    for i in range(sb.shape[0]):
        np.testing.assert_array_equal(syms[i, :n[i]],
                                      want_syms.numpy()[i, :n[i]])
    return final, counts


@pytest.mark.parametrize("K", SEGMENTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_plain(seed, K):
    lanes, tables = _lanes(seed)
    args = _pack(lanes, tables, 4096, 3072)
    final, counts = _held_to_plain(*args, 3072, K)
    if K == 1 << 20:                       # one segment: nothing to repair
        assert (counts[:, 0] <= 1).all() and (counts[:, 1] == 0).all()


@pytest.mark.parametrize("K", SEGMENTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_model_adversarial(seed, K):
    lanes, tables = _adversarial(seed)
    args = _pack(lanes, tables, 4096, 3072)
    final, counts = _held_to_plain(*args, 3072, K)
    m = len(_lanes(seed)[0])
    assert final[m] > 0                     # the over-long lane
    assert final[m + 1] == args[1][m + 1]   # n_syms 0 keeps start_bits
    assert (final[m + 4:] != 0).any()       # random bytes do not end at 0
    if K == 8:
        assert counts[:, 1].max() >= 2      # repairs that chain


@pytest.mark.parametrize("K", [8, 1024])
def test_model_head_and_caps(K):
    """start_bits past the last window (the closed-form head), negative
    start_bits (all tail) and n_syms past max_syms."""
    lanes, tables = _lanes(0)
    sb, bits, nsy, lut_sym, lut_len, tab = _pack(lanes, tables, 2048, 3072)
    bits = bits.copy()
    nsy = nsy.copy()
    bits[2] = 8 * 2048 + 40                # head, then the stream's top
    bits[5] = 8 * 2048 + 100000            # the head takes every symbol
    bits[6] = -5
    nsy[1] = 5000                          # clipped to max_syms
    _held_to_plain(sb, bits, nsy, lut_sym, lut_len, tab, 3072, K)


def test_model_counts_on_a_real_lane():
    """A 2500-symbol lane at the kernel's K: several segments, one repair
    round at most, a critical path well under the serial 2500 steps."""
    lanes, tables = _lanes(0)
    args = _pack(lanes[2:3], tables, 4096, 3072)
    _, counts = _held_to_plain(*args, 3072, hufmodel.K_KERNEL)
    S, rounds, longest, critical = counts[0]
    assert S == -(-int(args[1][0]) // hufmodel.K_KERNEL)
    assert rounds <= 1 and critical < 2500 // 2


@pytest.mark.parametrize("name", NAMES)
def test_literal_pool_plain_matches_jax(name):
    """literal_pool on the CPU (assemble_pool of huf_decode_plain) against
    zstd_tpu's assemble_pool of its Huffman scan, on each fixture frame's
    first device group."""
    blob = (FIXTURES / name).read_bytes()
    groups = tdec._group_dev_jobs(tdec._parse_jobs(blob, 31))
    runs = [run for kind, run in groups if kind == "dev"]
    g = tdec._group_inputs([pf for _, pf, _ in runs[0]])
    names = ("sb", "start_bits", "n_syms", "lut_sym", "lut_len", "lane_tab",
             "seg_start", "seg_lane", "seg_src", "seg_is_dev", "host_lits")
    pool, final = tops.literal_pool(
        *(torch.from_numpy(g[k]) for k in names), g["nb_lit"],
        g["max_syms"], g["n"])
    j = {k: jnp.asarray(g[k]) for k in names}
    wins = jax.vmap(jops.huf_window_values)(j["sb"])
    syms, jfinal = jops.huf_decode_streams(
        wins, j["start_bits"], j["n_syms"],
        j["lut_sym"][j["lane_tab"]].astype(jnp.int32),
        j["lut_len"][j["lane_tab"]].astype(jnp.int32), g["max_syms"])
    want = jops.assemble_pool(syms, j["seg_start"], j["seg_lane"],
                              j["seg_src"], j["seg_is_dev"], j["host_lits"],
                              g["n"])
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal))


@pytest.mark.parametrize("K", [64, hufmodel.K_KERNEL])
def test_model_pool_on_adversarial_group(K):
    """decodecases.adversarial_group (the lanes chip_smoke.py holds the
    kernel to on the card, here on a fixture frame's group): the model's
    pool equals the plain composition on [0, nb_lit), and its symbols and
    final equal huf_decode_plain's."""
    blob = (FIXTURES / "corpus192k_l3.zst").read_bytes()
    g = tdec._group_inputs([tdec._parse_frame(blob, 0, 31)])
    a = adversarial_group(g)
    lane_args = [a[k] for k in ("sb", "start_bits", "n_syms", "lut_sym",
                                "lut_len", "lane_tab")]
    final, counts = _held_to_plain(*lane_args, a["max_syms"], K)
    pool, mfinal = hufmodel.literal_pool(**a, K=K)
    want, wfinal = tops.literal_pool(
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in a.items()})
    nb = a["nb_lit"]
    np.testing.assert_array_equal(pool[:nb], want.numpy()[:nb])
    np.testing.assert_array_equal(mfinal, wfinal.numpy())
    assert (pool[nb:] == 0).all()
    assert final[4] < 0 and final[5] > 0        # under-run, over-long
    assert counts[8:11, 1].max() >= 1           # random lanes repair


def test_no_fallback_off_the_cpu():
    """Tensors that are not on the CPU never reach a plain version: a device
    without a kernel raises (a CUDA tensor launches csrc/huf_decode.cu)."""
    meta = torch.device("meta")
    sb = torch.zeros((4, 16), dtype=torch.uint8, device=meta)
    i = torch.zeros(4, dtype=torch.int32, device=meta)
    lut = torch.zeros((1, 2048), dtype=torch.uint8, device=meta)
    seg = torch.zeros(16, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.huf_decode_streams(sb, i, i, lut, lut, i, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.literal_pool(sb, i, i, lut, lut, i, seg, seg, seg,
                          seg.bool(), sb[0], 0, 16, 64)
