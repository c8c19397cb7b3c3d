"""zstd_tpu_torch's copied host layer against zstd_tpu's.

zstd_tpu's planning takes its C library where one is built (format/fse.py,
format/huffman.py, xxhash64.py), and so does the port's, over its own copy
of that C (tests/test_torch_host_c.py holds both branches); these tests
hold the port to whatever zstd_tpu computes, exactly. The stats vectors
come from the port's own stage A on real blocks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import gen_mixed, gen_text
from zstd_tpu import params as jparams
from zstd_tpu import pipeline as jpipe
from zstd_tpu import xxhash64 as jxxh
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import sequences as jseq
from zstd_tpu_torch import params as tparams
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch import xxhash64 as txxh
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.format import sequences as tseq

N = 16384


def _blocks():
    rng = np.random.default_rng(4)
    rows = [gen_text(N, seed=1), gen_mixed(N, seed=2, match_prob=0.6),
            gen_mixed(N, seed=3, match_prob=0.1), bytes(N),
            rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
            bytes(range(256)) * (N // 256),
            gen_text(300, seed=5) + bytes(N - 300),
            gen_text(N, seed=6)[:4000] + bytes(N - 4000)]
    lens = np.array([N] * 6 + [300, 4000], np.int32)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, N), lens


@pytest.fixture(scope="module")
def stats_and_lens():
    blocks, lens = _blocks()
    cp = tparams.get_cparams(1, N)
    stats, _ = tpipe._analyze(torch.from_numpy(blocks.copy()),
                              torch.from_numpy(lens), cp.hash_log, 6, N // 8)
    return stats.numpy(), lens


@pytest.mark.parametrize("level", range(-5, 5))
@pytest.mark.parametrize("size", [0, 1000, 100_000, 300_000, 1 << 20, 16 << 20,
                                  tparams.CONTENTSIZE_UNKNOWN])
def test_get_cparams(level, size):
    want = dataclasses.asdict(jparams.get_cparams(level, size))
    assert dataclasses.asdict(tparams.get_cparams(level, size)) == want


@pytest.mark.parametrize("strategy", [1, 2])
def test_sequences_header_from_hists(stats_and_lens, strategy):
    stats, _ = stats_and_lens
    for row in stats:
        nb_seq = int(row[tpipe._STATS_TAIL + 3])
        if nb_seq == 0:
            continue
        ll = row[tpipe._STATS_LL:tpipe._STATS_LL + 36].astype(np.int64)
        ml = row[tpipe._STATS_ML:tpipe._STATS_ML + 53].astype(np.int64)
        of = row[tpipe._STATS_OF:tpipe._STATS_OF + 32].astype(np.int64)
        last = tuple(int(x) for x in row[tpipe._STATS_TAIL:tpipe._STATS_TAIL + 3])
        w_hdr, w_state, w_last = jseq.build_sequences_header_from_hists(
            ll, of, ml, last, nb_seq, jseq.FseEntropyState(), strategy)
        g_hdr, g_state, g_last = tseq.build_sequences_header_from_hists(
            ll, of, ml, last, nb_seq, tseq.FseEntropyState(), strategy)
        assert (g_hdr, g_last) == (w_hdr, w_last)
        for name in ("ct_ll", "ct_of", "ct_ml"):
            g, w = getattr(g_state, name), getattr(w_state, name)
            assert g.table_log == w.table_log
            for f in ("state_table", "delta_nb_bits", "delta_find_state"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f"{name}.{f}")


def _lit_plan_fields(lp):
    d = {k: getattr(lp, k) for k in ("kind", "single", "tree_desc",
                                     "stream_sizes", "c_size", "n_lit",
                                     "first_byte")}
    if lp.ct is not None:
        d["ct"] = (lp.ct.table_log, lp.ct.nb_bits.tolist(), lp.ct.value.tolist())
    return d


@pytest.mark.parametrize("strategy", [1, 2])
def test_plan_literals(stats_and_lens, strategy):
    stats, _ = stats_and_lens
    rle = np.zeros((4, 256), np.int64)
    rle[:, 97] = 125
    cases = [(500, rle, 97)]
    for row in stats:
        hist4 = row[:1024].reshape(4, 256).astype(np.int64)
        nb_lit = int(row[tpipe._STATS_TAIL + 4])
        first = int(row[tpipe._STATS_TAIL + 6])
        cases.append((nb_lit, hist4, first))
        # the first 200 literals in one stream, for the small-input gates
        n_lit = min(nb_lit, 200)
        h4 = np.zeros((4, 256), np.int64)
        h4[0] = np.bincount(np.repeat(np.arange(256), hist4.sum(0))[:n_lit],
                            minlength=256)
        cases.append((n_lit, h4, first))
    kinds = set()
    for n_lit, h4, first in cases:
        want = jpipe.TpuCompressor()._plan_literals(n_lit, h4, first, strategy)
        got = tpipe.TorchCompressor(device="cpu")._plan_literals(
            n_lit, h4, first, strategy)
        assert _lit_plan_fields(got) == _lit_plan_fields(want)
        kinds.add((want.kind, want.single))
    assert {k for k, _ in kinds} == {"raw", "rle", "huf"}
    assert ("huf", True) in kinds and ("huf", False) in kinds


def test_build_plans(stats_and_lens):
    stats, lens = stats_and_lens
    want = jpipe.TpuCompressor()._build_plans(stats, lens, 1, N)
    got = tpipe.TorchCompressor(device="cpu")._build_plans(stats, lens, 1, N)
    np.testing.assert_array_equal(got[1], want[1])       # the plan blob
    assert got[2:] == want[2:]
    for g, w in zip(got[0], want[0]):
        g, w = dict(g), dict(w)
        assert _lit_plan_fields(g.pop("lit_plan")) == \
            _lit_plan_fields(w.pop("lit_plan"))
        assert g == w


@pytest.mark.parametrize("src_size", [0, 1, 255, 256, 65791, 65792, 1 << 20,
                                      (1 << 32) + 5])
@pytest.mark.parametrize("window_log", [10, 17, 21])
@pytest.mark.parametrize("checksum", [False, True])
def test_write_frame_header(src_size, window_log, checksum):
    assert tframe.write_frame_header(src_size, window_log, checksum) == \
        jframe.write_frame_header(src_size, window_log, checksum)


def test_content_checksum():
    rng = np.random.default_rng(8)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 1000, 65536):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert txxh.content_checksum(data) == jxxh.content_checksum(data), n


def test_literal_headers_and_buckets():
    for n in (0, 1, 31, 32, 1023, 1024, 4095, 4096, 16383, 16384, 131072):
        assert tpipe._raw_lit_header(n) == jpipe._raw_lit_header(n)
        assert tpipe._rle_lit_section(n, 7) == jpipe._rle_lit_section(n, 7)
        for single in (False, True):
            args = (2, n, max(n // 2, 1), single)
            assert tpipe._lit_header(*args) == jpipe._lit_header(*args)
    for m in (1, 1024, 1025, 16384, 16385, 32768, 40000):
        assert tpipe._seq_cap_bucket(m) == jpipe._seq_cap_bucket(m)
    assert (tpipe.PLAN_LEN, tpipe.STATS_LEN) == (jpipe.PLAN_LEN, jpipe.STATS_LEN)
