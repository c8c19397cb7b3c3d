"""zstd_tpu_torch's copied host layer against zstd_tpu's.

zstd_tpu's planning takes its C library where one is built (format/fse.py,
format/huffman.py, xxhash64.py), and so does the port's, over its own copy
of that C (tests/test_torch_host_c.py holds both branches); these tests
hold the port to whatever zstd_tpu computes, exactly. The device encode's
planning (TorchCompressor._build_plans) is one call of csrc/host/plan.c a
batch; it is held to zstd_tpu's per-block Python planning on stats vectors
from the port's own stage A on real blocks (the eight edge rows, a batch of
32 blocks of the benchmark's corpus) and on stats rows built to reach every
gate of the literal plan and every sequence mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpubench import refdecode
from gpubench.corpus import big_corpus as bench_corpus
from tests import planform
from tests.conftest import gen_mixed, gen_text
from zstd_tpu import params as jparams
from zstd_tpu import pipeline as jpipe
from zstd_tpu import xxhash64 as jxxh
from zstd_tpu.errors import Corruption
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.format import literals as jlit
from zstd_tpu.format import sequences as jseq
from zstd_tpu_torch import _kernels
from zstd_tpu_torch import native as tnative
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


_LIT_FIELDS = ("kind", "single", "size0", "size1", "size2", "size3",
               "c_size", "tree_len", "huf_log", "huf_max_symbol", "nb_lit")


def _lit_plan_fields(got):
    """The literal plan of a one-block batch of the port's planner (its
    _build_plans result): the record's literal fields, the first literal
    where the plan is RLE, the tree and the Huffman table."""
    (rec, arena), blob = got[:2]
    d = {k: int(rec[0, planform.COL[k]]) for k in _LIT_FIELDS}
    d["first_byte"] = int(rec[0, planform.COL["first_lit"]]) \
        if d["kind"] == planform.KINDS["rle"] else 0
    off = int(rec[0, planform.COL["tree_off"]])
    return d, arena[off:off + d["tree_len"]], planform.huf_table(rec[0],
                                                                 blob[0])


def _ref_lit_plan_fields(lp):
    """The same of zstd_tpu's literal plan `lp`."""
    d = dict.fromkeys(_LIT_FIELDS, 0)
    d.update(planform.lit_fields(lp), nb_lit=lp.n_lit,
             first_byte=lp.first_byte)
    return d, lp.tree_desc, planform.ref_table(lp)


def _stats_row(n_lit=0, h4=None, first_lit=0, seq=None):
    """One stats vector (pipeline._STATS_*) from a literal histogram per
    stream and, where given, the LL, OF and ML codes of the sequences."""
    row = np.zeros(tpipe.STATS_LEN, np.int32)
    if h4 is not None:
        row[:1024] = np.asarray(h4).reshape(-1)
    tail = tpipe._STATS_TAIL
    if seq is not None:
        ll, of, ml = (np.asarray(c, np.int64) for c in seq)
        for at, codes, n in ((tpipe._STATS_LL, ll, 36), (tpipe._STATS_OF, of, 32),
                             (tpipe._STATS_ML, ml, 53)):
            row[at:at + n] = np.bincount(codes, minlength=n)
        row[tail:tail + 4] = ll[-1], of[-1], ml[-1], len(ll)
    row[tail + 4] = n_lit
    row[tail + 6] = first_lit
    return row


def _plan_one(n_lit, h4, first, strategy):
    """The port's literal plan of one case, as a one-row batch
    (_lit_plan_fields)."""
    return _lit_plan_fields(tpipe.TorchCompressor(device="cpu")._build_plans(
        _stats_row(n_lit, h4, first)[None], np.array([N], np.int32),
        strategy, N))


@pytest.mark.parametrize("strategy", [1, 2])
def test_plan_literals(stats_and_lens, strategy):
    """Each literal case as a one-row batch of the batch planner, against
    zstd_tpu's _plan_literals."""
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
        assert _plan_one(n_lit, h4, first, strategy) == \
            _ref_lit_plan_fields(want)
        kinds.add((want.kind, want.single))
    assert {k for k, _ in kinds} == {"raw", "rle", "huf"}
    assert ("huf", True) in kinds and ("huf", False) in kinds


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


# ---- the batch planner (csrc/host/plan.c) against zstd_tpu's planning -------

BLOCK = 128 * 1024


def _split4(hist):
    """A literal histogram dealt to the four streams about evenly."""
    hist = np.asarray(hist, np.int64)
    h4 = np.zeros((4, 256), np.int64)
    h4[:] = hist // 4
    h4[0] += hist - 4 * (hist // 4)
    return h4


def _lit_rows() -> dict:
    """Literal histograms, each built to stop at one gate of the plan:
    name -> (n_lit, h4, first literal)."""
    def hist(pairs, fill=0):
        h = np.full(256, fill, np.int64)
        for sym, c in pairs:
            h[sym] = c
        return h

    zipf = hist([(97 + i, 1000 // (i + 1)) for i in range(26)])
    rows = {
        "raw_count": hist([(97, 4), (98, 3)]),                # 7 literals
        "rle": hist([(97, 500)]),
        "raw_flat": np.full(256, 8, np.int64),        # largest <= n/128 + 4
        "raw_gain": hist([(10, 300), (20, 300)], fill=100),   # 8 bits each
        # c_size equals n_lit - min_gain at strategy 9: still raw
        "gain_boundary": hist([(10, 244), (20, 488)], fill=60),
        "huf_1": hist([(97 + i, c) for i, c in
                       enumerate((60, 40, 30, 20, 15, 10, 10, 5, 5, 5))]),
        "huf_4": zipf,
        # symbols 0-253 share one code length, 254 has a shorter one: the
        # weights left to describe are all equal, which the FSE weight coder
        # does not take, and 254 symbols pass the 4-bit form's 128
        "tree_decline": np.r_[np.full(254, 100), 205, 0].astype(np.int64),
        # four streams of about 80,000 literals near 8 bits each
        "stream_cap": hist([(0, 40000)], fill=280000 // 255),
    }
    return {name: (int(h.sum()), _split4(h), int(np.nonzero(h)[0][0]))
            for name, h in rows.items()}


def _seq_rows() -> dict:
    """LL, OF and ML codes of sequences, built to reach each mode: name ->
    (ll, of, ml)."""
    rng = np.random.default_rng(20)

    def draw(p, n, last=None):
        p = np.asarray(p, np.float64)
        codes = rng.choice(len(p), n, p=p / p.sum())
        if last is not None:
            codes[-1] = last
        return codes

    def geo(k, r):
        return r ** np.arange(k)

    def default(d):
        return np.where(d == -1, 1, d)

    return {
        "one": ([3], [2], [5]),                      # nb_seq <= 2: predefined
        "of_above_default": ([1, 2], [30, 30], [3, 3]),   # OF RLE, not default
        "rle": ([0] * 300, draw(geo(19, 0.8), 300), [7] * 300),
        "few": (draw(geo(36, 0.8), 50), draw(geo(20, 0.8), 50),
                draw(geo(53, 0.85), 50)),
        "predefined_like": (draw(default(jseq.LL_DEFAULT_DIST), 3000),
                            draw(default(jseq.OF_DEFAULT_DIST), 3000),
                            draw(default(jseq.ML_DEFAULT_DIST), 3000)),
        "long": (draw(geo(36, 0.85), 40000), draw(geo(32, 0.9), 40000, 31),
                 draw(geo(53, 0.9), 40000)),
    }


@pytest.fixture(scope="module")
def crafted():
    lits, seqs = _lit_rows(), _seq_rows()
    rows = [_stats_row(n, h4, first) for n, h4, first in lits.values()]
    rows += [_stats_row(*lits["huf_4"], seq=s) if i % 2 else
             _stats_row(seq=s) for i, s in enumerate(seqs.values())]
    return np.stack(rows), np.full(len(rows), N, np.int32), N


@pytest.fixture(scope="module")
def edge(stats_and_lens):
    return (*stats_and_lens, N)


@pytest.fixture(scope="module")
def corpus():
    """Stage A's stats of 32 blocks of 128 KiB of the benchmark's corpus,
    the last block short."""
    data = bench_corpus(32 * BLOCK - 5000)
    comp = tpipe.TorchCompressor(level=1, device="cpu")
    cp, bs, _ = comp._setup(len(data))
    assert bs == BLOCK
    blocks, lens = comp._batch_blocks(np.frombuffer(data, np.uint8), len(data),
                                      0, 32, bs)
    stats, _ = tpipe._analyze(torch.from_numpy(blocks), torch.from_numpy(lens),
                              cp.hash_log, min(max(cp.min_match, 4), 8),
                              bs // 8)
    return stats.numpy(), lens, bs


def _assert_plans_equal(got, want):
    """The port's plans `got` equal zstd_tpu's `want` in the port's form:
    the plan rows, cap and widths, every field of every block's record, the
    arena of sequences headers and trees, and every Huffman table."""
    np.testing.assert_array_equal(got[1], want[1])       # the plan blob
    assert got[1].dtype == want[1].dtype
    assert got[2:] == want[2:]                           # cap and widths
    (rec, arena), (w_rec, w_arena) = got[0], planform.records(want[0])
    assert rec.dtype == w_rec.dtype and rec.shape == w_rec.shape
    for name, col in planform.COL.items():
        np.testing.assert_array_equal(rec[:, col], w_rec[:, col],
                                      err_msg=name)
    assert arena == w_arena
    for j, p in enumerate(want[0]):
        assert planform.huf_table(rec[j], got[1][j]) == \
            planform.ref_table(p["lit_plan"]), j


@pytest.mark.parametrize("strategy", [1, 3, 6, 9])
@pytest.mark.parametrize("rows", ["edge", "corpus", "crafted"])
def test_build_plans(rows, strategy, request):
    """The plans of a batch (blob, cap, widths, every field of every plan,
    the Huffman table) equal zstd_tpu's per-block planning, at strategies
    below ZSTD_lazy (the heuristic of select_encoding_type) and above it
    (the costs)."""
    stats, lens, block_size = request.getfixturevalue(rows)
    want = jpipe.TpuCompressor()._build_plans(stats, lens, strategy,
                                              block_size)
    got = tpipe.TorchCompressor(device="cpu")._build_plans(
        stats, lens, strategy, block_size)
    _assert_plans_equal(got, want)


def _modes(header: bytes, nb_seq: int) -> tuple:
    at = 1 + (nb_seq >= 128) + (nb_seq >= 0x7F00)
    return tuple((header[at] >> s) & 3 for s in (6, 4, 2))


@pytest.mark.parametrize("strategy", [1, 3, 6, 9])
def test_crafted_rows_reach_every_gate_and_mode(crafted, strategy):
    """The built rows reach what they are named for, by zstd_tpu's own
    functions: every literal gate, and every sequence mode, predefined also
    by the costs at strategies >= 5."""
    stats, lens, _ = crafted
    kinds = {name: _plan_one(n, h4, first, strategy)
             for name, (n, h4, first) in _lit_rows().items()}
    assert {k: lp[0]["kind"] for k, lp in kinds.items()} == {
        k: planform.KINDS[v] for k, v in dict(
            raw_count="raw", rle="rle", raw_flat="raw", raw_gain="raw",
            gain_boundary="raw", huf_1="huf", huf_4="huf",
            tree_decline="raw", stream_cap="raw").items()}
    assert kinds["huf_1"][0]["single"] and not kinds["huf_4"][0]["single"]
    lits = _lit_rows()
    assert lits["raw_count"][0] < jlit._min_literals_to_compress(
        strategy, jlit.HufRepeat.NONE)
    n, h4, _ = lits["raw_flat"]
    assert h4.sum(0).max() <= (n >> 7) + 4
    for name in ("raw_gain", "gain_boundary", "tree_decline", "stream_cap"):
        n, h4, _ = lits[name]
        hist = h4.sum(0)
        ms = int(np.nonzero(hist)[0][-1])
        ct = jhuf.build_huf_ctable(hist, ms, jhuf.huf_optimal_table_log(
            jhuf.HUF_TABLELOG_DEFAULT, n, ms))
        assert hist.max() > (n >> 7) + 4
        if name == "tree_decline":
            with pytest.raises(Corruption):
                jhuf.write_tree_description(ct)
            continue
        tree = jhuf.write_tree_description(ct)
        sizes = [(int(b) + 8) // 8 for b in h4 @ ct.nb_bits.astype(np.int64)]
        c_size = len(tree) + 6 + sum(sizes)
        if name == "stream_cap":
            assert max(sizes[:3]) > 65535
            assert c_size < n - jlit._min_gain(n, strategy)
        else:
            assert max(sizes) <= 65535
            assert c_size >= n - jlit._min_gain(n, strategy)
            if name == "gain_boundary" and strategy == 9:
                assert c_size == n - jlit._min_gain(n, strategy)

    plans = jpipe.TpuCompressor()._build_plans(stats, lens, strategy, N)[0]
    modes, by_cost = set(), False
    for p, row in zip(plans, stats):
        if not p["nb_seq"]:
            continue
        m = _modes(p["seq_header"], p["nb_seq"])
        modes.update(m)
        for t, at, n in ((0, tpipe._STATS_LL, 36), (1, tpipe._STATS_OF, 32),
                         (2, tpipe._STATS_ML, 53)):
            most = row[at:at + n].max()
            by_cost |= m[t] == 0 and most < p["nb_seq"] > 2
    assert modes == {0, 1, 2}
    assert by_cost
    assert {len(p["seq_header"]) for p in plans if not p["nb_seq"]} == {1}
    assert max(p["nb_seq"] for p in plans) >= 0x7F00


def test_a_batch_is_planned_in_one_host_call(corpus, monkeypatch):
    """A batch of 32 blocks is one call of native.plan_batch, one call of
    the C entry point and no per-block call of the entropy pieces; a whole
    encode calls the planner once a batch."""
    stats, lens, bs = corpus
    calls = dict.fromkeys(("plan_batch", "zt_plan_batch", "fse_normalize",
                           "fse_write_ncount", "fse_build_ctable",
                           "fse_compress_2state", "huf_build_write"), 0)

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    for name in calls:
        if name.startswith("zt_"):
            lib = _kernels.host()
            monkeypatch.setattr(lib, name, counted(name, getattr(lib, name)))
        else:
            monkeypatch.setattr(tnative, name,
                                counted(name, getattr(tnative, name)))
    rec, _ = tpipe.TorchCompressor(device="cpu")._build_plans(stats, lens, 1,
                                                              bs)[0]
    assert len(rec) == 32
    assert calls == dict(calls, plan_batch=1, zt_plan_batch=1) and \
        sum(calls.values()) == 2, calls
    calls.update(dict.fromkeys(calls, 0))
    frame = tpipe.TorchCompressor(level=1, batch_blocks=4, device="cpu") \
        .compress(bench_corpus(1 << 20))
    assert calls["plan_batch"] == calls["zt_plan_batch"] == 2     # 8 blocks
    assert refdecode.decode(frame) == bench_corpus(1 << 20)


@pytest.mark.parametrize("level", [1, 5])
def test_frames_equal_with_the_reference_plans(level, monkeypatch):
    """The device encode's frames of 1 MiB of the benchmark's corpus on the
    CPU equal those of the same code with zstd_tpu's plans patched in, and
    the plain reference decoder gives the input back."""
    data = bench_corpus(1 << 20)
    comp = tpipe.TorchCompressor(level=level, device="cpu")
    got = comp.compress(data)
    ref = jpipe.TpuCompressor()
    monkeypatch.setattr(tpipe.TorchCompressor, "_build_plans",
                        lambda self, *a: planform.port_form(
                            ref._build_plans(*a)))
    assert comp.compress(data) == got
    assert refdecode.decode(got) == data
