"""zstd_tpu_torch's host C on the CPU: the block decoder and the sequence
parse (csrc/host/decode.c), XXH64 (csrc/host/xxh64.c), and the entropy
planning and encoders (csrc/host/huf.c, encode.c), each at the call site
where zstd_tpu calls its own C.

Where zstd_tpu calls C, every comparison is three ways and exact: the
port's function (its C branch), the port's plain version (the Python
branch: `_parse_frame_plain`, `decompress_frame_plain`, the `*_plain`
functions) and zstd_tpu's function (its C branch; the module fixture
requires zstd_tpu's library). A spy on `zstd_tpu_torch.native` counts the
C calls and the declines, so each path a test means to take is shown
taken: a decline runs the Python branch, as in zstd_tpu, and must give
the reference's result or error.
"""

import concurrent.futures as fut
import json
import pathlib
import sys

import numpy as np
import pytest

import zstd_tpu
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from tests.decodecases import overrun_frame, repeated_pieces
from tests.hostplain import plain_branches
from zstd_tpu import device_decoder as jdec
from zstd_tpu import xxhash64 as jxxh
from zstd_tpu.format import codec as jcodec
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import fse as jfse
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.format import sequences as jseq
from zstd_tpu.native import get_native
from tests.refnative import reference_native
from zstd_tpu_torch import device_decoder as tdec
from zstd_tpu_torch import native as tnative
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch import xxhash64 as txxh
from zstd_tpu_torch.format import codec as tcodec
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.format import fse as tfse
from zstd_tpu_torch.format import huffman as thuf
from zstd_tpu_torch.format import sequences as tseq
from zstd_tpu_torch.parallel import multihost as tmh
from zstd_tpu_torch.parallel import pzstd as tpz

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "torch_decode"
NAMES = sorted(json.loads((FIXTURES / "manifest.json").read_text()))
BIG = big_corpus(256 * 1024)
C_CALLS = ("decode_sequences", "decompress_block", "decompress_blocks",
           "xxh64", "fse_normalize", "fse_write_ncount", "fse_build_ctable",
           "fse_compress_2state", "huf_build_write", "huf_encode",
           "huf_encode4", "encode_sequences", "split_points")


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert reference_native() is not None, \
        "zstd_tpu's C library is not built"


def _unknown_size(frame: bytes, window_log: int) -> bytes:
    """The frame with a header that states no content size (window
    `window_log`, not single-segment): its blocks decode through the ring
    buffer of the per-block path."""
    hdr = tframe.parse_frame_header(frame, 31)
    head = tframe.write_frame_header(0, window_log, hdr.checksum_flag,
                                     content_size_flag=False)
    return head + frame[hdr.header_size:]


_FRAMES = {}


def frame(name: str) -> bytes:
    if name not in _FRAMES:
        if name == "big256k_l1":
            blob = tcodec.compress(BIG, level=1, checksum=True)
        elif name == "pieces_l1":        # one match length: RLE tables
            blob = tcodec.compress(repeated_pieces(60_000), level=1)
        elif name == "unknown_size":     # 600 KB in a 128 KiB window
            data = big_corpus(600_000)
            blob = _unknown_size(
                tcodec.compress(data, level=3, checksum=True, window_log=17),
                17)
        elif name == "unknown_size_2g":  # the C declines a 2^28 window
            blob = _unknown_size(tcodec.compress(gen_text(40_000, seed=4),
                                                 level=3), 28)
        else:
            blob = (FIXTURES / name).read_bytes()
        _FRAMES[name] = blob
    return _FRAMES[name]


class Spy:
    """Counts calls and declines (None, -1 or -2) of the port's C
    wrappers."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(C_CALLS, 0)
        self.declines = dict.fromkeys(C_CALLS, 0)
        for name in C_CALLS:
            monkeypatch.setattr(tnative, name, self._wrap(name))

    def _wrap(self, name):
        fn = getattr(tnative, name)

        def call(*args, **kw):
            r = fn(*args, **kw)
            self.calls[name] += 1
            if r is None or (isinstance(r, int) and name != "xxh64"
                             and r < 0):
                self.declines[name] += 1
            return r
        return call

    def reset(self):
        for d in (self.calls, self.declines):
            for k in d:
                d[k] = 0


@pytest.fixture
def spy(monkeypatch):
    return Spy(monkeypatch)


def _outcome(fn, *args, **kw):
    """fn's result, or its exception's (type name, code) where it has one."""
    try:
        return fn(*args, **kw)
    except Exception as e:
        code = getattr(e, "code", None)
        return ("raises", type(e).__name__,
                code.name if code is not None else str(e))


# ---- the device decode's host parse -----------------------------------------

def _frame_fields(pf):
    hdr = pf.hdr
    for a in (pf.ll, pf.ml, pf.off):
        assert a.dtype == np.int64
    return dict(
        lanes=pf.lanes, lane_tab=list(pf.lane_tab),
        tables=[(s.tolist(), l.tolist()) for s, l in pf.tables],
        segs=[tuple(x) for x in pf.segs], host_pool=pf.host_pool,
        pool_len=pf.pool_len, ll=pf.ll.tolist(), ml=pf.ml.tolist(),
        off=pf.off.tolist(), n=pf.n, end_pos=pf.end_pos,
        hdr=(hdr.window_size, hdr.frame_content_size, hdr.dict_id,
             hdr.checksum_flag, hdr.single_segment, hdr.header_size))


def _jobs(jobs):
    return [(kind, _frame_fields(x) if kind == "dev" else x, csum)
            for kind, x, csum in jobs]


PARSED = NAMES + ["big256k_l1", "pieces_l1"]


@pytest.mark.parametrize("name", PARSED)
def test_parse_three_ways(name, spy, monkeypatch):
    """The parse's fields (lanes, tables, pool segments, ll, ml, off, n):
    C branch == plain branch == zstd_tpu's C branch."""
    blob = frame(name)
    want = _jobs(jdec._parse_jobs(blob, 31))
    got = _jobs(tdec._parse_jobs(blob, 31))
    n_sections = spy.calls["decode_sequences"]
    assert spy.declines["decode_sequences"] == 0
    monkeypatch.setattr(tdec, "_parse_frame", tdec._parse_frame_plain)
    plain = _jobs(tdec._parse_jobs(blob, 31))
    assert spy.calls["decode_sequences"] == n_sections
    assert got == want
    assert plain == want
    assert n_sections > 0 or name in ("framegen_400.zst", "framegen_403.zst",
                                      "framegen_404.zst", "framegen_408.zst",
                                      "framegen_411.zst")


def _table_modes(blobs) -> list[list[tuple]]:
    """Per frame, each sequences section's (LL, OF, ML) table modes, read
    from the sections the port's parse hands to the C."""
    seen = []
    orig = tnative.decode_sequences

    def record(ctx, section):
        b = bytes(section)
        k = 1 if b[0] < 128 else 2 if b[0] < 255 else 3
        if b[0] and len(b) > k:
            seen[-1].append(((b[k] >> 6) & 3, (b[k] >> 4) & 3,
                             (b[k] >> 2) & 3))
        return orig(ctx, section)

    tnative.decode_sequences = record
    try:
        for blob in blobs:
            seen.append([])
            tdec._parse_frame(blob, 0, 31)
    finally:
        tnative.decode_sequences = orig
    return seen


def test_parsed_frames_reach_repeat_and_rle_tables():
    """Among the frames above: a block after a frame's first whose tables
    repeat the previous block's (Repeat_Mode: the tables carry in the
    decoder context), and RLE tables."""
    modes = _table_modes([frame(n) for n in ("corpus192k_l19.zst",
                                             "pieces_l1")])
    assert any(3 in m for m in modes[0][1:])
    assert any(1 in m for m in modes[1])


def test_overrun_is_refused_after_the_c_parse(spy):
    """The port's refusal of literal lengths past the block's literals is
    reached after the C parse, on both entries and in both branches."""
    blob = overrun_frame(tcodec.compress(BIG, level=1))
    spy.reset()
    for fn in (tdec._parse_frame, tdec._parse_frame_plain):
        with pytest.raises(tdec.Corruption, match="literal buffer overrun"):
            fn(blob, 0, 31)
    assert spy.calls["decode_sequences"] == 1
    assert spy.declines["decode_sequences"] == 0


# ---- format.frame.decompress_frame ----------------------------------------

DECODED = PARSED + ["unknown_size", "unknown_size_2g"]


@pytest.mark.parametrize("name", DECODED)
def test_decompress_frame_three_ways(name, spy):
    blob = frame(name)
    pos, n_frames = 0, 0
    while pos < len(blob):
        if tframe.is_skippable(blob, pos):
            pos += 8 + int.from_bytes(blob[pos + 4:pos + 8], "little")
            continue
        want = jframe.decompress_frame(blob, pos, 31)
        got = tframe.decompress_frame(blob, pos, 31)
        plain = tframe.decompress_frame_plain(blob, pos, 31)
        assert got == want
        assert plain == want
        pos = want[1]
        n_frames += 1
    assert n_frames
    # the C path taken: the whole frame in C where the content size is
    # known, block by block through the ring buffer where it is not, none
    # above a 2^27 window; nothing declined
    assert not any(spy.declines.values()), spy.declines
    if name == "unknown_size":
        assert spy.calls["decompress_blocks"] == 0
        assert spy.calls["decompress_block"] >= 5     # 600,000 B
        assert len(want[0]) > 2 * (1 << 17) + 2 * (128 << 10)   # flushes
    elif name == "unknown_size_2g":
        assert spy.calls["decompress_block"] == \
            spy.calls["decompress_blocks"] == 0
    else:
        assert spy.calls["decompress_blocks"] == n_frames


def _corrupt(where: int) -> bytes:
    data = gen_text(50_000, seed=9)
    blob = bytearray(zstd_tpu.compress(data, level=1, checksum=True))
    blob[where] ^= 0x10
    return bytes(blob)


CORRUPT = {"checksum": lambda: _corrupt(-1), "literals": lambda: _corrupt(60),
           "sequences": lambda: _corrupt(2000),
           "overrun": lambda: overrun_frame(tcodec.compress(BIG, level=1)),
           "truncated": lambda: frame("big256k_l1")[:-1000]}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_frames_raise_the_reference_error(case, spy, monkeypatch):
    """The corrupt cases of test_corruption_raises_the_same_error and more:
    the host decoder (where the C declines, its Python branch raises)
    gives zstd_tpu's error, message included; the device decode's parse
    gives zstd_tpu's error type and code in both branches."""
    blob = CORRUPT[case]()
    spy.reset()
    errors = []
    for fn in (jframe.decompress_frame, tframe.decompress_frame):
        try:
            fn(blob, 0)
        except Exception as e:
            errors.append((type(e).__name__, e.code.name, str(e)))
    assert len(errors) == 2 and errors[1] == errors[0]
    assert spy.calls["decompress_blocks"] == 1
    # the flipped bits decode in C to a content whose checksum differs; the
    # overrun and the truncation the C declines to the Python branch, which
    # raises
    assert spy.declines["decompress_blocks"] == int(case in ("overrun",
                                                             "truncated"))
    want = ("raises",) + errors[0][:2]
    assert _outcome(tframe.decompress_frame_plain, blob, 0) == want
    dwant = _outcome(jdec.device_decompress, blob)
    if case == "overrun":    # a deliberate difference (ROADMAP section 3)
        dwant = ("raises", "Corruption", "corruption_detected")
    assert dwant[0] == "raises"
    assert _outcome(tdec.device_decompress, blob, device="cpu") == dwant
    monkeypatch.setattr(tdec, "_parse_frame", tdec._parse_frame_plain)
    assert _outcome(tdec.device_decompress, blob, device="cpu") == dwant


# ---- XXH64 ------------------------------------------------------------------

@pytest.mark.parametrize("size", (0, 1, 31, 32, 33, 100_000))
def test_xxh64_three_ways(size):
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    want = jxxh.xxh64(data)
    assert txxh.content_checksum(data) == want & 0xFFFFFFFF
    assert txxh.content_checksum_plain(data) == want & 0xFFFFFFFF
    assert txxh.content_checksum(bytearray(data)) == want & 0xFFFFFFFF
    for seed in (0, 1, (1 << 64) - 1):
        want = jxxh.xxh64(data, seed)
        assert tnative.xxh64(data, seed) == txxh._xxh64_py(data, seed) \
            == want


# ---- the entropy planning and encoders --------------------------------------

def _symbols(kind: str, n: int, alphabet: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, alphabet, n)
    if kind == "geometric":
        return np.minimum(rng.geometric(0.3, n) - 1, alphabet - 1)
    if kind == "skewed":                 # one symbol dominates
        x = rng.integers(0, alphabet, n)
        x[rng.random(n) < 0.9] = alphabet // 2
        return x
    if kind == "rare":                   # many symbols at count 1-2
        return np.concatenate([np.zeros(n - alphabet, np.int64),
                               np.arange(alphabet)])
    if kind == "two":
        return rng.integers(0, 2, n) * (alphabet - 1)
    if kind == "rle":                    # the C declines; Python raises
        return np.full(n, alphabet - 1)
    raise ValueError(kind)


FSE_CASES = [(k, n, a, s) for s, (k, n, a) in enumerate(
    [("uniform", 1000, 36), ("geometric", 5000, 53), ("skewed", 300, 32),
     ("rare", 2000, 53), ("two", 100, 29), ("uniform", 40, 13),
     ("geometric", 100_000, 256), ("rle", 500, 36)])]


def _ctable_arrays(ct):
    return (ct.table_log, ct.max_symbol, ct.state_table.tolist(),
            ct.delta_nb_bits.tolist(), ct.delta_find_state.tolist())


@pytest.mark.parametrize("case", FSE_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("low_prob", (False, True))
def test_fse_three_ways(case, low_prob, spy):
    """normalize_count, write_ncount, build_ctable and fse_compress_2state
    at table logs 5 to the cap (build_ctable in C up to 12)."""
    kind, n, alphabet, seed = case
    sym = _symbols(kind, n, alphabet, seed)
    count = np.bincount(sym, minlength=alphabet).astype(np.int64)
    mx = int(sym.max())
    data = sym.astype(np.uint8).tobytes()
    for tlog in sorted({tfse.min_table_log(n, mx), 5, 9, 12, 13}):
        if tlog < tfse.min_table_log(n, mx) or tlog > 15:
            continue
        spy.reset()
        want = _outcome(jfse.normalize_count, count, tlog, n, mx, low_prob)
        got = _outcome(tfse.normalize_count, count, tlog, n, mx, low_prob)
        plain = _outcome(tfse.normalize_count_plain, count, tlog, n, mx,
                         low_prob)
        if kind == "rle":
            assert want == got == plain == ("raises", "ZstdError", "GENERIC")
            assert spy.declines["fse_normalize"] == 1
            continue
        assert spy.declines["fse_normalize"] == 0
        assert got.dtype == plain.dtype == np.int32
        assert got.tolist() == plain.tolist() == want.tolist()
        norm = want
        w = jfse.write_ncount(norm, mx, tlog)
        assert tfse.write_ncount(norm, mx, tlog) == w
        assert tfse.write_ncount_plain(norm, mx, tlog) == w
        jct = jfse.build_ctable(norm, mx, tlog)
        tct = tfse.build_ctable(norm, mx, tlog)
        pct = tfse.build_ctable_plain(norm, mx, tlog)
        assert _ctable_arrays(tct) == _ctable_arrays(pct) == \
            _ctable_arrays(jct)
        assert spy.calls["fse_build_ctable"] == (1 if tlog <= 12 else 0)
        if mx < 256:
            w = jfse.fse_compress_2state(data, jct)
            assert tfse.fse_compress_2state(data, tct) == w
            assert tfse.fse_compress_2state_plain(data, tct) == w
            assert tfse.fse_compress_2state(data[:2], tct) == b""
        assert not any(spy.declines.values()), spy.declines


HUF_CASES = [("uniform", 50_000, 200, 1), ("geometric", 20_000, 200, 2),
             ("skewed", 5000, 64, 3), ("rare", 3000, 256, 4),
             ("two", 12, 90, 5), ("uniform", 300_000, 200, 6),
             ("single", 100, 66, 7), ("flat256", 256, 256, 8)]


def _huf_data(kind, n, alphabet, seed) -> bytes:
    if kind == "single":            # one symbol: the C declines
        return bytes([alphabet - 1]) * n
    if kind == "flat256":           # equal weights, > 128 symbols: -2
        return bytes(range(256))
    return _symbols(kind, n, alphabet, seed).astype(np.uint8).tobytes()


def _huf_table(r):
    if r[0] == "raises":
        return r
    ct, tree = r
    return (ct.table_log, ct.max_symbol, ct.nb_bits.tolist(),
            ct.value.tolist(), tree)


@pytest.mark.parametrize("case", HUF_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_huffman_three_ways(case, spy):
    """build_huf_ctable_with_tree (-2 -> Corruption; a single symbol or an
    infeasible height declines to Python), huf_encode_1x and huf_encode_4x
    (under 12 bytes no call; a stream past 65,535 bytes declines)."""
    data = _huf_data(*case)
    arr = np.frombuffer(data, np.uint8)
    count = np.bincount(arr, minlength=256).astype(np.int64)
    mx = int(arr.max())
    logs = (7, 11) if case[0] == "uniform" else (11,)
    for max_bits in logs:
        args = (count, mx, max_bits)
        want = _huf_table(_outcome(jhuf.build_huf_ctable_with_tree, *args))
        spy.reset()
        got = _huf_table(_outcome(thuf.build_huf_ctable_with_tree, *args))
        plain = _huf_table(_outcome(thuf.build_huf_ctable_with_tree_plain,
                                    *args))
        assert got == plain == want
        expect_decline = case[0] in ("single", "flat256") or max_bits == 7
        assert spy.declines["huf_build_write"] == int(expect_decline)
    if want[0] == "raises":
        assert case[0] in ("single", "flat256")
        return
    ct = jhuf.HufCTable(*want[:2], np.array(want[2], np.int32),
                        np.array(want[3], np.int32))
    tct = thuf.HufCTable(*want[:2], np.array(want[2], np.int32),
                         np.array(want[3], np.int32))
    spy.reset()
    for cut in (len(data), 11, 12, 1000):
        lit = data[:cut]
        w = jhuf.huf_encode_1x(lit, ct)
        assert thuf.huf_encode_1x(lit, tct) == thuf.huf_encode_1x_plain(
            lit, tct) == w
        w = jhuf.huf_encode_4x(lit, ct)
        assert thuf.huf_encode_4x(lit, tct) == thuf.huf_encode_4x_plain(
            lit, tct) == w
        if cut == len(data) and case[1] == 300_000:
            assert w is None                  # a stream past 65,535 bytes
    assert spy.declines["huf_encode4"] == int(case[1] == 300_000)
    assert not any(v for k, v in spy.declines.items() if k != "huf_encode4")


def _seqstore(mod, kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "random":
        ll = np.minimum(rng.geometric(0.2, n) - 1, 70_000)
        ll[rng.random(n) < 0.01] = 70_000
        ob = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n),
                      rng.integers(4, 1 << 22, n))
        mb = np.minimum(rng.geometric(0.1, n) - 1, 1 << 17)
    else:                                     # one code each: RLE tables
        ll, ob, mb = np.full(n, 5), np.full(n, 1000), np.full(n, 45)
    return mod.SeqStore(ll.astype(np.int32), ob.astype(np.int32),
                        mb.astype(np.int32), b"")


@pytest.mark.parametrize("kind, n", [("random", 1), ("random", 2),
                                     ("random", 300), ("random", 20_000),
                                     ("rle", 1000)])
@pytest.mark.parametrize("strategy", (1, 5))
def test_encode_sequences_three_ways(kind, n, strategy, spy):
    """The sequence bitstream with the tables the header build chose
    (predefined, RLE or FSE)."""
    js, ts = _seqstore(jseq, kind, n, n), _seqstore(tseq, kind, n, n)
    jcodes = jseq.seq_to_codes_np(js.lit_length, js.off_base, js.ml_base)
    tcodes = tseq.seq_to_codes_np(ts.lit_length, ts.off_base, ts.ml_base)
    jh, jst, _ = jseq.build_sequences_header(*jcodes, n,
                                             jseq.FseEntropyState(), strategy)
    th, tst, _ = tseq.build_sequences_header(*tcodes, n,
                                             tseq.FseEntropyState(), strategy)
    assert th == jh
    tables = (tst.ct_ll, tst.ct_of, tst.ct_ml)
    for a, b in zip(tables, (jst.ct_ll, jst.ct_of, jst.ct_ml)):
        assert _ctable_arrays(a) == _ctable_arrays(b)
    want = jseq.encode_sequences(js, *jcodes, jst.ct_ll, jst.ct_of,
                                 jst.ct_ml)
    assert tseq.encode_sequences(ts, *tcodes, *tables) == want
    assert tseq.encode_sequences_plain(ts, *tcodes, *tables) == want
    assert spy.calls["encode_sequences"] == 1
    assert not any(spy.declines.values()), spy.declines


# ---- decompress_stream on threads -------------------------------------------

def test_decompress_stream_threads_equal_serial():
    """48 frames decoded by 16 threads, whose C decodes run outside the GIL
    at once, six times: each time the serial output."""
    data = big_corpus(768 * 1024)
    stream = tpz.pzstd_compress(data, level=3, chunk_size=16 * 1024,
                                workers=4)
    serial = tmh.decompress_stream(stream, workers=1)
    assert serial == data
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with fut.ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(
                lambda _: tmh.decompress_stream(stream, workers=16),
                range(6)))
    finally:
        sys.setswitchinterval(old)
    assert all(o == serial for o in outs)


# ---- the slice as a whole ---------------------------------------------------

def _encode(kind: str) -> bytes:
    data = BIG[:96 * 1024]
    if kind == "codec_l19":          # the per-block loop, two-pass portfolio
        return tcodec.compress(data, level=19, checksum=True)
    if kind == "codec_l5_long":      # the host LDM's per-block loop
        return tcodec.compress(data * 2, level=5, long_mode=True,
                               window_log=20)
    return tpipe.compress(BIG, level=1, checksum=True, device="cpu")


def _reference(kind: str) -> bytes | None:
    data = BIG[:96 * 1024]
    if kind == "codec_l19":
        return jcodec.compress(data, level=19, checksum=True)
    if kind == "codec_l5_long":
        return jcodec.compress(data * 2, level=5, long_mode=True,
                               window_log=20)
    return None     # the device pipeline: tests/test_torch_pipeline.py


@pytest.mark.parametrize("kind", ("codec_l19", "codec_l5_long",
                                  "pipeline_l1"))
def test_slice_equals_under_plain_branches(kind, spy):
    """Whole encodes and decodes with the C branches and with every one of
    them swapped for its plain version (tests/hostplain.py): the same frame
    (zstd_tpu's, where its host codec makes it) and the same bytes back
    from the host decoder and the device decode's parse."""
    got = _encode(kind)
    assert spy.calls["encode_sequences"] + spy.calls["fse_build_ctable"] > 0
    decoded = tcodec.decompress(got)
    parsed = _jobs(tdec._parse_jobs(got, 31))
    with plain_branches():
        spy.reset()
        plain = _encode(kind)
        assert tcodec.decompress(plain) == decoded
        assert _jobs(tdec._parse_jobs(plain, 31)) == parsed
        assert not any(spy.calls.values()), spy.calls
    assert plain == got
    want = _reference(kind)
    if want is not None:
        assert got == want
    assert decoded == (BIG[:96 * 1024] * (2 if "long" in kind else 1)
                       if kind != "pipeline_l1" else BIG)


def test_reference_native_rebuilds_after_a_lost_build_race(monkeypatch):
    """A worker whose first `make -C native` lost the race to another
    worker's keeps None from zstd_tpu's get_native(); reference_native()
    builds again under its lock and loads the library."""
    from zstd_tpu import native as jnative
    monkeypatch.setattr(jnative, "_native", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert get_native() is None
    lib = reference_native()
    assert lib is not None and get_native() is lib
    assert lib.xxh64(b"abc", 0) == txxh._xxh64_py(b"abc", 0)
