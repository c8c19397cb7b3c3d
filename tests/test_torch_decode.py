"""zstd_tpu_torch's device decode on the CPU, against zstd_tpu's.

The same inputs, made from a seed with numpy, go through the JAX function
(on the CPU backend, as tests/test_device_decoder.py runs it) and its
counterpart in the port (the kernels' plain versions). zstd is exact, so
equality is exact everywhere: output bytes, error types, `ok` at the
EXEC_ROUNDS boundary and `final` of an under-running stream.
"""

import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zstd_tpu
from tests.bigcorpus import big_corpus
from tests.conftest import gen_mixed, gen_text
from tests.decodecases import (nested_data, overrun_frame, repeated_pieces,
                               underrun_frame)
from zstd_tpu import device_decoder as jdec
from zstd_tpu.errors import ZstdError as JZstdError
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.ops import decode_dev as jops
from zstd_tpu_torch import device_decoder as tdec
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.errors import ZstdError as TZstdError
from zstd_tpu_torch.ops import decode_dev as tops

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "torch_decode"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NAMES = sorted(MANIFEST)


def fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def decode_both(blob: bytes, **kw):
    """(JAX output or exception, port output or exception)."""
    res = []
    for fn in (lambda: jdec.device_decompress(blob, **kw),
               lambda: tdec.device_decompress(blob, device="cpu", **kw)):
        try:
            res.append(fn())
        except Exception as e:          # compared by type and code below
            res.append(e)
    return res


def assert_same_result(blob: bytes, **kw):
    want, got = decode_both(blob, **kw)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (want, got)
        assert type(got).__name__ == type(want).__name__
        assert got.code.name == want.code.name, (want, got)
        return want
    assert not isinstance(got, Exception), got
    assert got == want
    return want


# ---- fixtures: frames of other encoders ----------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_to_digest(name):
    """tests/data/torch_decode (tools/make_torch_decode_frames.py) still
    decodes to its digest through zstd_tpu's device decoder."""
    out = jdec.device_decompress(fixture(name))
    assert len(out) == MANIFEST[name]["size"]
    assert hashlib.sha256(out).hexdigest() == MANIFEST[name]["sha256"]


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decode_matches(name):
    out = assert_same_result(fixture(name))
    assert hashlib.sha256(out).hexdigest() == MANIFEST[name]["sha256"]


def _frame_fields(pf):
    hdr = pf.hdr
    return dict(
        lanes=pf.lanes, lane_tab=list(pf.lane_tab),
        tables=[(s.tolist(), l.tolist()) for s, l in pf.tables],
        segs=[tuple(x) for x in pf.segs], host_pool=pf.host_pool,
        pool_len=pf.pool_len, ll=pf.ll.tolist(), ml=pf.ml.tolist(),
        off=pf.off.tolist(), n=pf.n, end_pos=pf.end_pos,
        hdr=(hdr.window_size, hdr.frame_content_size, hdr.dict_id,
             hdr.checksum_flag, hdr.single_segment, hdr.header_size))


@pytest.mark.parametrize("name", NAMES)
def test_parse_frame_matches(name):
    """The port's host parse (the C sequence decode of csrc/host/decode.c)
    equals zstd_tpu's, which runs its C library's sequence decode where
    that is built."""
    blob = fixture(name)
    want = jdec._parse_jobs(blob, 31)
    got = tdec._parse_jobs(blob, 31)
    assert [j[0] for j in got] == [j[0] for j in want]
    for w, g in zip(want, got):
        assert g[2] == w[2]
        if w[0] == "dev":
            assert _frame_fields(g[1]) == _frame_fields(w[1])
        else:
            assert g[1] == w[1]


@pytest.mark.parametrize("name", NAMES)
def test_group_inputs_match(name, monkeypatch):
    """The arrays _dispatch_group hands to fused_frame_decode."""
    blob = fixture(name)
    captured = {}

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        raise StopIteration

    monkeypatch.setattr(jdec, "fused_frame_decode", capture)
    groups = jdec._group_dev_jobs(jdec._parse_jobs(blob, 31))
    tgroups = tdec._group_dev_jobs(tdec._parse_jobs(blob, 31))
    assert [g[0] for g in tgroups] == [g[0] for g in groups]
    for (kind, run), (_, trun) in zip(groups, tgroups):
        if kind != "dev":
            continue
        with pytest.raises(StopIteration):
            jdec._dispatch_group([pf for _, pf, _ in run])
        got = tdec._group_inputs([pf for _, pf, _ in trun])
        names = ("sb", "start_bits", "n_syms", "n_lanes", "lut_sym",
                 "lut_len", "lane_tab", "seg_start", "seg_lane", "seg_src",
                 "seg_is_dev", "host_lits", "nb_lit", "lls", "mls", "offs",
                 "nb_seq", "out_len")
        for key, w in zip(names, captured["args"]):
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w),
                                          err_msg=key)
        assert got["max_syms"] == captured["kw"]["max_syms"]
        assert got["n"] == captured["kw"]["n"]


# ---- per function ---------------------------------------------------------

@pytest.mark.parametrize("seed, m", [(0, 1), (1, 7), (2, 300)])
def test_huf_window_values(seed, m):
    sb = np.random.default_rng(seed).integers(0, 256, m, np.uint8)
    want = np.asarray(jops.huf_window_values(jnp.asarray(sb)))
    got = tops.huf_window_values(torch.from_numpy(sb)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _lanes(seed: int):
    """Lanes of real Huffman streams over two tables (tableLog 11 and 8):
    1-stream lanes, the 4 streams of one run, an empty (padding) lane, a
    lane that asks for more symbols than its stream holds and one whose
    stream lost its low bytes (both under-run)."""
    rng = np.random.default_rng(seed)
    tables, streams = [], []
    for alphabet, tlog in ((200, 11), (12, 8)):
        p = rng.dirichlet(np.full(alphabet, 0.3))
        data = rng.choice(alphabet, 6000, p=p).astype(np.uint8)
        hist = np.bincount(data, minlength=256).astype(np.int64)
        ct = jhuf.build_huf_ctable(hist, int(data.max()), tlog)
        tables.append(jdec._expand_lut(jhuf.ctable_to_dtable(ct)))
        streams.append((data, ct))
    lanes = []                                   # (bytes, n_syms, table)
    for t, (data, ct) in enumerate(streams):
        for ln in (1, 37, 2500):
            lanes.append((jhuf.huf_encode_1x(data[:ln].tobytes(), ct), ln, t))
    data, ct = streams[0]
    run = data[:4001].tobytes()
    seg = (len(run) + 3) // 4
    for k in range(4):
        part = run[k * seg:(k + 1) * seg]
        lanes.append((jhuf.huf_encode_1x(part, ct), len(part), 0))
    full = jhuf.huf_encode_1x(data[:900].tobytes(), ct)
    lanes.append((full, 950, 0))                 # 50 symbols too many
    lanes.append((full[40:], 900, 0))            # low bytes lost
    lanes.append((b"", 0, 1))                    # padding lane
    return lanes, tables


def _pack(lanes, tables, byte_cap, max_syms):
    L = len(lanes)
    sb = np.zeros((L, byte_cap), np.uint8)
    bits = np.zeros(L, np.int32)
    nsy = np.zeros(L, np.int32)
    tab = np.zeros(L, np.int32)
    for i, (s, ln, t) in enumerate(lanes):
        sb[i, :len(s)] = np.frombuffer(s, np.uint8)
        bits[i] = 8 * (len(s) - 1) + (s[-1].bit_length() - 1) if s else 0
        nsy[i] = ln
        tab[i] = t
    lut_sym = np.stack([s for s, _ in tables])
    lut_len = np.stack([l for _, l in tables])
    return sb, bits, nsy, lut_sym, lut_len, tab


@pytest.mark.parametrize("seed", [0, 1])
def test_huf_decode_streams(seed):
    lanes, tables = _lanes(seed)
    byte_cap, max_syms = 4096, 3072
    sb, bits, nsy, lut_sym, lut_len, tab = _pack(lanes, tables, byte_cap,
                                                  max_syms)
    wins = jax.vmap(jops.huf_window_values)(jnp.asarray(sb))
    w_syms, w_final = jops.huf_decode_streams(
        wins, jnp.asarray(bits), jnp.asarray(nsy),
        jnp.asarray(lut_sym[tab].astype(np.int32)),
        jnp.asarray(lut_len[tab].astype(np.int32)), max_syms)
    g_syms, g_final = tops.huf_decode_streams(
        *(torch.from_numpy(a) for a in (sb, bits, nsy, lut_sym, lut_len,
                                         tab)), max_syms)
    w_syms, w_final = np.asarray(w_syms), np.asarray(w_final)
    np.testing.assert_array_equal(g_final.numpy(), w_final)
    for i, (_, ln, _) in enumerate(lanes):
        np.testing.assert_array_equal(g_syms[i, :ln].numpy(),
                                      w_syms[i, :ln])
    # the plain version also repeats the JAX scan past n_syms
    np.testing.assert_array_equal(g_syms.numpy(), w_syms)
    # well-formed lanes end at bit 0 and decode their literals; the two
    # under-running lanes end below 0; the padding lane stays at 0
    assert (w_final[:-3] == 0).all() and (w_final[-3:-1] < 0).all()
    assert w_final[-1] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_pool(seed):
    rng = np.random.default_rng(seed)
    L, msyms, npad, S = 6, 64, 512, 32
    syms = rng.integers(0, 256, (L, msyms), np.uint8)
    host = rng.integers(0, 256, 300, np.uint8)
    k = 11                                      # real segments, then padding
    starts = np.sort(rng.choice(np.arange(1, 480), k - 1, replace=False))
    seg_start = np.full(S, npad, np.int32)
    seg_start[:k] = np.concatenate([[0], starts])
    seg_lane = rng.integers(0, L, S).astype(np.int32)
    seg_src = rng.integers(0, 250, S).astype(np.int32)
    seg_dev = rng.integers(0, 2, S).astype(bool)
    args = (syms, seg_start, seg_lane, seg_src, seg_dev, host)
    want = jops.assemble_pool(*(jnp.asarray(a) for a in args), npad)
    got = tops.assemble_pool(*(torch.from_numpy(a) for a in args), npad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pad(a, cap):
    return np.pad(a, (0, cap - len(a))).astype(np.int32)


def _sequences(rng, n, h, seq_cap):
    """Random valid sequences over n output bytes: zero-match
    pseudo-sequences, overlapping matches (off < ml), matches into an
    h-byte history, a run of positions past the last sequence."""
    ll, ml, off = [], [], []
    pos = 0
    while len(ll) < seq_cap - 1:
        a = int(rng.integers(0, 20))
        kind = rng.integers(0, 4)
        if kind == 0:
            m, d = 0, 1                                   # literals only
        else:
            m = int(rng.integers(3, 60))
            reach = pos + a + h
            if reach < 1:
                a, reach = 1, pos + 1 + h
            d = int(rng.integers(1, min(8, reach) + 1)) if kind == 1 \
                else int(rng.integers(1, reach + 1))
        if pos + a + m > n - 40:
            break
        ll.append(a)
        ml.append(m)
        off.append(d)
        pos += a + m
    return (np.array(ll, np.int32), np.array(ml, np.int32),
            np.array(off, np.int32), pos)


@pytest.mark.parametrize("seed, h, cut", [(0, 1, 0), (1, 64, 0), (2, 64, 100),
                                          (3, 300, 7)])
def test_exec_sequences(seed, h, cut):
    rng = np.random.default_rng(seed)
    n, seq_cap = 2048, 128
    ll, ml, off, total = _sequences(rng, n, h, seq_cap)
    nb = len(ll)
    seqs = [_pad(a, seq_cap) for a in (ll, ml, off)]
    lits = rng.integers(0, 256, n, np.uint8)
    history = rng.integers(0, 256, h, np.uint8)
    out_len = total - cut
    want = jops.exec_sequences(
        jnp.asarray(lits), int(ll.sum()), *map(jnp.asarray, seqs), nb,
        out_len, n, jnp.asarray(history), h)
    got = tops.exec_sequences(
        torch.from_numpy(lits), *map(torch.from_numpy, seqs), nb, out_len, n,
        torch.from_numpy(history))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(want[1]) is True


def _chain(depth: int):
    """16 literals, then `depth` matches that each copy the 16 bytes before
    them: byte j of match k resolves through k matches."""
    ll = np.array([16] + [0] * depth, np.int32)
    ml = np.array([0] + [16] * depth, np.int32)
    off = np.array([1] + [16] * depth, np.int32)
    return ll, ml, off, 16 * (depth + 1)


@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("depth", [2, 4, 8, 16])
def test_exec_depth_boundary(rounds, depth, monkeypatch):
    """ok turns false at the same depth in both packages."""
    monkeypatch.setattr(jops, "EXEC_ROUNDS", rounds)
    monkeypatch.setattr(tops, "EXEC_ROUNDS", rounds)
    n, seq_cap = 512, 32
    ll, ml, off, total = _chain(depth)
    seqs = [_pad(a, seq_cap) for a in (ll, ml, off)]
    lits = np.random.default_rng(depth).integers(0, 256, n, np.uint8)
    hist = np.zeros(1, np.uint8)
    want = jops.exec_sequences(
        jnp.asarray(lits), 16, *map(jnp.asarray, seqs), len(ll), total, n,
        jnp.asarray(hist), 0)
    got = tops.exec_sequences(
        torch.from_numpy(lits), *map(torch.from_numpy, seqs), len(ll), total,
        n, torch.from_numpy(hist))
    assert bool(got[1]) == bool(want[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # doubling reaches depth d after ceil(log2(d + 1)) rounds; one more
    # round must see no change for ok
    assert bool(got[1]) == (depth <= 2 ** (rounds + 1))


# ---- the whole path -------------------------------------------------------

@pytest.mark.parametrize("level", [1, 3, 19])
def test_decodes_own_frames(level):
    data = big_corpus(192 * 1024)
    frame = zstd_tpu.compress(data, level=level, checksum=True)
    assert assert_same_result(frame) == data


def test_decodes_pipeline_frames():
    from zstd_tpu import pipeline
    data = gen_text(150_000, seed=3) + gen_mixed(50_000, seed=4)
    frame = pipeline.compress(data, level=1, checksum=True)
    assert assert_same_result(frame) == data


@pytest.mark.parametrize("size", [100_000, 300_000])
def test_decodes_port_level1_frames(size):
    data = big_corpus(size)
    frame = tpipe.compress(data, level=1, checksum=True, device="cpu")
    assert assert_same_result(frame) == data


@pytest.mark.parametrize("where", [-1, 60, 2000])
def test_corruption_raises_the_same_error(where):
    """A flipped checksum bit, a flipped bit in a literal stream, a flipped
    bit in a sequence section: the same error type and code."""
    data = gen_text(50_000, seed=9)
    frame = bytearray(zstd_tpu.compress(data, level=1, checksum=True))
    frame[where] ^= 0x10
    want = assert_same_result(bytes(frame))
    if where == -1:
        assert isinstance(want, JZstdError)


def test_underrun_raises_overread():
    data = big_corpus(256 * 1024)
    frame = underrun_frame(zstd_tpu.compress(data, level=1))
    want = assert_same_result(frame)
    assert "over-read" in str(want)
    for dec, kw in ((jdec, {}), (tdec, {"device": "cpu"})):
        out, n, ok = dec.device_decompress_resident(frame, **kw)
        assert not bool(ok) and ok.error_kind() == "over-read"
    _, _, final, nl = tdec._dispatch_group([tdec._parse_frame(frame, 0, 31)],
                                           torch.device("cpu"))
    pf = jdec._parse_frame(frame, 0, 31)
    _, _, jfinal, jnl = jdec._dispatch_group([pf])
    assert nl == jnl
    np.testing.assert_array_equal(final.numpy()[:nl], np.asarray(jfinal)[:nl])
    assert final[0] < 0


def test_overrun_raises_in_the_host_parse():
    """Literal lengths that add up past the block's literal count: the host
    parse refuses the frame before any device work, so the card and the
    CPU raise the same Corruption (the executor kernel takes no negative
    trailing literal count), as the host decoders do."""
    data = big_corpus(256 * 1024)
    frame = overrun_frame(tpipe.compress(data, level=1, device="cpu"))
    with pytest.raises(JZstdError):
        zstd_tpu.decompress(frame)
    with pytest.raises(TZstdError, match="literal buffer overrun"):
        tdec._parse_frame(frame, 0, 31)
    with pytest.raises(TZstdError, match="literal buffer overrun"):
        tdec.device_decompress(frame, device="cpu")


def _first_literals_type(frame: bytes) -> int:
    """Literals block type of the frame's first compressed block."""
    fhd = frame[4]
    single = bool(fhd & 0x20)
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + \
        (1 if single else 0, 2, 4, 8)[fhd >> 6]
    while (frame[pos] >> 1) & 3 != 2:
        pos += 3 + int.from_bytes(frame[pos:pos + 3], "little") // 8
    return frame[pos + 3] & 3


@pytest.mark.parametrize("kind, jax_error, jax_resident", [
    ("huffman", "huffman stream over-read (device decode)",
     (262_143, False, "over-read")),
    ("raw", "decoded size mismatch", (199_967, True, None)),
])
def test_overrun_pins_both_decoders(kind, jax_error, jax_resident):
    """A deliberate difference: on literal lengths past a block's literal
    count zstd_tpu.device_decoder over-reads a Huffman stream, and on raw
    literals its resident entry returns a wrong result with `ok` True;
    the port refuses both frames in the host parse, on both entries."""
    data = big_corpus(256 * 1024) if kind == "huffman" else repeated_pieces()
    frame = overrun_frame(tpipe.compress(data, level=1, device="cpu"))
    assert _first_literals_type(frame) == (2 if kind == "huffman" else 0)
    with pytest.raises(JZstdError) as e:
        jdec.device_decompress(frame)
    assert str(e.value) == f"corruption_detected: {jax_error}"
    assert e.value.code.name == "corruption_detected"
    _, n, ok = jdec.device_decompress_resident(frame)
    assert (n, bool(ok), ok.error_kind()) == jax_resident
    for entry in (tdec.device_decompress, tdec.device_decompress_resident):
        with pytest.raises(TZstdError) as e:
            entry(frame, device="cpu")
        assert str(e.value) == ("corruption_detected: literal buffer overrun "
                                "(device decode)")
        assert e.value.code.name == "corruption_detected"


def test_exec_depth_error_kind(monkeypatch):
    data = nested_data()
    frame = tpipe.compress(data, level=1, device="cpu")
    assert assert_same_result(frame) == data
    monkeypatch.setattr(jops, "EXEC_ROUNDS", 2)
    monkeypatch.setattr(tops, "EXEC_ROUNDS", 2)
    # the jitted JAX program read EXEC_ROUNDS when it was traced
    monkeypatch.setattr(jdec, "fused_frame_decode",
                        jops.fused_frame_decode.__wrapped__)
    want = assert_same_result(frame)
    assert "dependency depth" in str(want)
    for dec, kw in ((jdec, {}), (tdec, {"device": "cpu"})):
        _, n, ok = dec.device_decompress_resident(frame, **kw)
        assert n == len(data)
        assert not bool(ok) and ok.error_kind() == "exec-depth"


def test_resident_matches():
    data = big_corpus(256 * 1024)
    frame = zstd_tpu.compress(data, level=3, checksum=True)
    w_out, w_n, w_ok = jdec.device_decompress_resident(frame)
    g_out, g_n, g_ok = tdec.device_decompress_resident(frame, device="cpu")
    assert g_n == w_n == len(data)
    assert bool(g_ok) and bool(w_ok) and g_ok.error_kind() is None
    assert g_out.shape == tuple(np.asarray(w_out).shape)
    assert g_out[:g_n].numpy().tobytes() == data


def test_resident_rejects_what_jax_rejects():
    skip = (0x184D2A50).to_bytes(4, "little") + (0).to_bytes(4, "little")
    for dec, kw, err in ((jdec, {}, JZstdError),
                         (tdec, {"device": "cpu"}, TZstdError)):
        with pytest.raises(err):
            dec.device_decompress_resident(skip, **kw)
        with pytest.raises(err):
            dec.device_decompress(b"", **kw)


def test_host_route_is_counted(monkeypatch):
    """A frame the device cannot take goes to the host decoder, as in
    zstd_tpu, and is counted."""
    monkeypatch.setattr(jdec, "_STREAM_CAP", 256)
    monkeypatch.setattr(tdec, "_STREAM_CAP", 256)
    data = big_corpus(150_000)
    frame = zstd_tpu.compress(data, level=3, checksum=True)
    tdec.COUNTS["host_frames"] = 0
    assert assert_same_result(frame) == data
    assert tdec.COUNTS["host_frames"] == 1


def test_no_card_raises(monkeypatch):
    """With no device given the decoder runs on the card, and never falls
    back to the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = fixture("framegen_401.zst")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.device_decompress(frame)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.device_decompress_resident(frame)
