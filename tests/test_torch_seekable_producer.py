"""zstd_tpu_torch's seekable format and external sequence producer on the
CPU, against zstd_tpu's.

seekable: the same inputs go through zstd_tpu.seekable and
zstd_tpu_torch.seekable; blobs, seek tables, ranges and errors (type, code
and message) must be equal. One fault of zstd_tpu is not inherited and is
pinned here: `seekable_compress(data, frame_size=0)` (or any negative
frame_size) never returns on data that is not empty, because its loop
never advances; the port raises ValueError there and gives zstd_tpu's bytes
on every input zstd_tpu returns on.

The producer: the same function is registered in both packages (inside
try / finally, so no worker keeps one), and the frames must be equal at
every level, the whole-frame C routes of levels 1-12 included, which must
stand aside while a producer is registered.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import zstd_tpu
import zstd_tpu_torch
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from zstd_tpu import errors as jerrors
from zstd_tpu import seekable as jseek
from zstd_tpu.format import codec as jcodec
from zstd_tpu.format import matchfinder as jmf
from zstd_tpu_torch import errors as terrors
from zstd_tpu_torch import seekable as tseek
from zstd_tpu_torch.format import block as tblock
from zstd_tpu_torch.format import codec as tcodec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RAND = np.random.default_rng(1).integers(0, 256, 96 * 1024,
                                          dtype=np.uint8).tobytes()
# 1.5 MiB: big_corpus and incompressible stretches in turn
MIX = (big_corpus(96 * 1024) + _RAND) * 8
INPUTS = {"0B": b"", "90B": gen_text(90, seed=2), "1.5MiB": MIX}


def _outcome(fn, *args, **kwargs):
    """("ok", value) or (error type name, code name, message)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except (jerrors.ZstdError, terrors.ZstdError) as e:
        return (type(e).__name__, e.code.name, str(e))


# ---------------------------------------------------------------- seekable

@pytest.fixture(scope="module")
def blobs():
    return {}


def _blob(cache, name, level, frame_size, checksum):
    key = (name, level, frame_size, checksum)
    if key not in cache:
        data = INPUTS[name]
        cache[key] = (
            jseek.seekable_compress(data, level, frame_size, checksum),
            tseek.seekable_compress(data, level, frame_size, checksum))
    return cache[key]


@pytest.mark.parametrize("checksum", (True, False))
@pytest.mark.parametrize("frame_size", (64 * 1024, 1 << 20))
@pytest.mark.parametrize("level", (1, 3, 19))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_seekable_blob_equals_jax(blobs, name, level, frame_size, checksum):
    want, got = _blob(blobs, name, level, frame_size, checksum)
    assert got == want
    st, jst = tseek.read_seek_table(got), jseek.read_seek_table(want)
    assert (st.entries, st.frame_offsets, st.content_offsets) == \
        (jst.entries, jst.frame_offsets, jst.content_offsets)
    assert st.content_size == len(INPUTS[name])
    assert tseek.seekable_decompress(got) == INPUTS[name]


@pytest.mark.parametrize("frame_size", (64 * 1024, 1 << 20))
def test_seekable_ranges_equal_jax(blobs, frame_size):
    _, blob = _blob(blobs, "1.5MiB", 1, frame_size, True)
    total = len(MIX)
    cases = [(0, None), (0, 10), (70_000, 200_000), (65_535, 2),
             (total - 5, None), (total, None), (total, 10),
             (1 << 20, 1), (300_000, -7), (100, 0), (total - 100, 10_000),
             (-1, 5), (total + 1, None), (-20, None)]
    for offset, length in cases:
        want = _outcome(jseek.seekable_decompress, blob, offset, length)
        got = _outcome(tseek.seekable_decompress, blob, offset, length)
        assert got == want, (offset, length)
        if want[0] == "ok" and length is not None and length >= 0 \
                and offset >= 0:
            assert got[1] == MIX[offset:offset + length]
    assert _outcome(tseek.seekable_decompress, blob, -1, 5)[1] == \
        "parameter_outOfBound"


def _corrupt(blob: bytes, at: int, xor: int) -> bytes:
    out = bytearray(blob)
    out[at] ^= xor
    return bytes(out)


def test_seekable_errors_equal_jax(blobs):
    _, blob = _blob(blobs, "1.5MiB", 1, 1 << 20, True)
    st = tseek.read_seek_table(blob)
    table_start = len(blob) - 8 - (len(st.entries) * 12 + 9)
    flipped = bytearray(blob)
    frame1 = st.frame_offsets[1]
    # the first frame's content checksum in the seek table
    flipped[table_start + 8 + 8] ^= 0x01
    sized = bytearray(blob)
    sized[table_start + 8 + 4] ^= 0x01       # frame 0's decompressed size
    cases = {
        "bad_footer_magic": _corrupt(blob, len(blob) - 1, 0x40),
        "reserved_bits": _corrupt(blob, len(blob) - 5, 0x04),
        "truncated_table": blob[:table_start] + blob[table_start + 12:],
        "table_larger_than_file": blob[-20:],
        "bad_skippable_magic": _corrupt(blob, table_start, 0x01),
        "flipped_checksum": bytes(flipped),
        "frame_size_mismatch": bytes(sized),
        "too_small": blob[-16:],
        "corrupt_frame": _corrupt(blob, frame1 // 2, 0xFF),
    }
    for name, bad in cases.items():
        want = _outcome(jseek.read_seek_table, bad)
        got = _outcome(tseek.read_seek_table, bad)
        assert (got[0] == "ok") == (want[0] == "ok"), name
        if got[0] == "ok":
            assert got[1].entries == want[1].entries, name
            want = _outcome(jseek.seekable_decompress, bad)
            got = _outcome(tseek.seekable_decompress, bad)
        assert got == want, name
        assert want[0] != "ok", name
    codes = {n: _outcome(tseek.seekable_decompress, b)[1]
             for n, b in cases.items()}
    assert codes["bad_footer_magic"] == "prefix_unknown"
    assert codes["flipped_checksum"] == "checksum_wrong"
    assert codes["reserved_bits"] == codes["truncated_table"] == \
        "corruption_detected"
    # verify_checksum=False reads past a flipped table checksum
    assert tseek.seekable_decompress(bytes(flipped), 0, 100,
                                     verify_checksum=False) == MIX[:100]


def test_frame_size_zero_pins_reference_fault():
    """zstd_tpu's loop never ends at frame_size 0 (a subprocess killed
    after 3 s); the port raises ValueError, and equals zstd_tpu on the one
    input zstd_tpu returns on (empty data)."""
    code = ("from zstd_tpu.seekable import seekable_compress\n"
            "print('called', flush=True)\n"
            "seekable_compress(b'abc' * 100, level=1, frame_size=0)\n"
            "print('returned', flush=True)\n")
    with pytest.raises(subprocess.TimeoutExpired) as hung:
        subprocess.run([sys.executable, "-c", code], capture_output=True,
                       cwd=ROOT, timeout=3)
    assert hung.value.stdout == b"called\n"
    for data, frame_size in ((b"abc" * 100, 0), (b"abc" * 100, -4),
                             (b"", -1)):
        with pytest.raises(ValueError, match="frame_size must be at least"):
            tseek.seekable_compress(data, level=1, frame_size=frame_size)
    assert tseek.seekable_compress(b"", level=1, frame_size=0) == \
        jseek.seekable_compress(b"", level=1, frame_size=0)


# ---------------------------------------------------- the sequence producer

def _both(producer, fn):
    """fn() with `producer` registered in both packages."""
    zstd_tpu.register_sequence_producer(producer)
    zstd_tpu_torch.register_sequence_producer(producer)
    try:
        return fn()
    finally:
        zstd_tpu.register_sequence_producer(None)
        zstd_tpu_torch.register_sequence_producer(None)


def period8(full, bs, be, wl):
    """One long repeat of an 8-byte period per block."""
    if be - bs < 64:
        return None
    ml = (be - bs) - 16
    ml -= ml % 8
    return [(8, 8, ml)]


def greedy(full, bs, be, wl):
    """Raw sequences (literal length, distance, match length) of zstd_tpu's
    greedy finder, its offset codes resolved to distances."""
    if be - bs < 16:
        return None
    seqs, _ = jmf.find_sequences(full, bs, be, wl, (1, 4, 8), 16, 5)
    reps, out = (1, 4, 8), []
    for ll, ob, mb in zip(seqs.lit_length.tolist(), seqs.off_base.tolist(),
                          seqs.ml_base.tolist()):
        out.append((ll, jmf.resolve_offset(reps, ob, ll), mb + 3))
        reps = jmf.update_reps(reps, ob, ll)
    return out


def test_external_sequence_producer():
    """tests/test_extras.py's producer test on the port."""
    data = b"abcdefgh" * 4000
    zstd_tpu_torch.register_sequence_producer(period8)
    try:
        blob = zstd_tpu_torch.compress(data, level=3, checksum=True)
    finally:
        zstd_tpu_torch.register_sequence_producer(None)
    assert zstd_tpu.decompress(blob) == data
    assert zstd_tpu_torch.decompress(blob) == data
    assert len(blob) < 200


def test_sequence_producer_validation():
    """tests/test_extras.py's validation test on the port."""
    def bad(full, bs, be, wl):
        return [(0, 999999, 100)]  # offset beyond window

    zstd_tpu_torch.register_sequence_producer(bad)
    try:
        with pytest.raises(terrors.Corruption):
            zstd_tpu_torch.compress(b"x" * 50000, level=3)
    finally:
        zstd_tpu_torch.register_sequence_producer(None)
    assert tblock._SEQ_PRODUCER is None


TEXT = gen_text(150_000, seed=12)


@pytest.mark.parametrize("long_mode", (False, True))
@pytest.mark.parametrize("level", (1, 3, 9, 19))
@pytest.mark.parametrize("producer", ("period8", "greedy"))
def test_producer_frames_equal_jax(producer, level, long_mode):
    fn = {"period8": period8, "greedy": greedy}[producer]
    data = b"abcdefgh" * 20_000 if producer == "period8" else TEXT
    if level == 19:
        data = data[:40_000]
    kwargs = dict(level=level, checksum=True, long_mode=long_mode)
    if long_mode:
        kwargs["window_log"] = 20
    want, got = _both(fn, lambda: (jcodec.compress(data, **kwargs),
                                   tcodec.compress(data, **kwargs)))
    assert got == want
    assert tcodec.decompress(got) == data
    # the producer's frame is not the built-in finders'
    assert got != tcodec.compress(data, **kwargs)


@pytest.mark.parametrize("level", (1, 3, 9, 19))
def test_producer_returning_none_equals_jax(level):
    calls = []

    def none(full, bs, be, wl):
        calls.append((bs, be))
        return None

    data = TEXT[:60_000] if level == 19 else TEXT
    want, got = _both(none, lambda: (jcodec.compress(data, level=level),
                                     tcodec.compress(data, level=level)))
    assert got == want
    assert calls, "the producer was never asked"
    assert tcodec.decompress(got) == data


def test_register_none_restores_the_builtin_finders():
    data = TEXT[:50_000]
    plain = tcodec.compress(data, level=1)
    _both(period8, lambda: None)
    assert tblock._SEQ_PRODUCER is None
    assert tcodec.compress(data, level=1) == plain == \
        jcodec.compress(data, level=1)


@pytest.mark.parametrize("case,message", (
    ("short_match", "sequence producer: invalid sequence"),
    ("negative_literals", "sequence producer: invalid sequence"),
    ("zero_offset", "sequence producer: invalid sequence"),
    ("past_block", "sequence producer: out-of-window sequence"),
    ("before_window", "sequence producer: out-of-window sequence"),
    ("no_repeat", "sequence producer: match bytes do not repeat")))
def test_producer_corruption_equals_jax(case, message):
    seqs = {"short_match": [(4, 4, 2)], "negative_literals": [(-1, 4, 8)],
            "zero_offset": [(10, 0, 8)], "past_block": [(10, 4, 10 ** 6)],
            "before_window": [(0, 999_999, 100)],
            "no_repeat": [(100, 37, 40)]}[case]

    def bad(full, bs, be, wl):
        return seqs

    data = gen_text(50_000, seed=5)
    for level in (1, 3, 19):
        want, got = _both(bad, lambda: (
            _outcome(jcodec.compress, data, level=level),
            _outcome(tcodec.compress, data, level=level)))
        assert got == want == ("Corruption", "corruption_detected",
                               f"corruption_detected: {message}")
