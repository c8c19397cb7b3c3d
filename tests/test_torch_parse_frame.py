"""The device decode's host parse in one C call a frame
(csrc/host/decode.c, zt_parse_frame) against its plain version, on the
corrupt and limit cases that the plain walk (device_decoder._parse_blocks)
checks, and on frames whose arrays outgrow the first guess of their length.

Each corrupt case raises the same exception class, with the same code,
from `_parse_frame` and `_parse_frame_plain`, and the same message where
the case names one. The fields of valid frames are held three ways in
tests/test_torch_host_c.py (test_parse_three_ways).
"""

import numpy as np
import pytest

from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from tests.decodecases import overrun_frame
from zstd_tpu_torch import device_decoder as tdec
from zstd_tpu_torch import native as tnative
from zstd_tpu_torch.format import codec as tcodec
from zstd_tpu_torch.format import frame as tframe

MAGIC = (0xFD2FB528).to_bytes(4, "little")
HEAD = MAGIC + bytes([0x00, 0x00])   # no content size; a 1 KiB window
TREE = bytes([128, 0x10])            # symbols 0 and 1, one bit each
STREAM = bytes([0x81])               # seven bits and the sentinel
NO_SEQUENCES = b"\x00"


def block(btype: int, payload: bytes, last: bool = True,
          size: int | None = None) -> bytes:
    size = len(payload) if size is None else size
    return (int(last) | btype << 1 | size << 3).to_bytes(3, "little") + payload


def compressed(payload: bytes, **kw) -> bytes:
    return HEAD + block(2, payload, **kw)


def huf_header(ltype: int, sf: int, regen: int, csize: int) -> bytes:
    """A compressed (2) or treeless (3) literals header of 3 bytes."""
    return (ltype | sf << 2 | regen << 4 | csize << 14).to_bytes(3, "little")


def four_streams(ltype: int, jump: tuple, streams: bytes,
                 tree: bytes = TREE) -> bytes:
    body = tree + b"".join(s.to_bytes(2, "little") for s in jump) + streams
    return huf_header(ltype, 1, 8, len(body)) + body + NO_SEQUENCES


def rle_sequences(n: int, ll_code: int, of_code: int, ml_code: int,
                  bits: bytes) -> bytes:
    """A sequences section of n sequences under RLE tables (no state bits):
    each reads only its codes' extra bits from `bits`."""
    head = bytes([n]) if n < 128 else bytes([128 + (n >> 8), n & 0xFF])
    return head + bytes([0x54, ll_code, of_code, ml_code]) + bits


def unknown_size(blob: bytes, window_log: int) -> bytes:
    hdr = tframe.parse_frame_header(blob, 31)
    head = tframe.write_frame_header(0, window_log, hdr.checksum_flag,
                                     content_size_flag=False)
    return head + blob[hdr.header_size:]


_SHORT, _CORRUPT = "srcSize_wrong", "corruption_detected"

# name -> (frame, error code, message or None where the plain version says
# more: it names the check of the tree or of the sequences section)
CASES = {
    "truncated_block_header": (lambda: HEAD + b"\x01\x00", _SHORT,
                               "truncated block header"),
    "truncated_raw_block": (lambda: HEAD + block(0, b"abc", size=10), _SHORT,
                            "truncated raw block"),
    "truncated_rle_block": (lambda: HEAD + block(1, b"", size=5), _SHORT,
                            "truncated RLE block"),
    "empty_payload": (lambda: compressed(b""), _CORRUPT,
                      "empty block payload"),
    "raw_literals_header": (lambda: compressed(bytes([0x04])), _CORRUPT,
                            "literals: truncated header"),
    "raw_literals_truncated": (lambda: compressed(bytes([5 << 3]) + b"ab"),
                               _CORRUPT, "literals: raw content truncated"),
    "rle_literal_missing": (lambda: compressed(bytes([1 | 5 << 3])),
                            _CORRUPT, "literals: missing RLE byte"),
    "truncated_literals_header": (lambda: compressed(bytes([0x02, 0x00])),
                                  _CORRUPT, "literals header truncated"),
    "truncated_literals_section": (
        lambda: compressed(huf_header(2, 0, 10, 50) + b"xx"), _CORRUPT,
        "literals section truncated"),
    "corrupt_tree": (
        lambda: compressed(huf_header(2, 0, 8, 3) + bytes([128, 0x00])
                           + STREAM + NO_SEQUENCES), _CORRUPT, None),
    "treeless_first": (
        lambda: compressed(huf_header(3, 0, 8, 1) + STREAM + NO_SEQUENCES),
        _CORRUPT, "treeless literals without a previous table"),
    "missing_jump_table": (
        lambda: compressed(huf_header(2, 1, 8, 5) + TREE + b"\x01\x02\x03"
                           + NO_SEQUENCES), _CORRUPT,
        "4-stream literals: missing jump table"),
    "bad_jump_table": (
        lambda: compressed(four_streams(2, (5, 0, 0), STREAM * 3)),
        _CORRUPT, "4-stream literals: bad jump table"),
    "zero_size_stream": (
        lambda: compressed(four_streams(2, (0, 1, 1), STREAM * 3)),
        _CORRUPT, "literal stream size out of range"),
    "empty_single_stream": (
        lambda: compressed(huf_header(2, 0, 8, 2) + TREE + NO_SEQUENCES),
        _CORRUPT, "literal stream size out of range"),
    "stream_without_sentinel": (
        lambda: compressed(huf_header(2, 0, 8, 4) + TREE + b"\x81\x00"
                           + NO_SEQUENCES), _CORRUPT,
        "huffman stream: missing sentinel"),
    "fourth_stream_without_sentinel": (
        lambda: compressed(four_streams(2, (1, 1, 1), STREAM * 3 + b"\x00")),
        _CORRUPT, "huffman stream: missing sentinel"),
    "treeless_stream_without_sentinel": (
        lambda: HEAD + block(2, four_streams(2, (1, 1, 1), STREAM * 4),
                             last=False)
        + block(2, four_streams(3, (1, 1, 1), STREAM * 3 + b"\x00",
                                tree=b"")), _CORRUPT,
        "huffman stream: missing sentinel"),
    "empty_sequences_section": (
        lambda: compressed(bytes([4 << 3]) + b"abcd"), _CORRUPT, None),
    "literal_buffer_overrun": (
        lambda: overrun_frame(tcodec.compress(big_corpus(256 * 1024),
                                              level=1)), _CORRUPT,
        "literal buffer overrun (device decode)"),
    # one match of 3 at offset 10 after 4 literals: past the frame's start
    "offset_before_frame": (
        lambda: compressed(bytes([4 << 3]) + b"abcd"
                           + rle_sequences(1, 4, 3, 0, bytes([0x0D]))),
        _CORRUPT, "offset beyond window (device decode)"),
    # a level-1 frame of 50 KB of text declared with a 1 KiB window
    "offset_beyond_window": (
        lambda: unknown_size(tcodec.compress(gen_text(50_000, seed=9),
                                             level=1), 10), _CORRUPT,
        "offset beyond window (device decode)"),
    "reserved_block_type": (lambda: HEAD + block(3, b"x"), _CORRUPT,
                            "reserved block type"),
}


def _raised(fn, blob):
    with pytest.raises(Exception) as e:
        fn(blob, 0, 31)
    return e.value


@pytest.mark.parametrize("case", sorted(CASES))
def test_corrupt_frame_raises_as_the_plain_parse(case):
    make, code, msg = CASES[case]
    blob = make()
    got = _raised(tdec._parse_frame, blob)
    want = _raised(tdec._parse_frame_plain, blob)
    assert type(got) is type(want), (got, want)
    assert got.code.name == want.code.name == code
    if msg is not None:
        assert str(got) == str(want) == f"{code}: {msg}"


def test_stream_over_the_cap_goes_to_the_host(monkeypatch):
    """A literal stream past _STREAM_CAP: both branches decline the frame
    (_DeviceUnsupported), and _parse_jobs decodes it on the host and
    counts it."""
    data = big_corpus(150_000)
    blob = tcodec.compress(data, level=3, checksum=True)
    monkeypatch.setattr(tdec, "_STREAM_CAP", 256)
    for fn in (tdec._parse_frame, tdec._parse_frame_plain):
        with pytest.raises(tdec._DeviceUnsupported):
            fn(blob, 0, 31)
    before = tdec.COUNTS["host_frames"]
    assert tdec._parse_jobs(blob, 31) == [("host", data, -1)]
    assert tdec.COUNTS["host_frames"] == before + 1


def _fields(pf):
    return dict(
        lanes=pf.lanes, lane_tab=list(pf.lane_tab),
        tables=[(s.tolist(), l.tolist()) for s, l in pf.tables],
        segs=[tuple(x) for x in pf.segs], host_pool=pf.host_pool,
        pool_len=pf.pool_len, ll=pf.ll.tolist(), ml=pf.ml.tolist(),
        off=pf.off.tolist(), n=pf.n, end_pos=pf.end_pos)


def _many_sequences(n: int) -> bytes:
    """8 raw bytes, then a block of n matches of 3 at repcodes (offsets 4
    and 1 by turns) and no literals: n sequences in a few bytes."""
    return HEAD + block(0, b"abcdefgh", last=False) + block(
        2, b"\x00" + rle_sequences(n, 0, 0, 0, b"\x01"))


def _rle_blocks() -> bytes:
    """Three RLE blocks of 100,000 bytes and 40 raw blocks of one byte:
    a host pool and segments far past the frame's own size."""
    blocks = [block(1, b"z", last=False, size=100_000) for _ in range(3)]
    blocks += [block(0, bytes([i]), last=i == 39) for i in range(40)]
    return HEAD + b"".join(blocks)


def _tree_then_treeless() -> bytes:
    """Two blocks with trees, then one treeless: its lanes take the second
    tree's table."""
    fresh = four_streams(2, (1, 1, 1), STREAM * 4)
    return HEAD + block(2, fresh, last=False) + block(2, fresh, last=False) \
        + block(2, four_streams(3, (1, 1, 1), STREAM * 4, tree=b""))


ROOMY = {"many_sequences": lambda: _many_sequences(20_000),
         "tree_then_treeless": _tree_then_treeless,
         "rle_blocks": _rle_blocks,
         "big256k_l1": lambda: tcodec.compress(big_corpus(256 * 1024),
                                               level=1, checksum=True),
         "text_l19": lambda: tcodec.compress(gen_text(120_000, seed=3),
                                             level=19)}


@pytest.mark.parametrize("room", ("guessed", "none"))
@pytest.mark.parametrize("name", sorted(ROOMY))
def test_arrays_past_their_first_length(name, room, monkeypatch):
    """Frames whose arrays outgrow the first guess (or every array given
    no room at all): the C counts what each needs, the second call fits,
    and the fields equal the plain parse's."""
    blob = ROOMY[name]()
    calls = []
    host = tnative._kernels.host()

    class Counting:
        def zt_parse_frame(self, *args):
            calls.append(1)
            return host.zt_parse_frame(*args)

    monkeypatch.setattr(tnative._kernels, "host", lambda: Counting())
    if room == "none":
        monkeypatch.setattr(tnative, "_parse_room", lambda m: dict(
            lanes=0, tables=0, segs=0, host_len=0, seqs=0))
    got = tdec._parse_frame(blob, 0, 31)
    assert _fields(got) == _fields(tdec._parse_frame_plain(blob, 0, 31))
    for a in (got.ll, got.ml, got.off):
        assert a.dtype == np.int64
    short = room == "none" or name in ("many_sequences", "rle_blocks")
    assert len(calls) == 1 + short
