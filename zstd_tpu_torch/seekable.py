"""Seekable format: random-access decompression via a seek table.

Copy of zstd_tpu/seekable.py over the port's host codec. Format parity:
zstd's contrib/seekable_format (spec in
zstd_seekable_compression_format.md): frames of bounded content size,
followed by a skippable frame (magic 0x184D2A5E) holding the seek table:
per-frame (compressed_size u32, decompressed_size u32[, checksum u32]) entries
+ 9-byte footer (num_frames u32, descriptor u8, magic 0x8F92EAB1).

Every frame is independent, so any subrange decodes alone. One change
from zstd_tpu: a frame_size below 1 raises ValueError wherever zstd_tpu's
loop would never advance and append empty frames for ever, which is every
input but empty data at frame_size 0 (one empty frame in both).
"""

from __future__ import annotations

import dataclasses

from .errors import Corruption, ZstdError, ZstdErrorCode
from .format.codec import compress as _compress, decompress as _decompress
from .xxhash64 import xxh64

SEEKABLE_MAGIC = 0x8F92EAB1
SEEK_TABLE_SKIPPABLE_MAGIC = 0x184D2A5E
MAX_FRAME_SIZE_DEFAULT = 1 << 20


def seekable_compress(data: bytes, level: int = 3,
                      frame_size: int = MAX_FRAME_SIZE_DEFAULT,
                      checksum: bool = True) -> bytes:
    if frame_size < 0 or (frame_size == 0 and data):
        raise ValueError(f"seekable: frame_size must be at least 1, "
                         f"not {frame_size}")
    out = bytearray()
    entries = []
    pos = 0
    while pos < len(data) or not entries:
        chunk = data[pos : pos + frame_size]
        blob = _compress(chunk, level=level)
        out += blob
        cs = (xxh64(chunk) & 0xFFFFFFFF) if checksum else 0
        entries.append((len(blob), len(chunk), cs))
        pos += frame_size
        if pos >= len(data):
            break
    # seek table skippable frame
    entry_size = 12 if checksum else 8
    payload = bytearray()
    for c_size, d_size, cs in entries:
        payload += c_size.to_bytes(4, "little")
        payload += d_size.to_bytes(4, "little")
        if checksum:
            payload += cs.to_bytes(4, "little")
    payload += len(entries).to_bytes(4, "little")
    payload += bytes([0x80 if checksum else 0x00])  # seek table descriptor
    payload += SEEKABLE_MAGIC.to_bytes(4, "little")
    out += SEEK_TABLE_SKIPPABLE_MAGIC.to_bytes(4, "little")
    out += len(payload).to_bytes(4, "little")
    out += payload
    return bytes(out)


@dataclasses.dataclass
class SeekTable:
    entries: list[tuple[int, int, int]]  # (c_size, d_size, checksum)
    frame_offsets: list[int]             # compressed offset of each frame
    content_offsets: list[int]           # decompressed offset of each frame

    @property
    def content_size(self) -> int:
        return self.content_offsets[-1]


def read_seek_table(data: bytes) -> SeekTable:
    if len(data) < 17:
        raise Corruption("seekable: too small")
    if int.from_bytes(data[-4:], "little") != SEEKABLE_MAGIC:
        raise ZstdError(ZstdErrorCode.prefix_unknown, "no seekable footer")
    desc = data[-5]
    with_checksum = bool(desc & 0x80)
    if desc & 0x7C:
        raise Corruption("seekable: reserved descriptor bits set")
    num_frames = int.from_bytes(data[-9:-5], "little")
    entry_size = 12 if with_checksum else 8
    table_len = num_frames * entry_size + 9
    start = len(data) - 8 - table_len
    if start < 0:
        raise Corruption("seekable: table larger than file")
    magic = int.from_bytes(data[start : start + 4], "little")
    if magic != SEEK_TABLE_SKIPPABLE_MAGIC:
        raise Corruption("seekable: bad skippable magic")
    entries = []
    p = start + 8
    for _ in range(num_frames):
        c_size = int.from_bytes(data[p : p + 4], "little")
        d_size = int.from_bytes(data[p + 4 : p + 8], "little")
        cs = int.from_bytes(data[p + 8 : p + 12], "little") if with_checksum else 0
        entries.append((c_size, d_size, cs))
        p += entry_size
    frame_offsets = [0]
    content_offsets = [0]
    for c_size, d_size, _ in entries:
        frame_offsets.append(frame_offsets[-1] + c_size)
        content_offsets.append(content_offsets[-1] + d_size)
    return SeekTable(entries, frame_offsets, content_offsets)


def seekable_decompress(data: bytes, offset: int = 0,
                        length: int | None = None,
                        verify_checksum: bool = True) -> bytes:
    """Decompress [offset, offset+length) touching only the needed frames."""
    st = read_seek_table(data)
    total = st.content_size
    if length is None:
        length = total - offset
    end = min(offset + length, total)
    if offset < 0 or offset > total:
        raise ZstdError(ZstdErrorCode.parameter_outOfBound, "offset out of range")
    out = bytearray()
    import bisect
    fi = max(bisect.bisect_right(st.content_offsets, offset) - 1, 0)
    while fi < len(st.entries) and st.content_offsets[fi] < end:
        c_size, d_size, cs = st.entries[fi]
        fo = st.frame_offsets[fi]
        content = _decompress(data[fo : fo + c_size])
        if len(content) != d_size:
            raise Corruption("seekable: frame size mismatch")
        if verify_checksum and cs:
            if (xxh64(content) & 0xFFFFFFFF) != cs:
                raise ZstdError(ZstdErrorCode.checksum_wrong,
                                f"seekable frame {fi} checksum mismatch")
        lo = max(offset - st.content_offsets[fi], 0)
        hi = min(end - st.content_offsets[fi], d_size)
        out += content[lo:hi]
        fi += 1
    return bytes(out)
