"""LZ4 frame format support for the CLI's --format=lz4 passthrough.

Copy of zstd_tpu/lz4frame.py over the port's copy of native/lz4.c
(csrc/host/lz4.c: the block codec and XXH32). Role of zstd's
programs/fileio.c:1213-1445 (LZ4F glue), which compresses and decompresses
.lz4 files when built with liblz4; here the block codec is bundled and the
frame format (lz4_Frame_format.md v1.6.x) is written out, so the format
has no system dependency.

Frame layout: magic 0x184D2204 LE | FLG | BD | [content size 8B] |
HC (xxh32(descriptor)>>8 & 0xFF) | blocks (4B LE size, high bit set =
stored/uncompressed) | end mark (4 zero bytes) | [content xxh32].
"""

from __future__ import annotations

import numpy as np

from . import native
from .errors import Corruption

LZ4_MAGIC = 0x184D2204
_BLOCK_MAX = {4: 65536, 5: 262144, 6: 1048576, 7: 4194304}


def is_lz4_frame(data: bytes) -> bool:
    return len(data) >= 4 and int.from_bytes(data[:4], "little") == LZ4_MAGIC


def compress_lz4(data: bytes, block_max_code: int = 6,
                 content_checksum: bool = True) -> bytes:
    """One LZ4 frame: independent blocks, content size + checksum
    (matching the reference CLI's defaults for --format=lz4)."""
    bsz = _BLOCK_MAX[block_max_code]
    out = bytearray(LZ4_MAGIC.to_bytes(4, "little"))
    # FLG: version 01, block independence, content size, content checksum
    flg = (1 << 6) | (1 << 5) | (1 << 3) | ((1 << 2) if content_checksum
                                            else 0)
    bd = block_max_code << 4
    desc = bytes([flg, bd]) + len(data).to_bytes(8, "little")
    out += desc
    out += bytes([(native.xxh32(desc) >> 8) & 0xFF])
    for i in range(0, len(data), bsz):
        blk = data[i : i + bsz]
        comp = native.lz4_block_compress(blk)
        if comp is not None and len(comp) < len(blk):
            out += len(comp).to_bytes(4, "little")
            out += comp
        else:
            out += (len(blk) | 0x80000000).to_bytes(4, "little")
            out += blk
    out += (0).to_bytes(4, "little")          # end mark
    if content_checksum:
        out += native.xxh32(data).to_bytes(4, "little")
    return bytes(out)


def decompress_lz4(data: bytes, pos: int = 0) -> tuple[bytes, int]:
    """Decode one LZ4 frame at `pos`; returns (content, next_pos)."""
    if int.from_bytes(data[pos : pos + 4], "little") != LZ4_MAGIC:
        raise Corruption("not an lz4 frame")
    p = pos + 4
    if p + 3 > len(data):
        raise Corruption("lz4 frame header truncated")
    flg = data[p]
    bd = data[p + 1]
    if (flg >> 6) != 1:
        raise Corruption(f"lz4 frame version {flg >> 6} unsupported")
    has_bchk = bool(flg & (1 << 4))
    has_csize = bool(flg & (1 << 3))
    has_cchk = bool(flg & (1 << 2))
    has_dict = bool(flg & 1)
    bmax_code = (bd >> 4) & 7
    if bmax_code not in _BLOCK_MAX:
        raise Corruption("lz4 frame: invalid block max size")
    bmax = _BLOCK_MAX[bmax_code]
    desc_len = 2 + (8 if has_csize else 0) + (4 if has_dict else 0)
    desc = data[p : p + desc_len]
    if p + desc_len + 1 > len(data):
        raise Corruption("lz4 frame header truncated")
    hc = data[p + desc_len]
    if ((native.xxh32(desc) >> 8) & 0xFF) != hc:
        raise Corruption("lz4 frame header checksum mismatch")
    csize = (int.from_bytes(data[p + 2 : p + 10], "little")
             if has_csize else None)
    p += desc_len + 1
    # one contiguous output buffer: earlier bytes are match history, so
    # block-LINKED frames (liblz4's default) decode the same way as
    # block-independent ones
    cap = csize if csize is not None else max(4 * bmax, 1 << 20)
    buf = np.empty(max(cap, bmax), dtype=np.uint8)
    total = 0
    while True:
        if p + 4 > len(data):
            raise Corruption("lz4 frame truncated (no end mark)")
        bword = int.from_bytes(data[p : p + 4], "little")
        p += 4
        if bword == 0:
            break
        stored = bool(bword & 0x80000000)
        blen = bword & 0x7FFFFFFF
        if p + blen > len(data):
            raise Corruption("lz4 block truncated")
        blk = data[p : p + blen]
        p += blen
        if has_bchk:
            if p + 4 > len(data):
                raise Corruption("lz4 block checksum truncated")
            stored_sum = int.from_bytes(data[p : p + 4], "little")
            if stored_sum != native.xxh32(blk):
                raise Corruption("lz4 block checksum mismatch")
            p += 4
        need = total + (blen if stored else bmax)
        if need > len(buf):
            grown = np.empty(max(2 * len(buf), need), dtype=np.uint8)
            grown[:total] = buf[:total]
            buf = grown
        if stored:
            buf[total : total + blen] = np.frombuffer(blk, np.uint8)
            total += blen
        else:
            r = native.lz4_block_decompress(blk, len(buf), out=buf,
                                         start=total)
            if r is None:
                raise Corruption("lz4 block decode failed")
            total += r
    content = buf[:total].tobytes()
    if has_cchk:
        if p + 4 > len(data):
            raise Corruption("lz4 content checksum truncated")
        stored_sum = int.from_bytes(data[p : p + 4], "little")
        if stored_sum != native.xxh32(content):
            raise Corruption("lz4 content checksum mismatch")
        p += 4
    if csize is not None and csize != len(content):
        raise Corruption("lz4 content size mismatch")
    return content, p
