"""Streaming API: incremental compression/decompression over arbitrary
input slices.

Copy of zstd_tpu/streaming.py over the port's host codec (format/block.py)
and its streaming XXH64 (xxhash64.Xxh64, the C state). API parity:
ZSTD_compressStream2 / ZSTD_decompressStream (zstd's
lib/compress/zstd_compress.c:6365, lib/decompress/zstd_decompress.c:2084).
zstd drives a zcss_load/flush state machine over fixed buffers; here the
host accumulates whole 128 KiB blocks and flushes complete frames' worth of
block payloads, which yields identical frame structure for the
continue/end operating modes.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .constants import (BLOCK_MAX_SIZE, BT_COMPRESSED, BT_RAW, BT_RESERVED,
                        BT_RLE)
from .errors import Corruption, ZstdError, ZstdErrorCode
from .format.block import BlockCState, BlockDState, compress_block, decompress_block
from .format.frame import parse_frame_header, write_frame_header, is_skippable
from .params import get_cparams
from .xxhash64 import Xxh64


class EndDirective(enum.Enum):
    CONTINUE = 0
    FLUSH = 1
    END = 2


class CompressStream:
    """Incremental compressor producing one zstd frame (unknown content size).

    write(data) -> compressed bytes available so far; finish() -> final bytes.
    """

    def __init__(self, level: int = 3, checksum: bool = False,
                 window_log: int | None = None):
        self.cparams = get_cparams(level, -1)
        if window_log is not None:
            self.cparams = dataclasses.replace(self.cparams,
                                               window_log=window_log)
        self.checksum = checksum
        self.window_size = 1 << self.cparams.window_log
        self.block_size = min(self.window_size, BLOCK_MAX_SIZE)
        self._buf = bytearray()      # unconsumed input
        self._window = bytearray()   # retained history (window + current)
        self._state = BlockCState()
        self._started = False
        self._finished = False
        self._xxh = Xxh64(0) if checksum else None
        self._total_in = 0

    def _header(self) -> bytes:
        # unknown content size: no FCS, window descriptor present
        hdr = write_frame_header(0, self.cparams.window_log, self.checksum,
                                 content_size_flag=False)
        return hdr

    def write(self, data: bytes) -> bytes:
        if self._finished:
            raise ZstdError(ZstdErrorCode.stage_wrong, "stream already finished")
        out = bytearray()
        if not self._started:
            out += self._header()
            self._started = True
        self._buf += data
        self._total_in += len(data)
        if self._xxh is not None:
            self._xxh.update(data)
        while len(self._buf) >= self.block_size:
            out += self._emit_block(self.block_size, last=False)
        return bytes(out)

    def flush(self) -> bytes:
        """Emit all buffered input as (possibly short) non-final blocks."""
        out = bytearray()
        if not self._started:
            out += self._header()
            self._started = True
        while len(self._buf) >= self.block_size:
            out += self._emit_block(self.block_size, last=False)
        if self._buf:
            out += self._emit_block(len(self._buf), last=False)
        return bytes(out)

    def finish(self) -> bytes:
        if self._finished:
            return b""
        out = bytearray()
        if not self._started:
            out += self._header()
            self._started = True
        while len(self._buf) > self.block_size:
            out += self._emit_block(self.block_size, last=False)
        out += self._emit_block(len(self._buf), last=True)
        self._finished = True
        if self._xxh is not None:
            h = self._xxh.digest() & 0xFFFFFFFF
            out += h.to_bytes(4, "little")
        return bytes(out)

    def _emit_block(self, size: int, last: bool) -> bytes:
        chunk = bytes(self._buf[:size])
        del self._buf[:size]
        if size == 0:
            return (int(last) | (BT_RAW << 1)).to_bytes(3, "little")
        window_start_len = len(self._window)
        self._window += chunk
        full = np.frombuffer(bytes(self._window), dtype=np.uint8)
        block_start = window_start_len
        window_low = max(0, block_start + size - self.window_size)
        payload, btype, self._state = compress_block(
            full, block_start, block_start + size, window_low,
            self._state, self.cparams)
        # trim retained window
        keep = self.window_size
        if len(self._window) > 2 * keep:
            drop = len(self._window) - keep
            del self._window[:drop]
        if btype == BT_RLE:
            bh = int(last) | (BT_RLE << 1) | (size << 3)
        else:
            bh = int(last) | (btype << 1) | (len(payload) << 3)
        return bh.to_bytes(3, "little") + payload


class DecompressStream:
    """Incremental decompressor over arbitrary input slicing; handles
    multi-frame and skippable-frame streams (zdss_* stage analog)."""

    def __init__(self, window_log_max: int = 27):
        self.window_log_max = window_log_max
        self._in = bytearray()
        self._stage = "header"
        self._hdr = None
        self._out = bytearray()
        self._emitted = 0
        self._dstate = BlockDState()
        self._last_block_seen = False
        self._xxh = None

    def write(self, data: bytes) -> bytes:
        """Feed input, returns newly decompressed bytes."""
        self._in += data
        produced = bytearray()
        progress = True
        while progress:
            progress = False
            if self._stage == "header":
                if len(self._in) >= 8 and is_skippable(bytes(self._in[:8]), 0):
                    size = int.from_bytes(self._in[4:8], "little")
                    if len(self._in) >= 8 + size:
                        del self._in[: 8 + size]
                        progress = True
                    continue
                if len(self._in) < 4:
                    break
                try:
                    hdr = parse_frame_header(bytes(self._in), self.window_log_max)
                except ZstdError as e:
                    if e.code == ZstdErrorCode.srcSize_wrong:
                        break  # need more input
                    raise
                del self._in[: hdr.header_size]
                self._hdr = hdr
                self._dstate = BlockDState()
                self._frame_start = self._emitted + len(self._out)
                self._xxh = Xxh64(0) if hdr.checksum_flag else None
                self._stage = "blocks"
                progress = True
            elif self._stage == "blocks":
                if len(self._in) < 3:
                    break
                bh = int.from_bytes(self._in[:3], "little")
                last = bool(bh & 1)
                btype = (bh >> 1) & 3
                bsize = bh >> 3
                need = 3 + (1 if btype == 1 else bsize)
                if len(self._in) < need:
                    break
                pre = len(self._out)
                self._decode_block(btype, bsize, bytes(self._in[3:need]))
                if self._xxh is not None:
                    self._xxh.update(memoryview(self._out)[pre:])
                del self._in[:need]
                produced += self._drain()
                if last:
                    self._stage = "checksum" if self._hdr.checksum_flag else "header"
                progress = True
            elif self._stage == "checksum":
                if len(self._in) < 4:
                    break
                # Always verified, incrementally over emitted output: zstd
                # never skips this check
                # (lib/decompress/zstd_decompress.c:1047-1057).
                stored = int.from_bytes(self._in[:4], "little")
                calc = self._xxh.digest() & 0xFFFFFFFF
                if stored != calc:
                    raise ZstdError(ZstdErrorCode.checksum_wrong,
                                    f"content checksum {calc:#010x} != "
                                    f"stored {stored:#010x}")
                del self._in[:4]
                self._stage = "header"
                progress = True
        return bytes(produced)

    def _decode_block(self, btype, bsize, payload: bytes):
        if btype == BT_RESERVED:
            raise Corruption("reserved block type")
        block_max = min(self._hdr.window_size or BLOCK_MAX_SIZE, BLOCK_MAX_SIZE)
        if btype == BT_RAW:
            self._out += payload
        elif btype == BT_RLE:
            if bsize > block_max:
                raise Corruption("RLE block larger than maximum")
            self._out += payload[:1] * bsize
        else:
            if bsize > block_max:
                raise Corruption("block larger than maximum")
            window_low = max(0, len(self._out)
                             - (self._hdr.window_size or (1 << 62)))
            self._dstate = decompress_block(payload, self._out, window_low,
                                            self._dstate, block_max)

    def _drain(self) -> bytes:
        """Emit output beyond the retained window."""
        keep = (self._hdr.window_size if self._hdr else 0) or BLOCK_MAX_SIZE
        if len(self._out) > 2 * keep:
            cut = len(self._out) - keep
            chunk = bytes(self._out[:cut])
            del self._out[:cut]
            self._emitted += cut
            return chunk
        return b""

    def finish(self) -> bytes:
        if self._stage == "blocks":
            raise ZstdError(ZstdErrorCode.srcSize_wrong, "truncated frame")
        out = bytes(self._out)
        self._emitted += len(self._out)
        self._out = bytearray()
        return out
