"""Frame headers, the host frame encoder of the long-distance path, the
host frame decoder and skippable frames.

Copy of write_frame_header, FrameHeader, parse_frame_header, is_skippable,
the Python branches of _split_points and decompress_frame, and of
compress_frame's per-block loop in zstd_tpu/format/frame.py (zstd's
lib/compress/zstd_compress.c ZSTD_writeFrameHeader:4626 and
ZSTD_compress_frameChunk:4527, lib/decompress/zstd_decompress.c
ZSTD_getFrameHeader_advanced:447 and ZSTD_decompressFrame:951).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (BLOCK_HEADER_SIZE, BLOCK_MAX_SIZE, BT_RAW,
                         BT_RESERVED, BT_RLE, SKIPPABLE_MAGIC_MAX,
                         SKIPPABLE_MAGIC_MIN, WINDOWLOG_LIMIT_DEFAULT,
                         ZSTD_MAGIC)
from ..errors import Corruption, ZstdError, ZstdErrorCode
from ..xxhash64 import content_checksum
from .block import BlockCState, BlockDState, compress_block, decompress_block


@dataclasses.dataclass
class FrameHeader:
    window_size: int
    frame_content_size: int | None
    dict_id: int
    checksum_flag: bool
    single_segment: bool
    header_size: int


def write_frame_header(src_size: int, window_log: int, checksum: bool,
                       content_size_flag: bool = True, dict_id: int = 0,
                       window_must_cover: int | None = None) -> bytes:
    """ZSTD_writeFrameHeader. src_size is the pledged content size (>= 0).

    window_must_cover: minimum window the DECODER must end up with (e.g.
    prefix + content for --patch-from frames). Single-segment mode sets
    the decoder's window to the content size, which would strand matches
    reaching into the prefix — so it is only taken when the content size
    alone covers the requirement."""
    window_size = 1 << window_log
    need = max(src_size, window_must_cover or 0)
    single_segment = (content_size_flag and window_size >= src_size
                      and src_size >= need)
    if content_size_flag:
        fcs_code = (src_size >= 256) + (src_size >= 65536 + 256) + (src_size > 0xFFFFFFFF)
    else:
        fcs_code = 0
    if dict_id == 0:
        did_code = 0
    elif dict_id < 256:
        did_code = 1
    elif dict_id < 65536:
        did_code = 2
    else:
        did_code = 3
    fhd = did_code + (int(checksum) << 2) + (int(single_segment) << 5) + (fcs_code << 6)
    out = bytearray(ZSTD_MAGIC.to_bytes(4, "little"))
    out.append(fhd)
    if not single_segment:
        out.append((window_log - 10) << 3)  # exponent only; mantissa 0
    if did_code == 1:
        out += dict_id.to_bytes(1, "little")
    elif did_code == 2:
        out += dict_id.to_bytes(2, "little")
    elif did_code == 3:
        out += dict_id.to_bytes(4, "little")
    if fcs_code == 0:
        if single_segment:
            out.append(src_size)
    elif fcs_code == 1:
        out += (src_size - 256).to_bytes(2, "little")
    elif fcs_code == 2:
        out += src_size.to_bytes(4, "little")
    else:
        out += src_size.to_bytes(8, "little")
    return bytes(out)


def _split_points(full: np.ndarray, bs: int, be: int) -> list[int]:
    """Entropy-divergence pre-split inside one block (ZSTD_splitBlock /
    zstd_preSplit.c fingerprint-divergence analog, vectorized): compare each
    4 KiB chunk's coarse byte histogram against the running segment
    histogram and cut where the L1 divergence passes 0.35, no segment
    under 16 KiB. Returns interior split offsets."""
    chunk, min_seg, threshold = 4096, 16384, 0.35
    n = be - bs
    if n < 2 * min_seg:
        return []
    nch = n // chunk
    if nch < 2:
        return []
    v = (full[bs : bs + nch * chunk] >> 2).reshape(nch, chunk)
    # one bincount over (chunk_id << 6 | bucket) does all chunks at once
    idx = (np.arange(nch, dtype=np.int64)[:, None] << 6) | v.astype(np.int64)
    hists = np.bincount(idx.ravel(), minlength=nch * 64).reshape(nch, 64)
    splits = []
    seg_hist = hists[0].astype(np.float64)
    seg_n = 1
    for c in range(1, nch):
        ref = seg_hist / (seg_n * chunk)
        cur = hists[c] / chunk
        div = float(np.abs(ref - cur).sum()) / 2.0
        off = c * chunk
        if div > threshold and off >= min_seg and n - off >= min_seg:
            splits.append(bs + off)
            seg_hist = hists[c].astype(np.float64)
            seg_n = 1
        else:
            seg_hist += hists[c]
            seg_n += 1
    return splits


def compress_frame(data: bytes, cparams, checksum: bool = False,
                   ldm_state=None) -> bytes:
    """One full zstd frame through the long-distance matcher `ldm_state` (a
    parallel/ldm_sharded.ShardedLdmState or a format/ldm.LdmState): the
    per-block loop of zstd_tpu's compress_frame (ZSTD_compressContinue_internal
    driver shape) with its content-divergence pre-split, for no prefix and no
    target block size. Strategies 5 and up (seqstore splitting) raise."""
    if ldm_state is None:
        raise ValueError("the port's host frame encoder is the long-distance "
                         "path's: pass an ldm_state")
    if cparams.strategy >= 5:
        raise ValueError(f"strategy {cparams.strategy}: the port's host frame "
                         f"encoder has no seqstore splitting (strategy < 5)")
    n = len(data)
    window_log = cparams.window_log
    out = bytearray(write_frame_header(n, window_log, checksum))

    if n == 0:
        out += (1 | (BT_RAW << 1) | (0 << 3)).to_bytes(3, "little")
        if checksum:
            out += content_checksum(b"").to_bytes(4, "little")
        return bytes(out)

    full = np.frombuffer(data, dtype=np.uint8)
    window_size = 1 << window_log
    block_size = min(window_size, BLOCK_MAX_SIZE)
    state = BlockCState()
    pos = 0
    while pos < n:
        end = min(pos + block_size, n)
        if end - pos >= 32768:
            # content-divergence pre-split (zstd_preSplit.c analog): phase-
            # shifts the block grid onto content transitions
            pts = _split_points(full, pos, end)
            if pts:
                end = pts[0]
        last = end == n
        # window floor from the region END, not its start (the reference's
        # ZSTD_window_enforceMaxDist role; zstd_tpu cuts regions into pieces
        # at other levels, and keeps this floor for every level)
        window_low = max(0, end - window_size)
        payload, btype, state = compress_block(
            full, pos, end, window_low, state, cparams, ldm_state)
        if btype == BT_RLE:
            bh = int(last) | (BT_RLE << 1) | ((end - pos) << 3)
        else:
            bh = int(last) | (btype << 1) | (len(payload) << 3)
        out += bh.to_bytes(3, "little")
        out += payload
        pos = end
    if checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def parse_frame_header(data: bytes, window_log_max: int = WINDOWLOG_LIMIT_DEFAULT
                       ) -> FrameHeader:
    """ZSTD_getFrameHeader_advanced (zstd format only; caller strips magic)."""
    if len(data) < 5:
        raise ZstdError(ZstdErrorCode.srcSize_wrong, "input too small for frame header")
    magic = int.from_bytes(data[:4], "little")
    if magic != ZSTD_MAGIC:
        raise ZstdError(ZstdErrorCode.prefix_unknown, f"bad magic 0x{magic:08X}")
    fhd = data[4]
    did_code = fhd & 3
    checksum_flag = bool((fhd >> 2) & 1)
    single_segment = bool((fhd >> 5) & 1)
    fcs_code = fhd >> 6
    if (fhd >> 3) & 1:
        raise Corruption("reserved bit set in frame header")
    pos = 5
    if not single_segment:
        if len(data) < pos + 1:
            raise ZstdError(ZstdErrorCode.srcSize_wrong)
        wd = data[pos]
        pos += 1
        exponent = wd >> 3
        mantissa = wd & 7
        window_log = 10 + exponent
        window_size = (1 << window_log) + ((1 << window_log) // 8) * mantissa
        if window_log > window_log_max:
            raise ZstdError(ZstdErrorCode.frameParameter_windowTooLarge,
                            f"windowLog {window_log} > limit {window_log_max}")
    else:
        window_size = 0  # = frame content size, set below
    did_size = (0, 1, 2, 4)[did_code]
    if len(data) < pos + did_size:
        raise ZstdError(ZstdErrorCode.srcSize_wrong)
    dict_id = int.from_bytes(data[pos : pos + did_size], "little") if did_size else 0
    pos += did_size
    fcs_size = (1 if single_segment else 0, 2, 4, 8)[fcs_code]
    if len(data) < pos + fcs_size:
        raise ZstdError(ZstdErrorCode.srcSize_wrong)
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[pos : pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        pos += fcs_size
    if single_segment:
        window_size = fcs if fcs is not None else 0
    return FrameHeader(window_size, fcs, dict_id, checksum_flag,
                       single_segment, pos)


def decompress_frame(data: bytes, pos: int,
                     window_log_max: int = WINDOWLOG_LIMIT_DEFAULT
                     ) -> tuple[bytes, int]:
    """Decode one zstd frame starting at data[pos:]; returns (content, end)."""
    hdr = parse_frame_header(data[pos:], window_log_max)
    if hdr.dict_id:
        raise ZstdError(ZstdErrorCode.dictionary_wrong,
                        "frame requires a dictionary (unsupported here)")
    pos += hdr.header_size
    out = bytearray()
    state = BlockDState()
    block_max = min(hdr.window_size or BLOCK_MAX_SIZE, BLOCK_MAX_SIZE)
    if hdr.single_segment and hdr.frame_content_size is not None:
        block_max = min(max(hdr.frame_content_size, 1), BLOCK_MAX_SIZE)
    last = False
    while not last:
        if pos + BLOCK_HEADER_SIZE > len(data):
            raise ZstdError(ZstdErrorCode.srcSize_wrong, "truncated block header")
        bh = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        if btype == BT_RESERVED:
            raise Corruption("reserved block type")
        if btype == BT_RAW:
            if pos + bsize > len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong, "truncated raw block")
            out += data[pos : pos + bsize]
            pos += bsize
        elif btype == BT_RLE:
            if pos + 1 > len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong, "truncated RLE block")
            if bsize > block_max:
                raise Corruption("RLE block larger than maximum")
            out += data[pos : pos + 1] * bsize
            pos += 1
        else:
            if bsize > block_max or pos + bsize > len(data):
                raise (Corruption("compressed block larger than maximum")
                       if bsize > block_max else
                       ZstdError(ZstdErrorCode.srcSize_wrong, "truncated block"))
            window_low = max(0, len(out) - (hdr.window_size or (1 << 63)))
            state = decompress_block(data[pos : pos + bsize], out, window_low,
                                     state, block_max)
            pos += bsize
    if hdr.frame_content_size is not None and len(out) != hdr.frame_content_size:
        raise Corruption(
            f"content size mismatch: {len(out)} != {hdr.frame_content_size}")
    if hdr.checksum_flag:
        if pos + 4 > len(data):
            raise ZstdError(ZstdErrorCode.srcSize_wrong, "missing checksum")
        expect = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        got = content_checksum(bytes(out))
        if got != expect:
            raise ZstdError(ZstdErrorCode.checksum_wrong,
                            f"checksum 0x{got:08X} != 0x{expect:08X}")
    return bytes(out), pos


def is_skippable(data: bytes, pos: int) -> bool:
    if pos + 4 > len(data):
        return False
    magic = int.from_bytes(data[pos : pos + 4], "little")
    return SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX
