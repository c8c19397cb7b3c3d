"""Frame headers, the host frame encoder, the host frame decoder and
skippable frames.

Copy of write_frame_header, FrameHeader, parse_frame_header, is_skippable,
_split_points, _finish_c_frame, compress_frame, decompress_frame and
_decompress_frame_native in zstd_tpu/format/frame.py (zstd's
lib/compress/zstd_compress.c ZSTD_writeFrameHeader:4626 and
ZSTD_compress_frameChunk:4527, lib/decompress/zstd_decompress.c
ZSTD_getFrameHeader_advanced:447 and ZSTD_decompressFrame:951), without a
window prefix (--patch-from), a target block size or an external sequence
producer. compress_frame runs the whole-frame C paths of csrc/host/cblock.c
where zstd_tpu does (ZSTD_TPU_HOST_PARSER and ZSTD_TPU_OPT_ITER at their
defaults), else the per-block loop. decompress_frame runs the port's copy
of native/decode.c (csrc/host/decode.c) as zstd_tpu's does, and its Python
block loop where that C declines; decompress_frame_plain is that Python
branch alone. _split_points takes the C of csrc/host/encode.c at its
default threshold, as zstd_tpu's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..constants import (BLOCK_HEADER_SIZE, BLOCK_MAX_SIZE, BT_COMPRESSED,
                         BT_RAW, BT_RESERVED, BT_RLE, SKIPPABLE_MAGIC_MAX,
                         SKIPPABLE_MAGIC_MIN, WINDOWLOG_LIMIT_DEFAULT,
                         ZSTD_MAGIC)
from ..errors import Corruption, ZstdError, ZstdErrorCode
from ..xxhash64 import content_checksum
from .block import (BlockCState, BlockDState, compress_block,
                    compress_block_pieces, decompress_block)
from .ldm import LdmState
from .opt import row_params


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


def _split_points(full: np.ndarray, bs: int, be: int,
                  threshold: float = 0.35) -> list[int]:
    """Entropy-divergence pre-split inside one block (ZSTD_splitBlock /
    zstd_preSplit.c fingerprint-divergence analog, vectorized): compare each
    4 KiB chunk's coarse byte histogram against the running segment
    histogram and cut where the L1 divergence passes `threshold`, no
    segment under 16 KiB. Returns interior split offsets."""
    chunk, min_seg = 4096, 16384
    if threshold != 0.35 or be - bs < 2 * min_seg:
        return _split_points_plain(full, bs, be, threshold)
    # the exact-integer C of the Python branch's loop
    return native.split_points(full, bs, be, chunk, min_seg)


def _split_points_plain(full: np.ndarray, bs: int, be: int,
                        threshold: float = 0.35) -> list[int]:
    """The Python branch of _split_points."""
    chunk, min_seg = 4096, 16384
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


def _finish_c_frame(out: bytearray, blocks: bytes, checksum: bool,
                    data: bytes) -> bytes:
    """Shared tail of the whole-frame C paths: append blocks + checksum."""
    out += blocks
    if checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def _c_frame(data: bytes, cparams) -> bytes | None:
    """The blocks of a whole-frame C path (csrc/host/cblock.c: parse,
    entropy and block emit of every block in one call, the shape of
    ZSTD_compress_frameChunk), or None where zstd_tpu takes none or the C
    declines."""
    n = len(data)
    full = np.frombuffer(data, dtype=np.uint8)
    window_size = 1 << cparams.window_log
    block_size = min(window_size, BLOCK_MAX_SIZE)
    strategy, search_log = cparams.strategy, cparams.search_log
    if strategy == 1:
        # fast path (levels 1-2 and --fast)
        step0 = max(1, -cparams.target_length
                    if cparams.target_length < 0
                    else cparams.target_length
                    if cparams.target_length > 0 else 1)
        table = np.full(2 << cparams.hash_log, -1, dtype=np.int32)
        return native.compress_fast_frame(
            full, 0, n, window_size, block_size, cparams.hash_log, 8,
            min(max(cparams.min_match, 4), 8), step0, strategy, table)
    blocks = None
    if strategy in (2, 3, 4, 5) and search_log <= 4:
        # row path (levels 3-9). Strategies 3-4 skip the Python route's
        # seqstore splitting; strategy 5 carries the in-C over-matching
        # detector, which aborts the C frame (None) on a word-salad-shaped
        # parse and reroutes it through the per-block loop
        row_log, width_log, mls, attempts, defer, hlog_long = \
            row_params(cparams)
        blocks = native.compress_row_frame(
            full, 0, n, window_size, block_size, strategy, row_log,
            width_log, mls, attempts, defer,
            np.full(1 << (row_log + width_log), -1, dtype=np.int32),
            np.zeros(1 << (row_log + width_log), dtype=np.uint8),
            np.zeros(1 << row_log, dtype=np.uint8),
            np.full(2 << hlog_long, -1, dtype=np.int32), hlog_long)
    if blocks is None and strategy in (5, 6, 7) and search_log >= 5:
        # shallow-DP path (levels 10-15 class; the keep-min levels stay on
        # the exact per-block sizing), with find_sequences_shallow_dp's /
        # find_sequences_opt's ladder floors
        if strategy == 5:
            dp_sl = min(max(search_log - 1, 3), 5)
            dp_hl = cparams.hash_log
            dp_tl = 32
        elif n >= (1 << 21):
            dp_sl = max(search_log, 5)
            dp_hl = max(cparams.hash_log, min(22, cparams.hash_log + 3))
            dp_tl = cparams.target_length
        elif n <= 262144:
            dp_sl = max(search_log, 11)
            dp_hl = cparams.hash_log
            dp_tl = max(cparams.target_length, 999)
        else:
            dp_sl = max(search_log, 8 if strategy >= 6 else 5)
            dp_hl = cparams.hash_log
            dp_tl = max(cparams.target_length, 256)
        blocks = native.compress_dp_frame(
            full, 0, n, window_size, block_size,
            8 if strategy == 5 else strategy, dp_hl, dp_sl,
            min(max(cparams.min_match, 4), 6), dp_tl)
    return blocks


def compress_frame(data: bytes, cparams, checksum: bool = False,
                   long_mode: bool = False, ldm_state=None) -> bytes:
    """One full zstd frame (the shape of ZSTD_compressContinue_internal).

    long_mode: long-distance matching through the host LdmState.
    ldm_state: a pre-built long-distance matcher state (the sharded
    parallel/ldm_sharded.ShardedLdmState) instead of the host LdmState;
    implies long matching."""
    n = len(data)
    window_log = cparams.window_log
    out = bytearray(write_frame_header(n, window_log, checksum))

    if n == 0:
        out += (1 | (BT_RAW << 1) | (0 << 3)).to_bytes(3, "little")
        if checksum:
            out += content_checksum(b"").to_bytes(4, "little")
        return bytes(out)

    if not long_mode and ldm_state is None and n >= 128:
        blocks = _c_frame(data, cparams)
        if blocks is not None:
            return _finish_c_frame(out, blocks, checksum, data)

    full = np.frombuffer(data, dtype=np.uint8)
    window_size = 1 << window_log
    block_size = min(window_size, BLOCK_MAX_SIZE)
    state = BlockCState()
    ldm_ctx = ldm_state
    if long_mode and ldm_ctx is None:
        ldm_ctx = LdmState(full, window_log)
    # cost-driven seqstore splitting at the slow-strategy levels
    # (ZSTD_deriveBlockSplits analog, format/split.py); the cheap
    # histogram-divergence pre-split (_split_points, zstd_preSplit.c analog)
    # applies at every level
    split_full = cparams.strategy >= 5
    pos = 0
    while pos < n:
        end = min(pos + block_size, n)
        if end - pos >= 32768:
            # content-divergence pre-split: phase-shifts the block grid onto
            # content transitions. Slow levels demand a stronger divergence:
            # their seqstore splitter already handles mild mixtures exactly
            pts = _split_points(full, pos, end,
                                threshold=0.45 if split_full else 0.35)
            if pts:
                end = pts[0]
        last_region = end == n
        # window floor from the region END, not its start: regions may be
        # re-cut into several emitted blocks (compress_block_pieces), and
        # the decoder enforces out_len - window at each EMITTED block's
        # start; anchoring at `end` makes every piece cut window-safe (the
        # reference's ZSTD_window_enforceMaxDist role)
        window_low = max(0, end - window_size)
        if split_full:
            pieces, state = compress_block_pieces(
                full, pos, end, window_low, state, cparams, ldm_ctx=ldm_ctx)
        else:
            payload, btype, state = compress_block(
                full, pos, end, window_low, state, cparams, ldm_ctx=ldm_ctx)
            pieces = [(payload, btype, end - pos)]
        for pi, (payload, btype, clen) in enumerate(pieces):
            last = last_region and pi == len(pieces) - 1
            if btype == BT_RLE:
                bh = int(last) | (BT_RLE << 1) | (clen << 3)
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


def _frame_start(data: bytes, pos: int, window_log_max: int
                 ) -> tuple[FrameHeader, int]:
    hdr = parse_frame_header(data[pos:], window_log_max)
    if hdr.dict_id:
        raise ZstdError(ZstdErrorCode.dictionary_wrong,
                        "frame requires a dictionary (unsupported here)")
    return hdr, pos + hdr.header_size


def _decompress_frame_native(data: bytes, pos: int, hdr: FrameHeader):
    """The block decoder in C over a preallocated window buffer. Returns
    (content, end_pos), or None where zstd_tpu hands the frame to its Python
    decoder: a window above 2^27 with no content size, or any block the C
    declines."""
    window = hdr.window_size or BLOCK_MAX_SIZE
    if hdr.frame_content_size is not None:
        buf = np.empty(hdr.frame_content_size + BLOCK_MAX_SIZE,
                       dtype=np.uint8)
    else:
        # unknown content size: a ring buffer that flushes what falls out of
        # the window. A window beyond the ring's capacity would leave the
        # flush less than the window (no forward progress), so such frames
        # go to the fully buffered Python decoder
        if window > (1 << 27):
            return None
        buf = np.empty(2 * window + 2 * BLOCK_MAX_SIZE, dtype=np.uint8)
    flushed: list[bytes] = []
    block_max = min(window, BLOCK_MAX_SIZE)
    if hdr.single_segment and hdr.frame_content_size is not None:
        block_max = min(max(hdr.frame_content_size, 1), BLOCK_MAX_SIZE)

    def checked(content: bytes, pos: int):
        if hdr.checksum_flag:
            if pos + 4 > len(data):
                return None
            expect = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
            if content_checksum(content) != expect:
                raise ZstdError(ZstdErrorCode.checksum_wrong,
                                "content checksum mismatch")
        return content, pos

    ctx = native.dctx_new()
    try:
        if hdr.frame_content_size is not None:
            # the whole frame in C: block headers and dispatch too
            res = native.decompress_blocks(
                ctx, data, pos, buf, 0, hdr.window_size or (1 << 62),
                block_max)
            if res is None or res[0] != hdr.frame_content_size:
                return None
            return checked(buf[:res[0]].tobytes(), pos + res[1])
        out_pos = 0
        last = False
        while not last:
            if out_pos + BLOCK_MAX_SIZE > len(buf):
                keep = min(window, out_pos)
                cut = out_pos - keep
                flushed.append(buf[:cut].tobytes())
                buf[:keep] = buf[cut:out_pos]
                out_pos = keep
            if pos + BLOCK_HEADER_SIZE > len(data):
                return None
            bh = int.from_bytes(data[pos : pos + 3], "little")
            pos += 3
            last = bool(bh & 1)
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if btype == BT_RAW:
                # bsize > block_max is corruption (ZSTD_getcBlockSize): both
                # decoders are equally strict
                if pos + bsize > len(data) or out_pos + bsize > len(buf) \
                        or bsize > block_max:
                    return None
                buf[out_pos : out_pos + bsize] = np.frombuffer(
                    data[pos : pos + bsize], dtype=np.uint8)
                out_pos += bsize
                pos += bsize
            elif btype == BT_RLE:
                if pos + 1 > len(data) or bsize > block_max or \
                        out_pos + bsize > len(buf):
                    return None
                buf[out_pos : out_pos + bsize] = data[pos]
                out_pos += bsize
                pos += 1
            elif btype == BT_COMPRESSED:
                if bsize > block_max or pos + bsize > len(data):
                    return None
                window_low = max(0, out_pos - (hdr.window_size or (1 << 62)))
                r = native.decompress_block(ctx, data[pos : pos + bsize], buf,
                                            out_pos, window_low, block_max)
                if r < 0:
                    return None
                out_pos += r
                pos += bsize
            else:
                return None
        return checked(b"".join(flushed) + buf[:out_pos].tobytes(), pos)
    finally:
        native.dctx_free(ctx)


def decompress_frame(data: bytes, pos: int,
                     window_log_max: int = WINDOWLOG_LIMIT_DEFAULT
                     ) -> tuple[bytes, int]:
    """Decode one zstd frame starting at data[pos:]; returns (content, end)."""
    hdr, pos = _frame_start(data, pos, window_log_max)
    fast = _decompress_frame_native(data, pos, hdr)
    if fast is not None:
        return fast
    return _decompress_blocks(data, pos, hdr)


def decompress_frame_plain(data: bytes, pos: int,
                           window_log_max: int = WINDOWLOG_LIMIT_DEFAULT
                           ) -> tuple[bytes, int]:
    """The Python branch of decompress_frame."""
    hdr, pos = _frame_start(data, pos, window_log_max)
    return _decompress_blocks(data, pos, hdr)


def _decompress_blocks(data: bytes, pos: int,
                       hdr: FrameHeader) -> tuple[bytes, int]:
    """The Python block loop of decompress_frame, from the first block."""
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
