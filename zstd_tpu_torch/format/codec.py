"""Top-level one-shot host codec: multi-frame compress / decompress.

Copy of zstd_tpu/format/codec.py (zstd's ZSTD_compress,
lib/compress/zstd_compress.c:5423, and ZSTD_decompress,
lib/decompress/zstd_decompress.c:1201 -> ZSTD_decompressMultiFrame:1068;
compress_patch / decompress_patch, the --patch-from pair), with the
tracer's spans. compress runs the host encoder (format/frame.py over the C
of csrc/host); decompress runs format/frame.decompress_frame (the block
decoder of csrc/host/decode.c).
"""

from __future__ import annotations

import dataclasses

from .. import native
from ..constants import WINDOWLOG_LIMIT_DEFAULT
from ..errors import ZstdError, ZstdErrorCode
from ..params import get_cparams
from ..trace import GLOBAL_TRACER
from .frame import compress_frame, decompress_frame, is_skippable

# pre-1.0 formats (ZSTD_isLegacy analog, zstd's lib/legacy/zstd_legacy.h:56):
# detected and refused
_LEGACY_MAGICS = {0x1EB52FFD} | {0xFD2FB522 + i for i in range(6)}


def compress(data: bytes, level: int = 3, checksum: bool = False,
             window_log: int | None = None, long_mode: bool = False,
             target_cblock_size: int | None = None) -> bytes:
    """One-shot compression into a single zstd frame.

    long_mode: enable the long-distance matcher (--long analog); pair with
    an explicit window_log for windows beyond the level default.
    target_cblock_size: aim each emitted block's compressed size at this
    many bytes (ZSTD_c_targetCBlockSize / superblock analog) for
    low-latency streaming."""
    cparams = get_cparams(level, len(data))
    if window_log is not None:
        cparams = dataclasses.replace(cparams, window_log=window_log)
    with GLOBAL_TRACER.span("compress", level, cparams.window_log) as rec:
        out = compress_frame(data, cparams, checksum=checksum,
                             long_mode=long_mode,
                             target_cblock_size=target_cblock_size)
        # small-input seeding portfolio at the keep-min levels: the
        # first-block statistics seeding mode (sampled estimate vs full A/B
        # pass) is content-dependent and each wins on about half of small
        # inputs, which cost milliseconds, so encode BOTH and keep the
        # smaller frame; large inputs keep the default seeding
        if (cparams.strategy >= 6 and len(data) <= 262144
                and not long_mode and not target_cblock_size):
            try:
                native.opt_twopass(1)
                alt = compress_frame(data, cparams, checksum=checksum)
                if len(alt) < len(out):
                    out = alt
            finally:
                native.opt_twopass(-1)
        rec.src_size = len(data)
        rec.dst_size = len(out)
    return out


def compress_patch(data: bytes, patch: bytes, level: int = 3,
                   checksum: bool = False) -> bytes:
    """--patch-from analog: compress `data` as a delta against `patch`
    (ZSTD_CCtx_refPrefix semantics; the decoder needs the same patch)."""
    total = len(patch) + len(data)
    wlog = max(total - 1, 1).bit_length()
    wlog = min(max(wlog, 10), 30)
    cparams = dataclasses.replace(get_cparams(level, len(data)),
                                  window_log=wlog)
    return compress_frame(data, cparams, checksum=checksum, long_mode=True,
                          prefix=patch)


def decompress_patch(data: bytes, patch: bytes,
                     window_log_max: int = 31) -> bytes:
    """Decode frames produced with compress_patch / zstd --patch-from."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        if is_skippable(data, pos):
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            pos += 8 + size
            continue
        content, pos = decompress_frame(data, pos, window_log_max,
                                        prefix=patch)
        out += content
    return bytes(out)


def decompress(data: bytes,
               window_log_max: int = WINDOWLOG_LIMIT_DEFAULT) -> bytes:
    """One-shot decompression of all concatenated frames (incl. skippable)."""
    parts: list[bytes] = []
    pos = 0
    if len(data) == 0:
        raise ZstdError(ZstdErrorCode.srcSize_wrong, "empty input")
    while pos < len(data):
        if pos + 4 <= len(data) and \
                int.from_bytes(data[pos : pos + 4], "little") in _LEGACY_MAGICS:
            raise ZstdError(ZstdErrorCode.prefix_unknown,
                            "legacy zstd frame (v0.x): unsupported")
        if is_skippable(data, pos):
            if pos + 8 > len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong,
                                "truncated skippable frame")
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            if pos + 8 + size > len(data):
                raise ZstdError(ZstdErrorCode.srcSize_wrong,
                                "truncated skippable frame")
            pos += 8 + size
            continue
        with GLOBAL_TRACER.span("decompress") as rec:
            frame_start = pos
            content, pos = decompress_frame(data, pos, window_log_max)
            rec.src_size = pos - frame_start
            rec.dst_size = len(content)
        parts.append(content)
    # single-frame fast path: bytes.join returns the sole element uncopied
    return b"".join(parts)
