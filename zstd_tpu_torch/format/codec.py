"""Top-level one-shot host codec: multi-frame compress / decompress.

Copy of compress and decompress in zstd_tpu/format/codec.py (zstd's
ZSTD_compress, lib/compress/zstd_compress.c:5423, and ZSTD_decompress,
lib/decompress/zstd_decompress.c:1201 -> ZSTD_decompressMultiFrame:1068),
without a target block size or the tracer. compress runs the host encoder
(format/frame.py over the C of csrc/host); decompress runs
format/frame.decompress_frame (the block decoder of csrc/host/decode.c).
"""

from __future__ import annotations

import dataclasses

from .. import native
from ..constants import WINDOWLOG_LIMIT_DEFAULT
from ..errors import ZstdError, ZstdErrorCode
from ..params import get_cparams
from .frame import compress_frame, decompress_frame, is_skippable

# pre-1.0 formats (ZSTD_isLegacy analog, zstd's lib/legacy/zstd_legacy.h:56):
# detected and refused
_LEGACY_MAGICS = {0x1EB52FFD} | {0xFD2FB522 + i for i in range(6)}


def compress(data: bytes, level: int = 3, checksum: bool = False,
             window_log: int | None = None, long_mode: bool = False) -> bytes:
    """One-shot compression into a single zstd frame.

    long_mode: enable the long-distance matcher (--long analog); pair with
    an explicit window_log for windows beyond the level default."""
    cparams = get_cparams(level, len(data))
    if window_log is not None:
        cparams = dataclasses.replace(cparams, window_log=window_log)
    out = compress_frame(data, cparams, checksum=checksum,
                         long_mode=long_mode)
    # small-input seeding portfolio at the keep-min levels: the first-block
    # statistics seeding mode (sampled estimate vs full A/B pass) is
    # content-dependent and each wins on about half of small inputs, which
    # cost milliseconds, so encode BOTH and keep the smaller frame; large
    # inputs keep the default seeding
    if cparams.strategy >= 6 and len(data) <= 262144 and not long_mode:
        try:
            native.opt_twopass(1)
            alt = compress_frame(data, cparams, checksum=checksum)
            if len(alt) < len(out):
                out = alt
        finally:
            native.opt_twopass(-1)
    return out


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
        content, pos = decompress_frame(data, pos, window_log_max)
        parts.append(content)
    # single-frame fast path: bytes.join returns the sole element uncopied
    return b"".join(parts)
