"""Literals-section decisions used by the device pipeline's host planning.

Copy of zstd_tpu/format/literals.py's repeat modes and gates (zstd's
lib/compress/zstd_compress_literals.c ZSTD_compressLiterals minGain gate,
lib/compress/zstd_compress_internal.h ZSTD_minLiteralsToCompress).
"""

from __future__ import annotations


class HufRepeat:
    NONE = 0
    CHECK = 1
    VALID = 2


def _min_gain(src_size: int, strategy: int) -> int:
    minlog = strategy - 1 if strategy >= 8 else 6
    return (src_size >> minlog) + 2


def _min_literals_to_compress(strategy: int, repeat: int) -> int:
    shift = min(9 - strategy, 3)
    return 6 if repeat == HufRepeat.VALID else 8 << shift
