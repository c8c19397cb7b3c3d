"""Zstandard format constants (RFC 8878).

Copy of zstd_tpu/constants.py: derived from the public format specification
(zstd's doc/zstd_compression_format.md) and mirrored against the reference
implementation's internal constants (lib/common/zstd_internal.h).
"""

from __future__ import annotations

import numpy as np

# --- Frame-level magic numbers ------------------------------------------------
ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F
DICT_MAGIC = 0xEC30A437

BLOCK_HEADER_SIZE = 3
BLOCK_MAX_SIZE = 128 * 1024  # 128 KiB hard cap per block (spec: Block_Maximum_Size)
MIN_MATCH = 3
MAX_MATCH = 131074  # ML code 52 baseline 65539 + 16 bits

# Window log bounds (zstd.h: ZSTD_WINDOWLOG_MIN/MAX, LIMIT_DEFAULT)
WINDOWLOG_MIN = 10
WINDOWLOG_MAX = 31
WINDOWLOG_LIMIT_DEFAULT = 27

# Block types (spec: Block_Type)
BT_RAW = 0
BT_RLE = 1
BT_COMPRESSED = 2
BT_RESERVED = 3

# Literals block types (spec: Literals_Block_Type)
LBT_RAW = 0
LBT_RLE = 1
LBT_COMPRESSED = 2
LBT_TREELESS = 3

# Sequence symbol compression modes (spec: Compression_Mode)
MODE_PREDEFINED = 0
MODE_RLE = 1
MODE_FSE = 2
MODE_REPEAT = 3

# FSE bounds (lib/common/fse.h FSE_MIN/MAX_TABLELOG; spec caps per table)
FSE_MIN_TABLELOG = 5
FSE_MAX_TABLELOG = 15
FSE_DEFAULT_TABLELOG = 11

LL_FSE_LOG = 9   # max accuracy for literal-length table (spec)
OF_FSE_LOG = 8   # max accuracy for offset table (spec)
ML_FSE_LOG = 9   # max accuracy for match-length table (spec)
LL_DEFAULT_LOG = 6
OF_DEFAULT_LOG = 5
ML_DEFAULT_LOG = 6

MAX_LL_CODE = 35
MAX_ML_CODE = 52
MAX_OFF_CODE = 31  # reference decoder supports up to 31

# Huffman (spec: max code length 11 bits; weights FSE max accuracy 6)
HUF_MAX_BITS = 11
HUF_WEIGHT_FSE_LOG_MAX = 6
HUF_SYMBOLVALUE_MAX = 255

# Repcode initial history (spec: Repeat Offsets)
REPCODE_INIT = (1, 4, 8)

# --- Literals-length code tables (spec tables; 36 codes) -----------------------
LL_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16], dtype=np.int32)
LL_BASE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
     8192, 16384, 32768, 65536], dtype=np.int64)

# --- Match-length code tables (53 codes); value = baseline + readBits ----------
ML_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
     12, 13, 14, 15, 16], dtype=np.int32)
ML_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
     19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
     35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
     4099, 8195, 16387, 32771, 65539], dtype=np.int64)

# --- Predefined FSE distributions (spec: Default Distributions) -----------------
LL_DEFAULT_DIST = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
     -1, -1, -1, -1], dtype=np.int16)
ML_DEFAULT_DIST = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
     -1, -1, -1, -1, -1], dtype=np.int16)
OF_DEFAULT_DIST = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], dtype=np.int16)


def highbit32(v: int) -> int:
    """Index of the highest set bit (ZSTD_highbit32 semantics, v > 0)."""
    assert v > 0
    return v.bit_length() - 1


def ll_code(litlen: int) -> int:
    """Literal-length value -> LL code (zstd_compress_internal.h ZSTD_LLcode)."""
    LL_DELTA_CODE = 19
    return (highbit32(litlen) + LL_DELTA_CODE) if litlen > 63 else _LL_CODE_TABLE[litlen]


def ml_code(mlbase: int) -> int:
    """(matchLength - MINMATCH) -> ML code (ZSTD_MLcode)."""
    ML_DELTA_CODE = 36
    return (highbit32(mlbase) + ML_DELTA_CODE) if mlbase > 127 else _ML_CODE_TABLE[mlbase]


# Small-value LUTs, identical layout to the reference's LL_Code/ML_Code tables.
_LL_CODE_TABLE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
     22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
     24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24],
    dtype=np.int32)
_ML_CODE_TABLE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
     32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
     38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39,
     40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40,
     41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41,
     42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
     42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42],
    dtype=np.int32)
