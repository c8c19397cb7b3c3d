"""Compression parameters: level tables, negotiation, bounds.

Copy of zstd_tpu/params.py. Level table values
are behavioral data copied for parity from zstd's lib/compress/clevels.h:25
(ZSTD_defaultCParameters), as the exact (-1/-3/-19 …) level semantics depend
on them. Adjustment logic mirrors lib/compress/zstd_compress.c
ZSTD_getCParams_internal:7123 and ZSTD_adjustCParams_internal:1466.
"""

from __future__ import annotations

import dataclasses

from .constants import highbit32

ZSTD_MAX_CLEVEL = 22
ZSTD_MIN_CLEVEL = -131072
ZSTD_CLEVEL_DEFAULT = 3
WINDOWLOG_ABSOLUTEMIN = 10
HASHLOG_MIN = 6
CONTENTSIZE_UNKNOWN = -1


class Strategy:
    FAST = 1
    DFAST = 2
    GREEDY = 3
    LAZY = 4
    LAZY2 = 5
    BTLAZY2 = 6
    BTOPT = 7
    BTULTRA = 8
    BTULTRA2 = 9


@dataclasses.dataclass(frozen=True)
class CParams:
    window_log: int
    chain_log: int
    hash_log: int
    search_log: int
    min_match: int
    target_length: int
    strategy: int


@dataclasses.dataclass(frozen=True)
class FrameParams:
    content_size_flag: bool = True
    checksum_flag: bool = False
    no_dict_id_flag: bool = False


# (W, C, H, S, L, TL, strategy) x 23 rows x 4 srcSize classes.
_S = Strategy
_LEVELS_DEFAULT = [
    (19, 12, 13, 1, 6, 1, _S.FAST), (19, 13, 14, 1, 7, 0, _S.FAST),
    (20, 15, 16, 1, 6, 0, _S.FAST), (21, 16, 17, 1, 5, 0, _S.DFAST),
    (21, 18, 18, 1, 5, 0, _S.DFAST), (21, 18, 19, 3, 5, 2, _S.GREEDY),
    (21, 18, 19, 3, 5, 4, _S.LAZY), (21, 19, 20, 4, 5, 8, _S.LAZY),
    (21, 19, 20, 4, 5, 16, _S.LAZY2), (22, 20, 21, 4, 5, 16, _S.LAZY2),
    (22, 21, 22, 5, 5, 16, _S.LAZY2), (22, 21, 22, 6, 5, 16, _S.LAZY2),
    (22, 22, 23, 6, 5, 32, _S.LAZY2), (22, 22, 22, 4, 5, 32, _S.BTLAZY2),
    (22, 22, 23, 5, 5, 32, _S.BTLAZY2), (22, 23, 23, 6, 5, 32, _S.BTLAZY2),
    (22, 22, 22, 5, 5, 48, _S.BTOPT), (23, 23, 22, 5, 4, 64, _S.BTOPT),
    (23, 23, 22, 6, 3, 64, _S.BTULTRA), (23, 24, 22, 7, 3, 256, _S.BTULTRA2),
    (25, 25, 23, 7, 3, 256, _S.BTULTRA2), (26, 26, 24, 7, 3, 512, _S.BTULTRA2),
    (27, 27, 25, 9, 3, 999, _S.BTULTRA2),
]
_LEVELS_256K = [
    (18, 12, 13, 1, 5, 1, _S.FAST), (18, 13, 14, 1, 6, 0, _S.FAST),
    (18, 14, 14, 1, 5, 0, _S.DFAST), (18, 16, 16, 1, 4, 0, _S.DFAST),
    (18, 16, 17, 3, 5, 2, _S.GREEDY), (18, 17, 18, 5, 5, 2, _S.GREEDY),
    (18, 18, 19, 3, 5, 4, _S.LAZY), (18, 18, 19, 4, 4, 4, _S.LAZY),
    (18, 18, 19, 4, 4, 8, _S.LAZY2), (18, 18, 19, 5, 4, 8, _S.LAZY2),
    (18, 18, 19, 6, 4, 8, _S.LAZY2), (18, 18, 19, 5, 4, 12, _S.BTLAZY2),
    (18, 19, 19, 7, 4, 12, _S.BTLAZY2), (18, 18, 19, 4, 4, 16, _S.BTOPT),
    (18, 18, 19, 4, 3, 32, _S.BTOPT), (18, 18, 19, 6, 3, 128, _S.BTOPT),
    (18, 19, 19, 6, 3, 128, _S.BTULTRA), (18, 19, 19, 8, 3, 256, _S.BTULTRA),
    (18, 19, 19, 6, 3, 128, _S.BTULTRA2), (18, 19, 19, 8, 3, 256, _S.BTULTRA2),
    (18, 19, 19, 10, 3, 512, _S.BTULTRA2), (18, 19, 19, 12, 3, 512, _S.BTULTRA2),
    (18, 19, 19, 13, 3, 999, _S.BTULTRA2),
]
_LEVELS_128K = [
    (17, 12, 12, 1, 5, 1, _S.FAST), (17, 12, 13, 1, 6, 0, _S.FAST),
    (17, 13, 15, 1, 5, 0, _S.FAST), (17, 15, 16, 2, 5, 0, _S.DFAST),
    (17, 17, 17, 2, 4, 0, _S.DFAST), (17, 16, 17, 3, 4, 2, _S.GREEDY),
    (17, 16, 17, 3, 4, 4, _S.LAZY), (17, 16, 17, 3, 4, 8, _S.LAZY2),
    (17, 16, 17, 4, 4, 8, _S.LAZY2), (17, 16, 17, 5, 4, 8, _S.LAZY2),
    (17, 16, 17, 6, 4, 8, _S.LAZY2), (17, 17, 17, 5, 4, 8, _S.BTLAZY2),
    (17, 18, 17, 7, 4, 12, _S.BTLAZY2), (17, 18, 17, 3, 4, 12, _S.BTOPT),
    (17, 18, 17, 4, 3, 32, _S.BTOPT), (17, 18, 17, 6, 3, 256, _S.BTOPT),
    (17, 18, 17, 6, 3, 128, _S.BTULTRA), (17, 18, 17, 8, 3, 256, _S.BTULTRA),
    (17, 18, 17, 10, 3, 512, _S.BTULTRA), (17, 18, 17, 5, 3, 256, _S.BTULTRA2),
    (17, 18, 17, 7, 3, 512, _S.BTULTRA2), (17, 18, 17, 9, 3, 512, _S.BTULTRA2),
    (17, 18, 17, 11, 3, 999, _S.BTULTRA2),
]
_LEVELS_16K = [
    (14, 12, 13, 1, 5, 1, _S.FAST), (14, 14, 15, 1, 5, 0, _S.FAST),
    (14, 14, 15, 1, 4, 0, _S.FAST), (14, 14, 15, 2, 4, 0, _S.DFAST),
    (14, 14, 14, 4, 4, 2, _S.GREEDY), (14, 14, 14, 3, 4, 4, _S.LAZY),
    (14, 14, 14, 4, 4, 8, _S.LAZY2), (14, 14, 14, 6, 4, 8, _S.LAZY2),
    (14, 14, 14, 8, 4, 8, _S.LAZY2), (14, 15, 14, 5, 4, 8, _S.BTLAZY2),
    (14, 15, 14, 9, 4, 8, _S.BTLAZY2), (14, 15, 14, 3, 4, 12, _S.BTOPT),
    (14, 15, 14, 4, 3, 24, _S.BTOPT), (14, 15, 14, 5, 3, 32, _S.BTULTRA),
    (14, 15, 15, 6, 3, 64, _S.BTULTRA), (14, 15, 15, 7, 3, 256, _S.BTULTRA),
    (14, 15, 15, 5, 3, 48, _S.BTULTRA2), (14, 15, 15, 6, 3, 128, _S.BTULTRA2),
    (14, 15, 15, 7, 3, 256, _S.BTULTRA2), (14, 15, 15, 8, 3, 256, _S.BTULTRA2),
    (14, 15, 15, 8, 3, 512, _S.BTULTRA2), (14, 15, 15, 9, 3, 512, _S.BTULTRA2),
    (14, 15, 15, 10, 3, 999, _S.BTULTRA2),
]
_LEVEL_TABLES = [_LEVELS_DEFAULT, _LEVELS_256K, _LEVELS_128K, _LEVELS_16K]


def _cycle_log(chain_log: int, strategy: int) -> int:
    bt_scale = 1 if strategy >= Strategy.BTLAZY2 else 0
    return chain_log + bt_scale


def adjust_cparams(cp: CParams, src_size: int, dict_size: int = 0) -> CParams:
    """ZSTD_adjustCParams_internal (cpm_unknown mode, row-matchfinder auto)."""
    w, c, h, s, mm, tl, strat = dataclasses.astuple(cp)
    max_window_resize = 1 << 30  # 1 << (WINDOWLOG_MAX - 1)
    if src_size != CONTENTSIZE_UNKNOWN and src_size <= max_window_resize \
            and dict_size <= max_window_resize:
        t_size = src_size + dict_size
        hash_size_min = 1 << HASHLOG_MIN
        src_log = HASHLOG_MIN if t_size < hash_size_min else highbit32(max(t_size - 1, 1)) + 1
        if t_size <= 1:
            src_log = HASHLOG_MIN
        if w > src_log:
            w = src_log
    if src_size != CONTENTSIZE_UNKNOWN:
        dict_and_window_log = w  # no dictionary support in this path yet
        cyc = _cycle_log(c, strat)
        if h > dict_and_window_log + 1:
            h = dict_and_window_log + 1
        if cyc > dict_and_window_log:
            c -= cyc - dict_and_window_log
    if w < WINDOWLOG_ABSOLUTEMIN:
        w = WINDOWLOG_ABSOLUTEMIN
    # row match finder hashLog cap (assume enabled, tag bits = 8)
    if strat in (Strategy.GREEDY, Strategy.LAZY, Strategy.LAZY2):
        row_log = min(max(4, s), 6)
        max_hash_log = (32 - 8) + row_log
        if h > max_hash_log:
            h = max_hash_log
    return CParams(w, c, h, s, mm, tl, strat)


def get_cparams(level: int, src_size: int = CONTENTSIZE_UNKNOWN,
                dict_size: int = 0) -> CParams:
    r_size = src_size + dict_size if src_size != CONTENTSIZE_UNKNOWN else (1 << 62)
    table_id = (r_size <= 256 * 1024) + (r_size <= 128 * 1024) + (r_size <= 16 * 1024)
    if level == 0:
        row = ZSTD_CLEVEL_DEFAULT
    elif level < 0:
        row = 0
    elif level > ZSTD_MAX_CLEVEL:
        row = ZSTD_MAX_CLEVEL
    else:
        row = level
    t = _LEVEL_TABLES[table_id][row]
    cp = CParams(*t)
    if level < 0:
        clamped = max(ZSTD_MIN_CLEVEL, level)
        cp = dataclasses.replace(cp, target_length=-clamped)
    return adjust_cparams(cp, src_size, dict_size)


BLOCK_MAX_SIZE_P = 128 * 1024
MIN_MATCH_P = 3


def estimate_cctx_size(level: int,
                       src_size: int = CONTENTSIZE_UNKNOWN) -> int:
    """Workspace estimate for one compression context, in bytes.

    Parity role: ZSTD_estimateCCtxSize (zstd's lib/compress/zstd_compress.c
    ZSTD_estimateCCtxSize_internal, zstd_cwksp.h sizing). There is no arena
    allocator here, but the sizing semantics hold: match-state tables scale
    with the hash and chain logs, plus the block buffer, the seqstore bound
    and the entropy workspaces, so capacity planning written against zstd
    keeps working.
    """
    cp = get_cparams(level, src_size)
    block_size = min(1 << cp.window_log, BLOCK_MAX_SIZE_P)
    hash_size = 4 << cp.hash_log
    chain_size = 4 << cp.chain_log if cp.strategy >= Strategy.DFAST else 0
    h3_size = (4 << 16) if cp.strategy >= Strategy.BTOPT else 0
    # seqstore: (pos, len, off) int32 triples + literal buffer
    seq_bound = block_size // MIN_MATCH_P + 1
    seqstore = seq_bound * 3 * 4 + block_size
    entropy_ws = 8 * 1024          # tables + scratch (HUF/FSE builds)
    buffers = 2 * block_size       # input window slice + output bound
    return hash_size + chain_size + h3_size + seqstore + entropy_ws + buffers


def estimate_dctx_size() -> int:
    """ZSTD_estimateDCtxSize analog: entropy tables + block buffer."""
    return (4 << 11) * 3 + (4 << 12) + 2 * BLOCK_MAX_SIZE_P
