"""A numpy model of csrc/xla_walk.cu: the tile pass's length bytes and the
walk through them, as the kernel runs them on one row.

The kernel walks a row in tiles of TILE positions. Per tile, at or past the
walk's position and emit_from and below valid_len - 8, every position q gets
sl[q] = 0 (no candidate, or the 4-byte words at q and cand[q] differ), its
length min(lcp, cap) computed up to SHORT bytes, or LONG where the match is
longer than SHORT and the cap (min(8164, valid_len - q)) allows more, and
nx[q] = the first position >= q of the tile with a nonzero sl (TILE if
none). The walk steps q = nx[p], finishes a LONG length from the bytes 128
at a time, commits q and jumps by its length, until it passes the tile's
end. `walk` returns what the kernel writes and its counts (steps, commits)
for any tile size (the kernel's is 8,192), so the tests hold the tiling to
the plain chain.
"""

from __future__ import annotations

import numpy as np

TILE = 8192
SHORT = 64
LONG = 255
CAP = 4 + 4 * 8 * 255
MARGIN = 8


def _lcp(pad: bytes, a: int, b: int, limit: int, step: int) -> int:
    """Common prefix of pad[a:] and pad[b:], capped at limit, compared
    `step` bytes a round (`pad`: the row and CAP + 256 zero bytes)."""
    l = 0
    while l < limit:
        x, y = pad[a + l:a + l + step], pad[b + l:b + l + step]
        if x != y:
            return min(l + next(i for i in range(step) if x[i] != y[i]),
                       limit)
        l += step
    return min(l, limit)


def walk(row: np.ndarray, cand: np.ndarray, valid_len: int, emit_from: int,
         tile: int = TILE):
    """(committed u8[n], take_len i32[n], steps, commits) of one row."""
    n = row.shape[0]
    raw = row.tobytes() + bytes(CAP + 256)
    committed = np.zeros(n, np.uint8)
    take = np.zeros(n, np.int32)
    ef = max(emit_from, 0)
    limit = valid_len - MARGIN
    p = ef
    rounds = commits = 0
    base = (ef // tile) * tile
    while base < limit:
        if p >= base + tile:
            base += tile
            continue
        sl = np.zeros(tile, np.int32)
        for q in range(max(p, ef), min(base + tile, limit)):
            c = int(cand[q])
            if c < 0 or raw[q:q + 4] != raw[c:c + 4]:
                continue
            lim = min(CAP, valid_len - q)
            cap = min(lim, SHORT)
            l = _lcp(raw, q, c, cap, 4)
            sl[q - base] = LONG if (l == SHORT and lim > SHORT) else l
        nx = np.full(tile + 1, tile, np.int64)
        for i in range(tile - 1, -1, -1):
            nx[i] = i if sl[i] else nx[i + 1]
        end = min(base + tile, limit)
        while p < end:
            rounds += 1
            q = base + int(nx[p - base])
            if q >= end:
                p = end
                break
            length = int(sl[q - base])
            if length == LONG:
                lim = min(CAP, valid_len - q)
                length = SHORT + _lcp(raw, q + SHORT, int(cand[q]) + SHORT,
                                      lim - SHORT, 128)
            committed[q] = 1
            take[q] = length
            commits += 1
            p = q + length
        p = max(p, end)
        base += tile
    return committed, take, rounds, commits
