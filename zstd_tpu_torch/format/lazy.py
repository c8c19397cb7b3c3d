"""The Python lazy ladder and the serial match helpers of the host parsers.

Copy of zstd_tpu/format/lazy.py: find_sequences_lazy, the branch that
format/opt.find_sequences_opt takes where the C DP declines a block (as
zstd_tpu's does; it is not a device fallback), with its propose-then-resolve
helpers, and _ext_fwd / _off_base, the forward extension of a verified
candidate and the offset value of a match given the repeat offsets (RFC 8878
"Repeat offsets"). Role of zstd's lib/compress/zstd_lazy.c:1516
ZSTD_compressBlock_lazy_generic: PROPOSE hashes every window position and
gathers each block position's K most recent same-bucket predecessors with
their capped common-prefix lengths; RESOLVE commits left to right with
repcode-first probes, gain-based selection (4*len - log2(offset)), 0-2 lazy
deferral rounds and backward extension.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import MIN_MATCH
from ..params import Strategy
from .matchfinder import update_reps
from .sequences import SeqStore

_PRIME64 = np.uint64(0xCF1BBCDCB7A56463)
_SEARCH_STRENGTH = 8
_LCP_CAP = 64           # vector-precomputed LCP cap; winners extend serially
_PAIR_CHUNK = 1 << 18   # pairs per LCP slab (bounds gather memory)


@dataclasses.dataclass(frozen=True)
class _Config:
    tables: tuple          # ((hash_bytes, K), ...)
    depth: int             # lazy deferral rounds


def _strategy_config(strategy: int, mls: int, search_log: int) -> _Config:
    mls = min(max(mls, 4), 7)
    if strategy == Strategy.DFAST:
        return _Config(((8, 2), (mls, 2)), 0)
    k = min(1 << max(search_log, 2), 64)
    if strategy == Strategy.GREEDY:
        return _Config(((mls, max(min(k, 24), 16)),), 1)
    if strategy == Strategy.LAZY:
        return _Config(((mls, max(min(k, 32), 24)),), 1)
    if strategy == Strategy.LAZY2:
        return _Config(((mls, max(min(k, 40), 32)),), 2)
    # BTLAZY2 and above (opt strategies fall back here until the optimal
    # parser takes over): deepest dense search + full deferral
    return _Config(((mls, min(max(k, 48), 64)),), 2)


def _hash_window(full: np.ndarray, lo: int, hi: int, nbytes: int,
                 bits: int) -> np.ndarray:
    """Hash of the `nbytes` bytes at each position in [lo, hi)."""
    n = hi - lo
    v = np.zeros(n, dtype=np.uint64)
    for b in range(nbytes):
        idx = np.minimum(np.arange(lo + b, hi + b), len(full) - 1)
        v |= full[idx].astype(np.uint64) << np.uint64(8 * b)
    if nbytes < 8:
        v &= np.uint64((1 << (8 * nbytes)) - 1)
    return (v * _PRIME64) >> np.uint64(64 - bits)


def _prev_k(h: np.ndarray, blk_lo: int, k: int) -> np.ndarray:
    """cands[i, d] = (d+1)-th most recent j < i with h[j] == h[i], else -1.

    Rows returned only for positions >= blk_lo (indices relative to h's 0).
    """
    n = len(h)
    order = np.argsort(h, kind="stable")
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    hs = h[order]
    blk_inv = inv[blk_lo:]
    out = np.full((n - blk_lo, k), -1, dtype=np.int64)
    for d in range(1, k + 1):
        cd = np.full(n, -1, dtype=np.int64)
        same = hs[d:] == hs[:-d]
        cd[d:] = np.where(same, order[:-d], -1)
        out[:, d - 1] = cd[blk_inv]
    return out


def _lcp_batch(full: np.ndarray, pos: np.ndarray, cand: np.ndarray,
               limit: np.ndarray, cap: int) -> np.ndarray:
    """Capped common-prefix length of full[pos:] vs full[cand:], elementwise.

    pos/cand absolute indices; pairs with cand < 0 return 0. limit is the
    per-pair hard bound (bytes left in block)."""
    m = len(pos)
    out = np.zeros(m, dtype=np.int32)
    n = len(full)
    for s in range(0, m, _PAIR_CHUNK):
        e = min(s + _PAIR_CHUNK, m)
        p = pos[s:e]
        c = cand[s:e]
        lim = np.minimum(limit[s:e], cap)
        ln = np.zeros(e - s, dtype=np.int32)
        alive = c >= 0
        CH = 16
        off = 0
        while off < cap and alive.any():
            idx = np.nonzero(alive)[0]
            ia = np.minimum(p[idx, None] + off + np.arange(CH), n - 1)
            ib = np.minimum(np.maximum(c[idx, None], 0) + off + np.arange(CH), n - 1)
            neq = full[ia] != full[ib]
            any_neq = neq.any(axis=1)
            first = np.where(any_neq, neq.argmax(axis=1), CH)
            ln[idx] += first.astype(np.int32)
            alive[idx] = ~any_neq
            off += CH
        out[s:e] = np.minimum(ln, lim)
    return out


def _ext_fwd(full: np.ndarray, a: int, b: int, limit: int) -> int:
    """Serial forward extension (only for cap-hitting winners)."""
    n = 0
    CHUNK = 512
    while n < limit:
        m = min(CHUNK, limit - n)
        x = full[a + n : a + n + m]
        y = full[b + n : b + n + m]
        neq = x != y
        if neq.any():
            return n + int(np.argmax(neq))
        n += m
    return limit


def _off_base(d: int, ll: int, reps: tuple) -> int:
    """Offset value encoding given current reps (spec 'Repeat offsets')."""
    r1, r2, r3 = reps
    if ll != 0:
        if d == r1:
            return 1
        if d == r2:
            return 2
        if d == r3:
            return 3
    else:
        if d == r2:
            return 1
        if d == r3:
            return 2
        if d == r1 - 1 and d > 0:
            return 3
    return d + 3


def find_sequences_lazy(full: np.ndarray, block_start: int, block_end: int,
                        window_low: int, reps: tuple, cparams
                        ) -> tuple[SeqStore, tuple]:
    """Lazy-class sequence extraction for full[block_start:block_end]."""
    n = block_end - block_start
    if n < MIN_MATCH + 1:
        return SeqStore(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int32),
                        full[block_start:block_end].tobytes()), reps

    cfg = _strategy_config(cparams.strategy, cparams.min_match,
                           cparams.search_log)
    hash_bits = cparams.hash_log

    # ---- PROPOSE ----
    cands_l = []
    for (nbytes, k) in cfg.tables:
        h = _hash_window(full, window_low, block_end, nbytes, hash_bits)
        cands_l.append(_prev_k(h, block_start - window_low, k) )
    cands = np.concatenate(cands_l, axis=1) + window_low  # absolute; -1 -> wl-1
    cands[cands == window_low - 1] = -1
    K = cands.shape[1]

    pos_abs = (np.arange(n, dtype=np.int64) + block_start)[:, None]
    limit = (block_end - pos_abs).astype(np.int64)
    lens = _lcp_batch(full, np.broadcast_to(pos_abs, cands.shape).reshape(-1),
                      cands.reshape(-1),
                      np.broadcast_to(limit, cands.shape).reshape(-1),
                      _LCP_CAP).reshape(n, K)

    # best candidate per position by gain = 4*len - bitlen(offset); resolve
    # the (rare) cap-hitting rows serially during the commit scan.
    offs = np.maximum(pos_abs - cands, 1)
    obits = np.zeros_like(offs)
    tmp = offs.copy()
    while (tmp > 0).any():
        obits += (tmp > 0)
        tmp >>= 1
    gains = 4 * lens.astype(np.int64) - obits
    gains[lens < MIN_MATCH + 1] = -(1 << 40)  # require len >= 4
    gains[cands < 0] = -(1 << 40)
    best_k = gains.argmax(axis=1)
    rows = np.arange(n)
    best_len = lens[rows, best_k].astype(np.int64)
    best_cand = cands[rows, best_k]
    best_gain = gains[rows, best_k]
    has_cand = best_gain > -(1 << 39)

    # 4-byte LE views for O(1) rep probes
    v4 = (full[:-3].astype(np.uint32)
          | (full[1:-2].astype(np.uint32) << 8)
          | (full[2:-1].astype(np.uint32) << 16)
          | (full[3:].astype(np.uint32) << 24))

    # ---- RESOLVE ----
    lits: list[tuple[int, int]] = []
    lls, obs, mbs = [], [], []
    r1, r2, r3 = reps
    anchor = block_start
    ip = block_start
    ilimit = block_end - 8
    depth = cfg.depth

    def probe(p: int) -> tuple[int, int, bool]:
        """Best (len, dist, is_rep) at position p, or (0, 0, False)."""
        bl, bd, brep, bg = 0, 0, False, -(1 << 40)
        # repcodes: all three, gain treats rep offset as ~1 bit + bonus
        for d in (r1, r2, r3):
            if d > 0 and p - d >= window_low and p + 4 <= block_end and \
                    v4[p] == v4[p - d]:
                ml = 4 + _ext_fwd(full, p + 4, p - d + 4, block_end - p - 4)
                g = 4 * ml + 1
                if g > bg:
                    bl, bd, brep, bg = ml, d, True, g
        r = p - block_start
        if has_cand[r]:
            ml = int(best_len[r])
            c = int(best_cand[r])
            if ml == _LCP_CAP and block_end - p > _LCP_CAP:
                ml += _ext_fwd(full, p + ml, c + ml, block_end - p - ml)
            g = 4 * ml - (p - c).bit_length()
            if g > bg:
                bl, bd, brep, bg = ml, p - c, False, g
        return bl, bd, brep

    def gain_of(ml: int, d: int, is_rep: bool) -> int:
        return 4 * ml + 1 if is_rep else 4 * ml - d.bit_length()

    while ip < ilimit:
        ml, d, is_rep = probe(ip)
        if ml < MIN_MATCH + 1:
            ip += 1 + ((ip - anchor) >> _SEARCH_STRENGTH)
            continue
        start = ip
        # lazy deferral: probe the next position(s); switch on clear gain
        t = 0
        while t < depth and start + 1 < ilimit:
            ml2, d2, rep2 = probe(start + 1)
            if ml2 >= MIN_MATCH + 1 and \
                    gain_of(ml2, d2, rep2) > gain_of(ml, d, is_rep) + 4 + 3 * t:
                start, ml, d, is_rep = start + 1, ml2, d2, rep2
                t += 1
            else:
                break
        # backward extension (catch-up), valid for search and rep matches
        while start > anchor and start - d > window_low and \
                full[start - 1] == full[start - 1 - d]:
            start -= 1
            ml += 1
        ll = start - anchor
        ob = _off_base(d, ll, (r1, r2, r3))
        lits.append((anchor, ll))
        lls.append(ll)
        obs.append(ob)
        mbs.append(ml - MIN_MATCH)
        r1, r2, r3 = update_reps((r1, r2, r3), ob, ll)
        anchor = start + ml
        ip = anchor

    lits.append((anchor, block_end - anchor))
    literal_bytes = b"".join(full[s : s + l].tobytes() for s, l in lits)
    seqs = SeqStore(np.array(lls, dtype=np.int32),
                    np.array(obs, dtype=np.int32),
                    np.array(mbs, dtype=np.int32),
                    literal_bytes)
    return seqs, (r1, r2, r3)
