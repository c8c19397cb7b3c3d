"""Greedy hash-based match finder (host; fast-strategy class) and the
repeat-offset rules shared by the sequence decoders.

Copy of zstd_tpu/format/matchfinder.py. find_sequences produces the
SeqStore of one block as zstd's fast strategy does in role
(lib/compress/zstd_fast.c:192): every position hashed up front, the most
recent earlier position of the same bucket found by a sort (the dense
equivalent of a fully-updated hash table), then a greedy left-to-right
commit scan, repcode first, with backward extension. The dictionary
finalizer (dict_builder/zdict.py) gathers its statistics with it; the
block encoder's dispatch does not reach it (zstd_tpu reaches it there only
through its ZSTD_TPU_HOST_PARSER=fast knob, which the port leaves out).
update_reps and resolve_offset follow RFC 8878 "Repeat offsets" and
"Offset updates rules".
"""

from __future__ import annotations

import numpy as np

from ..constants import MIN_MATCH
from .sequences import SeqStore

_PRIME64 = np.uint64(0xCF1BBCDCB7A56463)


def hash_positions(arr: np.ndarray, n_pos: int, mls: int, hash_log: int) -> np.ndarray:
    """Vectorized hash of the first `mls` (5..8) bytes at each position."""
    mls = min(max(mls, 4), 8)
    if n_pos <= 0:
        return np.zeros(0, dtype=np.uint64)
    v = np.zeros(n_pos, dtype=np.uint64)
    for k in range(8):
        idx = np.arange(n_pos) + k
        idx = np.minimum(idx, len(arr) - 1)
        byte = arr[idx].astype(np.uint64)
        if k < mls:
            v |= byte << np.uint64(8 * k)
    if mls < 8:
        v &= np.uint64((1 << (8 * mls)) - 1)
    h = (v * _PRIME64) >> np.uint64(64 - hash_log)
    return h


def prev_same_bucket(h: np.ndarray) -> np.ndarray:
    """For each position i, the largest j < i with h[j] == h[i], else -1."""
    n = len(h)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(h, kind="stable")  # groups equal hashes, positions ascending
    prev = np.full(n, -1, dtype=np.int64)
    same = h[order][1:] == h[order][:-1]
    prev[order[1:]] = np.where(same, order[:-1], -1)
    return prev


def _ob_for_dist(d: int, ll: int, r1: int, r2: int, r3: int) -> int:
    """Offset code (offBase) for match distance d at litLength ll (spec
    'Repeat offsets': the rep mapping shifts when litLength is 0)."""
    if ll != 0:
        if d == r1:
            return 1
        if d == r2:
            return 2
        if d == r3:
            return 3
        return d + 3
    if d == r2:
        return 1
    if d == r3:
        return 2
    if d == r1 - 1 and d > 0:
        return 3
    return d + 3


def _match_len(arr: np.ndarray, a: int, b: int, limit: int) -> int:
    """Length of the common prefix of arr[a:] and arr[b:], capped to limit."""
    n = 0
    CHUNK = 256
    while n < limit:
        m = min(CHUNK, limit - n)
        x = arr[a + n : a + n + m]
        y = arr[b + n : b + n + m]
        neq = x != y
        if neq.any():
            return n + int(np.argmax(neq))
        n += m
    return limit


def find_sequences(full: np.ndarray, block_start: int, block_end: int,
                   window_low: int, reps: tuple[int, int, int],
                   hash_log: int, mls: int,
                   search_strength: int = 8) -> tuple[SeqStore, tuple[int, int, int]]:
    """Greedy sequence extraction for full[block_start:block_end].

    full: uint8 array of the frame prefix + current block.
    window_low: lowest position matches may reference.
    Returns (SeqStore, updated reps).
    """
    n = block_end - block_start
    if n < MIN_MATCH + 1:
        return SeqStore(np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int32),
                        full[block_start:block_end].tobytes()), reps

    # Hash every position in the window + block (dense table equivalent).
    n_pos = block_end - window_low
    h = hash_positions(full[window_low:block_end], n_pos, mls, hash_log)
    prev = prev_same_bucket(h)  # indices relative to window_low

    lits: list[tuple[int, int]] = []  # (start, len) runs into full
    lls, obs, mbs = [], [], []
    r1, r2, r3 = reps

    anchor = block_start
    ip = block_start
    ilimit = block_end - 8  # keep an 8-byte tail of pure literals margin
    u32 = full  # byte-wise compares below

    def eq4(a: int, b: int) -> bool:
        return bool(np.array_equal(u32[a:a + 4], u32[b:b + 4]))

    while ip < ilimit:
        ll = ip - anchor
        best_len = 0
        best_ob = 0
        best_start = ip

        # repcode-first probe: rep1 at ip, ip+1 and ip+2 (the reference
        # checks the repcode up to two positions AHEAD of the scan point and
        # prefers it over a table match — zstd_fast.c:277 checks ip2 first),
        # shifted rep when the hit lands at litLength 0.
        for d_ahead in (0, 1, 2):
            p = ip + d_ahead
            ll_p = p - anchor
            rep_d = r1 if ll_p != 0 else r2
            if (rep_d > 0 and p - rep_d >= window_low and p < ilimit
                    and eq4(p, p - rep_d)):
                mlen = 4 + _match_len(u32, p + 4, p - rep_d + 4,
                                      block_end - p - 4)
                # bounded backward extension (same distance; the offset CODE
                # must be re-derived because litLength may change)
                start = p
                while (start > anchor and start - rep_d > window_low
                       and u32[start - 1] == u32[start - rep_d - 1]):
                    start -= 1
                    mlen += 1
                ob = _ob_for_dist(rep_d, start - anchor, r1, r2, r3)
                best_len = mlen
                best_ob = ob
                best_start = start
                break
        if best_len == 0:
            cand = prev[ip - window_low]
            if cand >= 0:
                c = cand + window_low
                if eq4(ip, c):
                    mlen = 4 + _match_len(u32, ip + 4, c + 4, block_end - ip - 4)
                    # backward extension
                    start = ip
                    cc = c
                    while start > anchor and cc > window_low and u32[start - 1] == u32[cc - 1]:
                        start -= 1
                        cc -= 1
                        mlen += 1
                    d = start - cc
                    ob = _ob_for_dist(d, start - anchor, r1, r2, r3)
                    best_len = mlen
                    best_ob = ob
                    best_start = start

        if best_len >= MIN_MATCH:
            ll = best_start - anchor
            lits.append((anchor, ll))
            lls.append(ll)
            obs.append(best_ob)
            mbs.append(best_len - MIN_MATCH)
            # repcode state update (decoder-mirror rule)
            r1, r2, r3 = update_reps((r1, r2, r3), best_ob, ll)
            anchor = best_start + best_len
            ip = anchor
        else:
            ip += 1 + ((ip - anchor) >> search_strength)

    lits.append((anchor, block_end - anchor))
    literal_bytes = b"".join(full[s : s + l].tobytes() for s, l in lits)
    seqs = SeqStore(np.array(lls, dtype=np.int32),
                    np.array(obs, dtype=np.int32),
                    np.array(mbs, dtype=np.int32),
                    literal_bytes)
    return seqs, (r1, r2, r3)


def update_reps(reps: tuple[int, int, int], off_base: int, ll: int
                ) -> tuple[int, int, int]:
    """Repeat-offset update rule (spec 'Offset updates rules'); shared by
    encoder and decoder so both sides stay in lockstep."""
    r1, r2, r3 = reps
    if off_base > 3:
        return off_base - 3, r1, r2
    idx = off_base + (1 if ll == 0 else 0)
    if idx == 1:
        return r1, r2, r3
    if idx == 2:
        return r2, r1, r3
    if idx == 3:
        return r3, r1, r2
    # idx == 4: offBase 3 with ll == 0 -> rep1 - 1
    return r1 - 1, r1, r2


def resolve_offset(reps: tuple[int, int, int], off_base: int, ll: int) -> int:
    """Decoder-side offset resolution (spec 'Repeat offsets')."""
    if off_base > 3:
        return off_base - 3
    idx = off_base + (1 if ll == 0 else 0)
    if idx == 1:
        return reps[0]
    if idx == 2:
        return reps[1]
    if idx == 3:
        return reps[2]
    return reps[0] - 1
