"""A Python model of csrc/xla_walk.cu: the xla engine's segment-parallel
greedy walk and its emit, as the kernel runs them on one row.

The kernel cuts a row's positions [emit_from, valid_len - 8) into S
segments (C CTAs of 32 warps a row: S = 32 C), one warp each.
- Speculate: each warp walks the greedy chain from its segment's start:
  32 positions a ballot to the next position that can commit (a candidate
  whose 4-byte word agrees), then its length min(lcp, 8164, valid_len - q),
  128 bytes in a first round, 512 a round after it; it records (q, length)
  and its exit, the first position >= the segment's end that the walk
  stands on.
- Repair, in rounds: every warp reads every segment's (entry, exit) and
  follows the chain over the segments in order: an entry at or past a
  segment's end passes through it, an entry inside it takes its exit. A
  segment whose entry moved walks again from it until it stands on a
  position its speculative walk stood on (from there that list is right),
  following the chain into later segments while it stands inside their
  speculative commits (its exit is then where it met one of their walks,
  past the last position, or where its list of scap records filled).
  Rounds repeat until no entry moves.
- Emit: prefix sums over the segments place every commit; each one is
  extended backward (zstd_tpu's four word steps, cut to the previous end
  and, where the halo is fabricated, to cand - emit_from), its ll/off/ml go
  to its rank below seq_cap, and the gaps between the extended matches
  from emit_from to valid_len are the literal index.

`extract_row` returns the seven keys of seqextract.xla_extract for one row
and the kernel's counts for it (seqextract.XLA_STATS without the cycles),
for any segment count; tests/test_torch_xla_engine.py holds it to
xla_extract_plain. Test code only: zstd_tpu_torch does not use it.
"""

from __future__ import annotations

import numpy as np

CAP = 4 + 4 * 8 * 255   # 8164
MARGIN = 8
FIRST = 128             # bytes of the first length round (4 a lane)
ROUND = 512             # bytes of a later one (16 a lane)


def _lcp(raw: bytes, a: int, b: int, limit: int) -> int:
    """Common prefix of raw[a:] and raw[b:], at most limit bytes."""
    l = 0
    while l < limit:
        k = min(ROUND, limit - l)
        x = int.from_bytes(raw[a + l:a + l + k], "little") ^ \
            int.from_bytes(raw[b + l:b + l + k], "little")
        if x:
            return l + ((x & -x).bit_length() - 1) // 8
        l += k
    return limit


def extract_row(row: np.ndarray, cand: np.ndarray, valid_len: int,
                emit_from: int, halo_ok: bool, seq_cap: int, n_segs: int):
    """(dict of nb_seq, ll, off, ml, lit_idx, nb_lit, overflow as numpy
    values; counts: commits, segments, spec_steps, rounds, repair_steps)."""
    n = row.shape[0]
    raw = row.tobytes() + bytes(CAP + 2 * ROUND)    # bytes past n read 0
    pad = np.frombuffer(raw, np.uint8).astype(np.int64)
    words = pad[:n + 4] | (pad[1:n + 5] << 8) | (pad[2:n + 6] << 16) | \
        (pad[3:n + 7] << 24)
    cand = cand.astype(np.int64)
    can = (cand >= 0) & (words[:n] == words[np.maximum(cand, 0)])
    idx = np.where(can, np.arange(n), n)
    nxt = np.minimum.accumulate(idx[::-1])[::-1].tolist()
    words, cand = words.tolist(), cand.tolist()

    vl, ef = valid_len, emit_from
    efc = max(ef, 0)
    limit = vl - MARGIN
    top = max(limit, efc)
    seg = max(-(-(top - efc) // n_segs), 1)
    lo = [min(efc + t * seg, top) for t in range(n_segs + 1)]

    def scan(p, end):
        """The first position of [p, end) that can commit (or end) and the
        ballots of 32 aligned positions the warp takes to find it."""
        if p >= end:
            return end, 0
        q = nxt[p]
        last = q if q < end else end - 1
        return (q if q < end else end), (last >> 5) - (p >> 5) + 1

    def length(q):
        """(min(lcp, 8164, vl - q), the warp's rounds past the first word:
        one of FIRST bytes, then rounds of ROUND bytes)."""
        c = cand[q]
        lim = min(CAP, vl - q) - 4
        more = max(-(-(lim - FIRST) // ROUND), 0)
        l = _lcp(raw, q + 4, c + 4, FIRST + more * ROUND)
        rounds = 1 if l < FIRST or more == 0 else \
            1 + min((l - FIRST) // ROUND + 1, more)
        return 4 + min(l, lim), rounds

    def spec_walk(p, hi):
        """(commits, exit, steps) of the walk from p while p < hi."""
        recs, steps = [], 0
        while p < hi:
            q, ballots = scan(p, hi)
            steps += ballots
            if q >= hi:
                p = hi
                break
            ln, rounds = length(q)
            steps += rounds
            recs.append((q, ln))
            p = q + ln
        return recs, p, steps

    scap = (-(-n // n_segs) + 3) // 4 + 2      # records a list holds

    def rewalk(p, t):
        """(commits, j, exit or None where merged with spec[t][j:], steps)
        of segment t's walk from p, on into later segments while it stands
        inside their speculative commits."""
        recs, j, steps, u = [], 0, 0, t
        while p < top:
            while p >= lo[u + 1]:
                u, j = u + 1, 0
            sp = spec[u]
            while j < len(sp) and sp[j][0] + sp[j][1] <= p:
                j += 1
            if j == len(sp) or sp[j][0] >= p:
                return (recs, j, None, steps) if u == t else \
                    (recs, None, p, steps)
            if u != t and len(recs) >= scap:
                break
            end = min(sp[j][0] + sp[j][1], lo[u + 1])
            q, ballots = scan(p, end)
            steps += ballots
            if q >= end:
                p = end
                continue
            ln, rounds = length(q)
            steps += rounds
            recs.append((q, ln))
            p = q + ln
        return recs, None, p, steps

    spec, spec_exit, spec_steps = [], [], 0
    for t in range(n_segs):
        recs, ex, st = spec_walk(lo[t], lo[t + 1])
        spec.append(recs)
        spec_exit.append(ex)
        spec_steps = max(spec_steps, st)
    entry, exits = lo[:n_segs], list(spec_exit)
    lists = [list(r) for r in spec]
    rounds = repair_steps = 0
    while True:
        e, v = [], lo[0]
        for t in range(n_segs):     # the chain over the segments in order
            e.append(v)
            if v < lo[t + 1]:
                v = exits[t]
        moved = [t for t in range(n_segs) if e[t] != entry[t]]
        if not moved:
            break
        rounds += 1
        for t in moved:
            entry[t], lists[t], exits[t] = e[t], [], e[t]
            if e[t] < lo[t + 1]:
                pre, j, ex, st = rewalk(e[t], t)
                repair_steps += st
                if ex is None:
                    lists[t], exits[t] = pre + spec[t][j:], spec_exit[t]
                else:
                    lists[t], exits[t] = pre, ex

    recs = [r for lst in lists for r in lst]
    ll = np.zeros(seq_cap, np.int32)
    off = np.zeros(seq_cap, np.int32)
    ml = np.zeros(seq_cap, np.int32)
    lit_idx = np.full(n, n - 1, np.int32)
    nb_lit, pe = 0, None
    for k, (q, ln) in enumerate(recs):
        c = cand[q]
        ext, still = 0, True
        for back in (4, 8, 12, 16):
            ok = still and q - back >= 0 and c - back >= 0
            x = words[max(q - back, 0)] ^ words[max(c - back, 0)]
            if ok:
                ext += 4 if x == 0 else 3 - (x.bit_length() - 1) // 8
            still = ok and x == 0
        a_ext = efc if pe is None else pe
        ext = min(ext, max(q - a_ext, 0))
        if not halo_ok:
            ext = min(ext, max(c - ef, 0))
        s = q - ext
        if k < seq_cap:
            ll[k] = s - (ef if pe is None else pe)
            off[k] = q - c
            ml[k] = ln + ext
        lit_idx[nb_lit:nb_lit + s - a_ext] = np.arange(a_ext, s)
        nb_lit += s - a_ext
        pe = q + ln
    tail_at = efc if pe is None else pe
    tail = max(vl - tail_at, 0)
    lit_idx[nb_lit:nb_lit + tail] = np.arange(tail_at, tail_at + tail)
    nb_lit += tail
    out = dict(nb_seq=len(recs), ll=ll, off=off, ml=ml, lit_idx=lit_idx,
               nb_lit=nb_lit, overflow=len(recs) > seq_cap)
    counts = dict(commits=len(recs),
                  segments=sum(lo[t] < lo[t + 1] for t in range(n_segs)),
                  spec_steps=spec_steps, rounds=rounds,
                  repair_steps=repair_steps)
    return out, counts
