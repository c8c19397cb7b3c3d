"""A numpy model of the lazy and v3 engines' seqstore kernels, row by row,
in the kernels' own terms: a row is cut across a cluster of `ctas` CTAs,
each part is computed alone, and only the carries that cross the cluster
join the parts (ctas = 1 is the whole row in one part).

- `merge_row`, csrc/seq_merge.cu. The slots in C segments of 4-aligned
  length. Pass 1: each segment's last valid slot (v, e, d), its first valid
  slot (p, d) and its group starts, its first valid slot counted as a start
  for now. Exchange: a segment's carry-in is the last valid slot of the
  segments before it; its first slot is no start when it chains to that
  carry. Pass 2: each start writes its group's pos and dist (max 0) and the
  previous group's end into the CTA that owns that group id (ids in runs of
  ceil(nb / C)); a group's length is its last end less its pos. Then each
  CTA takes its own groups: the rewrite from the previous group's dist
  (across the cut for its first), the merge starts (its first counted for
  now), an exchange of (merged starts, first and last rewritten dist, last
  group's end, the end before its second start) that corrects the first,
  and each CTA writes its merged groups: a group ends where the next start
  begins, its last where the next CTA's first real start begins (or the
  row's last group ends).
- `finish_row`, csrc/seq_finish.cu. The sequences in C runs of ceil(nb /
  C); each CTA extends its own (forward to the next original start, and
  the previous run's last forward end computed again for its first
  backward bound; where no index is clamped, the steps come from a count
  of agreeing bytes, as the kernel takes them on its shared-memory route;
  elsewhere the plain's step loops, as the kernel keeps them), its gaps'
  ranks from a local scan and the exchange of the C totals and of the tail
  gap's rank and start (the tail gap in the last CTA). Each CTA writes the literal index at the ranks of its own
  gaps, from its own ranks and starts alone, and a slice of the rest (the
  tail gap's ranks, then n - 1 past nb_lit).

tests/test_torch_seq_tail.py holds both to the plain torch versions at C =
1 to 4. Imports neither JAX nor zstd_tpu.
"""

from __future__ import annotations

import numpy as np

REP_MAX = 18
EXT3, EXT1, BACK3, BACK1 = 7, 2, 5, 2


class _Row:
    """Bytes of one row; reads past n give 0."""

    def __init__(self, row: np.ndarray):
        self.b = [int(x) for x in row]
        self.n = len(self.b)

    def byte(self, x: int) -> int:
        return self.b[x] if x < self.n else 0

    def tri(self, x: int) -> int:
        return self.byte(x) | self.byte(x + 1) << 8 | self.byte(x + 2) << 16


def slot_segments(M: int, ctas: int) -> list:
    """[lo, hi) of each CTA's slots: ceil(M / C) rounded up to 4 a part."""
    seg = -(-(-(-M // ctas)) // 4) * 4
    return [(min(c * seg, M), min((c + 1) * seg, M)) for c in range(ctas)]


def runs(nb: int, ctas: int) -> list:
    """[k0, k1) of each CTA's groups or sequences: runs of ceil(nb / C)."""
    per = -(-nb // ctas)
    return [(min(c * per, nb), min((c + 1) * per, nb)) for c in range(ctas)]


def _chains(cur, p, d) -> bool:
    """Whether a valid slot at p with dist d joins the last valid slot."""
    return cur[0] and p == cur[1] and d == cur[2]


def merge_row(yp, yl, cand, row, cap: int, ctas: int = 1):
    """(pos, len, dist, nb) of one row's merged sequences."""
    r = _Row(row)
    n = r.n
    yp, yl = yp.tolist(), yl.tolist()
    cand = cand.tolist()
    segs = slot_segments(len(yp), ctas)

    def valid_slots(lo, hi):
        for i in range(lo, hi):
            if yl[i] > 0:
                yield yp[i], yl[i], yp[i] - cand[yp[i]]

    # pass 1: each segment alone
    last, first, starts = [], [], []
    for lo, hi in segs:
        cur, f, s = (False, 0, 0), None, 0
        for p, ln, d in valid_slots(lo, hi):
            s += not _chains(cur, p, d)
            f = f or (p, d)
            cur = (True, p + ln, d)
        last.append(cur)
        first.append(f)
        starts.append(s)
    # exchange: carry-ins, the first slots' corrections, group bases
    carry, run = [], (False, 0, 0)
    for c in range(ctas):
        carry.append(run)
        run = last[c] if last[c][0] else run
    count, base = 0, []
    for c in range(ctas):
        base.append(count)
        f = first[c]
        count += starts[c] - bool(f and _chains(carry[c], *f))
    nb = min(count, cap)
    per = max(-(-nb // ctas), 1)
    # the groups, ids in runs of `per` a CTA
    parts = {key: np.zeros((ctas, per), np.int64)
             for key in ("pos", "dist", "end")}

    def put(key, g, v):
        parts[key][g // per, g % per] = v

    def get(key, g):
        return int(parts[key][g // per, g % per])

    # pass 2: each segment from its carry-in and base
    for c, (lo, hi) in enumerate(segs):
        cur, g = carry[c], base[c]
        for p, ln, d in valid_slots(lo, hi):
            if not _chains(cur, p, d):
                if g < cap:
                    put("pos", g, p)
                    put("dist", g, max(d, 0))
                if 1 <= g <= cap:
                    put("end", g - 1, cur[1])
                g += 1
            cur = (True, p + ln, d)
    if 1 <= count <= cap:
        put("end", count - 1, run[1])

    # rewrite and merge: each CTA its own groups
    spans = runs(nb, ctas)
    starts, pub = [], []
    for k0, k1 in spans:
        rd = []
        for k in range(k0, k1):
            pos, v = get("pos", k), get("dist", k)
            if k > 0:
                d, ln = get("dist", k - 1), get("end", k) - pos
                if d > 0 and v != d and pos - d >= 0 and ln <= REP_MAX \
                        and all(r.tri(min(pos + j, n - 1))
                                == r.tri(max(min(pos - d + j, n - 1), 0))
                                for j in range(0, ln, 3)):
                    v = d
            rd.append(v)
        # the merge starts (pos, dist, the end of the group before), the
        # CTA's first group counted for now
        st = [(get("pos", k), max(rd[k - k0], 0),
               get("end", k - 1) if k else 0)
              for k in range(k0, k1)
              if k == k0 or not (get("pos", k) == get("end", k - 1)
                                 and rd[k - k0] == rd[k - k0 - 1])]
        starts.append(st)
        # shown to the cluster: whether the first group starts at the
        # previous group's end, the first and last rewritten dists, the
        # last group's end and the end before the second start
        pub.append((0 < k0 < k1 and get("pos", k0) == get("end", k0 - 1),
                    rd[0] if rd else 0, rd[-1] if rd else 0,
                    get("end", k1 - 1) if rd else 0,
                    st[1][2] if len(st) > 1 else 0))
    # exchange: the first groups' corrections, merged bases
    merged, mbase, corr = 0, [], []
    for c in range(ctas):
        corr.append(c > 0 and pub[c][0] and pub[c][1] == pub[c - 1][2])
        mbase.append(merged)
        merged += len(starts[c]) - corr[c]

    def last_end(c):
        """The end of CTA c's last merged group: the end before the next
        real start in a later CTA, else the row's last group's end."""
        for c2 in range(c + 1, ctas):
            if not starts[c2]:
                break
            if not corr[c2]:
                return pub[c2 - 1][3]
            if len(starts[c2]) > 1:
                return pub[c2][4]
        return get("end", nb - 1)

    out_pos = np.full(cap, n, np.int64)
    out_len = np.zeros(cap, np.int64)
    out_dist = np.zeros(cap, np.int64)
    for c in range(ctas):
        own = starts[c][corr[c]:]               # its real starts
        ends = [e for _, _, e in own[1:]] + [last_end(c)] if own else []
        for j, ((pos, dist, _), end) in enumerate(zip(own, ends)):
            o = mbase[c] + j
            out_pos[o], out_dist[o], out_len[o] = pos, dist, end - pos
    return out_pos, out_len, out_dist, merged


def finish_row(row, pos, length, off, nb_seq: int, valid_len: int,
               cap: int, ctas: int = 1) -> dict:
    """The seqstore fields of one row from its merged sequences."""
    r = _Row(row)
    n = r.n
    nb = min(max(nb_seq, 0), cap)
    vn = min(valid_len, n)
    pos, length, off = (a.tolist() for a in (pos, length, off))

    def agree(x, y, step):
        """How many bytes agree at x + step * i and y + step * i, up to
        24."""
        i = 0
        while i < 24 and r.byte(x + step * i) == r.byte(y + step * i):
            i += 1
        return i

    def forward(k):
        p, ln, o = pos[k], length[k], off[k]
        room = max((pos[k + 1] if k + 1 < nb else vn) - (p + ln), 0)
        if room > 0 and 0 <= o <= p:
            # the kernel's count of agreeing bytes: no index is clamped
            m = min(agree(p + ln, p - o + ln, 1), room)
            s3 = min(EXT3, m // 3)
            return p + ln + 3 * s3 + min(EXT1, m - 3 * s3)
        if room > 0:
            limit, src = ln + room, p - o
            for _ in range(EXT3):
                if ln + 3 > limit or r.tri(min(p + ln, n - 1)) \
                        != r.tri(max(min(src + ln, n - 1), 0)):
                    break
                ln += 3
            for _ in range(EXT1):
                if ln >= limit or r.byte(min(p + ln, n - 1)) \
                        != r.byte(max(min(src + ln, n - 1), 0)):
                    break
                ln += 1
        return p + ln

    ll, ml, of = (np.zeros(cap, np.int64) for _ in range(3))
    spans = runs(nb, ctas)
    efwd, gaps = [], []          # per CTA: forward ends from k0 - 1, gaps
    for c, (k0, k1) in enumerate(spans):
        ef = {k: forward(k) for k in range(max(k0 - 1, 0), k1)}
        gl = []
        for k in range(k0, k1):
            o, pe, sp = off[k], ef[k - 1] if k else 0, pos[k]
            if o >= 0 and sp - o >= 24:           # the kernel's count
                m = max(min(agree(sp - 1, sp - o - 1, -1), sp - pe, sp - o),
                        0)
                s3 = min(BACK3, m // 3)
                sp -= 3 * s3 + min(BACK1, m - 3 * s3)
                ll[k], ml[k], of[k] = sp - pe, ef[k] - sp, o
                gl.append(max(ll[k], 0))
                continue
            for _ in range(BACK3):
                if sp - 3 < pe or sp - o - 3 < 0 \
                        or r.tri(max(sp - 3, 0)) != r.tri(max(sp - o - 3, 0)):
                    break
                sp -= 3
            for _ in range(BACK1):
                if sp <= pe or sp - o <= 0 or r.byte(max(sp - 1, 0)) \
                        != r.byte(max(sp - o - 1, 0)):
                    break
                sp -= 1
            ll[k], ml[k], of[k] = sp - pe, ef[k] - sp, o
            gl.append(max(ll[k], 0))
        if c == ctas - 1:                          # the tail gap
            gl.append(max(vn - (ef[nb - 1] if nb else 0), 0))
        efwd.append(ef)
        gaps.append(gl)
    # exchange: each CTA's first rank, the tail gap's rank and start
    base = np.concatenate([[0], np.cumsum([sum(g) for g in gaps])])
    total = int(base[-1])
    tail_rank = int(base[-1]) - gaps[-1][-1]
    tail_start = efwd[-1][nb - 1] if nb else 0
    lit_idx = np.zeros(n, np.int64)
    written = np.zeros(n, bool)
    for c, (k0, k1) in enumerate(spans):    # each CTA's own gaps
        rank = np.concatenate([[0], np.cumsum(gaps[c])[:-1]])[:k1 - k0]
        start = np.array([efwd[c][k - 1] if k else 0
                          for k in range(k0, k1)], np.int64)
        own = np.arange(base[c], base[c] + sum(gaps[c][:k1 - k0]))
        g = np.searchsorted(rank, own - base[c], side="right") - 1
        assert not written[own].any()
        written[own] = True
        lit_idx[own] = start[g] + own - base[c] - rank[g]
    rest = n - tail_rank                      # split across the cluster
    for c in range(ctas):
        ranks = np.arange(tail_rank + c * rest // ctas,
                          tail_rank + (c + 1) * rest // ctas)
        assert not written[ranks].any()
        written[ranks] = True
        lit_idx[ranks] = np.where(ranks < total,
                                  tail_start + ranks - tail_rank, n - 1)
    assert written.all()
    return dict(ll=ll, off=of, ml=ml, lit_idx=lit_idx, nb_lit=total,
                overflow=nb_seq >= cap)
