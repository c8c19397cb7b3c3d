"""A numpy model of the lazy and v3 engines' seqstore kernels, row by row,
in the kernels' own terms:

- `merge_row`, csrc/seq_merge.cu: each valid slot finds the last valid slot
  before it; a start writes its group's pos and dist (max 0) and the
  previous group's end; a group's length is its last end less its pos (the
  members start where the one before ends). Then the rewrite of each group
  from its predecessor's dist, its compares stopped at the first mismatch,
  and the merge of the rewritten groups by the same end-writing.
- `finish_row`, csrc/seq_finish.cu: each sequence's forward and backward
  steps on its own (the backward bound is the previous sequence's end after
  its forward steps), then the literals gap by gap: gap k is [previous end,
  start of k), the last [last end, min(valid_len, n)); each rank finds its
  gap by a search of the gaps' first ranks.

tests/test_torch_seq_tail.py holds both to the plain torch versions. Imports
neither JAX nor zstd_tpu.
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


def merge_row(yp, yl, cand, row, cap: int):
    """(pos, len, dist, nb) of one row's merged sequences."""
    r = _Row(row)
    n = r.n
    gpos = np.zeros(cap, np.int64)
    gdist = np.zeros(cap, np.int64)
    gend = np.zeros(cap, np.int64)
    have, last_e, last_d = False, 0, 0       # the last valid slot so far
    count = 0
    for p, ln in zip(yp.tolist(), yl.tolist()):
        if ln <= 0:
            continue
        d = p - int(cand[p])
        if not (have and p == last_e and d == last_d):
            g = count
            count += 1
            if g < cap:
                gpos[g], gdist[g] = p, max(d, 0)
            if 1 <= g <= cap:
                gend[g - 1] = last_e
        have, last_e, last_d = True, p + ln, d
    if 1 <= count <= cap:
        gend[count - 1] = last_e
    nb = min(count, cap)

    out_pos = np.full(cap, n, np.int64)
    out_len = np.zeros(cap, np.int64)
    out_dist = np.zeros(cap, np.int64)
    merged, prd = 0, 0
    for k in range(nb):
        pos, rd, prev_end = int(gpos[k]), int(gdist[k]), 0
        if k > 0:
            d, ln = int(gdist[k - 1]), int(gend[k] - pos)
            prev_end = int(gend[k - 1])
            if d > 0 and rd != d and pos - d >= 0 and ln <= REP_MAX:
                if all(r.tri(min(pos + j, n - 1))
                       == r.tri(max(min(pos - d + j, n - 1), 0))
                       for j in range(0, ln, 3)):
                    rd = d
        if not (k > 0 and pos == prev_end and rd == prd):
            out_pos[merged], out_dist[merged] = pos, max(rd, 0)
            if merged > 0:
                out_len[merged - 1] = prev_end
            merged += 1
        prd = rd
    if merged:
        out_len[merged - 1] = gend[nb - 1]
    out_len[:merged] -= out_pos[:merged]
    return out_pos, out_len, out_dist, merged


def finish_row(row, pos, length, off, nb_seq: int, valid_len: int,
               cap: int) -> dict:
    """The seqstore fields of one row from its merged sequences."""
    r = _Row(row)
    n = r.n
    nb = min(max(nb_seq, 0), cap)
    vn = min(valid_len, n)
    pos, length, off = (a.tolist() for a in (pos, length, off))
    efwd = []
    for k in range(nb):
        p, ln, o = pos[k], length[k], off[k]
        room = max((pos[k + 1] if k + 1 < nb else vn) - (p + ln), 0)
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
        efwd.append(p + ln)
    ll, ml, of = (np.zeros(cap, np.int64) for _ in range(3))
    for k in range(nb):
        o, pe, sp = off[k], efwd[k - 1] if k else 0, pos[k]
        for _ in range(BACK3):
            if sp - 3 < pe or sp - o - 3 < 0 \
                    or r.tri(max(sp - 3, 0)) != r.tri(max(sp - o - 3, 0)):
                break
            sp -= 3
        for _ in range(BACK1):
            if sp <= pe or sp - o <= 0 \
                    or r.byte(max(sp - 1, 0)) != r.byte(max(sp - o - 1, 0)):
                break
            sp -= 1
        ll[k], ml[k], of[k] = sp - pe, efwd[k] - sp, o
    # the literals, gap by gap
    tail_start = efwd[nb - 1] if nb else 0
    gaps = np.append(np.maximum(ll[:nb], 0), max(vn - tail_start, 0))
    rank = np.concatenate([[0], np.cumsum(gaps)[:-1]])
    total = int(gaps.sum())
    starts = np.array([0] + efwd, np.int64)
    ranks = np.arange(n)
    g = np.searchsorted(rank, ranks, side="right") - 1
    lit_idx = np.where(ranks < total, starts[g] + ranks - rank[g], n - 1)
    return dict(ll=ll, off=of, ml=ml, lit_idx=lit_idx, nb_lit=total,
                overflow=nb_seq >= cap)
