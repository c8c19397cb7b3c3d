"""A Python model of csrc/extract.cu's segment-parallel greedy walk.

The kernel cuts a row's positions [0, vl - 8) into S segments. Each warp
walks the greedy chain from its segment's start (speculate), the true chain
is followed into each segment from the previous segment's exit until it
meets a speculative match start (repair, in rounds), and a prefix sum over
the per-segment match counts places every match (emit). `segment_walk`
mirrors those phases for one row; tests/test_torch_extract.py holds it to
extract_plain, and tools/torch_walk_counts.py counts its steps on corpus
blocks. Test and analysis code only: zstd_tpu_torch does not use it.
"""

import torch

from zstd_tpu_torch.ops import match as tmatch
from zstd_tpu_torch.ops.resolve import _lcp
from zstd_tpu_torch.ops.seqextract import next_possible

END = 1 << 31      # exit of a chain that takes no more match


def propose_np(blocks, lens, hash_log, mls):
    """cands and nxt (numpy) from the port's propose ops."""
    tb = torch.from_numpy(blocks.copy())
    w32 = tmatch.words_at(tb)
    cands = tmatch.prev_same_bucket(
        tmatch.hash_positions(tb, hash_log, mls, w32), torch.from_numpy(lens))
    return cands.numpy(), next_possible(tb, cands, w32).numpy()


def segment_walk(buf, cand, nxt, vl, cap, S):
    """speculate -> repair -> emit over S segments; returns the row's
    (ll, off, ml, lits, stats) with stats = (longest speculative walk,
    repair steps, repair rounds, most repair steps of one segment in one
    round)."""
    limit = vl - 8
    seg = max(-(-limit // S), 1)
    starts = [min(w * seg, max(limit, 0)) for w in range(S + 1)]

    def first(p):      # the first match start at or after p
        m = nxt[p] if p < limit else END
        return m if m < limit else END

    def walk(m, end, spec=()):
        """Matches from start m while m < end; stops early where m meets a
        start of `spec`. Returns (matches, index of the meeting, exit)."""
        recs, j = [], 0
        while m < end:
            while j < len(spec) and spec[j][0] < m:
                j += 1
            if j < len(spec) and spec[j][0] == m:
                return recs, j, None
            c = cand[m]
            l = _lcp(buf, m, c, vl - m)
            assert l >= 4, (m, c, l)    # nxt[p] < vl - 8 always matches
            recs.append((m, l, c))
            m = first(m + l)
        return recs, len(spec), m

    entry = [first(starts[w]) for w in range(S)]
    spec, spec_exit = [], []
    for w in range(S):
        recs, _, ex = walk(entry[w], starts[w + 1])
        spec.append(recs)
        spec_exit.append(ex)
    lists, exits = [list(r) for r in spec], list(spec_exit)
    repair_steps = rounds = worst = 0
    while True:     # a round repairs every segment whose entry moved
        seen = [entry[0]] + exits[:-1]
        todo = [w for w in range(S) if seen[w] != entry[w]]
        if not todo:
            break
        rounds += 1
        for w in todo:
            pre, j, ex = walk(seen[w], starts[w + 1], spec[w])
            repair_steps += len(pre)
            worst = max(worst, len(pre))
            lists[w] = pre + spec[w][j:]
            exits[w] = spec_exit[w] if ex is None else ex
            entry[w] = seen[w]

    matches = [r for lst in lists for r in lst][:cap]
    ll, off, ml, lits = [], [], [], bytearray()
    anchor = 0
    for m, l, c in matches:
        d = m - c
        s = m
        while s > anchor and s > d and buf[s - 1] == buf[s - 1 - d]:
            s -= 1
        lits += buf[anchor:s]
        ll.append(s - anchor)
        off.append(d)
        ml.append(l + m - s)
        anchor = m + l
    lits += buf[anchor:max(vl, anchor)]
    return ll, off, ml, bytes(lits), (max(map(len, spec)), repair_steps,
                                       rounds, worst)
