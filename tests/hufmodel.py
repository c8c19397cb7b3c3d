"""A Python model of csrc/huf_decode.cu's segment-parallel Huffman decode.

A lane decodes backward from bit position start_bits: the step at position
p reads idx = win(min(p, W - 1)) (bits [p - 11, p) of the stream, zeros
below bit 0, W = 8 * byte_cap + 1), emits sym[idx] and moves to
p - len[idx]. Lengths are >= 1, so positions fall strictly.

The kernel (one CTA a lane) splits that chain in three:
  - head: while p > W - 1 every step reads the same window win(W - 1), so
    the count of those steps and the position after them are closed form;
  - segments: positions (0, T0] are cut into segments of K positions,
    segment s holding (s K, min((s + 1) K, T0)]; each thread walks one
    segment from its top (speculate; the top segment starts at T0 and is
    right), marking every position it visits in a bitmap. A Huffman decode
    begun at a wrong position falls into step with the true one after a
    few symbols, so most speculative walks end where the true walk ends.
    Repair rounds re-walk each segment whose entry (the exit of the
    segment above) differs from the one it walked, until it meets a
    position of its speculative path (the rest of the path, its exit and
    its symbol count, a popcount of the bitmap, are then known) or leaves
    the segment; rounds run until no entry changed. A CTA-wide prefix sum
    of the counts places each segment's first symbol, and a write pass
    walks each segment from its true entry and stores its symbols;
  - tail: once p <= 0 every step reads win(0) = 0, index 0, so the
    remaining symbols are sym[0] and final = p - (n - C) * len[0].

`decode_lane` runs those phases for one lane and returns the symbols, the
final position and the kernel's counts; tests/test_torch_huf_segments.py
holds it to huf_decode_plain and tools/torch_huf_counts.py prints its
counts. Test and analysis code only: zstd_tpu_torch does not use it.
"""

import numpy as np

MAX_TLOG = 11
K_KERNEL = 512         # the segment of csrc/huf_decode.cu, in bit positions


def windows(row: np.ndarray) -> list:
    """win[q] for q in [0, 8 * len(row)]: bits [q - 11, q) of the stream,
    bit q - 1 most significant, zeros below bit 0."""
    pb = np.pad(row.astype(np.int64), (2, 2))
    word = pb[:-2] | (pb[1:-1] << 8) | (pb[2:] << 16)
    q = np.arange(8 * len(row) + 1) + 5
    return ((word[q >> 3] >> (q & 7)) & ((1 << MAX_TLOG) - 1)).tolist()


def _i32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def decode_lane(win, start, n_syms, sym, ln, max_syms, K=K_KERNEL):
    """One lane through the kernel's phases. win from `windows` (the lane's
    whole byte_cap row), sym/ln the lane's table (2048 ints each, lengths
    >= 1). Returns (symbols [n], final, counts) with n = clip(n_syms, 0,
    max_syms) and counts = (segments, repair rounds, longest speculative
    walk, critical path in dependent steps: the longest speculative walk,
    plus the longest re-walk of each repair round, plus the longest write
    walk)."""
    w1 = len(win) - 1
    n = min(max(n_syms, 0), max_syms)
    if n == 0:
        return [], start, (0, 0, 0, 0)
    c, t0 = 0, start
    if start > w1:                              # head: the same window
        lc = ln[win[w1]]
        c = -(-(start - w1) // lc)
        t0 = start - c * lc
        if c >= n:
            return [sym[win[w1]]] * n, _i32(start - n * lc), (0, 0, 0, 0)
    out = [sym[win[w1]]] * c
    S = -(-t0 // K) if t0 > 0 else 0
    bottom = [s * K for s in range(S)]
    top = [min((s + 1) * K, t0) for s in range(S)]
    mark = bytearray(max(t0, 0))

    # speculate: every segment from its top
    entry, exit_, count = list(top), [0] * S, [0] * S
    for s in range(S):
        p, k = top[s], 0
        while p > bottom[s]:
            mark[p - 1] = 1
            p -= ln[win[p]]
            k += 1
        exit_[s], count[s] = p, k
    spec_exit = list(exit_)
    longest = max(count, default=0)

    # repair: rounds read the exits of the round before
    rounds, critical = 0, longest
    while True:
        need = [s for s in range(S - 1) if exit_[s + 1] != entry[s]]
        if not need:
            break
        rounds += 1
        new, most = {}, 0
        for s in need:
            e = p = exit_[s + 1]
            t = 0
            while p > bottom[s] and not mark[p - 1]:
                p -= ln[win[p]]
                t += 1
            most = max(most, t)
            if p > bottom[s]:              # met the speculative path at p
                new[s] = (e, spec_exit[s], t + sum(mark[bottom[s]:p]))
            else:
                new[s] = (e, p, t)
        for s, (e, x, k) in new.items():
            entry[s], exit_[s], count[s] = e, x, k
        critical += most

    # place and write, top segment first
    first, run = [0] * S, c
    for s in reversed(range(S)):
        first[s] = run
        run += count[s]
    final, most = None, 0
    for s in reversed(range(S)):
        if first[s] >= n:
            continue
        p, i = entry[s], first[s]
        while p > bottom[s] and i < n:
            j = win[p]
            out.append(sym[j])
            p -= ln[j]
            i += 1
            if i == n:
                final = p
        most = max(most, i - first[s])
    critical += most
    if final is None:                           # tail: index 0 from here
        p = exit_[0] if S else t0
        out += [sym[0]] * (n - run)
        final = p - (n - run) * ln[0]
    return out, _i32(final), (S, rounds, longest, critical)


def decode_lanes(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                 max_syms, K=K_KERNEL):
    """Every lane of a huf_decode_streams call (numpy inputs): (syms u8[L,
    max_syms] with zeros past each lane's n, final i32[L], counts i32[L,
    4])."""
    L = sb.shape[0]
    syms = np.zeros((L, max_syms), np.uint8)
    final = np.zeros(L, np.int32)
    counts = np.zeros((L, 4), np.int32)
    T = lut_sym.shape[0]
    for l in range(L):
        t = min(max(int(lane_tab[l]), 0), T - 1)
        got, final[l], counts[l] = decode_lane(
            windows(sb[l]), int(start_bits[l]), int(n_syms[l]),
            lut_sym[t].tolist(), lut_len[t].tolist(), max_syms, K)
        syms[l, :len(got)] = got
    return syms, final, counts


def literal_pool(sb, start_bits, n_syms, lut_sym, lut_len, lane_tab,
                 seg_start, seg_lane, seg_src, seg_is_dev, host_lits, nb_lit,
                 max_syms, npad, K=K_KERNEL):
    """The pool as the kernel builds it (numpy inputs): zeros, each lane's
    symbols at the start of its dev segment (the largest, if several; none
    without one), each host segment's bytes up to the next start or nb_lit.
    Returns (pool u8[npad], final i32[L])."""
    syms, final, _ = decode_lanes(sb, start_bits, n_syms, lut_sym, lut_len,
                                  lane_tab, max_syms, K)
    pool = np.zeros(npad, np.uint8)
    lim = min(max(nb_lit, 0), npad)
    S, H = len(seg_start), len(host_lits)
    base = np.full(sb.shape[0], -1, np.int64)
    for i in range(S):
        if seg_is_dev[i]:
            base[seg_lane[i]] = max(base[seg_lane[i]], seg_start[i])
            continue
        end = min(int(seg_start[i + 1]) if i + 1 < S else lim, lim)
        for j in range(max(int(seg_start[i]), 0), end):
            pool[j] = host_lits[min(max(seg_src[i] + j - seg_start[i], 0),
                                    H - 1)]
    for l in range(sb.shape[0]):
        n = min(max(int(n_syms[l]), 0), max_syms)
        if base[l] >= 0:
            m = max(min(n, npad - base[l]), 0)
            pool[base[l]:base[l] + m] = syms[l, :m]
    return pool, final
