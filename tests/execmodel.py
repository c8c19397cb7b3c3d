"""A Python model of csrc/exec_seq.cu's sequence executor.

`place` is the kernel's phase 1: each output byte j < n is placed from the
sequences alone, through prefix sums over the nb valid sequences (clamped
to n) and, per lane of a warp, a binary search for the first byte's
sequence and a forward walk over the lane's every 32nd byte. It gives
exec_prepare's (ptr, in_match, placed) and worklist 0, the match bytes.

`resolve` is phases 2 and 3: each match byte's final source F and hop
count d by in-place pointer jumping over a worklist of (pointer, hops)
pairs, in passes until the list is empty, then out, ok and the rounds of
the JAX loop's out-of-place doubling in closed form: r = 1 + min(rounds,
ceil(log2 D)), D the most hops, and a byte has reached its source iff
d <= 2^r. `order` walks each pass's list forward (as the kernel's blocks
mostly do: one pass resolves all) or backward (sources not yet final: the
kernel's other blocks, at their worst), which must give the same result.

tests/test_torch_exec_fused.py holds both to exec_prepare and
exec_resolve_plain. Test and analysis code only: zstd_tpu_torch does not
use it.
"""

import numpy as np

LANES, PER = 32, 8         # a warp's lanes, and bytes a lane, per tile


def prefix(ll, ml, nb_seq, n):
    """The kernel's inputs from the wrapper's prefix sums: (seq_end,
    mstart, lit_start[nb + 1], nb), each clamped to n."""
    nb = min(max(int(nb_seq), 0), len(ll))
    llv = np.asarray(ll[:nb], np.int64)
    mlv = np.asarray(ml[:nb], np.int64)
    assert (llv >= 0).all() and (mlv >= 0).all()
    cs = np.cumsum(llv + mlv)
    lit = np.concatenate([[0], np.cumsum(llv)])
    return (np.minimum(cs, n), np.minimum(cs - mlv, n), np.minimum(lit, n),
            nb)


def place(lits, ll, ml, off, nb_seq, out_len, n):
    """Phase 1: (ptr i32[n], in_match bool[n], placed u8[n], worklist 0)."""
    seq_end, mstart, lit_start, nb = prefix(ll, ml, nb_seq, n)
    total = int(seq_end[nb - 1]) if nb else 0
    lit_cap = min(n, len(lits)) - 1
    ptr = np.zeros(n, np.int64)
    in_match = np.zeros(n, bool)
    placed = np.zeros(n, np.uint8)
    for j0 in range(0, n, LANES * PER):
        for lane in range(LANES):
            # first sequence with seq_end > j, then walk forward
            k = int(np.searchsorted(seq_end, j0 + lane, side="right"))
            for m in range(PER):
                j = j0 + lane + LANES * m
                if j >= n:
                    break
                while k < nb and seq_end[k] <= j:
                    k += 1
                p, rank = j, -1
                if k >= nb:
                    if j < out_len:
                        rank = int(lit_start[nb]) + j - total
                elif j < mstart[k]:
                    if j < out_len:
                        start = int(seq_end[k - 1]) if k else 0
                        rank = int(lit_start[k]) + j - start
                else:
                    ms, d = int(mstart[k]), max(int(off[k]), 1)
                    p = ms - d + (j - ms) % d
                    in_match[j] = True
                ptr[j] = p
                if rank >= 0:
                    placed[j] = lits[min(rank, lit_cap)]
    return ptr.astype(np.int32), in_match, placed, np.flatnonzero(in_match)


def ceil_log2(d: int) -> int:
    return (d - 1).bit_length()


def resolve(ptr, in_match, placed, history, out_len, rounds, worklist,
            order=1):
    """Phases 2 and 3: (out u8[n], ok, rounds run, entries of each pass's
    worklist, the hop count of every byte)."""
    n, h = len(ptr), len(history)
    P = [(int(p), 1 if m else 0) for p, m in zip(ptr, in_match)]
    lin, passes, D = [int(i) for i in worklist], [], 0
    while lin:
        passes.append(len(lin))
        lout = []
        for i in lin[::order]:
            q, hops = P[i]
            if q >= 0:
                q2, h2 = P[q]
                if q2 != q:                        # q is a match byte
                    hops += h2
                    P[i] = (q2, hops)
                    if q2 >= 0 and P[q2][0] != q2:  # q2 not yet final
                        lout.append(i)
                        continue
            D = max(D, hops)
        lin = lout[::order]
    r = 1 + min(rounds, ceil_log2(max(D, 1))) if len(worklist) else 0
    out = placed.copy()
    bad = False
    for j in worklist:
        F, d = P[j]
        if d <= 2 ** r:
            out[j] = history[min(max(h + F, 0), h - 1)] if F < 0 else out[F]
        else:
            out[j] = 0
            bad |= bool(j < out_len)
    return out, not bad, r, passes, np.array([d for _, d in P])


def round_changes(hops, r):
    """The pointers that round t < r of out-of-place doubling changes: the
    bytes with more than 2^t hops."""
    return [int((hops > 2 ** t).sum()) for t in range(r)]


def exec_sequences(lits, ll, ml, off, nb_seq, out_len, n, history, rounds):
    """The kernel's whole launch: (out, ok, rounds run, pass sizes,
    hops)."""
    ptr, in_match, placed, wl = place(lits, ll, ml, off, nb_seq,
                                      min(max(out_len, 0), n), n)
    return resolve(ptr, in_match, placed, history,
                   min(max(out_len, 0), n), rounds, wl)
