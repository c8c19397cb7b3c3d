"""A Python model of csrc/fse_chain.cu's cut-and-resolve state chain.

One FSE step maps the encoder state x to st[(x >> nb(x)) + df[s]] with
nb(x) = (x + dn[s]) >> 16, and x >> nb(x) covers exactly [p_s, 2 p_s) for a
symbol of normalized count p_s: after the step the state is one of p_s
candidates st[df[s] + p_s + j], j < p_s. The kernel cuts each stream's chain
(walk order q = 0 .. nb_seq - 2, sequence i = nb_seq - 2 - q) into windows
of W steps and cuts each window right after its step with the fewest
candidates, max(p, 1) (the first such step on ties). Every candidate entry
state of every segment is walked to the next cut and its exit recorded as
a candidate index there (candidate walk); one pass over the segments picks each segment's true entry
(resolve); each segment is walked again from it and writes its states
(replay). `chain_fields` mirrors those phases for a batch and assembles the
field list as the kernel's write phase does; tests/test_torch_fse_chain.py
holds it to fse_fields_plain and tools/torch_chain_counts.py prints its
counts. Test and analysis code only: zstd_tpu_torch does not use it.
"""

import numpy as np

from zstd_tpu_torch.constants import (LL_BITS, LL_DEFAULT_DIST, LL_DEFAULT_LOG,
                                      MAX_LL_CODE, MAX_ML_CODE, ML_BITS,
                                      ML_DEFAULT_DIST, ML_DEFAULT_LOG,
                                      OF_DEFAULT_DIST, OF_DEFAULT_LOG)
from zstd_tpu_torch.format import fse
from zstd_tpu_torch.ops.fse_enc import STATE_TABLE_PAD, SYM_PAD, T_LL, T_ML, T_OF
from zstd_tpu_torch.pipeline import _pad_ct

W_KERNEL = 64        # the window of csrc/fse_chain.cu
FIELD_STREAMS = (T_OF, T_ML, T_LL)   # stream of field slots 0, 1, 2


def p_closed_form(dn: int) -> int:
    """A symbol's normalized count (1 for -1, 0 if absent) from its
    delta_nb alone: m = (dn >> 16) + 1, p = ((m << 16) - dn) >> m."""
    m = (dn >> 16) + 1
    return ((m << 16) - dn) >> m


def stream_chain(codes, x0, st, dn, df, W):
    """One stream's chain by cut / candidate walk / resolve / replay.
    codes: the symbols in walk order (nb_seq - 1 of them); x0 the init
    state. Returns (states, nbits per step, final state, counts) with counts
    = (segments, longest segment, most candidates, candidate walk steps)."""
    L = len(codes)
    p = [p_closed_form(int(dn[s])) for s in codes]
    cnt = [min(max(v, 1), STATE_TABLE_PAD) for v in p]
    base = [int(df[s]) + v for s, v in zip(codes, p)]
    n = -(-L // W)
    cuts = []
    for w in range(n):
        lo, hi = w * W, min(w * W + W, L)
        cuts.append(min(range(lo, hi), key=lambda q: (cnt[q], q)))
    starts = [0] + [c + 1 for c in cuts]
    ends = [c + 1 for c in cuts] + [L]
    ent = [1] + [cnt[c] for c in cuts]

    def entry(k, j):
        return x0 if k == 0 else int(st[base[cuts[k - 1]] + j])

    def step(x, q):
        nb = (x + int(dn[codes[q]])) >> 16
        return nb, (x >> nb) + int(df[codes[q]])

    maps = []                       # candidate walk: exits as cut indices
    for k in range(n):
        row = []
        for j in range(ent[k]):
            x = entry(k, j)
            for q in range(starts[k], ends[k] - 1):
                x = int(st[step(x, q)[1]])
            idx = step(x, ends[k] - 1)[1]
            row.append(min(max(idx - base[cuts[k]], 0), cnt[cuts[k]] - 1))
        maps.append(row)
    true = [0]                      # resolve
    for k in range(n):
        true.append(maps[k][true[k]])
    states, nbits = [0] * L, [0] * L   # replay
    for k in range(n + 1):
        x = entry(k, true[k])
        for q in range(starts[k], ends[k]):
            nb, idx = step(x, q)
            states[q], nbits[q] = x, nb
            x = int(st[idx])
        if k == n:
            final = x
    longest = max(e - s for s, e in zip(starts, ends))
    walked = sum(ent[k] * (ends[k] - starts[k]) for k in range(n))
    return states, nbits, final, (n + 1, longest, max(ent), walked)


def _init_state(st, dn, df, sym):
    d = int(dn[sym])
    nb_out = (d + (1 << 15)) >> 16
    return int(st[(((nb_out << 16) - d) >> nb_out) + int(df[sym])])


def chain_fields(args, W=W_KERNEL):
    """fse_fields on numpy inputs (llc, mlc, ofc, llx, mlb, ob, nb, st, dn,
    df, tl) through the model: (values, nbits i32[B, 6 cap + 4], counts
    i32[B, 3, 4]). A stream whose table log is 0 (RLE) is all zero and has
    no segments, as in the kernel."""
    llc, mlc, ofc, llx, mlb, ob, nbs, st, dn, df, tl = (np.asarray(a)
                                                        for a in args)
    B, cap = llc.shape
    M = 6 * cap + 4
    vals = np.zeros((B, M), np.int64)
    nbits = np.zeros((B, M), np.int64)
    counts = np.zeros((B, 3, 4), np.int64)
    codes_of = {T_LL: llc, T_OF: ofc, T_ML: mlc}
    for b in range(B):
        nb = min(max(int(nbs[b]), 0), cap)
        chains = {}
        for t in (T_LL, T_OF, T_ML):
            sym = np.clip(codes_of[t][b, :nb], 0, SYM_PAD - 1).astype(int)
            if nb == 0 or tl[b, t] == 0:
                chains[t] = ([0] * max(nb - 1, 0), [0] * max(nb - 1, 0), 0)
                continue
            x0 = _init_state(st[b, t], dn[b, t], df[b, t], sym[nb - 1])
            *chains[t], counts[b, t] = stream_chain(
                sym[:nb - 1][::-1].tolist(), x0, st[b, t], dn[b, t],
                df[b, t], W)
        for i in range(nb):
            f = 6 * (cap - 1 - i)
            if i < nb - 1:
                q = nb - 2 - i
                for slot, t in enumerate(FIELD_STREAMS):
                    vals[b, f + slot] = chains[t][0][q]
                    nbits[b, f + slot] = chains[t][1][q]
            vals[b, f + 3:f + 6] = llx[b, i], mlb[b, i], ob[b, i]
            nbits[b, f + 3:f + 6] = (LL_BITS[min(max(llc[b, i], 0), 35)],
                                     ML_BITS[min(max(mlc[b, i], 0), 52)],
                                     ofc[b, i])
        if nb:
            for slot, t in enumerate((T_ML, T_OF, T_LL)):
                vals[b, 6 * cap + slot] = chains[t][2]
                nbits[b, 6 * cap + slot] = tl[b, t]
        vals[b, M - 1] = nbits[b, M - 1] = 1
    return vals.astype(np.int32), nbits.astype(np.int32), counts


# ---- synthetic table sets ------------------------------------------------

def _flat(n_sym, each, log):
    """n_sym symbols of normalized count `each`: every cut keeps `each`
    candidates."""
    return fse.build_ctable(np.full(n_sym, each, np.int32), n_sym - 1, log)


def _predefined(t):
    dist, log = {T_LL: (LL_DEFAULT_DIST, LL_DEFAULT_LOG),
                 T_OF: (OF_DEFAULT_DIST, OF_DEFAULT_LOG),
                 T_ML: (ML_DEFAULT_DIST, ML_DEFAULT_LOG)}[t]
    norm = np.asarray(dist, np.int32)
    return fse.build_ctable(norm, len(norm) - 1, log)


def _random_table(rng, t):
    """A table normalized from a skewed random histogram, as the planner
    builds one for a block."""
    mx = {T_LL: MAX_LL_CODE, T_OF: 31, T_ML: MAX_ML_CODE}[t]
    log_max = 8 if t == T_OF else 9
    n_used = int(rng.integers(2, mx + 2))
    count = np.zeros(mx + 1, np.int64)
    used = rng.choice(mx + 1, n_used, replace=False)
    count[used] = (rng.pareto(1.0, n_used) * 50).astype(np.int64) + 1
    top = int(np.nonzero(count)[0][-1])
    total = int(count.sum())
    log = fse.optimal_table_log(log_max, total, top)
    norm = fse.normalize_count(count[:top + 1], log, total, top, total >= 2048)
    return fse.build_ctable(norm, top, log)


def _draw_codes(rng, ct, n):
    """n symbols drawn from the symbols the table can encode, weighted by
    their normalized counts."""
    if ct.table_log == 0:
        return np.full(n, ct.max_symbol, np.int32)
    p = np.array([p_closed_form(int(d)) for d in ct.delta_nb_bits], float)
    return rng.choice(len(p), n, p=p / p.sum()).astype(np.int32)


# name -> per stream: "flat" (no symbol of count 1), "rle", "pre"
# (predefined) or "rand"; and nb_seq ("cap" for the cap row)
SYNTHETIC_ROWS = {
    "flat": (("flat", "flat", "flat"), "cap"),
    "rle": (("rle", "rle", "rle"), "cap"),
    "predefined": (("pre", "pre", "pre"), "cap"),
    "mixed": (("rle", "pre", "flat"), "cap"),
    "nb0": (("pre", "pre", "pre"), 0),
    "nb1": (("rand", "rand", "rand"), 1),
    "nb2": (("rand", "flat", "pre"), 2),
    "random_cap": (("rand", "rand", "rand"), "cap"),
    "random_half": (("rand", "rand", "rand"), "half"),
}


def synthetic_batch(cap, seed=0, rows=tuple(SYNTHETIC_ROWS)):
    """numpy inputs of fse_fields, one row per name of SYNTHETIC_ROWS, with
    tables from format/fse.py and extras within their bit widths."""
    rng = np.random.default_rng(seed)
    B = len(rows)
    codes = np.zeros((3, B, cap), np.int32)      # LL, OF, ML
    st = np.zeros((B, 3, STATE_TABLE_PAD), np.int32)
    dn = np.zeros((B, 3, SYM_PAD), np.int32)
    df = np.zeros((B, 3, SYM_PAD), np.int32)
    tl = np.zeros((B, 3), np.int32)
    nb = np.zeros(B, np.int32)
    for b, name in enumerate(rows):
        kinds, n = SYNTHETIC_ROWS[name]
        nb[b] = {"cap": cap, "half": cap // 2 + 3}.get(n, n)
        for t, kind in zip((T_LL, T_OF, T_ML), kinds):
            if kind == "flat":
                ct = _flat(4, 64, 8) if t == T_OF else _flat(4, 128, 9)
            elif kind == "rle":
                ct = fse.build_ctable_rle(int(rng.integers(0, 28)))
            elif kind == "pre":
                ct = _predefined(t)
            else:
                ct = _random_table(rng, t)
            st[b, t], dn[b, t], df[b, t], tl[b, t] = _pad_ct(ct)
            codes[t, b, :nb[b]] = _draw_codes(rng, ct, nb[b])
    llc, ofc, mlc = codes
    llx = (rng.integers(0, 1 << 16, (B, cap))
           & ((1 << LL_BITS[np.clip(llc, 0, 35)]) - 1)).astype(np.int32)
    mlb = (rng.integers(0, 1 << 16, (B, cap))
           & ((1 << ML_BITS[np.clip(mlc, 0, 52)]) - 1)).astype(np.int32)
    ob = (rng.integers(0, 1 << 31, (B, cap))
          & ((1 << ofc.astype(np.int64)) - 1)).astype(np.int32)
    for x in (llx, mlb, ob, llc, ofc, mlc):
        x[np.arange(cap)[None, :] >= nb[:, None]] = 0
    return llc, mlc, ofc, llx, mlb, ob, nb, st, dn, df, tl
