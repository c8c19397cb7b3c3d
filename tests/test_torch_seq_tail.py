"""The lazy and v3 engines' seqstore tail on the CPU: `seq_merge_plain`
(compact, rep_rewrite, merge_chains) and `finish_sequences_plain` of
zstd_tpu_torch.ops.fastmatch against zstd_tpu.ops.fastmatch's `_compact` ->
`_rep_rewrite` -> `_merge_chains` and `_finish_sequences` (vmapped over the
rows), both engines' seqstores through the wrappers against the JAX
engines, tests/seqtailmodel.py (the algorithm of csrc/seq_merge.cu and
csrc/seq_finish.cu, literals gap by gap) against the plain versions, with
the row whole and cut across a cluster of 2, 3 and 4 CTAs as the kernels
cut it (also on hand-made slot sets at the cuts' edges), the wrappers'
input checks, and chip_smoke.py's marks of what the plain outputs read
(`merge_reads`, `finish_reads`: the kernels' byte bounds count only
those). Equality is exact throughout (tolerance 0).

Rows (HASH_LOG 17, MLS 5, both engines' slots from the plain resolve):
big_corpus blocks, zero, period-4 and random rows, gen_text rows with
valid_len below n, at n = 16,384 and 8,192, at seq_cap = n / 8; the
16 KiB rows also at seq_cap 64, the overflow case, where compact drops
groups.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import seqtailmodel
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from zstd_tpu.ops import fastmatch as jfm
from zstd_tpu_torch.ops import fastmatch as tfm

HASH_LOG = 17
MLS = 5
OVERFLOW_CAP = 64


def _corpus():
    """16 KiB rows: three big_corpus blocks from three of its segments, and
    gen_text with valid_len 12,345."""
    n = 16384
    arr = np.frombuffer(big_corpus(8 * n), np.uint8).reshape(8, n)
    text = np.frombuffer(gen_text(n, seed=21)[:n], np.uint8)
    return np.stack([arr[0], arr[2], arr[5], text]), \
        np.array([n, n, n, 12345], np.int32)


def _synthetic():
    """8 KiB rows: zero, period-4, random, and gen_text with valid_len
    3,001."""
    n = 8192
    rng = np.random.default_rng(16)
    text = np.frombuffer(gen_text(n, seed=5)[:n], np.uint8)
    return np.stack([np.zeros(n, np.uint8),
                     np.tile(rng.integers(0, 256, 4, dtype=np.uint8), n // 4),
                     rng.integers(0, 256, n, dtype=np.uint8), text]), \
        np.array([n, n, n, 3001], np.int32)


ROWS = {"corpus": _corpus, "synthetic": _synthetic}
CASES = [(rows, mode, cap) for mode in tfm.MODES
         for rows, cap in (("corpus", "n/8"), ("corpus", OVERFLOW_CAP),
                           ("synthetic", "n/8"))]


def _cap(blocks, cap):
    return blocks.shape[1] // 8 if cap == "n/8" else cap


@functools.cache
def _slots(rows, mode):
    """(blocks, lens, tri, yp, yl, cand) as torch tensors: the engine's
    committed slots from the port's plain resolve."""
    blocks, lens = ROWS[rows]()
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    tri, cand_rows = tfm.engine_rows(tb, tl, HASH_LOG, MLS, mode)
    yp, yl, cand = tfm.select_resolve_plain(tb, cand_rows, tl, mode)
    return tb, tl, tri, yp, yl, cand


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_merge(yp, yl, cand, tri, cap):
    n = tri.shape[1]

    def one(yp, yl, cand, tri):
        c_pos, c_len, c_dist, c_nb = jfm._compact(yp, yl, cand, cap, n)
        c_dist = jfm._rep_rewrite(tri, c_pos, c_len, c_dist, c_nb, n)
        return jfm._merge_chains(c_pos, c_len, c_dist, c_nb, cap, n)
    return jax.vmap(one)(yp, yl, cand, tri)


@functools.partial(jax.jit, static_argnums=(7,))
def _jax_finish(blocks, tri, pos, ln, off, nb, lens, cap):
    n = blocks.shape[1]
    return jax.vmap(lambda b, t, p, l, o, c, v: jfm._finish_sequences(
        b, t, p, l, o, c, v, 0, cap, n))(blocks, tri, pos, ln, off, nb, lens)


@functools.cache
def _plain_tail(rows, mode, cap):
    """The plain merge (torch) and finish of one case."""
    tb, tl, tri, yp, yl, cand = _slots(rows, mode)
    cap = _cap(tb, cap)
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap)
    return merged, tfm.finish_sequences_plain(tb, tri, *merged, tl, cap)


@functools.cache
def _tail(rows, mode, cap):
    """The plain merge and finish of one case (numpy), and the JAX ones."""
    tb, tl, tri, yp, yl, cand = _slots(rows, mode)
    merged, fin = _plain_tail(rows, mode, cap)
    cap = _cap(tb, cap)
    j = [jnp.asarray(t.numpy()) for t in (yp, yl, cand, tri)]
    j_merged = _jax_merge(*j, cap)
    j_fin = _jax_finish(jnp.asarray(tb.numpy()), j[3],
                        *(jnp.asarray(t.numpy()) for t in merged),
                        jnp.asarray(tl.numpy()), cap)
    np_ = lambda x: np.asarray(x)          # noqa: E731
    return ([t.numpy() for t in merged], {k: v.numpy() for k, v in fin.items()},
            [np_(a) for a in j_merged], {k: np_(v) for k, v in j_fin.items()})


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_seq_merge_plain_equals_jax(rows, mode, cap):
    merged, _, j_merged, _ = _tail(rows, mode, cap)
    for want, got in zip(j_merged, merged):
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_finish_sequences_plain_equals_jax(rows, mode, cap):
    _, fin, _, j_fin = _tail(rows, mode, cap)
    assert set(fin) == set(j_fin)
    for k, want in j_fin.items():
        np.testing.assert_array_equal(want, fin[k], err_msg=k)


def test_overflow_case_drops_groups():
    """At seq_cap 64 compact drops the groups past the cap (the slot rows
    hold more), and the seqstore says overflow."""
    tb, _, _, yp, yl, cand = _slots("corpus", "lazy")
    c_nb = tfm.compact(yp, yl, cand, OVERFLOW_CAP, tb.shape[1])[3]
    assert (c_nb == OVERFLOW_CAP).all()
    merged, fin, _, _ = _tail("corpus", "lazy", OVERFLOW_CAP)
    assert fin["overflow"].tolist() == (merged[3] >= OVERFLOW_CAP).tolist()
    assert (fin["nb_lit"] > 0).all()


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_kernel_model_equals_plain(rows, mode, cap):
    """tests/seqtailmodel.py, the kernels' algorithm (group lengths from
    ends, the rewrite's compares to the first mismatch, each sequence's
    extension alone, literals gap by gap), against the plain versions on
    every row, the overflow and short rows included."""
    tb, tl, _, yp, yl, cand = _slots(rows, mode)
    c = _cap(tb, cap)
    merged, fin, _, _ = _tail(rows, mode, cap)
    blocks = tb.numpy()
    for b in range(blocks.shape[0]):
        m = seqtailmodel.merge_row(yp[b].numpy(), yl[b].numpy(),
                                   cand[b].numpy(), blocks[b], c)
        for want, got in zip(merged, m):
            np.testing.assert_array_equal(want[b], got)
        f = seqtailmodel.finish_row(blocks[b], merged[0][b], merged[1][b],
                                    merged[2][b], int(merged[3][b]),
                                    int(tl[b]), c)
        for k, got in f.items():
            np.testing.assert_array_equal(fin[k][b], got, err_msg=k)


# ---- the cluster cut: hand-made slot sets at n = 8,192 (M = 2,560 slots;
# the segments' cuts at slots 1,280 (C = 2), 856 and 1,712 (C = 3), 640,
# 1,280 and 1,920 (C = 4)) ---------------------------------------------------
BOUNDARY_N = 8192
BOUNDARY_M = BOUNDARY_N // tfm.RESOLVE_CHUNK * tfm.RESOLVE_STEPS
CUTS = sorted({lo for c in (2, 3, 4)
               for lo, _ in seqtailmodel.slot_segments(BOUNDARY_M, c)[1:]})


def _pattern_row(rng):
    """Period-4 bytes with a random byte every 61: the rewrite's compares
    agree at dists 4, 8 and 12 except near the noise."""
    row = np.tile(np.array([7, 1, 7, 2], np.uint8), BOUNDARY_N // 4)
    row[::61] = rng.integers(0, 256, len(row[::61]), dtype=np.uint8)
    return row


def _slot_row(rng, spans=((0, BOUNDARY_M),), density=0.5, chain=0.5,
              touch=0.3, force=()):
    """(yp, yl, cand) of one row: valid slots in the [lo, hi) spans with the
    given
    density; a valid slot continues the last one's chain (same start, same
    dist) with probability `chain`, starts a new group at its end with
    another dist with probability `touch` (a merge after the rewrite), else
    starts a gap later. Slots in `force` are valid and chained."""
    yp = np.full(BOUNDARY_M, -1, np.int32)
    yl = np.zeros(BOUNDARY_M, np.int32)
    cand = np.full(BOUNDARY_N, -1, np.int32)
    end, d, have = 40, 4, False
    for i in (i for lo, hi in spans for i in range(lo, hi)):
        forced = i in force
        if not forced and rng.random() >= density:
            continue
        u = rng.random()
        if have and (forced or u < chain):
            p = end
        elif have and u < chain + touch:
            p, d = end, int(rng.choice([4, 8, 12, 3, 5]))
        else:
            p = end + int(rng.integers(1, 9))
            d = int(rng.choice([4, 8, 12, 7]))
        ln = int(rng.integers(1, 9))
        if p + ln > BOUNDARY_N - 16:
            break
        yp[i], yl[i], cand[p] = p, ln, p - d
        end, have = p + ln, True
    return yp, yl, cand


def _backward_stop_row():
    """A zero row with a sequence of length 10 at dist 1 every 40 bytes (one
    slot in ten): each extends 23 bytes forward, then its successor's
    backward steps stop exactly at that end (ll 0), across every cut."""
    yp = np.full(BOUNDARY_M, -1, np.int32)
    yl = np.zeros(BOUNDARY_M, np.int32)
    cand = np.full(BOUNDARY_N, -1, np.int32)
    for j, i in enumerate(range(0, BOUNDARY_M, 10)):
        p = 50 + 40 * j
        if p + 10 > BOUNDARY_N - 16:
            break
        yp[i], yl[i], cand[p] = p, 10, p - 1
    return np.zeros(BOUNDARY_N, np.uint8), (yp, yl, cand)


def _merging_row(runs):
    """Clean period-4 bytes and, for each run length, that many contiguous
    one-slot groups of 6 bytes at dists 4 and 5 in turn (a gap of 10 bytes
    between runs): each 5 is rewritten to the 4 before it and each 4 stays
    (at distance 5 the words differ), so a run is one merged group, across
    whole CTAs' groups."""
    yp = np.full(BOUNDARY_M, -1, np.int32)
    yl = np.zeros(BOUNDARY_M, np.int32)
    cand = np.full(BOUNDARY_N, -1, np.int32)
    i, p = 0, 100
    for run in runs:
        for k in range(run):
            yp[i], yl[i], cand[p] = p, 6, p - (4 if k % 2 == 0 else 5)
            i, p = i + 1, p + 6
        p += 10
    return np.tile(np.array([7, 1, 7, 2], np.uint8), BOUNDARY_N // 4), \
        (yp, yl, cand)


def _boundary_case(name):
    """(blocks, lens, yp, yl, cand, cap) of one hand-made slot set."""
    rng = np.random.default_rng(17)
    force = {c + j for c in CUTS for j in range(-2, 3)}
    if name == "chains across cuts":
        rows = [_slot_row(rng, chain=0.6, force=force),
                _slot_row(rng, chain=0.2, touch=0.6, force=force),
                _slot_row(rng, ((500, 2100),), density=1.0, chain=1.0)]
    elif name == "empty segments":
        rows = [_slot_row(rng, ((0, 300),)),
                _slot_row(rng, ((2300, BOUNDARY_M),)),
                _slot_row(rng, ((0, 200), (2400, BOUNDARY_M)))]
    elif name == "nb below C":
        rows = [_slot_row(rng, ((1000, 1001),), density=1.0),
                _slot_row(rng, ((CUTS[0] - 1, CUTS[0] + 1),), density=1.0,
                          chain=1.0),
                _slot_row(rng, density=0.0)]
    elif name == "cap 64 mid-segment":
        rows = [_slot_row(rng, density=0.05, chain=0.0, touch=0.0),
                _slot_row(rng, chain=0.6, force=force)]
    elif name == "merges across whole CTAs":
        rows = [_merging_row([400]), _merging_row([150, 250])]
        return (np.stack([r[0] for r in rows]),
                np.full(2, BOUNDARY_N, np.int32),
                *(np.stack(a) for a in zip(*(r[1] for r in rows))),
                BOUNDARY_N // 8)
    else:
        blocks, slots = _backward_stop_row()
        return (blocks[None], np.array([BOUNDARY_N], np.int32),
                *(a[None] for a in slots), BOUNDARY_N // 8)
    blocks = np.stack([_pattern_row(rng) for _ in rows])
    lens = np.full(len(rows), BOUNDARY_N, np.int32)
    lens[-1] = BOUNDARY_N - 100
    cap = 64 if name == "cap 64 mid-segment" else BOUNDARY_N // 8
    return (blocks, lens, *(np.stack(a) for a in zip(*rows)), cap)


BOUNDARY = ("chains across cuts", "empty segments", "nb below C",
            "cap 64 mid-segment", "merges across whole CTAs",
            "backward stop at the cut")
CLUSTER_CASES = [f"{r}-{m}-{c}" for r, m, c in CASES] + list(BOUNDARY)


@functools.cache
@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_bound_marks_hold_every_read(rows, mode, cap):
    """chip_smoke.py bounds the tail kernels by what `merge_reads` and
    `finish_reads` mark (cand and the row's bytes a plain output depends
    on): the plain outputs do not move when cand and the bytes change
    everywhere else, and the finish's do when every byte changes."""
    import chip_smoke
    tb, tl, tri, yp, yl, cand = _slots(rows, mode)
    B, n = tb.shape
    c = _cap(tb, cap)
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, c)
    fin = tfm.finish_sequences_plain(tb, tri, *merged, tl, c)
    at, m_read = chip_smoke.merge_reads(yp, yl, cand, c, n)
    f_read = chip_smoke.finish_reads(merged, tl, fin, n)
    gen = torch.Generator().manual_seed(17)
    noise = torch.randint(0, 256, (B, n), generator=gen, dtype=torch.uint8)
    junk = torch.randint(0, n, (B, n), generator=gen, dtype=torch.int32)

    def merge(blocks, cands):
        return tfm.seq_merge_plain(yp, yl, cands, blocks,
                                   tfm.tri_arrays(blocks)[0], c)

    def finish(blocks):
        return tfm.finish_sequences_plain(blocks, tfm.tri_arrays(blocks)[0],
                                          *merged, tl, c)

    got = merge(torch.where(m_read, tb, noise), torch.where(at, cand, junk))
    for want, out in zip(merged, got):
        assert torch.equal(want, out)
    got = finish(torch.where(f_read, tb, noise))
    for k in fin:
        assert torch.equal(fin[k], got[k]), k
    got = finish(noise)
    assert not all(torch.equal(fin[k], got[k]) for k in fin)


def _cluster_case(case):
    """(blocks, lens, yp, yl, cand, cap) as numpy, and the plain merge and
    finish (numpy) of one case."""
    if case in BOUNDARY:
        blocks, lens, yp, yl, cand, cap = _boundary_case(case)
        tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
        tri = tfm.tri_arrays(tb)[0]
        merged = tfm.seq_merge_plain(*(torch.from_numpy(a)
                                       for a in (yp, yl, cand)), tb, tri, cap)
        fin = tfm.finish_sequences_plain(tb, tri, *merged, tl, cap)
    else:
        rows, mode, c = case.split("-")
        c = OVERFLOW_CAP if c == str(OVERFLOW_CAP) else c
        tb, tl, _, *slots = _slots(rows, mode)
        blocks, lens = tb.numpy(), tl.numpy()
        yp, yl, cand = (t.numpy() for t in slots)
        cap = _cap(tb, c)
        merged, fin = _plain_tail(rows, mode, c)
    return (blocks, lens, yp, yl, cand, cap), \
        ([t.numpy() for t in merged], {k: v.numpy() for k, v in fin.items()})


def test_boundary_cases_reach_their_edges():
    """The hand-made slot sets hold what their names say, on the plain
    versions: chains across every cut, segments without a valid slot, nb
    below 4, compact's drop past the first segment at cap 64, 400 groups
    merged into one (and into two), and every backward extension stopped
    at its predecessor's forward end."""
    (_, _, yp, yl, *_), _ = _cluster_case("chains across cuts")
    for cut in CUTS:
        assert (yl[:2, cut - 2:cut + 3] > 0).all()
        assert (yp[:2, cut - 1:cut + 3]
                == (yp + yl)[:2, cut - 2:cut + 2]).all()
    (_, _, _, yl, *_), _ = _cluster_case("empty segments")
    segs = seqtailmodel.slot_segments(BOUNDARY_M, 4)
    assert all((yl[:, lo:hi] > 0).any(1).tolist().count(False) >= 1
               for lo, hi in segs)
    _, (merged, _) = _cluster_case("nb below C")
    assert merged[3].tolist() == [1, 1, 0]
    (_, _, _, yl, cand, cap), (merged, _) = _cluster_case("cap 64 mid-segment")
    assert (merged[3] <= cap).all()
    drop = np.flatnonzero(np.cumsum(yl[0] > 0) == cap + 1)[0]
    assert drop > segs[1][0]                   # past the first CTA's slots
    (_, _, yp, yl, cand, cap), (merged, _) = _cluster_case(
        "merges across whole CTAs")
    assert merged[3].tolist() == [1, 2]
    assert merged[1][0, 0] == 400 * 6
    assert (tfm.compact(*(torch.from_numpy(a) for a in (yp, yl, cand)), cap,
                        BOUNDARY_N)[3] == 400).all()
    _, (merged, fin) = _cluster_case("backward stop at the cut")
    nb = int(merged[3][0])
    assert nb > 100 and (fin["ll"][0, 1:nb] == 0).all()


@pytest.mark.parametrize("ctas", (1, 2, 3, 4))
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_cluster_model_equals_plain(case, ctas):
    """tests/seqtailmodel.py with the row cut across `ctas` CTAs (each part
    alone, joined by the carries that cross the cluster) against
    seq_merge_plain and finish_sequences_plain: the corpus and synthetic
    cases and the hand-made edges of the cut, tolerance 0."""
    (blocks, lens, yp, yl, cand, cap), (merged, fin) = _cluster_case(case)
    for b in range(blocks.shape[0]):
        m = seqtailmodel.merge_row(yp[b], yl[b], cand[b], blocks[b], cap,
                                   ctas)
        for want, got in zip(merged, m):
            np.testing.assert_array_equal(want[b], got)
        f = seqtailmodel.finish_row(blocks[b], merged[0][b], merged[1][b],
                                    merged[2][b], int(merged[3][b]),
                                    int(lens[b]), cap, ctas)
        for k, got in f.items():
            np.testing.assert_array_equal(fin[k][b], got, err_msg=k)


ENGINES = {"lazy": (jfm.extract_batch_lazy, tfm.extract_batch_lazy,
                    dict(depth=8)),
           "v3": (jfm.extract_batch_v3, tfm.extract_batch_v3, {})}


@pytest.mark.parametrize("engine, rows, cap", [
    ("lazy", "synthetic", "n/8"), ("v3", "corpus", OVERFLOW_CAP)])
def test_seqstore_through_the_wrappers(engine, rows, cap):
    """extract_batch_lazy (depth 8) and extract_batch_v3, whose tail is now
    seq_merge and finish_sequences, equal the JAX engines."""
    blocks, lens = ROWS[rows]()
    c = _cap(blocks, cap)
    jfn, tfn, kw = ENGINES[engine]
    want = jax.jit(lambda b, v: jfn(b, v, HASH_LOG, MLS, c, **kw))(
        jnp.asarray(blocks), jnp.asarray(lens))
    got = tfn(torch.from_numpy(blocks), torch.from_numpy(lens), HASH_LOG,
              MLS, c)
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(w), got[k].numpy(),
                                      err_msg=k)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    tb, tl, tri, yp, yl, cand = _slots("synthetic", "lazy")
    cap = tb.shape[1] // 8
    merged = tfm.seq_merge(yp, yl, cand, tb, tri, cap)
    for want, got in zip(tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap),
                         merged):
        assert torch.equal(want, got)
    fin = tfm.finish_sequences(tb, tri, *merged, tl, cap)
    want = tfm.finish_sequences_plain(tb, tri, *merged, tl, cap)
    for k in want:
        assert torch.equal(want[k], fin[k]), k


def test_cluster_size_choice_and_checks():
    """The CTAs a row come from the clusters the card holds at once (the
    fewest waves over C, the larger C on a tie; a size the card refuses is
    skipped, and so is a size that reads the row from device memory where
    another holds it in shared memory), a cluster size outside 2-4 raises
    before any launch, and the per-phase cycle counts exist only on a
    card."""
    from zstd_tpu_torch import _kernels
    assert _kernels.fewest_waves(32, [66, 39, 30]) == 3
    assert _kernels.fewest_waves(1, [66, 39, 30]) == 4
    assert _kernels.fewest_waves(128, [66, 39, 30]) == 2
    assert _kernels.fewest_waves(32, [66, 0, -8]) == 2
    # seq_merge on the main path's rows (n = 131,072, cap 16,384): the card
    # holds 66, 39 and 30 clusters, but C = 2 takes the global route
    merge_held = [False, True, True]
    for B, want in ((32, 3), (64, 3), (67, 3), (128, 4)):
        assert _kernels.fewest_waves(B, [66, 39, 30], merge_held) == want, B
    # no size holds the row: the waves alone decide
    assert _kernels.fewest_waves(128, [66, 39, 30], [False] * 3) == 2
    # the only held size refused by the card: the others still count
    assert _kernels.fewest_waves(64, [66, 0, 30], [False, True, False]) == 2
    tb, tl, tri, yp, yl, cand = _slots("synthetic", "lazy")
    cap = tb.shape[1] // 8
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap)
    with pytest.raises(ValueError, match="ctas must be one of"):
        tfm.seq_merge_cycles(*_meta(yp, yl, cand, tb, tri), cap, ctas=5)
    with pytest.raises(ValueError, match="ctas must be one of"):
        tfm.finish_sequences_cycles(*_meta(tb, tri, *merged, tl), cap, ctas=1)
    with pytest.raises(ValueError, match="come from the CUDA kernel"):
        tfm.seq_merge_cycles(yp, yl, cand, tb, tri, cap)
    with pytest.raises(ValueError, match="come from the CUDA kernel"):
        tfm.finish_sequences_cycles(tb, tri, *merged, tl, cap)


def _meta(*ts):
    return [t.to("meta") for t in ts]


def test_wrappers_raise_off_the_cpu_and_never_run_the_plain():
    """A tensor on the meta device raises (not run on the CPU); a wrong
    dtype or shape raises before that."""
    tb, tl, tri, yp, yl, cand = _slots("synthetic", "lazy")
    cap = tb.shape[1] // 8
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap)
    m_args = _meta(yp, yl, cand, tb, tri)
    f_args = _meta(tb, tri, *merged, tl)
    with pytest.raises(ValueError, match="seq_merge: unsupported device"):
        tfm.seq_merge(*m_args, cap)
    with pytest.raises(ValueError,
                       match="finish_sequences: unsupported device"):
        tfm.finish_sequences(*f_args, cap)
    bad = dict(yp=m_args[0].to(torch.int64), yl=m_args[1][:, :-4],
               cand=m_args[2].to(torch.float32), blocks=m_args[3][:1])
    for i, name in enumerate(("yp", "yl", "cand", "blocks")):
        args = list(m_args)
        args[i] = bad[name]
        with pytest.raises(ValueError, match="must be a contiguous"):
            tfm.seq_merge(*args, cap)
    for i, name in ((1, "tri"), (2, "seq_pos"), (5, "nb_seq"),
                    (6, "valid_lens")):
        args = list(f_args)
        args[i] = args[i].to(torch.int64) if name != "tri" else \
            args[i].to(torch.uint8)
        with pytest.raises(ValueError, match=f"{name} must be a contiguous"):
            tfm.finish_sequences(*args, cap)
    args = list(f_args)
    args[3] = args[3][:, :-1]                       # seq_len of cap - 1
    with pytest.raises(ValueError, match="seq_len must be a contiguous"):
        tfm.finish_sequences(*args, cap)
