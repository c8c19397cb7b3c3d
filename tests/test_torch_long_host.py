"""The long path's host pieces on the CPU: the gap parser's tables
(format/ldm.GapTables, filled once a frame and copied for each gap) against
a fresh fill of each gap's window; the block's gaps parsed in one C call
(GapTables.parse_block, csrc/host/ldm.c's zt_ldm_gap_parse: the tables
written in place and undone after each gap) against the per-gap loop
(format/ldm._gap_parse_plain), its tables against the fill alone, its
counters, and whole frames against the per-gap path; and the long-match
walk in the host C (csrc/host/ldm.c, ShardedLdmState.find_long_matches)
against the Python walk that zstd_tpu's ShardedLdmState runs, transcribed
below."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from tests.longcorpus import long_corpus
from zstd_tpu_torch import native
from zstd_tpu_torch.format import block as tblock
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.format import ldm as tldm
from zstd_tpu_torch.format import opt as topt
from zstd_tpu_torch.params import get_cparams
from zstd_tpu_torch.parallel import ldm_sharded as tl

DATA = long_corpus(512 * 1024, seg=128 * 1024)
FULL = np.frombuffer(DATA, dtype=np.uint8)


def _walk_py(full, anchors, cands, block_start, block_end, window):
    """zstd_tpu's ShardedLdmState.find_long_matches, over plain arrays."""
    n = len(full)
    lo = np.searchsorted(anchors, block_start)
    hi = np.searchsorted(anchors, max(block_end - tldm.LDM_MIN_MATCH,
                                      block_start))
    out, cursor = [], block_start
    for ai in range(lo, hi):
        p = int(anchors[ai])
        if p < cursor:
            continue
        best_len, best_c = 0, -1
        for c in cands[ai]:
            c = int(c)
            if c < 0 or c >= p or p - c > window:
                continue
            limit = min(block_end - p, n - p)
            ln = 0
            while ln < limit and full[p + ln] == full[c + ln]:
                ln += 1
            if ln > best_len:
                best_len, best_c = ln, c
        if best_len >= tldm.LDM_MIN_MATCH:
            s, c2 = p, best_c
            while s > cursor and c2 > 0 and full[s - 1] == full[c2 - 1]:
                s, c2, best_len = s - 1, c2 - 1, best_len + 1
            out.append((s, best_len, s - c2))
            cursor = s + best_len
    return out


def _crafted(seed: int):
    """Random bytes of repeated motifs, random anchors, and candidates that
    hit every test of the walk: empty slots, candidates at or past the
    anchor, past the window, true repeats (equal ones tie), near misses."""
    rng = np.random.default_rng(seed)
    motif = rng.integers(0, 4, 3000, dtype=np.uint8)
    parts = []
    for _ in range(12):
        part = motif.copy()
        for _ in range(6):
            at = int(rng.integers(0, len(part)))
            part[at] = rng.integers(0, 256)
        parts.append(part)
    full = np.concatenate(parts)
    n = len(full)
    anchors = np.unique(rng.integers(1, n - 64, 1500)).astype(np.int64)
    cands = np.full((len(anchors), tldm.LDM_BUCKET), -1, dtype=np.int32)
    for i, p in enumerate(anchors):
        for b in range(tldm.LDM_BUCKET):
            kind = rng.integers(0, 6)
            if kind == 1:
                c = p - 3000 * int(rng.integers(1, 4))
            elif kind == 2:
                c = p - 3000
            elif kind == 3:
                c = p + int(rng.integers(0, 50))
            elif kind == 4:
                c = int(rng.integers(0, n))
            else:
                continue
            cands[i, b] = c if 0 <= c < n else -1
    return full, anchors, cands


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("window", [2999, 3000, 6000, 1 << 20])
def test_walk_equals_python_on_crafted_candidates(seed, window):
    full, anchors, cands = _crafted(seed)
    n = len(full)
    rng = np.random.default_rng(seed + 100)
    bounds = [(0, n), (0, 4096), (5000, 5031), (5000, 5033), (n - 900, n)]
    bounds += [tuple(sorted(rng.integers(0, n, 2))) for _ in range(20)]
    hits = 0
    for b, e in bounds:
        want = _walk_py(full, anchors, cands, b, e, window)
        lo = int(np.searchsorted(anchors, b))
        hi = int(np.searchsorted(anchors, max(e - tldm.LDM_MIN_MATCH, b)))
        got = native.ldm_walk(full, b, e, anchors, cands, lo, hi, window,
                              tldm.LDM_MIN_MATCH)
        assert list(map(tuple, got.tolist())) == want, (b, e)
        hits += len(want)
    # the motif repeats 3000 B apart: a narrower window refuses every match
    assert (hits > 0) == (window >= 3000)


def test_walk_equals_python_over_the_discovery():
    st = tl.ShardedLdmState(FULL, 20, device="cpu")
    total = 0
    for b in range(0, len(FULL), 1 << 17):
        e = min(len(FULL), b + (1 << 17))
        want = _walk_py(FULL, st.anchors, st.cands, b, e, st.window_size)
        assert st.find_long_matches(b, e) == want
        total += len(want)
    assert total > 0


def _gaps(n: int, seed: int):
    """(gs, ge) gaps in position order from 128 KiB on, split by long
    matches of 32 B to 5 KiB, as find_sequences_ldm hands them to the inner
    parser."""
    rng = np.random.default_rng(seed)
    out, gs = [], (1 << 17) + int(rng.integers(0, 64))
    while gs < n:
        ge = min(n, gs + int(rng.integers(0, 40_000)))
        out.append((gs, ge))
        gs = ge + int(rng.integers(32, 5_000))
    return out


@pytest.mark.parametrize("order", ["ascending", "reset", "widen"])
@pytest.mark.parametrize("level", [3, 5, 7, 10])
def test_gap_tables_parse_as_a_fresh_fill(level, order):
    """Each gap parsed on GapTables' copy gives the sequences and reps that
    tables filled afresh over its window give; windows of 64 KiB, less
    than the chain table's reach at level 10, move the window low. In
    "reset" order every fourth gap goes back to an earlier one, and in
    "widen" order every fourth gap's window reaches back to 0: both refill
    the tables."""
    cp = dataclasses.replace(get_cparams(level, len(FULL)), window_log=16)
    gaps = _gaps(len(FULL), level)
    if order == "reset":
        gaps = sum(([g, gaps[i // 2]] if i % 4 == 3 else [g]
                    for i, g in enumerate(gaps)), [])
    tabs = tldm.GapTables()
    reps, parsed = (1, 4, 8), 0
    for i, (gs, ge) in enumerate(gaps):
        wl = max(0, gs - (1 << 16))
        if order == "widen" and i % 4 == 3:
            wl = 0
        want = topt.find_sequences_chainlazy(FULL, gs, ge, wl, reps, cp)
        got = topt.find_sequences_chainlazy(
            FULL, gs, ge, wl, reps, cp, state=tabs.at(FULL, wl, gs, cp))
        assert (want is None) == (got is None)
        if want is None:
            continue
        (ws, wr), (gs_, gr) = want, got
        assert wr == gr
        for f in ("lit_length", "off_base", "ml_base"):
            assert np.array_equal(getattr(ws, f), getattr(gs_, f)), f
        assert ws.literals == gs_.literals
        parsed += len(ws.lit_length)
        reps = wr
    assert parsed > 1000


BLOCK = 1 << 15


def _block_longs(rng, b: int, e: int, reps: tuple) -> list:
    """Long matches (pos, length, dist) inside [b, e), in position order,
    as the walk hands them on: one at the block's start, at a distance
    one less than rep1 (its literal length is 0: offset value 3, rep1 - 1);
    one right after it at rep2 (an empty gap: offset value 1); gaps of
    1-15 B (too short to parse); one that ends at the block's end; long
    gaps between. The matches need not repeat bytes: the parse only reads
    around them."""
    r1, r2 = reps[0], reps[1]
    out = [(b, 40, r1 - 1)]
    pos = b + 40
    out.append((pos, 33, r1))          # rep1 - 1 became rep1, r1 rep2
    pos += 33
    while pos < e - 6000:
        pos += int(rng.choice([0, int(rng.integers(1, 16)),
                               int(rng.integers(16, 5000))]))
        ln = int(rng.integers(32, 600))
        if pos + ln > e - 200:
            break
        out.append((pos, ln, int(rng.integers(1, pos + 1))))
        pos += ln
    out.append((e - 64, 64, int(rng.integers(1, e - 64))))
    return out


def _block_order(order: str, n: int) -> list:
    """(block start, window_log) of each block: ascending from 64 KiB; in
    "reset" order every fourth block goes back to an earlier one, and in
    "widen" order every fourth block's inner window is 1 MiB, not 64 KiB:
    both reset the tables."""
    starts = list(range(1 << 16, n - BLOCK + 1, BLOCK))
    out = []
    for i, b in enumerate(starts):
        out.append((b, 16))
        if i % 4 == 3:
            if order == "reset":
                out.append((starts[i // 2], 16))
            elif order == "widen":
                out[-1] = (b, 20)
    return out


def _fill_alone(cp, start: int, upto: int) -> np.ndarray:
    tabs = np.full(topt.chainlazy_table_size(cp), -1, dtype=np.int32)
    if upto > start:
        topt.chainlazy_fill(FULL, start, upto + 7, cp, tabs)
    return tabs


@pytest.mark.parametrize("order", ["ascending", "reset", "widen"])
@pytest.mark.parametrize("level", [3, 5, 7, 10])
def test_one_call_equals_per_gap_loop(level, order):
    """Each block's sequences, reps and literals from the one C call equal
    the per-gap loop's, block after block on one table set a side; after
    each block the one call's tables are what the fill alone gives over
    [start, upto), and the resets of "reset" and "widen" order happen."""
    base = get_cparams(level, len(FULL))
    rng = np.random.default_rng(level * 7 + len(order))
    one, per = tldm.GapTables(), SimpleNamespace(gap_tables=tldm.GapTables())
    reps, seqs, resets, zero_ll_rep = (9, 4, 8), 0, 0, 0
    for b, wlog in _block_order(order, len(FULL)):
        cp = dataclasses.replace(base, window_log=wlog)
        e = b + BLOCK
        longs = _block_longs(rng, b, e, reps)
        start = one.start if one.all is not None else None
        got, gr, gaps = one.parse_block(FULL, b, e, 0, reps, cp, longs)
        want, wr = tldm._gap_parse_plain(FULL, b, e, 0, reps, cp, per,
                                         longs)
        assert gr == wr
        for f in ("lit_length", "off_base", "ml_base"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.literals == want.literals
        assert 0 < gaps <= len(longs) + 1
        assert np.array_equal(one.all,
                              _fill_alone(cp, one.start, one.upto))
        resets += start not in (None, one.start)
        zero_ll_rep += int(((want.lit_length == 0)
                            & (want.off_base == 3)).sum())
        seqs += len(want.lit_length)
        reps = wr
    assert seqs > 1000 and zero_ll_rep > 0
    assert (resets > 0) == (order != "ascending")


@pytest.mark.parametrize("lead", [0, 5, 40])
@pytest.mark.parametrize("dist", [9, 4, 7, 10, 100])
def test_one_call_long_match_offset_values(lead, dist):
    """A block of one long match after `lead` bytes and a tail under 16 B,
    at reps (10, 4, 7): its offset value and the reps after it, at
    literal length 0 (rep2, rep3, rep1 - 1, and rep1, which is no repeat
    there) and above, equal the per-gap loop's."""
    cp = get_cparams(3, len(FULL))
    b = 1 << 17
    e = b + lead + 40 + 10
    longs = [(b + lead, 40, dist)]
    got, gr, _ = tldm.GapTables().parse_block(FULL, b, e, 0, (10, 4, 7), cp,
                                              longs)
    want, wr = tldm._gap_parse_plain(
        FULL, b, e, 0, (10, 4, 7), cp,
        SimpleNamespace(gap_tables=tldm.GapTables()), longs)
    assert gr == wr
    for f in ("lit_length", "off_base", "ml_base"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.literals == want.literals
    if lead == 0:
        assert want.off_base[-1] == {9: 3, 4: 1, 7: 2}.get(dist, dist + 3)


def test_undo_log_restores_the_tables_after_a_reset():
    """A gap behind the tables' reach resets them: after it the tables are
    the fill alone over the new [start, upto), and the next block's gap
    extends them from there."""
    cp = dataclasses.replace(get_cparams(3, len(FULL)), window_log=16)
    tabs = tldm.GapTables()
    for b, start in ((3 << 17, 5 << 16), (1 << 17, 1 << 16),
                     ((1 << 17) + BLOCK, 1 << 16)):
        tabs.parse_block(FULL, b, b + BLOCK, 0, (1, 4, 8), cp,
                         [(b + 5000, 100, 3000)])
        assert (tabs.start, tabs.upto) == (start, b + 5100 - 7)
        assert np.array_equal(tabs.all,
                              _fill_alone(cp, tabs.start, tabs.upto))


@pytest.mark.parametrize("longs", [
    [(2 * BLOCK - 10, 64, 5)], [(BLOCK - 1, 64, 5)],
    [(BLOCK + 100, 64, 5), (BLOCK + 120, 64, 5)]])
def test_one_call_refuses_matches_outside_the_block(longs):
    """Long matches past the block's end, before its start or over each
    other are refused before the tables or the span change."""
    cp = get_cparams(3, len(FULL))
    tabs = tldm.GapTables()
    tabs.parse_block(FULL, 0, BLOCK, 0, (1, 4, 8), cp, [])
    before = (tabs.all.copy(), tabs.start, tabs.upto)
    with pytest.raises(ValueError, match="leave the block or overlap"):
        tabs.parse_block(FULL, BLOCK, 2 * BLOCK, 0, (1, 4, 8), cp, longs)
    assert np.array_equal(tabs.all, before[0])
    assert (tabs.start, tabs.upto) == before[1:]


SMALL = DATA[:256 * 1024]


@pytest.mark.parametrize("level", [1, 3, 19])
def test_counts_engage(monkeypatch, level):
    """format/ldm.COUNTS: at level 3 one C call parses every block's gaps;
    at levels 1 (fast) and 19 (the DP) every block takes the per-gap
    loop."""
    calls = []
    ldm_block = tblock.find_sequences_ldm

    def spy(*a, **k):
        calls.append(1)
        return ldm_block(*a, **k)

    monkeypatch.setattr(tblock, "find_sequences_ldm", spy)
    before = dict(tldm.COUNTS)
    tl.compress_long_sharded(SMALL, level=level, long_log=20, device="cpu")
    moved = {k: tldm.COUNTS[k] - v for k, v in before.items()}
    assert len(calls) >= 2
    if level == 3:
        assert moved["c_blocks"] == len(calls) and moved["py_blocks"] == 0
        assert moved["gaps"] >= len(calls)
    else:
        assert moved == {"c_blocks": 0, "py_blocks": len(calls), "gaps": 0}


@pytest.mark.parametrize("state", ["sharded", "host"])
@pytest.mark.parametrize("level", [3, 5])
def test_frames_equal_the_per_gap_path(monkeypatch, level, state):
    """compress_long_sharded's frames (device="cpu") and the host LdmState
    path's are the per-gap path's, byte for byte."""
    def run():
        if state == "sharded":
            return tl.compress_long_sharded(DATA, level=level, checksum=True,
                                            long_log=20, device="cpu")
        cp = dataclasses.replace(get_cparams(level, len(DATA)),
                                 window_log=20)
        return tframe.compress_frame(DATA, cp, checksum=True,
                                     ldm_state=tldm.LdmState(FULL, 20))

    before = dict(tldm.COUNTS)
    got = run()
    assert tldm.COUNTS["c_blocks"] > before["c_blocks"]
    monkeypatch.setattr(tblock, "find_sequences_ldm",
                        tldm.find_sequences_ldm_plain)
    before = dict(tldm.COUNTS)
    want = run()
    assert tldm.COUNTS["c_blocks"] == before["c_blocks"]
    assert got == want
