"""The long path's host pieces on the CPU: the gap parser's tables
(format/ldm.GapTables, filled once a frame and copied for each gap) against
a fresh fill of each gap's window, and the long-match walk in the host C
(csrc/host/ldm.c, ShardedLdmState.find_long_matches) against the Python
walk that zstd_tpu's ShardedLdmState runs, transcribed below."""

import dataclasses

import numpy as np
import pytest

from tests.longcorpus import long_corpus
from zstd_tpu_torch import native
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
