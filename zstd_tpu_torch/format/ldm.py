"""Long-distance matching (--long): content-defined anchor sampling over a
large window, wrapped around the inner match finder.

Copy of zstd_tpu/format/ldm.py: LdmState (the host discovery, and the
plain reference the sharded discovery of parallel/ldm_sharded.py is held
to) and find_sequences_ldm, whose inner parser is the level's own (fast,
chain-lazy or the DP, format/opt.py). Same role as the reference LDM
(zstd's lib/compress/zstd_ldm.c: gear rolling hash sampled every
2^hashRateLog bytes, bucketed candidate table,
ZSTD_ldm_blockCompress interleaving with the inner finder at
lib/compress/zstd_compress.c:3263): the anchor predicate is a
content-defined mask on a multiplicative 8-byte hash, anchors index a
bucketed recency table, and verified long matches are committed greedily
with the inner strategy compressing the gaps between them.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..constants import MIN_MATCH
from ..trace import RECORDER as _rec
from .lazy import _ext_fwd, _off_base
from .matchfinder import update_reps
from .opt import (_chainlazy_shape, chainlazy_fill, chainlazy_table_size,
                  find_sequences_chainlazy, find_sequences_fast,
                  find_sequences_opt)
from .sequences import SeqStore

LDM_MIN_MATCH = 32          # minimum long-distance match length
LDM_BUCKET = 4              # candidates kept per hash bucket
_PRIME64 = np.uint64(0xCF1BBCDCB7A56463)
_CHAINLAZY = (2, 3, 4, 5)   # the strategies whose gaps the chain-lazy C parses

# blocks whose gaps one C call parsed, blocks on the per-gap loop, and the
# gaps the C call parsed (empty ones left out)
COUNTS = {"c_blocks": 0, "py_blocks": 0, "gaps": 0}


class GapTables:
    """The chain-lazy gap parser's tables, filled once a frame.

    Each gap [gs, ge) is parsed on tables as a fresh fill over its window
    [wl, gs) leaves them. A fresh fill would index up to 1 MiB a gap;
    instead `all` indexes every position of [start, upto), from the
    frame's first window low on, in order, extended as the gaps advance.
    It differs from a fresh fill only in entries below wl (where the
    fresh one holds -1 or an older position below wl), and the parser
    takes no candidate below its window low (lz_search stops at the
    first, lz_search_long skips them), so the parse, its sequences and
    the frame are the same.

    `parse_block` parses all of a block's gaps in one C call
    (csrc/host/ldm.c) on `all` itself: each gap's table writes go to an
    undo log (`log`, kept from block to block) and are undone after it,
    so `all` is again what the fill alone left. `at` is the plain
    version: each gap parses a copy of `all` (`fast_table`)."""

    def __init__(self) -> None:
        self.all = None          # every position of [start, upto)
        self.fast_table = None   # the gap's copy (find_sequences_chainlazy)
        self.log = None          # parse_block's undo log
        self.start = 0
        self.upto = 0

    def at(self, full: np.ndarray, wl: int, gs: int, cparams) -> "GapTables":
        """Tables as a fresh fill over [wl, gs) would leave them, for the
        parser, in `fast_table`."""
        size = chainlazy_table_size(cparams)
        if (self.all is None or len(self.all) != size or self.start < 0
                or self.start > wl or self.upto > max(gs - 7, self.start)):
            self.all = np.full(size, -1, dtype=np.int32)
            self.fast_table = np.empty_like(self.all)
            self.start = self.upto = wl
        if gs - 7 > self.upto:
            chainlazy_fill(full, self.upto, gs, cparams, self.all)
            self.upto = gs - 7
        np.copyto(self.fast_table, self.all)
        return self

    def parse_block(self, full: np.ndarray, block_start: int,
                    block_end: int, window_low: int, reps: tuple, cparams,
                    longs: list) -> tuple[SeqStore, tuple, int]:
        """The block's sequences, the gaps between its long matches parsed
        as `_gap_parse_plain` parses them at strategies 2-5, in one C call:
        (SeqStore, new reps, gaps parsed)."""
        size = chainlazy_table_size(cparams)
        if self.all is None or len(self.all) != size:
            self.all = np.full(size, -1, dtype=np.int32)
            self.start = self.upto = -1     # the first gap resets
        need = 4 * (block_end - block_start)
        if self.log is None or len(self.log) < need:
            self.log = np.empty(need, dtype=np.uint64)
        span = np.array([self.start, self.upto], dtype=np.int64)
        ll, ob, mb, lits, r, gaps = native.ldm_gap_parse(
            full, block_start, block_end, window_low,
            min(1 << 20, 1 << cparams.window_log),
            np.array(longs, dtype=np.int64), reps, _chainlazy_shape(cparams),
            self.all, span, self.log)
        self.start, self.upto = int(span[0]), int(span[1])
        return SeqStore(ll, ob, mb, lits), r, gaps


class LdmState:
    """Per-frame long-range candidate table over content-defined anchors."""

    def __init__(self, full: np.ndarray, window_log: int,
                 hash_rate_log: int = 7, hash_log: int = 20):
        self.full = full
        self.window_size = 1 << window_log
        # anchor predicate uses the TOP bits of the multiplicative hash (the
        # well-mixed ones — low product bits depend only on low input bits),
        # the bucket key the next hash_log bits below them
        self.rate_shift = np.uint64(64 - hash_rate_log)
        self.hash_shift = np.uint64(64 - hash_rate_log - hash_log)
        self.hash_mask = np.uint64((1 << hash_log) - 1)
        n = len(full)
        # fingerprint spans SPAN bytes (4 strided 8-byte words): a short
        # window would collide constantly on low-vocabulary data and evict
        # the long-distance bucket entries (the reference's gear hash rolls
        # a ~64-byte window for the same reason)
        SPAN = 64
        n_pos = max(n - SPAN + 1, 0)
        if n_pos == 0:
            self.h = np.zeros(0, dtype=np.uint64)
            self.anchors = np.zeros(0, dtype=np.int64)
        else:
            def h8(off):
                v = np.zeros(n_pos, dtype=np.uint64)
                for k in range(8):
                    b = full[off + k : off + k + n_pos].astype(np.uint64)
                    v |= b << np.uint64(8 * k)
                return v * _PRIME64
            self.h = (h8(0) ^ (h8(16) >> np.uint64(3))
                      ^ (h8(32) >> np.uint64(7)) ^ (h8(48) >> np.uint64(13)))
            self.anchors = np.nonzero((self.h >> self.rate_shift) == 0)[0]
        self.table: dict[int, list[int]] = {}
        self.gap_tables = GapTables()
        self._inserted_upto = 0
        self._anchor_cursor = 0

    def insert_upto(self, pos: int) -> None:
        """Insert all anchors in [inserted_upto, pos) into the table."""
        a = self.anchors
        i = self._anchor_cursor
        while i < len(a) and a[i] < pos:
            p = int(a[i])
            key = int((self.h[p] >> self.hash_shift) & self.hash_mask)
            bucket = self.table.get(key)
            if bucket is None:
                self.table[key] = [p]
            else:
                bucket.append(p)
                if len(bucket) > LDM_BUCKET:
                    bucket.pop(0)
            i += 1
        self._anchor_cursor = i
        self._inserted_upto = pos

    def find_long_matches(self, block_start: int, block_end: int
                          ) -> list[tuple[int, int, int]]:
        """Greedy non-overlapping verified long matches inside the block.

        Returns [(pos, length, dist), ...] in position order."""
        full = self.full
        n = len(full)
        lo = np.searchsorted(self.anchors, block_start)
        hi = np.searchsorted(self.anchors, min(block_end - LDM_MIN_MATCH,
                                               len(self.h)))
        out = []
        cursor = block_start
        for ai in range(lo, hi):
            p = int(self.anchors[ai])
            if p < cursor:
                continue
            key = int((self.h[p] >> self.hash_shift) & self.hash_mask)
            bucket = self.table.get(key)
            if not bucket:
                continue
            best_len = 0
            best_c = -1
            for c in reversed(bucket):
                if c >= p or p - c > self.window_size:
                    continue
                limit = min(block_end - p, n - p)
                l = _ext_fwd(full, p, c, limit)
                if l > best_len:
                    best_len = l
                    best_c = c
            if best_len >= LDM_MIN_MATCH:
                # backward extension, bounded by the running cursor
                s, c2 = p, best_c
                while s > cursor and c2 > 0 and full[s - 1] == full[c2 - 1]:
                    s -= 1
                    c2 -= 1
                    best_len += 1
                out.append((s, best_len, s - c2))
                cursor = s + best_len
        return out


def _long_matches(ldm, block_start: int, block_end: int) -> list:
    """The block's long matches, [(pos, length, dist), ...], in span
    `ldm_walk`."""
    t = _rec.on and _rec.begin("ldm_walk")
    ldm.insert_upto(block_start)
    longs = ldm.find_long_matches(block_start, block_end)
    if t:
        _rec.end(t)
    return longs


def find_sequences_ldm(full: np.ndarray, block_start: int, block_end: int,
                       window_low: int, reps: tuple, cparams,
                       ldm: LdmState) -> tuple[SeqStore, tuple]:
    """LDM-wrapped sequence extraction: long matches partition the block;
    the inner strategy compresses the gaps. At the chain-lazy strategies
    (2-5) one C call parses every gap of the block
    (GapTables.parse_block), elsewhere the per-gap loop
    (_gap_parse_plain); COUNTS counts which. While trace.recording() is
    on: spans `ldm_walk` (the long matches) and `gap_parse` (the rest)."""
    longs = _long_matches(ldm, block_start, block_end)
    t = _rec.on and _rec.begin("gap_parse")
    if cparams.strategy in _CHAINLAZY:
        out, r, gaps = ldm.gap_tables.parse_block(
            full, block_start, block_end, window_low, reps, cparams, longs)
        COUNTS["c_blocks"] += 1
        COUNTS["gaps"] += gaps
    else:
        out, r = _gap_parse_plain(full, block_start, block_end, window_low,
                                  reps, cparams, ldm, longs)
    if t:
        _rec.end(t)
    return out, r


def find_sequences_ldm_plain(full: np.ndarray, block_start: int,
                             block_end: int, window_low: int, reps: tuple,
                             cparams, ldm: LdmState
                             ) -> tuple[SeqStore, tuple]:
    """find_sequences_ldm with the per-gap loop at every strategy: the
    plain version of the one C call."""
    longs = _long_matches(ldm, block_start, block_end)
    return _gap_parse_plain(full, block_start, block_end, window_low, reps,
                            cparams, ldm, longs)


def _gap_parse_plain(full: np.ndarray, block_start: int, block_end: int,
                     window_low: int, reps: tuple, cparams, ldm: LdmState,
                     longs: list) -> tuple[SeqStore, tuple]:
    """The level's parser over each gap between the long matches, the
    long matches' sequences between them."""
    COUNTS["py_blocks"] += 1
    # inner matcher window is capped: LDM owns the long range
    inner_window = min(1 << 20, 1 << cparams.window_log)

    lls, obs, mbs = [], [], []
    lit_parts = []
    r = reps
    gap_start = block_start

    def run_inner(gs: int, ge: int, r: tuple):
        if ge - gs <= 0:
            return SeqStore(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.int32), b""), r
        wl = max(window_low, gs - inner_window)
        # Same strategy dispatch as plain blocks (ZSTD_selectBlockCompressor
        # role): LDM wraps the LEVEL's inner match finder
        # (zstd_compress.c:3263-3292), each gap with tables as a fresh
        # fill of its window leaves them (GapTables). The fast parse never
        # declines: each sequence covers at least mls >= 5 bytes, and it
        # has room for n / 4 + 16
        if cparams.strategy == 1:
            return find_sequences_fast(full, gs, ge, wl, r, cparams)
        if cparams.strategy in _CHAINLAZY:
            res = find_sequences_chainlazy(
                full, gs, ge, wl, r, cparams,
                state=ldm.gap_tables.at(full, wl, gs, cparams))
            if res is not None:
                return res
        return find_sequences_opt(full, gs, ge, wl, r, cparams)

    for (mpos, mlen, mdist) in longs:
        seqs, r = run_inner(gap_start, mpos, r)
        lls.extend(seqs.lit_length.tolist())
        obs.extend(seqs.off_base.tolist())
        mbs.extend(seqs.ml_base.tolist())
        # the inner pass's trailing literals become this long match's LL
        trailing = len(seqs.literals) - int(seqs.lit_length.sum())
        lit_parts.append(seqs.literals)
        ob = _off_base(mdist, trailing, r)
        lls.append(trailing)
        obs.append(ob)
        mbs.append(mlen - MIN_MATCH)
        r = update_reps(r, ob, trailing)
        gap_start = mpos + mlen

    seqs, r = run_inner(gap_start, block_end, r)
    lls.extend(seqs.lit_length.tolist())
    obs.extend(seqs.off_base.tolist())
    mbs.extend(seqs.ml_base.tolist())
    lit_parts.append(seqs.literals)

    out = SeqStore(np.array(lls, dtype=np.int32),
                   np.array(obs, dtype=np.int32),
                   np.array(mbs, dtype=np.int32),
                   b"".join(lit_parts))
    return out, r
