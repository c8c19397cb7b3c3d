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

from ..constants import MIN_MATCH
from .lazy import _ext_fwd, _off_base
from .matchfinder import update_reps
from .opt import (find_sequences_chainlazy, find_sequences_fast,
                  find_sequences_opt)
from .sequences import SeqStore

LDM_MIN_MATCH = 32          # minimum long-distance match length
LDM_BUCKET = 4              # candidates kept per hash bucket
_PRIME64 = np.uint64(0xCF1BBCDCB7A56463)


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


def find_sequences_ldm(full: np.ndarray, block_start: int, block_end: int,
                       window_low: int, reps: tuple, cparams,
                       ldm: LdmState) -> tuple[SeqStore, tuple]:
    """LDM-wrapped sequence extraction: long matches partition the block;
    the inner strategy compresses the gaps."""
    ldm.insert_upto(block_start)
    longs = ldm.find_long_matches(block_start, block_end)

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
        # (zstd_compress.c:3263-3292), each gap with fresh tables. The
        # fast parse never declines: each sequence covers at least mls >= 5
        # bytes, and it has room for n / 4 + 16
        if cparams.strategy == 1:
            return find_sequences_fast(full, gs, ge, wl, r, cparams)
        if cparams.strategy in (2, 3, 4, 5):
            res = find_sequences_chainlazy(full, gs, ge, wl, r, cparams)
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

    return SeqStore(np.array(lls, dtype=np.int32),
                    np.array(obs, dtype=np.int32),
                    np.array(mbs, dtype=np.int32),
                    b"".join(lit_parts)), r
