"""Fast-class greedy parse of a block through the host C parser.

Copy of _rebuild_store and find_sequences_fast in zstd_tpu/format/opt.py,
with the wrapper semantics of zstd_tpu/native.py's fast_fill and fast_parse,
over the port's own copy of the C (csrc/host/fast.c, built with the host C
compiler at first use). Role of zstd's lib/compress/zstd_fast.c; the
long-distance path parses the gaps between its long matches with it at
strategy 1 (levels 1-2 and --fast). There is no fallback: without a C
compiler the call raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _kernels
from ..constants import MIN_MATCH
from .sequences import SeqStore


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p)


def _rebuild_store(full, block_start, block_end, ll, ob, mb, new_reps):
    """Gather the literal bytes (everything outside matches) in one
    vectorized multi-range take instead of a per-sequence Python loop."""
    n = len(ll)
    if n == 0:
        lits = full[block_start:block_end].tobytes()
        return SeqStore(ll, ob, mb, lits), new_reps
    steps = ll.astype(np.int64) + mb.astype(np.int64) + MIN_MATCH
    starts = block_start + np.concatenate(
        ([0], np.cumsum(steps[:-1])))          # literal-run starts
    tail_start = int(starts[-1] + steps[-1])
    lens = np.concatenate((ll.astype(np.int64),
                           [block_end - tail_start]))
    starts = np.concatenate((starts, [tail_start]))
    total = int(lens.sum())
    if total == 0:
        return SeqStore(ll, ob, mb, b""), new_reps
    offs = np.concatenate(([0], np.cumsum(lens[:-1])))
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - offs, lens)
    return SeqStore(ll, ob, mb, full[idx].tobytes()), new_reps


def fast_fill(full: np.ndarray, start: int, end: int, hash_log: int,
              mls: int, table: np.ndarray) -> None:
    """Index [start, end) (dictionary/window prefix) into the fast 2-way
    bucket table (ZSTD_fillHashTable role)."""
    full = np.ascontiguousarray(full)
    _kernels.get("host/fast.c").zt_fast_fill(
        _ptr(full), start, end, hash_log, mls, _ptr(table))


def fast_parse(full: np.ndarray, window_low: int, block_start: int,
               block_end: int, reps: tuple, hash_log: int, accel_log: int,
               mls: int, step0: int, table: np.ndarray):
    """Greedy fast-class parse of one block (zstd_fast.c role). `table` is
    the int32[2 << hash_log] position table (-1 empty). Returns (ll, ob, mb,
    new_reps)."""
    n = block_end - block_start
    seq_cap = n // 4 + 16
    ll = np.zeros(seq_cap, dtype=np.int32)
    ob = np.zeros(seq_cap, dtype=np.int32)
    mb = np.zeros(seq_cap, dtype=np.int32)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    nseq = _kernels.get("host/fast.c").zt_fast_parse(
        _ptr(full), window_low, block_start, block_end, _ptr(reps_arr),
        _ptr(ll), _ptr(ob), _ptr(mb), seq_cap, hash_log, accel_log, mls,
        step0, _ptr(table))
    return (ll[:nseq], ob[:nseq], mb[:nseq],
            (int(reps_arr[0]), int(reps_arr[1]), int(reps_arr[2])))


def find_sequences_fast(full: np.ndarray, block_start: int, block_end: int,
                        window_low: int, reps: tuple, cparams
                        ) -> tuple[SeqStore, tuple]:
    """Greedy fast-class parse via the C matchfinder (zstd_fast.c role;
    levels 1-2 and --fast) with a fresh table: the window prefix is
    indexed first (ZSTD_fillHashTable role)."""
    hash_log = min(max(cparams.hash_log, 12), 22)
    mls = min(max(cparams.min_match, 5), 7)
    table = np.full(2 << hash_log, -1, dtype=np.int32)    # 2-way buckets
    if block_start > window_low:
        fast_fill(full, window_low, block_start, hash_log, mls, table)
    # --fast=N (negative levels encode N in target_length): larger base step
    step0 = max(1, -cparams.target_length if cparams.target_length < 0
                else cparams.target_length if cparams.strategy == 1
                and cparams.target_length > 0 else 1)
    ll, ob, mb, new_reps = fast_parse(full, window_low, block_start,
                                      block_end, reps, hash_log, 8, mls,
                                      step0, table)
    return _rebuild_store(full, block_start, block_end, ll, ob, mb, new_reps)
