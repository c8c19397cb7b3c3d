"""Host block parsers over the C matchfinders: fast, double-fast, row,
chain-lazy and the optimal-parse DP (levels 1-22).

Copy of zstd_tpu/format/opt.py over the port's own copy of the C
(csrc/host/*.c through zstd_tpu_torch/native.py, built with the host C
compiler at first use). Role of zstd's lib/compress/zstd_fast.c,
zstd_double_fast.c, zstd_lazy.c and zstd_opt.c. The reference's environment
knobs are constants at their defaults: ZSTD_TPU_OPT_ITER 3,
ZSTD_TPU_OPT_MCACHE off, ZSTD_TPU_LAZY_{DEPTH,DEFER,MLS} and
ZSTD_TPU_ROW_{WIDTH,ATTEMPTS,DEFER,MLS} at the level's values, the row
parse's shallow-DP re-parse on. There is no fallback: without a C compiler
the call raises. find_sequences_opt parses with the Python lazy ladder
(format/lazy.py) only where the C DP declines, as zstd_tpu's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..constants import MIN_MATCH
from .lazy import find_sequences_lazy
from .sequences import SeqStore

OPT_ITER_CANDIDATES = 3   # keep-min parse candidates a block, levels 19+


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


def _store(full, block_start, block_end, res):
    if res is None:
        return None
    return _rebuild_store(full, block_start, block_end, *res)


def _table(state, attr: str, size: int):
    """(table, fresh): the int32 table `state.attr` of `size` entries (-1
    empty), made anew when missing or of another size; a fresh table with
    no state when `state` is None."""
    if state is not None:
        tab = getattr(state, attr)
        if tab is not None and len(tab) == size:
            return tab, False
    tab = np.full(size, -1, dtype=np.int32)
    if state is not None:
        setattr(state, attr, tab)
    return tab, True


def find_sequences_fast(full: np.ndarray, block_start: int, block_end: int,
                        window_low: int, reps: tuple, cparams,
                        state=None) -> tuple[SeqStore, tuple] | None:
    """Greedy fast-class parse via the C matchfinder (zstd_fast.c role;
    levels 1-2 and --fast). With a `state`, its fast_table carries across
    the frame's blocks; a fresh table indexes the window prefix first
    (ZSTD_fillHashTable role)."""
    hash_log = min(max(cparams.hash_log, 12), 22)
    mls = min(max(cparams.min_match, 5), 7)
    table, fresh = _table(state, "fast_table", 2 << hash_log)  # 2-way
    if fresh and block_start > window_low:
        native.fast_fill(full, window_low, block_start, hash_log, mls, table)
    # --fast=N (negative levels encode N in target_length): larger base step
    step0 = max(1, -cparams.target_length if cparams.target_length < 0
                else cparams.target_length if cparams.strategy == 1
                and cparams.target_length > 0 else 1)
    return _store(full, block_start, block_end, native.fast_parse(
        full, window_low, block_start, block_end, reps, hash_log, 8, mls,
        step0, table))


def find_sequences_dfast(full: np.ndarray, block_start: int, block_end: int,
                         window_low: int, reps: tuple, cparams,
                         state=None) -> tuple[SeqStore, tuple] | None:
    """Double-fast greedy parse via the C matchfinder (zstd_double_fast.c
    role). zstd_tpu reaches it only under ZSTD_TPU_HOST_PARSER=greedy,
    which the port leaves at its default: no block dispatch calls it."""
    hlog_long = min(max(cparams.hash_log, 14), 22)
    hlog_short = min(max(cparams.chain_log, 13), 21)
    buf, fresh = _table(state, "fast_table",
                        (2 << hlog_long) + (2 << hlog_short))
    tl = buf[: 2 << hlog_long]
    ts = buf[2 << hlog_long :]
    if fresh and block_start > window_low:
        # index the dictionary / window prefix (ZSTD_fillDoubleHashTable)
        native.dfast_fill(full, window_low, block_start, hlog_long,
                          hlog_short, tl, ts)
    return _store(full, block_start, block_end, native.dfast_parse(
        full, window_low, block_start, block_end, reps, hlog_long,
        hlog_short, 8, tl, ts))


def row_params(cparams) -> tuple[int, int, int, int, int, int]:
    """(row_log, width_log, mls, max_attempts, defer, hlog_long) of the row
    matchfinder at these parameters."""
    hash_log = min(max(cparams.hash_log, 14), 24)
    strat = cparams.strategy
    width_log = 4 if (cparams.search_log <= 4 and strat < 5) else 5
    # lazy2 class: a full row of attempts (32); the tag filter makes the
    # extra attempts nearly free (only tag-equal slots extend)
    max_attempts = min(1 << max(cparams.search_log, 5 if strat >= 5 else 3),
                       1 << width_log)
    # one deferral step even for the greedy strategy
    defer = min(max(strat - 3, 1), 2)
    mls = min(max(cparams.min_match, 4), 7)
    # far-reach long table (same role as chainlazy's): 8-byte-hash 2-way
    # buckets of absolute positions, so long matches far back in the
    # window survive the rows' per-bucket LRU eviction
    hlog_long = min(max(cparams.hash_log, 15), 22)
    return hash_log - width_log, width_log, mls, max_attempts, defer, \
        hlog_long


def find_sequences_row(full: np.ndarray, block_start: int,
                       block_end: int, window_low: int, reps: tuple,
                       cparams, state=None,
                       ) -> tuple[SeqStore, tuple] | None:
    """Row-matchfinder lazy parse (ZSTD_RowFindBestMatch role,
    zstd_lazy.c:986; the default for levels 3-9). Rows of 16/32 tagged
    slots replace hash chains: one SWAR tag compare per probe instead of a
    depth-256 pointer walk."""
    row_log, width_log, mls, max_attempts, defer, hlog_long = \
        row_params(cparams)
    entries = 1 << (row_log + width_log)
    rows = 1 << row_log
    fresh = True
    tabs = getattr(state, "row_table", None) if state is not None else None
    if tabs is not None and tabs[0].shape[0] == entries \
            and tabs[1].shape[0] == entries and tabs[2].shape[0] == rows:
        fresh = False
    else:
        tabs = (np.full(entries, -1, dtype=np.int32),
                np.zeros(entries, dtype=np.uint8),
                np.zeros(rows, dtype=np.uint8),
                np.full(2 << hlog_long, -1, dtype=np.int32))
        if state is not None:
            state.row_table = tabs
    pos_t, tag_t, head_t, tlong = tabs
    if fresh and block_start > window_low:
        native.row_fill(full, window_low, block_start, row_log, width_log,
                        mls, pos_t, tag_t, head_t, tlong, hlog_long)
    res = native.row_parse(full, window_low, block_start, block_end, reps,
                           row_log, width_log, mls, max_attempts, defer,
                           pos_t, tag_t, head_t, tlong, hlog_long)
    if res is None:
        return None
    ll, ob, mb, new_reps = res
    # over-matching regime detector: a parse made of uniformly SHORT fresh
    # matches with ~no repcodes is the one regime where the greedy/lazy
    # class loses to zstd, and where the shallow DP wins; re-parse it so
    nb = len(ll)
    if nb > 256 and cparams.strategy >= 5:
        mean_ml = float(mb.mean()) + 3.0
        rep_share = float((ob <= 3).mean())
        if mean_ml < 9.8 and rep_share < 0.003:
            dp = find_sequences_shallow_dp(
                full, block_start, block_end, window_low, reps, cparams,
                state=state)
            if dp is not None:
                return dp
    return _rebuild_store(full, block_start, block_end, ll, ob, mb,
                          new_reps)


def find_sequences_shallow_dp(full: np.ndarray, block_start: int,
                              block_end: int, window_low: int, reps: tuple,
                              cparams, state=None,
                              ) -> tuple[SeqStore, tuple] | None:
    """Shallow optimal parse for the wide-search lazy2 levels (10-12): the
    btultra DP (csrc/host/opt.c) run with the level's own narrow search
    (16-32 tree nodes) instead of the 128-node btopt class; its price-model
    parse decisions, not search depth, are what this regime buys."""
    if state is None:
        return None
    if state.opt_ctx is None:
        state.opt_ctx = native.OptCtx()
    sl = min(max(cparams.search_log - 1, 3), 5)
    return _store(full, block_start, block_end, native.opt_parse(
        full, window_low, block_start, block_end, reps, cparams.hash_log, sl,
        min(max(cparams.min_match, 4), 6), 32, 8, ctx=state.opt_ctx))


def find_sequences_chainlazy(full: np.ndarray, block_start: int,
                             block_end: int, window_low: int, reps: tuple,
                             cparams, state=None,
                             ) -> tuple[SeqStore, tuple] | None:
    """Hash-chain lazy parse via the C matchfinder (zstd_lazy.c
    greedy/lazy/lazy2 role; the --long gap parser of strategies 2-5).
    Depth = 2^search_log attempts, lazy deferral steps scale with
    strategy."""
    hash_log = min(max(cparams.hash_log, 14), 24)
    chain_log = min(max(cparams.chain_log, 14), 26)
    strat = cparams.strategy
    if strat <= 2:            # dfast-class levels: hash the minimum-match
        # width; depth scales with the level's chain budget
        depth = 32 if cparams.chain_log <= 16 else 64
        defer, mls = 2, 4
    elif strat <= 4:          # greedy/lazy: 0/1 deferral steps
        depth = 2 << min(max(cparams.search_log, 3), 8)
        defer = min(max(strat - 3, 0), 2)
        mls = min(max(cparams.min_match, 4), 7)
    else:                     # wide-search lazy2 class (levels 10-12):
        # 512-deep chains stand in for zstd's btlazy2 tree reach
        depth = 512
        defer = 2
        mls = min(max(cparams.min_match, 4), 7)
    # far-reach long table: the chain table's modular indexing caps reach
    # at 2^chain_log; the 8-byte 2-way buckets keep absolute positions so
    # far-window and dictionary-prefix long matches stay findable
    hlog_long = min(max(cparams.hash_log, 15), 22)
    buf, fresh = _table(state, "fast_table", (1 << hash_log)
                        + (1 << chain_log) + (2 << hlog_long))
    head = buf[: 1 << hash_log]
    chain = buf[1 << hash_log : (1 << hash_log) + (1 << chain_log)]
    tlong = buf[(1 << hash_log) + (1 << chain_log) :]
    if fresh and block_start > window_low:
        # index the window prefix so the parse can match into it
        native.lazy_fill(full, window_low, block_start, hash_log, chain_log,
                         mls, head, chain)
        native.lazy_fill_long(full, window_low, block_start, hlog_long,
                              tlong)
    return _store(full, block_start, block_end, native.lazy_parse(
        full, window_low, block_start, block_end, reps, hash_log, chain_log,
        mls, depth, defer, 8, head, chain, tlong, hlog_long))


def find_sequences_opt_dual(full: np.ndarray, block_start: int,
                            block_end: int, window_low: int, reps: tuple,
                            cparams, state):
    """Iterated keep-min parse (levels 19+): parse the block once with the
    chained statistics (pass 1), snapshot-clone the pre-block matcher, feed
    pass 1's histograms into the snapshot, and re-parse with the converged
    prices (pass 2, 3). Returns [(seqstore, reps, commit_fn), ...]: the
    caller sizes the candidates exactly and calls the winner's commit_fn
    (which swaps the persistent contexts when a re-parse wins)."""
    if state is None:
        return None
    # small-input search escalation: on inputs that fit a couple of blocks
    # an ultra search (2048 nodes, no sufficient-length early accept) costs
    # milliseconds; a graded mid tier from 256 KiB to 2 MiB
    if len(full) <= 256 * 1024 and cparams.search_log < 11:
        cparams = dataclasses.replace(cparams, search_log=11,
                                      target_length=999)
    elif len(full) <= (1 << 21) and cparams.search_log < 8:
        cparams = dataclasses.replace(
            cparams, search_log=8,
            target_length=max(cparams.target_length, 256))
    if state.opt_ctx is None:
        state.opt_ctx = native.OptCtx()
    # pool[0] is a pristine PRE-block snapshot (never parsed on this block);
    # pool[1..] host the re-parse candidates
    pool = state.opt_ctx_b
    if pool is None:
        pool = [native.OptCtx() for _ in range(OPT_ITER_CANDIDATES)]
        state.opt_ctx_b = pool
    if not native.opt_ctx_clone(pool[0], state.opt_ctx, used_hint=block_end):
        return None
    out = []
    prev_ctx = None
    for k in range(OPT_ITER_CANDIDATES):
        if k == 0:
            ctx = state.opt_ctx
        else:
            ctx = pool[k]
            if not native.opt_ctx_clone(ctx, pool[0], used_hint=block_end):
                break
            native.opt_ctx_copy_prices(ctx, prev_ctx)
        res = native.opt_parse(full, window_low, block_start, block_end,
                               reps, cparams.hash_log, cparams.search_log,
                               cparams.min_match, cparams.target_length,
                               cparams.strategy, ctx=ctx)
        if res is None:
            break
        sq, rp = _rebuild_store(full, block_start, block_end, *res)

        def commit(k=k, ctx=ctx):
            if k == 0:
                return
            # the winner becomes the chained context; the old chained ctx
            # returns to the pool for recycling
            pool[k] = state.opt_ctx
            state.opt_ctx = ctx

        out.append((sq, rp, commit))
        prev_ctx = ctx
    return out or None


def find_sequences_opt(full: np.ndarray, block_start: int, block_end: int,
                       window_low: int, reps: tuple, cparams,
                       state=None) -> tuple[SeqStore, tuple]:
    """Optimal parse via the C DP (zstd_opt.c role; levels 13-22, and the
    --long gap parser above strategy 5). With a `state`, its opt_ctx
    carries the matcher across the frame's blocks."""
    ctx = None
    if state is not None:
        if state.opt_ctx is None:
            state.opt_ctx = native.OptCtx()
        ctx = state.opt_ctx
    # ladder coherence: the btopt band's table is floored at the lazy2
    # band's size so level 13 never compresses worse than level 12; small
    # and mid inputs get a wider search (milliseconds there)
    hash_log = cparams.hash_log
    search_log = cparams.search_log
    target_len = cparams.target_length
    if cparams.strategy in (6, 7, 8) and len(full) >= (1 << 21):
        hash_log = max(hash_log, min(22, hash_log + 3))
        search_log = max(search_log, 5)
    elif cparams.strategy in (6, 7, 8) and len(full) <= 262144:
        search_log = max(search_log, 11)
        target_len = max(target_len, 999)
    elif cparams.strategy in (6, 7, 8):
        search_log = max(search_log, 8)
        target_len = max(target_len, 256)
    res = native.opt_parse(full, window_low, block_start, block_end, reps,
                           hash_log, search_log, cparams.min_match,
                           target_len, cparams.strategy, ctx=ctx)
    if res is None:
        return find_sequences_lazy(full, block_start, block_end, window_low,
                                   reps, cparams)
    return _rebuild_store(full, block_start, block_end, *res)
