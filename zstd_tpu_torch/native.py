"""ctypes wrappers of the port's host library (csrc/host/*.c).

Copy of the encoder methods of zstd_tpu/native.py's _Native, over the port's
own copy of the C (built with the host C compiler at first use by
_kernels.host()). The parsers take the whole input `full` (uint8) and
absolute positions, and return (ll, ob, mb, new_reps): int32 literal
lengths, spec Offset_Values and match lengths - 3. There is no fallback:
without a C compiler every call raises. A parse returns None only where the
C declines (a negative count), as zstd_tpu's does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _kernels


def _ptr(a: np.ndarray | None) -> ctypes.c_void_p | None:
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _seq_arrays(n: int, per: int):
    cap = n // per + 16
    return (cap, np.zeros(cap, dtype=np.int32), np.zeros(cap, dtype=np.int32),
            np.zeros(cap, dtype=np.int32))


def _result(nseq: int, ll, ob, mb, reps_arr):
    if nseq < 0:
        return None
    return (ll[:nseq], ob[:nseq], mb[:nseq],
            (int(reps_arr[0]), int(reps_arr[1]), int(reps_arr[2])))


def fast_fill(full: np.ndarray, start: int, end: int, hash_log: int,
              mls: int, table: np.ndarray) -> None:
    """Index [start, end) (dictionary/window prefix) into the fast 2-way
    bucket table (ZSTD_fillHashTable role)."""
    full = np.ascontiguousarray(full)
    _kernels.host().zt_fast_fill(_ptr(full), start, end, hash_log, mls,
                                 _ptr(table))


def fast_parse(full: np.ndarray, window_low: int, block_start: int,
               block_end: int, reps: tuple, hash_log: int, accel_log: int,
               mls: int, step0: int, table: np.ndarray):
    """Greedy fast-class parse of one block (zstd_fast.c role). `table` is
    the int32[2 << hash_log] position table (-1 empty)."""
    cap, ll, ob, mb = _seq_arrays(block_end - block_start, 4)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    nseq = _kernels.host().zt_fast_parse(
        _ptr(full), window_low, block_start, block_end, _ptr(reps_arr),
        _ptr(ll), _ptr(ob), _ptr(mb), cap, hash_log, accel_log, mls, step0,
        _ptr(table))
    return _result(nseq, ll, ob, mb, reps_arr)


def dfast_fill(full: np.ndarray, start: int, end: int, hlog_long: int,
               hlog_short: int, table_long: np.ndarray,
               table_short: np.ndarray) -> None:
    """Index a prefix into the double-fast long+short tables
    (ZSTD_fillDoubleHashTable role)."""
    full = np.ascontiguousarray(full)
    _kernels.host().zt_dfast_fill(_ptr(full), start, end, hlog_long,
                                  hlog_short, _ptr(table_long),
                                  _ptr(table_short))


def dfast_parse(full: np.ndarray, window_low: int, block_start: int,
                block_end: int, reps: tuple, hlog_long: int, hlog_short: int,
                accel_log: int, table_long: np.ndarray,
                table_short: np.ndarray):
    """Double-fast greedy parse (zstd_double_fast.c role): long 8-byte and
    short 5-byte hash tables, both 2-way buckets."""
    cap, ll, ob, mb = _seq_arrays(block_end - block_start, 4)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    nseq = _kernels.host().zt_dfast_parse(
        _ptr(full), window_low, block_start, block_end, _ptr(reps_arr),
        _ptr(ll), _ptr(ob), _ptr(mb), cap, hlog_long, hlog_short, accel_log,
        _ptr(table_long), _ptr(table_short))
    return _result(nseq, ll, ob, mb, reps_arr)


def lazy_fill(full: np.ndarray, start: int, end: int, hash_log: int,
              chain_log: int, mls: int, head: np.ndarray,
              chain: np.ndarray) -> None:
    """Index [start, end) (dictionary/window prefix) into the lazy
    matchfinder's head+chain tables (dictMatchState-loading role)."""
    full = np.ascontiguousarray(full)
    _kernels.host().zt_lazy_fill(_ptr(full), start, end, hash_log,
                                 chain_log, mls, _ptr(head), _ptr(chain))


def lazy_fill_long(full: np.ndarray, start: int, end: int, hlog_long: int,
                   table_long: np.ndarray) -> None:
    """Index a prefix range into the lazy parser's far-reach long table."""
    full = np.ascontiguousarray(full)
    _kernels.host().zt_lazy_fill_long(_ptr(full), start, end, hlog_long,
                                      _ptr(table_long))


def lazy_parse(full: np.ndarray, window_low: int, block_start: int,
               block_end: int, reps: tuple, hash_log: int, chain_log: int,
               mls: int, depth: int, defer: int, accel_log: int,
               head: np.ndarray, chain: np.ndarray,
               table_long: np.ndarray | None = None, hlog_long: int = 0):
    """Hash-chain lazy parse (zstd_lazy.c greedy/lazy/lazy2 role):
    depth-bounded chain search at every position plus 0-2 step lazy
    deferral. table_long (int32[2 << hlog_long] 2-way buckets) extends the
    reach past the chain table's modular horizon."""
    cap, ll, ob, mb = _seq_arrays(block_end - block_start, 4)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    nseq = _kernels.host().zt_lazy_parse(
        _ptr(full), window_low, block_start, block_end, _ptr(reps_arr),
        _ptr(ll), _ptr(ob), _ptr(mb), cap, hash_log, chain_log, mls, depth,
        defer, accel_log, _ptr(head), _ptr(chain), _ptr(table_long),
        hlog_long if table_long is not None else 0)
    return _result(nseq, ll, ob, mb, reps_arr)


def row_fill(full: np.ndarray, start: int, end: int, row_log: int,
             width_log: int, mls: int, pos_table: np.ndarray,
             tag_table: np.ndarray, head_table: np.ndarray,
             table_long: np.ndarray | None = None, hlog_long: int = 0
             ) -> None:
    """Index [start, end) (dictionary/window prefix) into the row
    matchfinder tables (ZSTD_row_update role)."""
    full = np.ascontiguousarray(full)
    _kernels.host().zt_row_fill(
        _ptr(full), start, end, row_log, width_log, mls, _ptr(pos_table),
        _ptr(tag_table), _ptr(head_table), _ptr(table_long),
        hlog_long if table_long is not None else 0)


def row_parse(full: np.ndarray, window_low: int, block_start: int,
              block_end: int, reps: tuple, row_log: int, width_log: int,
              mls: int, max_attempts: int, defer: int,
              pos_table: np.ndarray, tag_table: np.ndarray,
              head_table: np.ndarray, table_long: np.ndarray | None = None,
              hlog_long: int = 0):
    """Row-matchfinder lazy parse (ZSTD_RowFindBestMatch role,
    zstd_lazy.c:986). Same sequence contract as lazy_parse."""
    cap, ll, ob, mb = _seq_arrays(block_end - block_start, 4)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    nseq = _kernels.host().zt_row_parse(
        _ptr(full), window_low, block_start, block_end, _ptr(reps_arr),
        _ptr(ll), _ptr(ob), _ptr(mb), cap, row_log, width_log, mls,
        max_attempts, defer, 8, _ptr(pos_table), _ptr(tag_table),
        _ptr(head_table), _ptr(table_long),
        hlog_long if table_long is not None else 0)
    return _result(nseq, ll, ob, mb, reps_arr)


class OptCtx:
    """Persistent match-finder context of the DP parser for one frame's
    blocks (hash heads, suffix tree, statistics); freed with the object."""
    __slots__ = ("ptr", "_free")

    def __init__(self):
        lib = _kernels.host()
        self._free = lib.zt_opt_ctx_free
        self.ptr = lib.zt_opt_ctx_new()

    def __del__(self):
        if self.ptr:
            self._free(self.ptr)
            self.ptr = None


def opt_ctx_clone(dst: OptCtx, src: OptCtx, used_hint: int = 0) -> bool:
    """Snapshot src's matcher tables and statistics into dst (the per-block
    snapshot behind the iterated keep-min parse)."""
    return _kernels.host().zt_opt_ctx_clone(dst.ptr, src.ptr, used_hint) == 0


def opt_ctx_copy_prices(dst: OptCtx, src: OptCtx) -> None:
    _kernels.host().zt_opt_ctx_copy_prices(dst.ptr, src.ptr)


def opt_twopass(v: int) -> None:
    """Force the first-block statistics seeding mode of this thread's DP
    parses (-1 = default)."""
    _kernels.host().zt_opt_knob_twopass(v)


def opt_parse(full: np.ndarray, window_low: int, block_start: int,
              block_end: int, reps: tuple, hash_log: int, search_log: int,
              min_match: int, target_len: int, strategy: int = 9,
              ctx: OptCtx | None = None):
    """Optimal-parse one block (zstd_opt.c role). `ctx` carries the matcher
    across blocks. None where the C parser declines."""
    cap, ll, ob, mb = _seq_arrays(block_end - block_start, 2)
    reps_arr = np.array(reps, dtype=np.uint32)
    full = np.ascontiguousarray(full)
    lib = _kernels.host()
    tail = (_ptr(reps_arr), _ptr(ll), _ptr(ob), _ptr(mb), cap, hash_log,
            search_log, min_match, target_len, strategy)
    if ctx is not None and ctx.ptr:
        # src_end: ordering comparisons may read the whole buffer
        nseq = lib.zt_opt_parse_ctx(ctx.ptr, _ptr(full), window_low,
                                    block_start, block_end, len(full), *tail)
    else:
        nseq = lib.zt_opt_parse(_ptr(full), window_low, block_start,
                                block_end, *tail)
    return _result(nseq, ll, ob, mb, reps_arr)


def _frame_out(n: int):
    cap = n + n // 2 + 4096
    return cap, np.zeros(cap, dtype=np.uint8), np.array([1, 4, 8],
                                                        dtype=np.uint32)


def compress_fast_frame(full: np.ndarray, start: int, end: int,
                        window_size: int, block_size: int, hash_log: int,
                        accel_log: int, mls: int, step0: int, strategy: int,
                        table: np.ndarray) -> bytes | None:
    """Whole-frame fast-path block loop in C (csrc/host/cblock.c): parse,
    entropy-code and emit every block of [start, end) in one call. Returns
    the concatenated block bytes, or None where the C declines."""
    cap, out, reps_arr = _frame_out(end - start)
    full = np.ascontiguousarray(full)
    sz = _kernels.host().zt_compress_fast_frame(
        _ptr(full), start, end, window_size, block_size, hash_log,
        accel_log, mls, step0, strategy, _ptr(reps_arr), _ptr(table),
        _ptr(out), cap)
    return None if sz < 0 else out[:sz].tobytes()


def compress_dp_frame(full: np.ndarray, start: int, end: int,
                      window_size: int, block_size: int, strategy: int,
                      hash_log: int, search_log: int, min_match: int,
                      target_len: int) -> bytes | None:
    """Whole-frame shallow-DP block loop in C (levels 10-15 class)."""
    cap, out, reps_arr = _frame_out(end - start)
    full = np.ascontiguousarray(full)
    sz = _kernels.host().zt_compress_dp_frame(
        _ptr(full), start, end, window_size, block_size, strategy,
        _ptr(reps_arr), hash_log, search_log, min_match, target_len,
        _ptr(out), cap)
    return None if sz < 0 else out[:sz].tobytes()


def compress_row_frame(full: np.ndarray, start: int, end: int,
                       window_size: int, block_size: int, strategy: int,
                       row_log: int, width_log: int, mls: int,
                       max_attempts: int, defer: int, pos_t: np.ndarray,
                       tag_t: np.ndarray, head_t: np.ndarray,
                       tlong: np.ndarray, hlog_long: int) -> bytes | None:
    """Whole-frame row-matchfinder block loop in C (levels 3-9 class).
    None where the C declines (its over-matching detector aborts)."""
    cap, out, reps_arr = _frame_out(end - start)
    full = np.ascontiguousarray(full)
    sz = _kernels.host().zt_compress_row_frame(
        _ptr(full), start, end, window_size, block_size, strategy,
        _ptr(reps_arr), row_log, width_log, mls, max_attempts, defer,
        _ptr(pos_t), _ptr(tag_t), _ptr(head_t), _ptr(tlong), hlog_long,
        _ptr(out), cap)
    return None if sz < 0 else out[:sz].tobytes()
