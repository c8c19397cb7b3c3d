"""ctypes wrappers of the port's host library (csrc/host/*.c).

Copy of the methods of zstd_tpu/native.py's _Native that the port's host
code calls, over the port's own copy of the C (built with the host C
compiler at first use by _kernels.host()): the parsers and whole-frame
encoders, the entropy planning and encoders, the block decoder and XXH64,
the device encode's batch planner, and the long-distance matcher's walk and
gap parse.
The parsers take the whole input `full` (uint8) and absolute positions, and
return (ll, ob, mb, new_reps): int32 literal lengths, spec Offset_Values
and match lengths - 3. There is no fallback: without a C compiler every
call raises. A call returns None only where the C declines, as
zstd_tpu's does; its caller then runs the Python branch, as zstd_tpu's
callers do.
"""

from __future__ import annotations

import ctypes
import functools

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


def ldm_walk(full: np.ndarray, block_start: int, block_end: int,
             anchors: np.ndarray, cands: np.ndarray, lo: int, hi: int,
             window: int, min_match: int) -> np.ndarray:
    """The long-match walk over anchors[lo:hi] (int64, ascending) and their
    candidates (int32[n, bucket], -1 empty): int64[k, 3] rows of (pos,
    length, dist) of the committed long matches, in position order."""
    full = np.ascontiguousarray(full)
    anchors = np.ascontiguousarray(anchors, dtype=np.int64)
    cands = np.ascontiguousarray(cands, dtype=np.int32)
    if (cands.ndim != 2 or len(cands) != len(anchors)
            or not 0 <= lo <= hi <= len(anchors)):
        raise ValueError("ldm_walk: anchors, candidates and [lo, hi) "
                         "do not agree")
    out = np.empty((max(hi - lo, 0), 3), dtype=np.int64)
    k = _kernels.host().zt_ldm_walk(
        _ptr(full), len(full), block_start, block_end, _ptr(anchors),
        _ptr(cands), lo, hi, cands.shape[1], window, min_match, _ptr(out))
    return out[:k]


def ldm_gap_parse(full: np.ndarray, block_start: int, block_end: int,
                  window_low: int, inner_window: int, longs: np.ndarray,
                  reps: tuple, shape: tuple, tables: np.ndarray,
                  span: np.ndarray, log: np.ndarray):
    """The gaps of one block between its long matches (int64[k, 3] rows of
    (pos, length, dist)) parsed by the chain-lazy parse in one call, with
    the long matches' sequences between them (format/ldm.find_sequences_ldm
    at strategies 2-5). shape: (hash_log, chain_log, hlog_long, mls, depth,
    defer); tables: the int32 head, chain and long tables in one buffer,
    indexing [span[0], span[1]) (int64[2], updated in place; span[0] < 0
    for new tables); log: a uint64 buffer of at least 4 entries a byte of
    the block. Returns (ll, ob, mb, literals, new_reps, gaps parsed)."""
    hash_log, chain_log, hlog_long, mls, depth, defer = shape
    n = block_end - block_start
    longs = np.ascontiguousarray(longs, dtype=np.int64).reshape(-1, 3)
    if (len(tables) != (1 << hash_log) + (1 << chain_log) + (2 << hlog_long)
            or tables.dtype != np.int32 or not tables.flags.c_contiguous
            or log.dtype != np.uint64 or not log.flags.c_contiguous
            or span.dtype != np.int64 or len(span) != 2):
        raise ValueError("ldm_gap_parse: tables, span or log do not agree "
                         "with the shape")
    cap = n // 4 + 17 * (len(longs) + 1)
    ll = np.empty(cap, dtype=np.int32)
    ob = np.empty(cap, dtype=np.int32)
    mb = np.empty(cap, dtype=np.int32)
    lits = np.empty(max(n, 0), dtype=np.uint8)
    reps_arr = np.array(reps, dtype=np.int64)
    info = np.zeros(2, dtype=np.int64)
    full = np.ascontiguousarray(full)
    k = _kernels.host().zt_ldm_gap_parse(
        _ptr(full), block_start, block_end, window_low, inner_window,
        _ptr(longs), len(longs), _ptr(reps_arr), hash_log, chain_log,
        hlog_long, mls, depth, defer, _ptr(tables), _ptr(span), _ptr(log),
        len(log), _ptr(ll), _ptr(ob), _ptr(mb), cap, _ptr(lits), _ptr(info))
    if k < 0:
        raise ValueError("ldm_gap_parse: the long matches leave the block "
                         "or overlap, or the log is short")
    return (ll[:k], ob[:k], mb[:k],
            lits[:info[0]].tobytes(),
            (int(reps_arr[0]), int(reps_arr[1]), int(reps_arr[2])),
            int(info[1]))


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


def split_points(full: np.ndarray, bs: int, be: int, chunk: int,
                 min_seg: int) -> list[int]:
    """Entropy-divergence pre-split (format/frame.py _split_points at its
    default threshold, in exact integer arithmetic)."""
    cap = max((be - bs) // max(min_seg, 1) + 4, 8)
    out = np.empty(cap, dtype=np.int64)
    full = np.ascontiguousarray(full)
    k = _kernels.host().zt_split_points(_ptr(full), bs, be, chunk, min_seg,
                                        _ptr(out), cap)
    return [int(x) for x in out[:k]]


# ---- XXH64 (xxh64.c) --------------------------------------------------------

def xxh64(data, seed: int = 0) -> int:
    """XXH64 of any bytes-like object."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(_kernels.host().zt_xxh64(_ptr(buf), len(buf), seed))


def xxh64_state() -> ctypes.Array:
    """A zeroed streaming XXH64 state (XXH64_state_t role)."""
    return ctypes.create_string_buffer(_kernels.host().zt_xxh64_state_size())


def xxh64_reset(state, seed: int = 0) -> None:
    _kernels.host().zt_xxh64_reset(state, seed)


def xxh64_update(state, data) -> None:
    buf = np.frombuffer(data, dtype=np.uint8)
    _kernels.host().zt_xxh64_update(state, _ptr(buf), len(buf))


def xxh64_digest(state) -> int:
    return int(_kernels.host().zt_xxh64_digest(state))


# ---- the lz4 block codec and XXH32 (lz4.c) ----------------------------------

def lz4_block_compress(data: bytes) -> bytes | None:
    """LZ4 block compress; None if not compressible."""
    n = len(data)
    if n == 0:
        return None
    cap = n + n // 128 + 64
    out = np.empty(cap, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    r = _kernels.host().zt_lz4_block_compress(_ptr(src), n, _ptr(out), cap)
    if r <= 0:
        return None
    return out[:r].tobytes()


def lz4_block_decompress(data: bytes, cap: int, out: np.ndarray,
                         start: int = 0) -> int | None:
    """LZ4 block decompress appended at out[start:]; the bytes before
    `start` serve as match history (block-linked frames). Returns the
    produced byte count into `out`, or None on corruption."""
    src = np.frombuffer(data, dtype=np.uint8)
    r = _kernels.host().zt_lz4_block_decompress(
        _ptr(src) if len(data) else None, len(data), _ptr(out), cap, start)
    return None if r < 0 else int(r)


def xxh32(data, seed: int = 0) -> int:
    src = np.frombuffer(data, dtype=np.uint8)
    return int(_kernels.host().zt_xxh32(_ptr(src) if len(src) else None,
                                        len(src), seed))


# ---- the entropy planning and encoders (huf.c, encode.c) --------------------

def fse_normalize(count: np.ndarray, table_log: int, total: int,
                  max_symbol: int, use_low_prob: bool) -> np.ndarray | None:
    """FSE_normalizeCount (M2 included). The int32 norm, or None where the
    Python branch raises (the RLE case, an M2 failure)."""
    cnt = np.ascontiguousarray(count[: max_symbol + 1], dtype=np.int64)
    norm = np.empty(max_symbol + 1, dtype=np.int32)
    r = _kernels.host().zt_fse_normalize(_ptr(cnt), table_log, total,
                                         max_symbol, 1 if use_low_prob else 0,
                                         _ptr(norm))
    return None if r < 0 else norm


def fse_write_ncount(norm: np.ndarray, max_symbol: int,
                     table_log: int) -> bytes | None:
    """FSE_writeNCount's bit layout."""
    nn = np.ascontiguousarray(norm[: max_symbol + 1], dtype=np.int32)
    out = np.empty(512, dtype=np.uint8)
    r = _kernels.host().zt_fse_write_ncount(_ptr(nn), max_symbol, table_log,
                                            _ptr(out), out.shape[0])
    return None if r < 0 else out[:r].tobytes()


def fse_build_ctable(norm: np.ndarray, max_symbol: int, table_log: int):
    """FSE_buildCTable: (state_table int32, delta_nb int64, delta_fs int64)
    laid out as format/fse.py's CTable, or None on an invalid norm."""
    state_table = np.empty(1 << table_log, dtype=np.int32)
    delta_nb = np.empty(max_symbol + 1, dtype=np.int64)
    delta_fs = np.empty(max_symbol + 1, dtype=np.int64)
    norm32 = np.ascontiguousarray(norm[: max_symbol + 1], dtype=np.int32)
    rc = _kernels.host().zt_fse_build_ctable(
        _ptr(norm32), max_symbol, table_log, _ptr(state_table),
        _ptr(delta_nb), _ptr(delta_fs))
    return None if rc != 0 else (state_table, delta_nb, delta_fs)


def fse_compress_2state(data: bytes, ct) -> bytes | None:
    """FSE_compress_usingCTable (two alternating states) with a
    format/fse.py CTable."""
    n = len(data)
    if n <= 2:
        return b""
    cap = 2 * n + 64
    out = np.empty(cap, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    st = np.ascontiguousarray(ct.state_table, dtype=np.int32)
    dnb = np.ascontiguousarray(ct.delta_nb_bits, dtype=np.int64)
    dfs = np.ascontiguousarray(ct.delta_find_state, dtype=np.int64)
    ln = _kernels.host().zt_fse_compress_2state(
        _ptr(src), n, ct.table_log, _ptr(st), _ptr(dnb), _ptr(dfs),
        _ptr(out), cap)
    return None if ln < 0 else out[:ln].tobytes()


def huf_build_write(count: np.ndarray, max_symbol: int, max_nb_bits: int):
    """The canonical Huffman table and its serialized tree description in
    one call (HUF_buildCTable_wksp + HUF_writeCTable_wksp). Returns
    (table_log, nb_bits, value, tree bytes), -2 for a tree that cannot be
    serialized (the caller raises), or None where the Python branch runs."""
    nb = np.zeros(256, dtype=np.int32)
    val = np.zeros(256, dtype=np.int32)
    tree = np.empty(960, dtype=np.uint8)
    tlen = ctypes.c_int64(0)
    cnt = np.ascontiguousarray(count, dtype=np.int64)
    if cnt.shape[0] < 256:
        cnt = np.pad(cnt, (0, 256 - cnt.shape[0]))
    r = _kernels.host().zt_huf_build_write(
        _ptr(cnt), max_symbol, max_nb_bits, _ptr(nb), _ptr(val), _ptr(tree),
        tree.shape[0], ctypes.byref(tlen))
    if r == -2:
        return -2
    if r < 0:
        return None
    return int(r), nb, val, tree[: tlen.value].tobytes()


def _huf_call(fn, data: bytes, nb: np.ndarray, val: np.ndarray,
              cap: int) -> bytes | None:
    out = np.empty(cap, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    nb = np.ascontiguousarray(nb, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.int32)
    r = fn(_ptr(src), len(src), _ptr(nb), _ptr(val), _ptr(out), cap)
    return None if r < 0 else out[:r].tobytes()


def huf_encode(data: bytes, nb: np.ndarray, val: np.ndarray) -> bytes | None:
    """One Huffman stream, last symbol first (HUF_compress1X_usingCTable)."""
    return _huf_call(_kernels.host().zt_huf_encode, data, nb, val,
                     2 * len(data) + 64)


def huf_encode4(data: bytes, nb: np.ndarray,
                val: np.ndarray) -> bytes | None:
    """The jump table and four Huffman streams
    (HUF_compress4X_usingCTable)."""
    return _huf_call(_kernels.host().zt_huf_encode4, data, nb, val,
                     2 * len(data) + 256)


def encode_sequences(ll, ob, mb, llc, ofc, mlc, ll_bits, ml_bits,
                     ct_ll, ct_of, ct_ml) -> bytes | None:
    """The interleaved 3-state FSE sequence bitstream
    (ZSTD_encodeSequences_body) with format/fse.py CTables."""
    cap = 16 * len(ll) + 64
    out = np.empty(cap, dtype=np.uint8)
    # the contiguous copies stay alive across the call
    a32 = [np.ascontiguousarray(x, dtype=np.int32)
           for x in (ll, ob, mb, llc, ofc, mlc, ll_bits, ml_bits)]
    tables = []
    for ct in (ct_ll, ct_of, ct_ml):
        tables.append((ct.table_log,
                       np.ascontiguousarray(ct.state_table, dtype=np.int32),
                       np.ascontiguousarray(ct.delta_nb_bits, dtype=np.int64),
                       np.ascontiguousarray(ct.delta_find_state,
                                            dtype=np.int64)))
    args = [len(ll)] + [_ptr(a) for a in a32]
    for tlog, st, dnb, dfs in tables:
        args += [tlog, _ptr(st), _ptr(dnb), _ptr(dfs)]
    r = _kernels.host().zt_encode_sequences(*args, _ptr(out), cap)
    return None if r < 0 else out[:r].tobytes()


# ---- the device encode's batch planner (plan.c) -----------------------------

# a block's record from plan_batch, one int64 each: the literal kind (0 raw,
# 1 RLE, 2 Huffman), single stream, the four stream sizes, c_size, est,
# last_count, nb_seq, nb_lit, all_same, first_lit, the sequences header's
# and the tree's offset and length in the arena, the Huffman table's log and
# max symbol
PLAN_FIELDS = ("kind", "single", "size0", "size1", "size2", "size3",
               "c_size", "est", "last_count", "nb_seq", "nb_lit", "all_same",
               "first_lit", "hdr_off", "hdr_len", "tree_off", "tree_len",
               "huf_log", "huf_max_symbol")
_ARENA_PER_BLOCK = 1024     # a sequences header and a tree fit in 648 B


@functools.lru_cache(maxsize=None)
def _plan_tables():
    from .constants import (LL_BITS, LL_DEFAULT_DIST, ML_BITS,
                            ML_DEFAULT_DIST, OF_DEFAULT_DIST)
    from .format.sequences import K_INV_PROB_LOG256
    return (*(np.ascontiguousarray(t, dtype=np.int32) for t in (
        LL_BITS[:36], ML_BITS[:53], LL_DEFAULT_DIST, OF_DEFAULT_DIST,
        ML_DEFAULT_DIST)), np.ascontiguousarray(K_INV_PROB_LOG256,
                                                dtype=np.int64))


def plan_batch(stats: np.ndarray, lens: np.ndarray, strategy: int,
               plan_len: int):
    """Every block's entropy plan from its stats vector in one call:
    (plan rows int32[B, plan_len], records int64[B, len(PLAN_FIELDS)], the
    arena of sequences headers and tree descriptions as bytes)."""
    stats = np.ascontiguousarray(stats, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    b = stats.shape[0]
    if stats.ndim != 2 or lens.shape != (b,):
        raise ValueError(f"plan_batch: stats {stats.shape} and lens "
                         f"{lens.shape} are not [B, n] and [B]")
    blob = np.empty((b, plan_len), dtype=np.int32)
    rec = np.empty((b, len(PLAN_FIELDS)), dtype=np.int64)
    arena = np.empty(b * _ARENA_PER_BLOCK, dtype=np.uint8)
    r = _kernels.host().zt_plan_batch(
        _ptr(stats), stats.shape[1], _ptr(lens), b, strategy,
        *(_ptr(t) for t in _plan_tables()), _ptr(blob), plan_len, _ptr(rec),
        rec.shape[1], _ptr(arena), arena.shape[0])
    if r < 0:
        raise RuntimeError(
            "zt_plan_batch: " + ("layout or arena mismatch" if r == -1 else
                                 f"block {-2 - r} cannot be planned"))
    return blob, rec, arena[:r].tobytes()


# ---- the block decoder (decode.c) -------------------------------------------

def dctx_new() -> int:
    """A decoder context: the entropy tables and repcodes one frame's blocks
    carry from block to block. Free it with dctx_free."""
    return _kernels.host().zt_dctx_new()


def dctx_free(ctx: int) -> None:
    _kernels.host().zt_dctx_free(ctx)


def decompress_block(ctx: int, payload: bytes, dst: np.ndarray, dst_pos: int,
                     window_low: int, block_max: int) -> int:
    """Decode one compressed block at dst[dst_pos:] (dst: the writable uint8
    window of the whole frame). Returns the bytes produced, or -1 where the
    C declines (the caller runs the Python decoder)."""
    src = np.frombuffer(payload, dtype=np.uint8)
    return _kernels.host().zt_decompress_block(
        ctx, _ptr(src), len(src), _ptr(dst), dst_pos, len(dst), window_low,
        block_max)


def decompress_blocks(ctx: int, src: bytes, src_off: int, dst: np.ndarray,
                      dst_pos: int, window_size: int, block_max: int):
    """Walk every block of one frame in C. `src` is the whole input (any
    bytes-like object), read from src_off by pointer (no copy). Returns
    (produced, consumed), or None where the C declines (the caller takes
    the per-block path)."""
    consumed = ctypes.c_int64(0)
    buf = np.frombuffer(src, dtype=np.uint8)
    r = _kernels.host().zt_decompress_blocks(
        ctx, buf.ctypes.data + src_off, len(buf) - src_off, _ptr(dst),
        dst_pos, len(dst), window_size, block_max, ctypes.byref(consumed))
    if r < 0:
        return None
    return int(r), int(consumed.value)


# ---- the device decode's host parse (decode.c) ------------------------------

# a Huffman stream's record from parse_frame, one int64 each: its start and
# end in the bytes handed in, its symbol count, its table
PARSE_LANE_FIELDS = ("start", "end", "n_syms", "table")
# a literal-pool segment's record: its start in the pool, its lane (a
# device segment), its start in the host pool (a host segment), whether the
# device decodes it
PARSE_SEG_FIELDS = ("start", "lane", "src", "is_dev")
# the frame's totals: content length, literal-pool length, the end of its
# last block (from the bytes' start), then the records and bytes of each
# array
PARSE_TOTALS = ("n", "pool_len", "end", "lanes", "tables", "segs", "seqs",
                "host_len")
PARSE_ROOM = -21              # some array was short: totals say how long
PARSE_NO_MEMORY = -22
_LUT = 1 << 11                # a table's entries (ops/decode_dev.MAX_TLOG)


def _parse_room(m: int) -> dict:
    """First guesses of the arrays' lengths for m bytes of blocks. A 4 MiB
    level-1 frame of the port's takes 1.7 MB: 32 blocks with a table and
    4 lanes each, and 137,265 sequences (12.4 B each). A frame past a
    guess is parsed again with the lengths the first call counted."""
    blocks = m // 4096 + 16
    return dict(lanes=4 * blocks, tables=blocks, segs=5 * blocks,
                host_len=m + 4096, seqs=m // 2 + 4096)


def parse_frame(src, off: int, window: int, stream_cap: int):
    """Walk one frame's blocks from src[off] (its first block header; src
    any bytes-like object, read by pointer) in one C call: the Huffman
    streams (records PARSE_LANE_FIELDS), each tree's decode table spread
    over 2^11 entries (uint8 symbols and lengths), the literal pool's
    segments (PARSE_SEG_FIELDS) and host bytes, the frame-global ll, ml and
    off (int64, absolute offsets, literal-only pseudo-sequences included),
    the content length `n`, the pool length and the `end` of the last
    block, in a dict. Returns a negative int where the C refuses the frame
    (decode.c's PF_ codes)."""
    buf = np.frombuffer(src, dtype=np.uint8)
    if not 0 <= off <= len(buf):
        raise ValueError(f"parse_frame: offset {off} outside {len(buf)} B")
    m = len(buf) - off
    room = _parse_room(m)
    totals = np.zeros(len(PARSE_TOTALS), dtype=np.int64)
    for _ in range(2):
        lanes = np.empty((room["lanes"], len(PARSE_LANE_FIELDS)), np.int64)
        lut_sym = np.empty((room["tables"], _LUT), np.uint8)
        lut_len = np.empty((room["tables"], _LUT), np.uint8)
        segs = np.empty((room["segs"], len(PARSE_SEG_FIELDS)), np.int64)
        pool = np.empty(room["host_len"], np.uint8)
        seqs = np.empty((3, room["seqs"]), np.int64)
        r = _kernels.host().zt_parse_frame(
            buf.ctypes.data + off, m, window, stream_cap,
            _ptr(lanes), room["lanes"], _ptr(lut_sym), _ptr(lut_len),
            room["tables"], _ptr(segs), room["segs"], _ptr(pool),
            room["host_len"], _ptr(seqs[0]), _ptr(seqs[1]), _ptr(seqs[2]),
            room["seqs"], _ptr(totals))
        if r != PARSE_ROOM:
            break
        room = dict(zip(PARSE_TOTALS, totals.tolist()))
    else:
        raise RuntimeError("zt_parse_frame: short of room with the lengths "
                           "it counted")
    if r == PARSE_NO_MEMORY:
        raise MemoryError("zt_parse_frame")
    if r < 0:
        return int(r)
    t = dict(zip(PARSE_TOTALS, totals.tolist()))
    nseq = t["seqs"]
    return dict(n=t["n"], pool_len=t["pool_len"], end=t["end"],
                lanes=lanes[:t["lanes"]], lut_sym=lut_sym[:t["tables"]],
                lut_len=lut_len[:t["tables"]], segs=segs[:t["segs"]],
                host_pool=pool[:t["host_len"]].tobytes(),
                ll=seqs[0, :nseq], ml=seqs[1, :nseq], off=seqs[2, :nseq])
