"""ctypes wrappers of the port's host library (csrc/host/*.c).

Copy of the methods of zstd_tpu/native.py's _Native that the port's host
code calls, over the port's own copy of the C (built with the host C
compiler at first use by _kernels.host()): the parsers and whole-frame
encoders, the entropy planning and encoders, the block decoder and XXH64.
The parsers take the whole input `full` (uint8) and absolute positions, and
return (ll, ob, mb, new_reps): int32 literal lengths, spec Offset_Values
and match lengths - 3. There is no fallback: without a C compiler every
call raises. A call returns None only where the C declines, as
zstd_tpu's does; its caller then runs the Python branch, as zstd_tpu's
callers do.
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


def decode_sequences(ctx: int, payload: bytes):
    """Decode one block's sequences section (the FSE decode and the repcode
    resolution) without executing it; the tables and repcodes carry in
    ctx. Returns int32 (ll, ml, off) with absolute offsets, or None on a
    corrupt section."""
    cap = 0x7F00 + 0xFFFF + 16   # spec max nbSeq (RLE tables: 0 bits/seq)
    ll = np.empty(cap, dtype=np.int32)
    ml = np.empty(cap, dtype=np.int32)
    off = np.empty(cap, dtype=np.int32)
    src = np.frombuffer(payload, dtype=np.uint8)
    n = _kernels.host().zt_decode_sequences(ctx, _ptr(src), len(src),
                                            _ptr(ll), _ptr(ml), _ptr(off), cap)
    if n < 0:
        return None
    return ll[:n], ml[:n], off[:n]
