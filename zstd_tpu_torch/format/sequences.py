"""Sequences section: encoding-type selection, table builds and the section
writer (encoder), header parsing and the 3-state FSE sequence decode
(decoder).

Copy of zstd_tpu/format/sequences.py's functions that the device pipeline's
host planning, the host frame encoder (format/frame.py) and the device
decoder's host parse use. encode_sequences calls the port's copy of
zstd_tpu's C (csrc/host/encode.c) where zstd_tpu's does; its Python branch
is encode_sequences_plain. Parity targets: zstd's
lib/compress/zstd_compress_sequences.c (ZSTD_selectEncodingType,
ZSTD_buildCTable, ZSTD_fseBitCost, ZSTD_encodeSequences_body:291),
lib/compress/zstd_compress.c ZSTD_buildSequencesStatistics:2757 (LL table,
then OF, then ML; set_compressed decrements the last sequence's code count
before normalization) and lib/decompress/zstd_decompress_block.c
(ZSTD_decodeSeqHeaders:695, ZSTD_buildSeqTable:647, the sequence decode
loops).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..constants import (
    LL_BASE, LL_BITS, LL_DEFAULT_DIST, LL_DEFAULT_LOG, LL_FSE_LOG,
    MAX_LL_CODE, MAX_ML_CODE, MAX_OFF_CODE,
    ML_BASE, ML_BITS, ML_DEFAULT_DIST, ML_DEFAULT_LOG, ML_FSE_LOG,
    MODE_FSE, MODE_PREDEFINED, MODE_REPEAT, MODE_RLE,
    OF_DEFAULT_DIST, OF_DEFAULT_LOG, OF_FSE_LOG,
    _LL_CODE_TABLE, _ML_CODE_TABLE,
)
from .. import native
from ..errors import Corruption
from . import fse
from .bitstream import BitReader, pack_fields

LONGNBSEQ = 0x7F00
DEFAULT_MAX_OFF = 28  # largest offset code in the predefined distribution

# floor(256*log2(256/i)); exact-integer recomputation of the reference's
# kInverseProbabilityLog256 table (zstd_compress_sequences.c:21).
_T256 = 256 ** 256
K_INV_PROB_LOG256 = np.array(
    [0] + [(_T256 // (i ** 256)).bit_length() - 1 for i in range(1, 256)],
    dtype=np.int64)


class FSERepeat:
    NONE = 0
    CHECK = 1
    VALID = 2


def _use_low_prob_count(nb_seq: int) -> bool:
    return nb_seq >= 2048


def _entropy_cost(count: np.ndarray, mx: int, total: int) -> int:
    c = np.asarray(count[: mx + 1], dtype=np.int64)
    norm = (256 * c) // total
    norm = np.where((c != 0) & (norm == 0), 1, norm)
    return int(np.dot(c, K_INV_PROB_LOG256[norm])) >> 8


def _cross_entropy_cost(norm: np.ndarray, accuracy_log: int,
                        count: np.ndarray, mx: int) -> int:
    shift = 8 - accuracy_log
    na = np.asarray(norm[: mx + 1], dtype=np.int64)
    norm256 = np.where(na == -1, 1, na) << shift
    c = np.asarray(count[: mx + 1], dtype=np.int64)
    return int(np.dot(c, K_INV_PROB_LOG256[norm256])) >> 8


def _fse_bit_cost(ctable: fse.CTable, count: np.ndarray, mx: int) -> int | None:
    """ZSTD_fseBitCost; None signals 'table cannot represent count'."""
    k_acc = 8
    table_log = ctable.table_log
    if ctable.max_symbol < mx:
        return None
    c = np.asarray(count[: mx + 1], dtype=np.int64)
    used = c != 0
    # FSE_bitCost: deltaNbBits-based fractional bit cost, vectorized
    delta = np.asarray(ctable.delta_nb_bits[: mx + 1], dtype=np.int64)
    min_nb_bits = delta >> 16  # nbBits when state is at max
    if np.any(used & (min_nb_bits + 1 > table_log)):
        return None
    table_size = 1 << table_log
    threshold = (min_nb_bits + 1) << 16
    normalized_delta = ((threshold - (delta + table_size)) << k_acc) >> table_log
    bit_cost = (min_nb_bits << k_acc) + normalized_delta
    if np.any(used & (bit_cost >= ((table_log + 1) << k_acc))):
        return None
    return int(np.dot(c, np.where(used, bit_cost, 0))) >> k_acc


def _ncount_cost(count: np.ndarray, mx: int, nb_seq: int, fse_log: int) -> int:
    table_log = fse.optimal_table_log(fse_log, nb_seq, mx)
    norm = fse.normalize_count(count, table_log, nb_seq, mx,
                               _use_low_prob_count(nb_seq))
    return len(fse.write_ncount(norm, mx, table_log))


def select_encoding_type(repeat_mode: int, count: np.ndarray, mx: int,
                         most_frequent: int, nb_seq: int, fse_log: int,
                         prev_ctable: fse.CTable | None,
                         default_norm: np.ndarray, default_norm_log: int,
                         is_default_allowed: bool, strategy: int
                         ) -> tuple[int, int]:
    """Returns (mode, new_repeat_mode)."""
    if most_frequent == nb_seq:
        if is_default_allowed and nb_seq <= 2:
            return MODE_PREDEFINED, FSERepeat.NONE
        return MODE_RLE, FSERepeat.NONE
    ZSTD_LAZY = 5
    if strategy < ZSTD_LAZY:
        if is_default_allowed:
            static_fse_nbseq_max = 1000
            mult = 10 - strategy
            dynamic_fse_nbseq_min = ((1 << default_norm_log) * mult) >> 3
            if repeat_mode == FSERepeat.VALID and nb_seq < static_fse_nbseq_max:
                return MODE_REPEAT, repeat_mode
            if (nb_seq < dynamic_fse_nbseq_min
                    or most_frequent < (nb_seq >> (default_norm_log - 1))):
                return MODE_PREDEFINED, FSERepeat.NONE
    else:
        basic_cost = (_cross_entropy_cost(default_norm, default_norm_log, count, mx)
                      if is_default_allowed else None)
        repeat_cost = (_fse_bit_cost(prev_ctable, count, mx)
                       if (repeat_mode != FSERepeat.NONE and prev_ctable is not None)
                       else None)
        ncount_cost = _ncount_cost(count, mx, nb_seq, fse_log)
        compressed_cost = (ncount_cost << 3) + _entropy_cost(count, mx, nb_seq)
        inf = 1 << 62
        bc = basic_cost if basic_cost is not None else inf
        rc = repeat_cost if repeat_cost is not None else inf
        if bc <= rc and bc <= compressed_cost:
            return MODE_PREDEFINED, FSERepeat.NONE
        if rc <= compressed_cost:
            return MODE_REPEAT, repeat_mode
    return MODE_FSE, FSERepeat.CHECK


@functools.lru_cache(maxsize=None)
def _predef_ctable_cached(default_max: int, default_norm_log: int) -> fse.CTable:
    """The three predefined tables are constants — build each once per
    process (the reference keeps them static in zstd_internal.h)."""
    norm = {(MAX_LL_CODE, LL_DEFAULT_LOG): LL_DEFAULT_DIST,
            (DEFAULT_MAX_OFF, OF_DEFAULT_LOG): OF_DEFAULT_DIST,
            (MAX_ML_CODE, ML_DEFAULT_LOG): ML_DEFAULT_DIST}[
        (default_max, default_norm_log)].astype(np.int32)
    return fse.build_ctable(norm, default_max, default_norm_log)


@functools.lru_cache(maxsize=128)
def _rle_ctable_cached(mx: int) -> fse.CTable:
    return fse.build_ctable_rle(mx)


def build_seq_ctable(mode: int, count: np.ndarray, mx: int,
                     last_code: int, nb_seq: int, fse_log: int,
                     default_norm: np.ndarray, default_norm_log: int,
                     default_max: int, prev_ctable: fse.CTable | None
                     ) -> tuple[fse.CTable, bytes]:
    """ZSTD_buildCTable: returns (ctable, serialized table description).
    last_code: code of the final sequence (its count is decremented before
    normalization since the init state carries it). In RLE mode all codes
    equal mx."""
    if mode == MODE_RLE:
        return _rle_ctable_cached(mx), bytes([mx])
    if mode == MODE_REPEAT:
        assert prev_ctable is not None
        return prev_ctable, b""
    if mode == MODE_PREDEFINED:
        try:
            return _predef_ctable_cached(default_max, default_norm_log), b""
        except KeyError:  # non-standard default table: build directly
            norm = default_norm.astype(np.int32)
            return fse.build_ctable(norm, default_max, default_norm_log), b""
    assert mode == MODE_FSE
    table_log = fse.optimal_table_log(fse_log, nb_seq, mx)
    cnt = count.copy()
    nb_seq_1 = nb_seq
    if cnt[last_code] > 1:
        cnt[last_code] -= 1
        nb_seq_1 -= 1
    norm = fse.normalize_count(cnt, table_log, nb_seq_1, mx,
                               _use_low_prob_count(nb_seq_1))
    header = fse.write_ncount(norm, mx, table_log)
    return fse.build_ctable(norm, mx, table_log), header


@dataclasses.dataclass
class FseEntropyState:
    """Per-frame carried FSE tables + repeat modes (ZSTD_fseCTables_t analog)."""
    ct_ll: fse.CTable | None = None
    ct_of: fse.CTable | None = None
    ct_ml: fse.CTable | None = None
    ll_repeat: int = FSERepeat.NONE
    of_repeat: int = FSERepeat.NONE
    ml_repeat: int = FSERepeat.NONE

    def copy(self) -> "FseEntropyState":
        return FseEntropyState(self.ct_ll, self.ct_of, self.ct_ml,
                               self.ll_repeat, self.of_repeat, self.ml_repeat)


@dataclasses.dataclass
class SeqStore:
    """Canonical sequence intermediate (SoA; mirrors seqDef semantics but with
    full-width int32 lengths — no 16-bit longLength workaround needed)."""
    lit_length: np.ndarray  # int32[n]
    off_base: np.ndarray    # int32[n] == spec Offset_Value
    ml_base: np.ndarray     # int32[n] == matchLength - MINMATCH
    literals: bytes         # all literal bytes (incl. trailing run)

    @property
    def nb_seq(self) -> int:
        return len(self.lit_length)


def seq_to_codes_np(ll: np.ndarray, ob: np.ndarray, mlb: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized numpy code conversion (exact for values < 2^53)."""
    def hb(x):
        return (np.frexp(x.astype(np.float64))[1] - 1).astype(np.int32)
    ll = np.asarray(ll, dtype=np.int64)
    ob = np.asarray(ob, dtype=np.int64)
    mlb = np.asarray(mlb, dtype=np.int64)
    llc = np.where(ll > 63, hb(np.maximum(ll, 1)) + 19,
                   _LL_CODE_TABLE[np.minimum(ll, 63)])
    mlc = np.where(mlb > 127, hb(np.maximum(mlb, 1)) + 36,
                   _ML_CODE_TABLE[np.minimum(mlb, 127)])
    ofc = hb(ob)
    return llc.astype(np.int32), ofc.astype(np.int32), mlc.astype(np.int32)


def _state_chain(ct: fse.CTable, codes: np.ndarray):
    """One FSE state over codes[n-1] (its initial symbol), then codes[n-2]
    .. codes[0] (fse.CState's init and encode): the (value, nbits) field
    written before each of those n - 1 symbols, and the final state."""
    st = ct.state_table.tolist()
    dnb = ct.delta_nb_bits.tolist()
    dfs = ct.delta_find_state.tolist()
    first = int(codes[-1])
    nb_out = (dnb[first] + (1 << 15)) >> 16
    value = st[(((nb_out << 16) - dnb[first]) >> nb_out) + dfs[first]]
    vals, nbs = [], []
    for sym in codes[-2::-1].tolist():
        nb_out = (value + dnb[sym]) >> 16
        vals.append(value)
        nbs.append(nb_out)
        value = st[(value >> nb_out) + dfs[sym]]
    return vals, nbs, value


def encode_sequences(seqs: SeqStore, llc: np.ndarray, ofc: np.ndarray,
                     mlc: np.ndarray, ct_ll: fse.CTable, ct_of: fse.CTable,
                     ct_ml: fse.CTable) -> bytes:
    """ZSTD_encodeSequences_body's bitstream."""
    assert seqs.nb_seq > 0
    r = native.encode_sequences(seqs.lit_length, seqs.off_base, seqs.ml_base,
                                llc, ofc, mlc, LL_BITS, ML_BITS,
                                ct_ll, ct_of, ct_ml)
    if r is not None:
        return r
    return encode_sequences_plain(seqs, llc, ofc, mlc, ct_ll, ct_of, ct_ml)


def encode_sequences_plain(seqs: SeqStore, llc: np.ndarray, ofc: np.ndarray,
                           mlc: np.ndarray, ct_ll: fse.CTable,
                           ct_of: fse.CTable, ct_ml: fse.CTable) -> bytes:
    """The Python branch of encode_sequences: the last sequence's extra bits
    (LL, ML, OF), then for each earlier sequence, last to first, the OF, ML
    and LL state fields and its LL, ML and OF extra bits, then the ML, OF
    and LL final states. The three state chains are independent, so each
    runs alone; the fields are then interleaved and packed at once."""
    n = seqs.nb_seq
    assert n > 0
    vals = np.zeros(6 * n, dtype=np.int64)
    nbits = np.zeros(6 * n, dtype=np.int64)
    ll = seqs.lit_length.astype(np.int64)
    mb = seqs.ml_base.astype(np.int64)
    ob = seqs.off_base.astype(np.int64)
    # extra bits: the last sequence's at fields 0-2, sequence i < n - 1's at
    # fields 3 + 6 (n - 2 - i) + 3..5
    at = np.concatenate(([0], 6 + 6 * np.arange(n - 1)))
    order = np.concatenate(([n - 1], np.arange(n - 2, -1, -1)))
    for j, (x, b) in enumerate(((ll, LL_BITS[llc]), (mb, ML_BITS[mlc]),
                                (ob, ofc))):
        vals[at + j] = x[order]
        nbits[at + j] = np.asarray(b, dtype=np.int64)[order]
    states = 3 + 6 * np.arange(n - 1)
    finals = []
    for j, (ct, codes) in enumerate(((ct_of, ofc), (ct_ml, mlc),
                                     (ct_ll, llc))):
        v, b, last = _state_chain(ct, np.asarray(codes))
        vals[states + j] = v
        nbits[states + j] = b
        finals.append((last, ct.table_log))
    for j, (last, tlog) in enumerate((finals[1], finals[0], finals[2])):
        vals[6 * n - 3 + j] = last
        nbits[6 * n - 3 + j] = tlog
    return pack_fields(vals, nbits)


def write_nbseq_header(n: int) -> bytes:
    out = bytearray()
    if n < 128:
        out.append(n)
    elif n < LONGNBSEQ:
        out.append((n >> 8) + 0x80)
        out.append(n & 0xFF)
    else:
        out.append(0xFF)
        out += (n - LONGNBSEQ).to_bytes(2, "little")
    return bytes(out)


def build_sequences_header_from_hists(
        ll_hist: np.ndarray, of_hist: np.ndarray, ml_hist: np.ndarray,
        last_codes: tuple[int, int, int], nb_seq: int,
        prev: FseEntropyState, strategy: int
) -> tuple[bytes, FseEntropyState, int]:
    """Header+tables (no bitstream): returns (bytes, next state,
    last_count_size). Takes only histograms + the last sequence's codes so the
    device pipeline never needs the per-sequence code arrays on host.
    last_codes = (ll, of, ml) codes of the final sequence."""
    out = bytearray(write_nbseq_header(nb_seq))
    nxt = prev.copy()
    if nb_seq == 0:
        return bytes(out), nxt, 0
    n = nb_seq
    last_count_size = 0

    ll_last, of_last, ml_last = last_codes

    # LL
    cnt = ll_hist.astype(np.int64)
    mx = int(np.nonzero(cnt)[0][-1])
    most = int(cnt.max())
    ll_mode, nxt.ll_repeat = select_encoding_type(
        prev.ll_repeat, cnt, mx, most, n, LL_FSE_LOG, prev.ct_ll,
        LL_DEFAULT_DIST, LL_DEFAULT_LOG, True, strategy)
    nxt.ct_ll, ll_hdr = build_seq_ctable(
        ll_mode, cnt, mx, ll_last, n, LL_FSE_LOG,
        LL_DEFAULT_DIST, LL_DEFAULT_LOG, MAX_LL_CODE, prev.ct_ll)
    if ll_mode == MODE_FSE:
        last_count_size = len(ll_hdr)

    # OF
    cnt_of = of_hist.astype(np.int64)
    mx_of = int(np.nonzero(cnt_of)[0][-1])
    most_of = int(cnt_of.max())
    default_allowed = mx_of <= DEFAULT_MAX_OFF
    of_mode, nxt.of_repeat = select_encoding_type(
        prev.of_repeat, cnt_of, mx_of, most_of, n, OF_FSE_LOG, prev.ct_of,
        OF_DEFAULT_DIST, OF_DEFAULT_LOG, default_allowed, strategy)
    nxt.ct_of, of_hdr = build_seq_ctable(
        of_mode, cnt_of, mx_of, of_last, n, OF_FSE_LOG,
        OF_DEFAULT_DIST, OF_DEFAULT_LOG, DEFAULT_MAX_OFF, prev.ct_of)
    if of_mode == MODE_FSE:
        last_count_size = len(of_hdr)

    # ML
    cnt_ml = ml_hist.astype(np.int64)
    mx_ml = int(np.nonzero(cnt_ml)[0][-1])
    most_ml = int(cnt_ml.max())
    ml_mode, nxt.ml_repeat = select_encoding_type(
        prev.ml_repeat, cnt_ml, mx_ml, most_ml, n, ML_FSE_LOG, prev.ct_ml,
        ML_DEFAULT_DIST, ML_DEFAULT_LOG, True, strategy)
    nxt.ct_ml, ml_hdr = build_seq_ctable(
        ml_mode, cnt_ml, mx_ml, ml_last, n, ML_FSE_LOG,
        ML_DEFAULT_DIST, ML_DEFAULT_LOG, MAX_ML_CODE, prev.ct_ml)
    if ml_mode == MODE_FSE:
        last_count_size = len(ml_hdr)

    out.append((ll_mode << 6) + (of_mode << 4) + (ml_mode << 2))
    out += ll_hdr
    out += of_hdr
    out += ml_hdr
    return bytes(out), nxt, last_count_size


def build_sequences_header(llc: np.ndarray, ofc: np.ndarray, mlc: np.ndarray,
                           nb_seq: int, prev: FseEntropyState, strategy: int
                           ) -> tuple[bytes, FseEntropyState, int]:
    """Header+tables (no bitstream) from full code arrays."""
    if nb_seq == 0:
        return write_nbseq_header(0), prev.copy(), 0
    hists = tuple(np.bincount(c, minlength=m + 1).astype(np.int64)
                  for c, m in ((llc, MAX_LL_CODE), (ofc, MAX_OFF_CODE),
                               (mlc, MAX_ML_CODE)))
    last = (int(llc[nb_seq - 1]), int(ofc[nb_seq - 1]), int(mlc[nb_seq - 1]))
    return build_sequences_header_from_hists(hists[0], hists[1], hists[2],
                                             last, nb_seq, prev, strategy)


def write_sequences_section(seqs: SeqStore, prev: FseEntropyState,
                            strategy: int) -> tuple[bytes, FseEntropyState]:
    """Serialize nbSeq header + modes + tables + bitstream; returns the bytes
    and the next entropy state. Mirrors ZSTD_entropyCompressSeqStore_internal
    (sequences part) including the <=1.3.4 lastCountSize workaround."""
    n = seqs.nb_seq
    if n == 0:
        return write_nbseq_header(0), prev.copy()
    llc, ofc, mlc = seq_to_codes_np(seqs.lit_length, seqs.off_base,
                                    seqs.ml_base)
    header, nxt, last_count_size = build_sequences_header(
        llc, ofc, mlc, n, prev, strategy)
    bitstream = encode_sequences(seqs, llc, ofc, mlc,
                                 nxt.ct_ll, nxt.ct_of, nxt.ct_ml)
    if last_count_size and (last_count_size + len(bitstream)) < 4:
        # zstd <=1.3.4 decoder bug workaround: signal caller to emit raw block
        raise _EmitRawBlock()
    return header + bitstream, nxt


class _EmitRawBlock(Exception):
    """Internal: the <=1.3.4 workaround forces a raw block."""


# --------------------------------------------------------------------------
# Decode side
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FseDecodeState:
    """Per-frame carried decode tables (ZSTD_entropyDTables_t analog)."""
    dt_ll: fse.DTable | None = None
    dt_of: fse.DTable | None = None
    dt_ml: fse.DTable | None = None

    def copy(self) -> "FseDecodeState":
        return FseDecodeState(self.dt_ll, self.dt_of, self.dt_ml)


_PREDEF_DT_LL = fse.build_dtable(LL_DEFAULT_DIST.astype(np.int32), LL_DEFAULT_LOG)
_PREDEF_DT_OF = fse.build_dtable(OF_DEFAULT_DIST.astype(np.int32), OF_DEFAULT_LOG)
_PREDEF_DT_ML = fse.build_dtable(ML_DEFAULT_DIST.astype(np.int32), ML_DEFAULT_LOG)


def _build_seq_dtable(mode: int, data: bytes, max_code: int, max_log: int,
                      predef: fse.DTable, prev: fse.DTable | None
                      ) -> tuple[fse.DTable, int]:
    """ZSTD_buildSeqTable: returns (dtable, bytes consumed)."""
    if mode == MODE_PREDEFINED:
        return predef, 0
    if mode == MODE_RLE:
        if len(data) < 1:
            raise Corruption("RLE table: missing symbol byte")
        sym = data[0]
        if sym > max_code:
            raise Corruption("RLE table: symbol out of range")
        return fse.build_dtable_rle(sym), 1
    if mode == MODE_REPEAT:
        if prev is None:
            raise Corruption("repeat mode without previous table")
        return prev, 0
    assert mode == MODE_FSE
    norm, max_sym, table_log, consumed = fse.read_ncount(data, max_code, max_log)
    return fse.build_dtable(norm, table_log), consumed


def parse_sequences_section(data: bytes, prev: FseDecodeState
                            ) -> tuple[int, FseDecodeState, int]:
    """Parse nbSeq + modes + tables. Returns (nb_seq, tables, header_len)."""
    if len(data) < 1:
        raise Corruption("sequences section: empty")
    b0 = data[0]
    if b0 < 128:
        nb_seq = b0
        pos = 1
    elif b0 < 255:
        if len(data) < 2:
            raise Corruption("sequences section: truncated nbSeq")
        nb_seq = ((b0 - 0x80) << 8) + data[1]
        pos = 2
    else:
        if len(data) < 3:
            raise Corruption("sequences section: truncated nbSeq")
        nb_seq = data[1] + (data[2] << 8) + LONGNBSEQ
        pos = 3
    if nb_seq == 0:
        return 0, prev.copy(), pos

    if len(data) < pos + 1:
        raise Corruption("sequences section: missing modes byte")
    modes = data[pos]
    pos += 1
    if modes & 0x3:
        raise Corruption("sequences section: reserved mode bits set")
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3

    nxt = prev.copy()
    nxt.dt_ll, c = _build_seq_dtable(ll_mode, data[pos:], MAX_LL_CODE,
                                     LL_FSE_LOG, _PREDEF_DT_LL, prev.dt_ll)
    pos += c
    nxt.dt_of, c = _build_seq_dtable(of_mode, data[pos:], MAX_OFF_CODE,
                                     OF_FSE_LOG, _PREDEF_DT_OF, prev.dt_of)
    pos += c
    nxt.dt_ml, c = _build_seq_dtable(ml_mode, data[pos:], MAX_ML_CODE,
                                     ML_FSE_LOG, _PREDEF_DT_ML, prev.dt_ml)
    pos += c
    return nb_seq, nxt, pos


def decode_sequences(bitstream: bytes, nb_seq: int, st: FseDecodeState
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode nb_seq (litLength, offBase/Offset_Value, matchLength) triples.

    Spec "Decoding Sequences": states init LL,OF,ML; per sequence read OF
    extra bits, then ML, then LL; state updates LL,ML,OF (skipped for last).
    Repcode resolution happens at execution, not here; offBase is returned raw.
    """
    dt_ll, dt_of, dt_ml = st.dt_ll, st.dt_of, st.dt_ml
    assert dt_ll is not None and dt_of is not None and dt_ml is not None
    br = BitReader(bitstream)
    s_ll = br.read(dt_ll.table_log)
    s_of = br.read(dt_of.table_log)
    s_ml = br.read(dt_ml.table_log)
    if br.overflowed:
        raise Corruption("sequence bitstream too short for initial states")

    lls = np.zeros(nb_seq, dtype=np.int64)
    ofs = np.zeros(nb_seq, dtype=np.int64)
    mls = np.zeros(nb_seq, dtype=np.int64)
    for i in range(nb_seq):
        ll_code_v = int(dt_ll.symbol[s_ll])
        of_code_v = int(dt_of.symbol[s_of])
        ml_code_v = int(dt_ml.symbol[s_ml])
        if of_code_v > MAX_OFF_CODE:
            raise Corruption("offset code too large")
        of_extra = br.read(of_code_v)
        off_base = (1 << of_code_v) + of_extra
        ml = int(ML_BASE[ml_code_v]) + br.read(int(ML_BITS[ml_code_v]))
        ll = int(LL_BASE[ll_code_v]) + br.read(int(LL_BITS[ll_code_v]))
        if br.overflowed:
            raise Corruption("sequence bitstream over-read")
        lls[i] = ll
        ofs[i] = off_base
        mls[i] = ml
        if i < nb_seq - 1:
            s_ll = int(dt_ll.new_state[s_ll]) + br.read(int(dt_ll.nb_bits[s_ll]))
            s_ml = int(dt_ml.new_state[s_ml]) + br.read(int(dt_ml.nb_bits[s_ml]))
            s_of = int(dt_of.new_state[s_of]) + br.read(int(dt_of.nb_bits[s_of]))
            if br.overflowed:
                raise Corruption("sequence bitstream over-read (state update)")
    if br.pos != 0:
        raise Corruption("sequence bitstream not fully consumed")
    return lls, ofs, mls
