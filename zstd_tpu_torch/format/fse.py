"""Finite State Entropy (tANS) — exact RFC 8878 semantics.

Copy of zstd_tpu/format/fse.py: table-log selection,
the exact normalization (zstd's lib/compress/fse_compress.c
FSE_normalizeCount:465, FSE_normalizeM2:379), the normalized-count
serialization and parsing (FSE_writeNCount, "FSE Table Description"), the
encode- and decode-table builds (FSE_buildCTable_wksp:68,
fse_decompress.c FSE_buildDTable_internal) and the interleaved 2-state
byte codec used for Huffman weights (FSE_compress_usingCTable:610,
FSE_decompress_usingDTable_generic). normalize_count, write_ncount,
build_ctable and fse_compress_2state call the port's copy of zstd_tpu's C
(csrc/host/huf.c, encode.c) where zstd_tpu/format/fse.py does, and run
their Python branch, kept as the *_plain functions, where that C declines.
Host-side numpy + Python ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import FSE_DEFAULT_TABLELOG, FSE_MAX_TABLELOG, FSE_MIN_TABLELOG, highbit32
from .. import native
from ..errors import Corruption, ZstdError, ZstdErrorCode
from .bitstream import BitReader, BitWriter, ForwardBitReader


# --------------------------------------------------------------------------
# Table log selection
# --------------------------------------------------------------------------

def min_table_log(src_size: int, max_symbol: int) -> int:
    min_bits_src = highbit32(src_size) + 1
    min_bits_symbols = highbit32(max_symbol) + 2 if max_symbol else 2
    return min(min_bits_src, min_bits_symbols)


def optimal_table_log(max_table_log: int, src_size: int, max_symbol: int,
                      minus: int = 2) -> int:
    table_log = max_table_log or FSE_DEFAULT_TABLELOG
    max_bits_src = highbit32(src_size - 1) - minus if src_size > 1 else 0
    if max_bits_src < table_log:
        table_log = max_bits_src
    mb = min_table_log(src_size, max_symbol)
    if mb > table_log:
        table_log = mb
    return max(FSE_MIN_TABLELOG, min(FSE_MAX_TABLELOG, table_log))


# --------------------------------------------------------------------------
# Normalization (exact integer algorithm; required for compressed-size parity)
# --------------------------------------------------------------------------

_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


def _normalize_m2(norm: np.ndarray, table_log: int, count: np.ndarray,
                  total: int, max_symbol: int, low_prob_count: int) -> None:
    NOT_YET = -2
    distributed = 0
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)

    for s in range(max_symbol + 1):
        c = int(count[s])
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = low_prob_count
            distributed += 1
            total -= c
            continue
        if c <= low_one:
            norm[s] = 1
            distributed += 1
            total -= c
            continue
        norm[s] = NOT_YET
    to_distribute = (1 << table_log) - distributed

    if to_distribute == 0:
        return

    if (total // to_distribute) > low_one:
        low_one = (total * 3) // (to_distribute * 2)
        for s in range(max_symbol + 1):
            if norm[s] == NOT_YET and int(count[s]) <= low_one:
                norm[s] = 1
                distributed += 1
                total -= int(count[s])
        to_distribute = (1 << table_log) - distributed

    if distributed == max_symbol + 1:
        # all symbols low: dump remaining points on the most frequent symbol
        max_v, max_c = 0, 0
        for s in range(max_symbol + 1):
            if int(count[s]) > max_c:
                max_v, max_c = s, int(count[s])
        norm[max_v] += to_distribute
        return

    if total == 0:
        s = 0
        while to_distribute > 0:
            if norm[s] > 0:
                to_distribute -= 1
                norm[s] += 1
            s = (s + 1) % (max_symbol + 1)
        return

    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = (((1 << v_step_log) * to_distribute) + mid) // total
    tmp_total = mid
    for s in range(max_symbol + 1):
        if norm[s] == NOT_YET:
            end = tmp_total + int(count[s]) * r_step
            s_start = tmp_total >> v_step_log
            s_end = end >> v_step_log
            weight = s_end - s_start
            if weight < 1:
                raise ZstdError(ZstdErrorCode.GENERIC, "M2 normalization failed")
            norm[s] = weight
            tmp_total = end


def _checked_table_log(table_log: int, total: int, max_symbol: int) -> int:
    if table_log == 0:
        table_log = FSE_DEFAULT_TABLELOG
    if not (FSE_MIN_TABLELOG <= table_log <= FSE_MAX_TABLELOG):
        raise ZstdError(ZstdErrorCode.tableLog_tooLarge)
    if table_log < min_table_log(total, max_symbol):
        raise ZstdError(ZstdErrorCode.GENERIC, "tableLog too small")
    return table_log


def normalize_count(count: np.ndarray, table_log: int, total: int,
                    max_symbol: int, use_low_prob_count: bool) -> np.ndarray:
    """Exact FSE_normalizeCount. Returns int32 normalized counts.

    Raises if total == count[s] for some s (RLE case; caller must handle).
    """
    table_log = _checked_table_log(table_log, total, max_symbol)
    norm = native.fse_normalize(count, table_log, total, max_symbol,
                                use_low_prob_count)
    if norm is not None:
        return norm
    # the C declines the RLE case and an M2 failure: the Python branch
    # raises the typed error callers expect
    return normalize_count_plain(count, table_log, total, max_symbol,
                                 use_low_prob_count)


def normalize_count_plain(count: np.ndarray, table_log: int, total: int,
                          max_symbol: int,
                          use_low_prob_count: bool) -> np.ndarray:
    """The Python branch of normalize_count."""
    table_log = _checked_table_log(table_log, total, max_symbol)
    low_prob_count = -1 if use_low_prob_count else 1
    scale = 62 - table_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still_to_distribute = 1 << table_log
    largest = 0
    largest_p = 0
    low_threshold = total >> table_log

    norm = np.zeros(max_symbol + 1, dtype=np.int32)
    for s in range(max_symbol + 1):
        c = int(count[s])
        if c == total:
            raise ZstdError(ZstdErrorCode.GENERIC, "RLE special case")
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = low_prob_count
            still_to_distribute -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                if (c * step) - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = s
            norm[s] = proba
            still_to_distribute -= proba

    if -still_to_distribute >= (int(norm[largest]) >> 1):
        _normalize_m2(norm, table_log, count, total, max_symbol, low_prob_count)
    else:
        norm[largest] += still_to_distribute
    return norm


# --------------------------------------------------------------------------
# NCount serialization
# --------------------------------------------------------------------------

def write_ncount(norm: np.ndarray, max_symbol: int, table_log: int) -> bytes:
    """Serialize normalized counts (FSE_writeNCount exact bit layout)."""
    r = native.fse_write_ncount(norm, max_symbol, table_log)
    if r is not None:
        return r
    return write_ncount_plain(norm, max_symbol, table_log)


def write_ncount_plain(norm: np.ndarray, max_symbol: int,
                       table_log: int) -> bytes:
    """The Python branch of write_ncount."""
    out = bytearray()
    bit_stream = 0
    bit_count = 0

    def flush16():
        nonlocal bit_stream, bit_count
        out.append(bit_stream & 0xFF)
        out.append((bit_stream >> 8) & 0xFF)
        bit_stream >>= 16
        bit_count -= 16

    table_size = 1 << table_log
    bit_stream += (table_log - FSE_MIN_TABLELOG) << bit_count
    bit_count += 4
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    symbol = 0
    alphabet_size = max_symbol + 1
    previous_is0 = False

    while symbol < alphabet_size and remaining > 1:
        if previous_is0:
            start = symbol
            while symbol < alphabet_size and not norm[symbol]:
                symbol += 1
            if symbol == alphabet_size:
                raise ZstdError(ZstdErrorCode.GENERIC, "bad distribution")
            while symbol >= start + 24:
                start += 24
                bit_stream += 0xFFFF << bit_count
                flush16()
                bit_count += 16  # net: emitted 16 bits at current count
            while symbol >= start + 3:
                start += 3
                bit_stream += 3 << bit_count
                bit_count += 2
            bit_stream += (symbol - start) << bit_count
            bit_count += 2
            if bit_count > 16:
                flush16()
        count = int(norm[symbol])
        symbol += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1
        if count >= threshold:
            count += mx
        bit_stream += count << bit_count
        bit_count += nb_bits
        if count < mx:
            bit_count -= 1
        previous_is0 = (count == 1)
        if remaining < 1:
            raise ZstdError(ZstdErrorCode.GENERIC)
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if bit_count > 16:
            flush16()

    if remaining != 1:
        raise ZstdError(ZstdErrorCode.GENERIC, "incorrect normalized distribution")
    # flush remainder
    out.append(bit_stream & 0xFF)
    out.append((bit_stream >> 8) & 0xFF)
    n_extra = (bit_count + 7) // 8
    return bytes(out[: len(out) - 2 + n_extra])


def read_ncount(data: bytes, max_symbol_limit: int, max_log: int
                ) -> tuple[np.ndarray, int, int, int]:
    """Parse an FSE table description.

    Returns (norm int32 array sized max_symbol+1, max_symbol, table_log,
    bytes_consumed). Spec: "FSE Table Description".
    """
    if len(data) < 1:
        raise Corruption("NCount: empty input")
    br = ForwardBitReader(data)
    table_log = br.read(4) + FSE_MIN_TABLELOG
    if table_log > max_log:
        raise ZstdError(ZstdErrorCode.tableLog_tooLarge,
                        f"accuracy {table_log} > max {max_log}")
    table_size = 1 << table_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1

    norm = np.zeros(max_symbol_limit + 1, dtype=np.int32)
    charnum = 0
    previous_is0 = False
    while remaining > 1 and charnum <= max_symbol_limit:
        if previous_is0:
            # read zero-run flags
            while True:
                rep = br.read(2)
                charnum += rep
                if rep < 3:
                    break
            if charnum > max_symbol_limit:
                raise Corruption("NCount: too many symbols")
        mx = (2 * threshold - 1) - remaining
        low = br.peek(nb_bits - 1) & (threshold - 1)
        if low < mx:
            value = low
            br.skip(nb_bits - 1)
        else:
            full = br.read(nb_bits) & (2 * threshold - 1)
            value = full if full < threshold else full - mx
        proba = value - 1
        if proba == -1:
            remaining -= 1
            norm[charnum] = -1
        else:
            remaining -= proba
            norm[charnum] = proba
        charnum += 1
        previous_is0 = (proba == 0)
        if remaining < 1:
            raise Corruption("NCount: distribution overshoot")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

    if remaining != 1:
        raise Corruption("NCount: distribution does not sum to table size")
    if charnum < 2:
        raise Corruption("NCount: fewer than 2 symbols")
    max_symbol = charnum - 1
    nbytes = br.bytes_consumed
    if nbytes > len(data):
        raise Corruption("NCount: ran past input")
    return norm[: max_symbol + 1], max_symbol, table_log, nbytes


# --------------------------------------------------------------------------
# Decode table
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DTable:
    table_log: int
    symbol: np.ndarray     # int32[table_size]
    nb_bits: np.ndarray    # int32[table_size]
    new_state: np.ndarray  # int32[table_size] (baseline to add read bits to)


def build_dtable(norm: np.ndarray, table_log: int) -> DTable:
    table_size = 1 << table_log
    spread, _ = _spread_symbols(norm, table_log)
    symbol_next = np.where(norm == -1, 1, norm).astype(np.int64)
    nb_bits = np.zeros(table_size, dtype=np.int32)
    new_state = np.zeros(table_size, dtype=np.int32)
    for u in range(table_size):
        s = int(spread[u])
        next_state = int(symbol_next[s])
        symbol_next[s] += 1
        nb = table_log - highbit32(next_state)
        nb_bits[u] = nb
        new_state[u] = (next_state << nb) - table_size
    return DTable(table_log, spread, nb_bits, new_state)


def build_dtable_rle(symbol: int) -> DTable:
    """Single-state table for RLE mode (ZSTD_buildSeqTable rle path)."""
    return DTable(0,
                  np.array([symbol], dtype=np.int32),
                  np.array([0], dtype=np.int32),
                  np.array([0], dtype=np.int32))


# --------------------------------------------------------------------------
# Encode table
# --------------------------------------------------------------------------

def _spread_symbols(norm: np.ndarray, table_log: int) -> tuple[np.ndarray, int]:
    """Symbol spread (spec "From normalized distribution to decoding
    tables"): low-prob (-1) symbols occupy the highest states, the rest are
    spread with step = 5/8*size + 3."""
    table_size = 1 << table_log
    table_mask = table_size - 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    spread = np.zeros(table_size, dtype=np.int32)
    high_threshold = table_size - 1
    for s in range(len(norm)):
        if norm[s] == -1:
            spread[high_threshold] = s
            high_threshold -= 1
    position = 0
    for s in range(len(norm)):
        for _ in range(int(norm[s]) if norm[s] > 0 else 0):
            spread[position] = s
            position = (position + step) & table_mask
            while position > high_threshold:
                position = (position + step) & table_mask
    if position != 0:
        raise Corruption("FSE table spread did not cover the table")
    return spread, high_threshold


@dataclasses.dataclass
class CTable:
    table_log: int
    max_symbol: int
    state_table: np.ndarray        # int32[table_size]: next state values (+table_size)
    delta_nb_bits: np.ndarray      # int64[max_symbol+1]
    delta_find_state: np.ndarray   # int64[max_symbol+1]


def build_ctable(norm: np.ndarray, max_symbol: int, table_log: int) -> CTable:
    if table_log <= 12:
        res = native.fse_build_ctable(norm, max_symbol, table_log)
        if res is not None:
            return CTable(table_log, max_symbol, *res)
    return build_ctable_plain(norm, max_symbol, table_log)


def build_ctable_plain(norm: np.ndarray, max_symbol: int,
                       table_log: int) -> CTable:
    """The Python branch of build_ctable (FSE_buildCTable_wksp)."""
    table_size = 1 << table_log
    spread, _ = _spread_symbols(norm, table_log)

    cumul = np.zeros(max_symbol + 2, dtype=np.int64)
    for u in range(1, max_symbol + 2):
        prev = int(norm[u - 1])
        cumul[u] = cumul[u - 1] + (1 if prev == -1 else prev)
    cumul[max_symbol + 1] = table_size + 1

    state_table = np.zeros(table_size, dtype=np.int32)
    cc = cumul.copy()
    for u in range(table_size):
        s = int(spread[u])
        state_table[cc[s]] = table_size + u
        cc[s] += 1

    delta_nb = np.zeros(max_symbol + 1, dtype=np.int64)
    delta_fs = np.zeros(max_symbol + 1, dtype=np.int64)
    total = 0
    for s in range(max_symbol + 1):
        p = int(norm[s])
        if p == 0:
            delta_nb[s] = ((table_log + 1) << 16) - table_size
        elif p in (-1, 1):
            delta_nb[s] = (table_log << 16) - table_size
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - highbit32(p - 1)
            min_state_plus = p << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - p
            total += p
    return CTable(table_log, max_symbol, state_table, delta_nb, delta_fs)


def build_ctable_rle(symbol: int) -> CTable:
    """FSE_buildCTable_rle: 0-bit encoding of a single symbol."""
    state_table = np.zeros(2, dtype=np.int32)
    delta_nb = np.zeros(symbol + 1, dtype=np.int64)
    delta_fs = np.zeros(symbol + 1, dtype=np.int64)
    return CTable(0, symbol, state_table, delta_nb, delta_fs)


class CState:
    """FSE encoder state (fse.h FSE_initCState2/FSE_encodeSymbol/FSE_flushCState)."""

    __slots__ = ("ct", "value")

    def __init__(self, ct: CTable, first_symbol: int):
        self.ct = ct
        nb_out = (int(ct.delta_nb_bits[first_symbol]) + (1 << 15)) >> 16
        v = (nb_out << 16) - int(ct.delta_nb_bits[first_symbol])
        self.value = int(ct.state_table[(v >> nb_out) + int(ct.delta_find_state[first_symbol])])

    def encode(self, bw: BitWriter, symbol: int) -> None:
        nb_out = (self.value + int(self.ct.delta_nb_bits[symbol])) >> 16
        bw.add(self.value, nb_out)
        self.value = int(self.ct.state_table[
            (self.value >> nb_out) + int(self.ct.delta_find_state[symbol])])

    def flush(self, bw: BitWriter) -> None:
        bw.add(self.value, self.ct.table_log)


# --------------------------------------------------------------------------
# Interleaved 2-state byte codec (Huffman weights)
# --------------------------------------------------------------------------

def fse_compress_2state(data: bytes, ct: CTable) -> bytes:
    """FSE_compress_usingCTable (64-bit accumulator path). Empty result means
    'not compressible here' per the reference convention for <=2 symbols."""
    if len(data) <= 2:
        return b""
    r = native.fse_compress_2state(data, ct)
    if r is not None:
        return r
    return fse_compress_2state_plain(data, ct)


def fse_compress_2state_plain(data: bytes, ct: CTable) -> bytes:
    """The Python branch of fse_compress_2state."""
    n = len(data)
    if n <= 2:
        return b""
    bw = BitWriter()
    ip = n
    if n & 1:
        ip -= 1
        c1 = CState(ct, data[ip])
        ip -= 1
        c2 = CState(ct, data[ip])
        ip -= 1
        c1.encode(bw, data[ip])
    else:
        ip -= 1
        c2 = CState(ct, data[ip])
        ip -= 1
        c1 = CState(ct, data[ip])
    while ip > 0:
        ip -= 1
        c2.encode(bw, data[ip])
        ip -= 1
        c1.encode(bw, data[ip])
    c2.flush(bw)
    c1.flush(bw)
    return bw.close()


def fse_decompress_2state(data: bytes, dt: DTable, max_out: int) -> bytes:
    """FSE_decompress_usingDTable_generic semantics (alternating states;
    stops one symbol after bitstream overflow)."""
    br = BitReader(data)
    s1 = br.read(dt.table_log)
    s2 = br.read(dt.table_log)
    if br.overflowed:
        raise Corruption("FSE stream too short for initial states")
    out = bytearray()
    sym = dt.symbol
    nbb = dt.nb_bits
    ns = dt.new_state
    while True:
        if len(out) >= max_out:
            raise ZstdError(ZstdErrorCode.dstSize_tooSmall, "FSE output overflow")
        out.append(int(sym[s1]))
        s1 = int(ns[s1]) + br.read_clamped(int(nbb[s1]))
        if br.pos < 0:
            out.append(int(sym[s2]))
            break
        if len(out) >= max_out:
            raise ZstdError(ZstdErrorCode.dstSize_tooSmall, "FSE output overflow")
        out.append(int(sym[s2]))
        s2 = int(ns[s2]) + br.read_clamped(int(nbb[s2]))
        if br.pos < 0:
            out.append(int(sym[s1]))
            break
    return bytes(out)
