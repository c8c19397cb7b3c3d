"""Literals section: the encoder and the host decoder.

Copy of zstd_tpu/format/literals.py's encoder (zstd's
lib/compress/zstd_compress_literals.c ZSTD_compressLiterals: the
raw/RLE/compressed/treeless choice, 1X vs 4X, lhSize selection, the minGain
gate; lib/compress/huf_compress.c HUF_compress_internal:1380, the
compressibility heuristics and repeat-table reuse), of the superblock's
region table (build_region_table, compress_literals_seeded) and of its
decode side (lib/decompress/zstd_decompress_block.c
ZSTD_decodeLiteralsBlock:134).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import LBT_COMPRESSED, LBT_RAW, LBT_RLE, LBT_TREELESS
from ..errors import Corruption
from . import huffman


class HufRepeat:
    NONE = 0
    CHECK = 1
    VALID = 2


@dataclasses.dataclass
class HufEntropyState:
    """Carried Huffman table + repeat mode (ZSTD_hufCTables_t analog)."""
    ctable: huffman.HufCTable | None = None
    repeat: int = HufRepeat.NONE

    def copy(self) -> "HufEntropyState":
        return HufEntropyState(self.ctable, self.repeat)


def _min_gain(src_size: int, strategy: int) -> int:
    minlog = strategy - 1 if strategy >= 8 else 6
    return (src_size >> minlog) + 2


def _min_literals_to_compress(strategy: int, repeat: int) -> int:
    shift = min(9 - strategy, 3)
    return 6 if repeat == HufRepeat.VALID else 8 << shift


def _raw_literals(lit: bytes) -> bytes:
    n = len(lit)
    fl_size = 1 + (n > 31) + (n > 4095)
    if fl_size == 1:
        hdr = bytes([LBT_RAW | (n << 3) & 0xFF])
    elif fl_size == 2:
        hdr = (LBT_RAW + (1 << 2) + (n << 4)).to_bytes(2, "little")
    else:
        hdr = (LBT_RAW + (3 << 2) + (n << 4)).to_bytes(3, "little")
    return hdr + lit


def _rle_literals(lit: bytes) -> bytes:
    n = len(lit)
    fl_size = 1 + (n > 31) + (n > 4095)
    if fl_size == 1:
        hdr = bytes([LBT_RLE + ((n << 3) & 0xFF)])
    elif fl_size == 2:
        hdr = (LBT_RLE + (1 << 2) + (n << 4)).to_bytes(2, "little")
    else:
        hdr = (LBT_RLE + (3 << 2) + (n << 4)).to_bytes(3, "little")
    return hdr + lit[:1]


def _huf_compress(lit: bytes, single_stream: bool, prev: HufEntropyState,
                  prefer_repeat: bool
                  ) -> tuple[bytes | int, huffman.HufCTable | None, bool, bool]:
    """HUF_compress_internal.

    Returns (payload | 0 | 1, new_table_or_None, used_repeat, used_single).
    0 => not compressible; 1 => single-symbol RLE signal.
    used_repeat True means the previous table was reused (treeless block).
    used_single True means the payload is a one-stream encode — when the
    4-stream format is requested and the source fits the 1-stream header
    (n <= 1023), both are encoded exactly and the smaller wins (the
    reference picks by the n<256 heuristic only).
    """
    n = len(lit)
    if n == 0:
        return 0, None, False, single_stream
    arr = np.frombuffer(lit, dtype=np.uint8)
    count = np.bincount(arr, minlength=256).astype(np.int64)
    max_symbol = int(arr.max())
    largest = int(count.max())
    if largest == n:
        return 1, None, False, single_stream
    if largest <= (n >> 7) + 4:
        return 0, None, False, single_stream

    def encode_best(table):
        """Encode in the requested mode; for 4-stream sources that also fit
        the 1-stream header, encode both and keep the smaller."""
        out = _encode_streams(lit, table, single_stream)
        used1 = single_stream
        if not single_stream and n <= 1023:
            alt = _encode_streams(lit, table, True)
            if alt is not None and (out is None or len(alt) < len(out)):
                out, used1 = alt, True
        return out, used1

    repeat = prev.repeat
    old = prev.ctable
    # a VALID table is checked too: zstd_tpu trusts it, but the superblock
    # pieces leave their region's table VALID for the next region, whose
    # literals it may not cover (a treeless block that cannot decode)
    if repeat != HufRepeat.NONE and (old is None or
                                     not huffman.huf_validate_ctable(old, count, max_symbol)):
        repeat = HufRepeat.NONE
    if prefer_repeat and repeat != HufRepeat.NONE and old is not None:
        payload, used1 = encode_best(old)
        if payload is None or len(payload) >= n - 1:
            return 0, None, False, single_stream
        return payload, None, True, used1

    huff_log = huffman.huf_optimal_table_log(huffman.HUF_TABLELOG_DEFAULT, n, max_symbol)
    try:
        ct, hdr = huffman.build_huf_ctable_with_tree(count, max_symbol,
                                                     huff_log)
    except Corruption:
        # unserializable tree (>128 symbols with incompressible weights):
        # the reference treats any HUF error as "emit raw literals"
        # (zstd_compress_literals.c:188 ERR_isError -> noCompressLiterals)
        return 0, None, False, single_stream
    if repeat != HufRepeat.NONE and old is not None:
        old_size = huffman.huf_estimate_compressed_size(old, count, max_symbol)
        new_size = huffman.huf_estimate_compressed_size(ct, count, max_symbol)
        if old_size <= len(hdr) + new_size or len(hdr) + 12 >= n:
            payload, used1 = encode_best(old)
            if payload is None or len(payload) >= n - 1:
                return 0, None, False, single_stream
            return payload, None, True, used1
    if len(hdr) + 12 >= n:
        return 0, None, False, single_stream
    payload, used1 = encode_best(ct)
    if payload is None:
        return 0, None, False, single_stream
    total = hdr + payload
    if len(total) >= n - 1:
        return 0, None, False, single_stream
    return total, ct, False, used1


def _encode_streams(lit: bytes, ct: huffman.HufCTable,
                    single_stream: bool) -> bytes | None:
    if single_stream:
        out = huffman.huf_encode_1x(lit, ct)
        return out if out else None
    return huffman.huf_encode_4x(lit, ct)


def build_region_table(all_lits: bytes):
    """Superblock support (zstd_compress_superblock.c:263 hufMetadata
    role): ONE Huffman table built over a whole region's literals, so
    every piece of the region can encode against it — the first piece
    emits the description, later pieces go treeless. Returns
    (ctable, description bytes) or None when the region isn't
    Huffman-friendly."""
    n = len(all_lits)
    if n < 64:
        return None
    arr = np.frombuffer(all_lits, dtype=np.uint8)
    count = np.bincount(arr, minlength=256).astype(np.int64)
    max_symbol = int(arr.max())
    if int(count.max()) == n or int(count.max()) <= (n >> 7) + 4:
        return None
    huff_log = huffman.huf_optimal_table_log(
        huffman.HUF_TABLELOG_DEFAULT, n, max_symbol)
    try:
        ct, hdr = huffman.build_huf_ctable_with_tree(count, max_symbol,
                                                     huff_log)
    except Corruption:
        return None
    return ct, hdr


def compress_literals_seeded(lit: bytes, table, table_hdr: bytes,
                             emit_table: bool, strategy: int
                             ) -> tuple[bytes, bool] | None:
    """Encode one piece's literals against a shared region table
    (zstd_compress_superblock.c:506-529 role). emit_table: this piece
    carries the table description (LBT_COMPRESSED); otherwise treeless.
    Returns (section bytes, table_was_emitted) or None when raw wins
    (caller falls back to compress_literals/raw)."""
    n = len(lit)
    if n < 6:
        return None
    single = n < 256
    out = _encode_streams(lit, table, single)
    if not single and n <= 1023:
        alt = _encode_streams(lit, table, True)
        if alt is not None and (out is None or len(alt) < len(out)):
            out, single = alt, True
    if out is None:
        return None
    payload = (table_hdr + out) if emit_table else out
    if len(payload) >= n - _min_gain(n, strategy):
        return None
    h_type = LBT_COMPRESSED if emit_table else LBT_TREELESS
    c_size = len(payload)
    lh_size = 3 + (n >= 1024) + (n >= 16384)
    if lh_size == 3:
        lhc = h_type + ((0 if single else 1) << 2) + (n << 4) \
              + (c_size << 14)
        hdr = lhc.to_bytes(3, "little")
    elif lh_size == 4:
        lhc = h_type + (2 << 2) + (n << 4) + (c_size << 18)
        hdr = lhc.to_bytes(4, "little")
    else:
        lhc = h_type + (3 << 2) + (n << 4) + ((c_size & 0x3FF) << 22)
        hdr = lhc.to_bytes(4, "little") + bytes([(c_size >> 10) & 0xFF])
    return hdr + payload, emit_table


def compress_literals(lit: bytes, prev: HufEntropyState, strategy: int,
                      disable: bool, suspect_uncompressible: bool
                      ) -> tuple[bytes, HufEntropyState]:
    """ZSTD_compressLiterals. Returns (section bytes, next entropy state)."""
    n = len(lit)
    nxt = prev.copy()
    lh_size = 3 + (n >= 1024) + (n >= 16384)
    single_stream = n < 256

    if disable or n < _min_literals_to_compress(strategy, prev.repeat):
        return _raw_literals(lit), nxt

    prefer_repeat = strategy < 5 and n <= 1024
    if prev.repeat == HufRepeat.VALID and lh_size == 3:
        single_stream = True
    # Note: suspect_uncompressible maps to HUF_flags_suspectUncompressible,
    # which only gates a sampling speed heuristic inside HIST_count — the
    # output is unchanged, so it is accepted and ignored here.
    del suspect_uncompressible

    result, new_table, used_repeat, single_stream = _huf_compress(
        lit, single_stream, prev, prefer_repeat)
    if isinstance(result, int):
        c_lit_size = result
        payload = b""
    else:
        payload = result
        c_lit_size = len(payload)

    h_type = LBT_TREELESS if used_repeat else LBT_COMPRESSED

    min_gain = _min_gain(n, strategy)
    if c_lit_size == 0 or c_lit_size >= n - min_gain:
        return _raw_literals(lit), prev.copy()
    if c_lit_size == 1:
        if n >= 8 or len(set(lit)) == 1:
            return _rle_literals(lit), prev.copy()

    if h_type == LBT_COMPRESSED:
        nxt.ctable = new_table
        nxt.repeat = HufRepeat.CHECK

    if lh_size == 3:
        lhc = h_type + ((0 if single_stream else 1) << 2) + (n << 4) + (c_lit_size << 14)
        hdr = lhc.to_bytes(3, "little")
    elif lh_size == 4:
        lhc = h_type + (2 << 2) + (n << 4) + (c_lit_size << 18)
        hdr = lhc.to_bytes(4, "little")
    else:
        lhc = h_type + (3 << 2) + (n << 4) + ((c_lit_size & 0x3FF) << 22)
        hdr = lhc.to_bytes(4, "little") + bytes([(c_lit_size >> 10) & 0xFF])
    return hdr + payload, nxt


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

@dataclasses.dataclass
class HufDecodeState:
    dtable: huffman.HufDTable | None = None

    def copy(self) -> "HufDecodeState":
        return HufDecodeState(self.dtable)


def decode_literals(data: bytes, st: HufDecodeState
                    ) -> tuple[bytes, HufDecodeState, int]:
    """ZSTD_decodeLiteralsBlock. Returns (literals, next state, consumed)."""
    if len(data) < 1:
        raise Corruption("literals: empty section")
    b0 = data[0]
    block_type = b0 & 3
    size_format = (b0 >> 2) & 3

    if block_type in (LBT_RAW, LBT_RLE):
        if size_format in (0, 2):
            regen = b0 >> 3
            lh = 1
        elif size_format == 1:
            if len(data) < 2:
                raise Corruption("literals: truncated header")
            regen = (b0 >> 4) + (data[1] << 4)
            lh = 2
        else:
            if len(data) < 3:
                raise Corruption("literals: truncated header")
            regen = (b0 >> 4) + (data[1] << 4) + (data[2] << 12)
            lh = 3
        if block_type == LBT_RAW:
            if len(data) < lh + regen:
                raise Corruption("literals: raw content truncated")
            return data[lh : lh + regen], st.copy(), lh + regen
        if len(data) < lh + 1:
            raise Corruption("literals: missing RLE byte")
        return bytes([data[lh]]) * regen, st.copy(), lh + 1

    # compressed / treeless
    if size_format == 0:
        if len(data) < 3:
            raise Corruption("literals: truncated header")
        v = int.from_bytes(data[:3], "little")
        regen = (v >> 4) & 0x3FF
        c_size = (v >> 14) & 0x3FF
        lh = 3
        four_streams = False
    elif size_format == 1:
        if len(data) < 3:
            raise Corruption("literals: truncated header")
        v = int.from_bytes(data[:3], "little")
        regen = (v >> 4) & 0x3FF
        c_size = (v >> 14) & 0x3FF
        lh = 3
        four_streams = True
    elif size_format == 2:
        if len(data) < 4:
            raise Corruption("literals: truncated header")
        v = int.from_bytes(data[:4], "little")
        regen = (v >> 4) & 0x3FFF
        c_size = (v >> 18) & 0x3FFF
        lh = 4
        four_streams = True
    else:
        if len(data) < 5:
            raise Corruption("literals: truncated header")
        v = int.from_bytes(data[:5], "little")
        regen = (v >> 4) & 0x3FFFF
        c_size = (v >> 22) & 0x3FFFF
        lh = 5
        four_streams = True

    if c_size == 0 or len(data) < lh + c_size:
        raise Corruption("literals: compressed payload truncated")
    payload = data[lh : lh + c_size]

    nxt = st.copy()
    if block_type == LBT_COMPRESSED:
        nb_bits, nb_symbols, table_log, tree_len = huffman.read_tree_description(payload)
        nxt.dtable = huffman.build_huf_dtable(nb_bits, nb_symbols, table_log)
        streams = payload[tree_len:]
    else:
        if st.dtable is None:
            raise Corruption("treeless literals without a previous huffman table")
        streams = payload

    assert nxt.dtable is not None
    if four_streams:
        lit = huffman.huf_decode_4x(streams, nxt.dtable, regen)
    else:
        lit = huffman.huf_decode_1x(streams, nxt.dtable, regen)
    return lit, nxt, lh + c_size
