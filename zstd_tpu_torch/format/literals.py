"""Literals section: the encoder's gates and the host decoder.

Copy of zstd_tpu/format/literals.py's repeat modes and gates (zstd's
lib/compress/zstd_compress_literals.c ZSTD_compressLiterals minGain gate,
lib/compress/zstd_compress_internal.h ZSTD_minLiteralsToCompress) and of
its decode side (lib/decompress/zstd_decompress_block.c
ZSTD_decodeLiteralsBlock:134).
"""

from __future__ import annotations

import dataclasses

from ..constants import LBT_COMPRESSED, LBT_RAW, LBT_RLE
from ..errors import Corruption
from . import huffman


class HufRepeat:
    NONE = 0
    CHECK = 1
    VALID = 2


def _min_gain(src_size: int, strategy: int) -> int:
    minlog = strategy - 1 if strategy >= 8 else 6
    return (src_size >> minlog) + 2


def _min_literals_to_compress(strategy: int, repeat: int) -> int:
    shift = min(9 - strategy, 3)
    return 6 if repeat == HufRepeat.VALID else 8 << shift


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
