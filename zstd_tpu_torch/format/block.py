"""Host block decoder: literals + sequences + sequence execution.

Copy of BlockDState and decompress_block in zstd_tpu/format/block.py
(zstd's lib/decompress/zstd_decompress_block.c
ZSTD_decompressBlock_internal + ZSTD_execSequence:1001). The device decoder
sends a frame whose blocks the device cannot take here.
"""

from __future__ import annotations

import dataclasses

from ..constants import REPCODE_INIT
from ..errors import Corruption
from .literals import HufDecodeState, decode_literals
from .matchfinder import resolve_offset, update_reps
from .sequences import (FseDecodeState, decode_sequences,
                        parse_sequences_section)


@dataclasses.dataclass
class BlockDState:
    """Carried decompressor state across blocks of one frame."""
    huf: HufDecodeState = dataclasses.field(default_factory=HufDecodeState)
    fse: FseDecodeState = dataclasses.field(default_factory=FseDecodeState)
    reps: tuple[int, int, int] = REPCODE_INIT


def decompress_block(payload: bytes, out: bytearray, window_low: int,
                     state: BlockDState, block_max: int) -> BlockDState:
    """Decompress one compressed block, appending to `out` (the frame sink).

    window_low: lowest absolute position in `out` this block may reference.
    """
    lit, next_huf, consumed = decode_literals(payload, state.huf)
    nb_seq, next_fse, hdr_len = parse_sequences_section(payload[consumed:], state.fse)
    bitstream = payload[consumed + hdr_len:]

    if nb_seq == 0:
        if len(bitstream) != 0:
            raise Corruption("garbage after empty sequences section")
        if len(lit) > block_max:
            raise Corruption("block output exceeds maximum")
        out += lit
        return BlockDState(next_huf, next_fse, state.reps)

    lls, obs, mls = decode_sequences(bitstream, nb_seq, next_fse)

    reps = state.reps
    lit_pos = 0
    produced = 0
    for i in range(nb_seq):
        ll = int(lls[i])
        ob = int(obs[i])
        ml = int(mls[i])
        offset = resolve_offset(reps, ob, ll)
        reps = update_reps(reps, ob, ll)
        if offset <= 0:
            raise Corruption("invalid offset 0")
        if lit_pos + ll > len(lit):
            raise Corruption("literal buffer overrun")
        out += lit[lit_pos : lit_pos + ll]
        lit_pos += ll
        pos = len(out)
        if pos - offset < window_low:
            raise Corruption("offset beyond window")
        # overlap-safe match copy (pattern repeats when offset < length)
        start = pos - offset
        copied = 0
        while copied < ml:
            avail = len(out) - (start + copied)
            k = min(ml - copied, avail)
            out += out[start + copied : start + copied + k]
            copied += k
        produced += ll + ml
        if produced > block_max:
            raise Corruption("block output exceeds maximum")
    # trailing literals
    out += lit[lit_pos:]
    produced += len(lit) - lit_pos
    if produced > block_max:
        raise Corruption("block output exceeds maximum")
    return BlockDState(next_huf, next_fse, reps)
