"""Host block encoder and decoder: literals + sequences (+ execution).

Copy of BlockCState, compress_block, BlockDState and decompress_block in
zstd_tpu/format/block.py (zstd's lib/compress/zstd_compress.c
ZSTD_compressBlock_internal:4325, ZSTD_entropyCompressSeqStore:3001's
raw/RLE gates; lib/decompress/zstd_decompress_block.c
ZSTD_decompressBlock_internal + ZSTD_execSequence:1001). The encoder's
sequences come from the long-distance matcher only (the one caller is the
host frame encoder of parallel/ldm_sharded.py); the device decoder sends a
frame whose blocks the device cannot take to the decoder here.
"""

from __future__ import annotations

import dataclasses

from ..constants import MIN_MATCH, REPCODE_INIT
from ..errors import Corruption
from .ldm import find_sequences_ldm
from .literals import (HufDecodeState, HufEntropyState, _min_gain,
                       compress_literals, decode_literals)
from .matchfinder import resolve_offset, update_reps
from .sequences import (FseDecodeState, FseEntropyState, _EmitRawBlock,
                        decode_sequences, parse_sequences_section,
                        write_sequences_section)


@dataclasses.dataclass
class BlockCState:
    """Carried compressor state across blocks of one frame."""
    huf: HufEntropyState = dataclasses.field(default_factory=HufEntropyState)
    fse: FseEntropyState = dataclasses.field(default_factory=FseEntropyState)
    reps: tuple[int, int, int] = REPCODE_INIT


def compress_block(full, block_start: int, block_end: int, window_low: int,
                   state: BlockCState, cparams, ldm_ctx
                   ) -> tuple[bytes, int, BlockCState]:
    """Compress one block. Returns (payload, block_type, next_state).

    block_type: 0 raw, 1 RLE, 2 compressed (constants.BT_*). The caller wraps
    with the 3-byte block header. State only advances on compressed blocks,
    mirroring ZSTD_blockState_confirmRepcodesAndEntropyTables.
    """
    src = full[block_start:block_end]
    n = block_end - block_start
    raw = (src.tobytes(), 0, state)

    if n < MIN_MATCH + 1 + 8:
        return raw

    seqs, new_reps = find_sequences_ldm(full, block_start, block_end,
                                        window_low, state.reps, cparams,
                                        ldm_ctx)
    strategy = cparams.strategy
    try:
        num_seq = seqs.nb_seq
        num_lit = len(seqs.literals)
        suspect = (num_seq == 0) or (num_lit // max(num_seq, 1) >= 20)
        lit_section, next_huf = compress_literals(
            seqs.literals, state.huf, strategy, disable=False,
            suspect_uncompressible=suspect)
        seq_section, next_fse = write_sequences_section(seqs, state.fse,
                                                        strategy)
    except _EmitRawBlock:
        return raw
    payload = lit_section + seq_section

    max_c_size = n - _min_gain(n, strategy)
    if len(payload) >= max_c_size:
        # not compressible: raw, or RLE when the whole block is one byte
        if n > 1 and (src == src[0]).all():
            return bytes(src[:1]), 1, state
        return raw

    nxt = dataclasses.replace(state, huf=next_huf, fse=next_fse, reps=new_reps)
    return payload, 2, nxt


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
