"""Host block encoder and decoder: literals + sequences (+ execution).

Copy of BlockCState, compress_block, _find_block_sequences,
compress_block_pieces, BlockDState and decompress_block in
zstd_tpu/format/block.py (zstd's lib/compress/zstd_compress.c
ZSTD_compressBlock_internal:4325, ZSTD_buildSeqStore:3207's parser
dispatch, ZSTD_entropyCompressSeqStore:3001's raw/RLE gates,
ZSTD_deriveBlockSplits:4118; lib/decompress/zstd_decompress_block.c
ZSTD_decompressBlock_internal + ZSTD_execSequence:1001). Left out: the
external sequence producer (zstd_tpu's is None unless registered), the
ZSTD_TPU_HOST_PARSER and ZSTD_TPU_OPT_ITER overrides (their defaults are
constants) and the target block size (superblock) pieces. The device decoder
sends a frame whose blocks the device cannot take to the decoder here.
"""

from __future__ import annotations

import dataclasses

from ..constants import (BT_COMPRESSED, BT_RAW, BT_RLE, MIN_MATCH,
                         REPCODE_INIT)
from ..errors import Corruption
from . import opt
from .ldm import find_sequences_ldm
from .literals import (HufDecodeState, HufEntropyState, _min_gain,
                       compress_literals, decode_literals)
from .matchfinder import resolve_offset, update_reps
from .sequences import (FseDecodeState, FseEntropyState, _EmitRawBlock,
                        decode_sequences, parse_sequences_section,
                        write_sequences_section)
from .split import segment_content_len, slice_seqstore, split_points


@dataclasses.dataclass
class BlockCState:
    """Carried compressor state across blocks of one frame."""
    huf: HufEntropyState = dataclasses.field(default_factory=HufEntropyState)
    fse: FseEntropyState = dataclasses.field(default_factory=FseEntropyState)
    reps: tuple[int, int, int] = REPCODE_INIT
    # persistent C match-finder context of the DP (hash heads / suffix
    # tree), carried across blocks so the window is never re-inserted
    opt_ctx: object = None
    # persistent fast / double-fast / chain-lazy table (int32 positions)
    fast_table: object = None
    # snapshot contexts of the iterated keep-min parse (levels 19+)
    opt_ctx_b: object = None
    # persistent row-matchfinder tables (pos, tag, head, long)
    row_table: object = None


def compress_block(full, block_start: int, block_end: int, window_low: int,
                   state: BlockCState, cparams, ldm_ctx=None
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

    seqs, new_reps = _find_block_sequences(full, block_start, block_end,
                                           window_low, state, cparams,
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


def _find_block_sequences(full, block_start, block_end, window_low, state,
                          cparams, ldm_ctx=None):
    """Sequence extraction for one block (ZSTD_buildSeqStore dispatch)."""
    if ldm_ctx is not None:  # --long: the long matcher wraps the inner one
        return find_sequences_ldm(
            full, block_start, block_end, window_low, state.reps, cparams,
            ldm_ctx)
    # Strategy dispatch (ZSTD_selectBlockCompressor role):
    # - fast class (strategy 1: levels 1-2 and --fast) -> C greedy
    #   matchfinder (zstd_fast.c);
    # - the dfast-class levels (3-4), greedy/lazy (5-7) and the
    #   narrow-search lazy2 levels (8-9) -> row matchfinder
    #   (zstd_lazy.c:986 ZSTD_RowFindBestMatch role);
    # - the wide-search lazy2 levels (10-12) -> shallow btultra DP;
    # - strategies 2-5 where those decline -> hash-chain lazy matchfinder;
    # - everything else -> the C DP parser (find_sequences_opt).
    if cparams.strategy == 1:
        return opt.find_sequences_fast(
            full, block_start, block_end, window_low, state.reps, cparams,
            state=state)
    res = None
    if (cparams.strategy in (2, 3, 4)
            or (cparams.strategy == 5 and cparams.search_log <= 4)):
        res = opt.find_sequences_row(
            full, block_start, block_end, window_low, state.reps, cparams,
            state=state)
    if res is None and cparams.strategy == 5 and cparams.search_log >= 5:
        res = opt.find_sequences_shallow_dp(
            full, block_start, block_end, window_low, state.reps, cparams,
            state=state)
    if res is None and cparams.strategy in (2, 3, 4, 5):
        res = opt.find_sequences_chainlazy(
            full, block_start, block_end, window_low, state.reps, cparams,
            state=state)
    if res is not None:
        return res
    return opt.find_sequences_opt(
        full, block_start, block_end, window_low, state.reps, cparams,
        state=state)


def compress_block_pieces(full, block_start, block_end, window_low, state,
                          cparams, ldm_ctx=None):
    """Compress one block region into one-or-more blocks via cost-driven
    splitting of its seqstore (ZSTD_deriveBlockSplits analog; format/split.py).

    Returns (pieces, next_state) where pieces is a list of
    (payload, block_type, content_len). Extraction runs ONCE; the split is
    abandoned (single block) when it does not pay or when any piece would
    degrade to raw (a raw piece would drop its sequences and desynchronize
    downstream repcode history).
    """
    n = block_end - block_start
    src = full[block_start:block_end]
    raw_piece = [(src.tobytes(), BT_RAW, n)]
    if n < MIN_MATCH + 1 + 8:
        return raw_piece, state

    strategy = cparams.strategy

    def encode(sub, st, suspect):
        lit_section, next_huf = compress_literals(
            sub.literals, st.huf, strategy, disable=False,
            suspect_uncompressible=suspect)
        seq_section, next_fse = write_sequences_section(sub, st.fse, strategy)
        return lit_section + seq_section, next_huf, next_fse

    # Iterated keep-min optimal parse (levels 19+): several candidate
    # parses of the same block, the chained-statistics pass plus
    # self-seeded re-parses, sized EXACTLY here; the smallest encode wins
    # and its matcher context chains forward.
    candidates = None
    if ldm_ctx is None and strategy >= 8:
        candidates = opt.find_sequences_opt_dual(
            full, block_start, block_end, window_low, state.reps, cparams,
            state)
    if candidates is None:
        seqs, new_reps = _find_block_sequences(full, block_start, block_end,
                                               window_low, state, cparams,
                                               ldm_ctx)
        candidates = [(seqs, new_reps, lambda: None)]

    best = None
    for sq, rp, commit in candidates:
        nseq_c = sq.nb_seq
        nlit_c = len(sq.literals)
        susp = (nseq_c == 0) or (nlit_c // max(nseq_c, 1) >= 20)
        try:
            pay, nh, nf = encode(sq, state, susp)
        except _EmitRawBlock:
            continue
        # ties prefer the earlier candidate (chained-statistics continuity)
        if best is None or len(pay) < len(best[0]):
            best = (pay, nh, nf, sq, rp, commit)
    if best is None:
        return raw_piece, state
    whole_payload, whole_huf, whole_fse, seqs, new_reps, commit = best
    commit()
    max_c_size = n - _min_gain(n, strategy)
    if len(whole_payload) >= max_c_size:
        if n > 1 and (src == src[0]).all():
            return [(bytes(src[:1]), BT_RLE, n)], state
        return raw_piece, state
    whole = ([(whole_payload, BT_COMPRESSED, n)],
             dataclasses.replace(state, huf=whole_huf, fse=whole_fse,
                                 reps=new_reps))

    if n < 32768:
        return whole
    if strategy >= 7:
        # btopt class: EXACT recursive dyadic split search with entropy-
        # state chaining (zstd accepts splits from fresh-table estimates,
        # ZSTD_deriveBlockSplitsHelper zstd_compress.c:4139; exact sizing
        # costs about 5x the entropy stage at depth 4, little next to the
        # optimal parse). Always <= whole by construction.
        nb = seqs.nb_seq

        def _enc_seg(a, b, stt):
            sub = slice_seqstore(seqs, a, b, b == nb)
            lit_s, nh = compress_literals(
                sub.literals, stt.huf, strategy, disable=False,
                suspect_uncompressible=False)
            seq_s, nf = write_sequences_section(sub, stt.fse, strategy)
            return len(lit_s) + len(seq_s), dataclasses.replace(
                stt, huf=nh, fse=nf)

        def _best(a, b, stt, depth):
            try:
                w, stw = _enc_seg(a, b, stt)
            except _EmitRawBlock:
                return None
            if depth >= 4 or b - a < 300:
                return w + 3, stw, [(a, b)]
            mid = (a + b) // 2
            left = _best(a, mid, stt, depth + 1)
            if left is not None:
                lsz, stl, segl = left
                right = _best(mid, b, stl, depth + 1)
                if right is not None:
                    rsz, str_, segr = right
                    if lsz + rsz < w + 3:
                        return lsz + rsz, str_, segl + segr
            return w + 3, stw, [(a, b)]

        res = _best(0, nb, state, 0)
        if res is None or len(res[2]) == 1:
            return whole
        bounds = [a for a, _ in res[2]] + [nb]
    else:
        pts = split_points(seqs)
        if not pts:
            return whole
        bounds = [0] + pts + [seqs.nb_seq]
    pieces = []
    st = state
    total = 0
    for k in range(len(bounds) - 1):
        a, b = bounds[k], bounds[k + 1]
        last = k == len(bounds) - 2
        sub = slice_seqstore(seqs, a, b, last)
        clen = segment_content_len(seqs, a, b, last, n, total)
        try:
            payload, next_huf, next_fse = encode(sub, st, False)
        except _EmitRawBlock:
            return whole
        if len(payload) >= clen:
            return whole
        pieces.append((payload, BT_COMPRESSED, clen))
        st = dataclasses.replace(st, huf=next_huf, fse=next_fse)
        total += clen
    if sum(len(p) for p, _, _ in pieces) >= len(whole_payload):
        # entropy-driven splitting must pay for itself
        return whole
    return pieces, dataclasses.replace(st, reps=new_reps)


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
