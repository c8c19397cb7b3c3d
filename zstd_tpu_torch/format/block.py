"""Host block encoder and decoder: literals + sequences (+ execution).

Copy of BlockCState, compress_block, _find_block_sequences,
compress_block_pieces, BlockDState and decompress_block in
zstd_tpu/format/block.py (zstd's lib/compress/zstd_compress.c
ZSTD_compressBlock_internal:4325, ZSTD_buildSeqStore:3207's parser
dispatch, ZSTD_entropyCompressSeqStore:3001's raw/RLE gates,
ZSTD_deriveBlockSplits:4118; lib/decompress/zstd_decompress_block.c
ZSTD_decompressBlock_internal + ZSTD_execSequence:1001), with the
external sequence producer (register_sequence_producer,
ZSTD_registerSequenceProducer analog): while one is registered it is asked
first for every block, and the whole-frame C routes of format/frame.py
stand aside. Left out: the ZSTD_TPU_HOST_PARSER and ZSTD_TPU_OPT_ITER
overrides (their defaults are constants). The device decoder sends a frame
whose blocks the device cannot take to the decoder here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (BT_COMPRESSED, BT_RAW, BT_RLE, MIN_MATCH,
                         REPCODE_INIT)
from ..errors import Corruption
from . import opt
from .ldm import find_sequences_ldm
from . import huffman
from .literals import (HufDecodeState, HufEntropyState, HufRepeat, _min_gain,
                       build_region_table, compress_literals,
                       compress_literals_seeded, decode_literals)
from .matchfinder import resolve_offset, update_reps
from .sequences import (FseDecodeState, FseEntropyState, SeqStore,
                        _EmitRawBlock, decode_sequences,
                        parse_sequences_section, write_sequences_section)
from .split import (make_estimator, segment_content_len, slice_seqstore,
                    split_points, target_cost_cum)


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


_SEQ_PRODUCER = None


def register_sequence_producer(fn) -> None:
    """External sequence producer (ZSTD_registerSequenceProducer analog,
    zstd's lib/compress/zstd_compress.c:3294): fn(full, block_start,
    block_end, window_low) -> list of (lit_length, raw_offset, match_length)
    or None to fall back to the built-in finders. Sequences are validated;
    invalid output raises Corruption rather than emitting a bad frame.
    register_sequence_producer(None) restores the built-in finders."""
    global _SEQ_PRODUCER
    _SEQ_PRODUCER = fn


def _seqs_from_producer(full, block_start, block_end, window_low, reps,
                        raw_seqs):
    lls, obs, mbs = [], [], []
    lit_parts = []
    pos = block_start
    r = reps
    for (ll, off, ml) in raw_seqs:
        if ll < 0 or ml < MIN_MATCH or off <= 0:
            raise Corruption("sequence producer: invalid sequence")
        start = pos + ll
        if start + ml > block_end or start - off < window_low:
            raise Corruption("sequence producer: out-of-window sequence")
        if not np.array_equal(full[start : start + ml],
                              full[start - off : start - off + ml]):
            raise Corruption("sequence producer: match bytes do not repeat")
        lit_parts.append(full[pos : start].tobytes())
        ob = off + 3  # conservative encoding; repcodes not asserted
        lls.append(ll)
        obs.append(ob)
        mbs.append(ml - MIN_MATCH)
        r = update_reps(r, ob, ll)
        pos = start + ml
    lit_parts.append(full[pos:block_end].tobytes())
    return SeqStore(np.array(lls, np.int32), np.array(obs, np.int32),
                    np.array(mbs, np.int32), b"".join(lit_parts)), r


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
    produced = None
    if _SEQ_PRODUCER is not None:
        produced = _SEQ_PRODUCER(full, block_start, block_end, window_low)
    if produced is not None:
        return _seqs_from_producer(
            full, block_start, block_end, window_low, state.reps, produced)
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
                          cparams, ldm_ctx=None,
                          target_cblock_size: int | None = None):
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
    if _SEQ_PRODUCER is None and ldm_ctx is None and strategy >= 8:
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

    if n < 32768 and not target_cblock_size:
        return whole
    if target_cblock_size:
        # superblock mode: greedy EXACT sub-block sizing — each sub-block
        # is proposed from the estimator, then actually encoded and
        # resized once if its true compressed size strays from the target
        # (ZSTD_compressSubBlock's exact sub-block sizer role,
        # zstd's lib/compress/zstd_compress_superblock.c:263,506-529;
        # table modes are re-decided per sub-block by the entropy states).
        est = make_estimator(seqs)
        cum = np.concatenate([[0], target_cost_cum(est)])
        tgt_bits = max(target_cblock_size, 1024) * 8
        nb = seqs.nb_seq
        if nb == 0:
            return whole
        # true superblock sections (zstd_compress_superblock.c:263,
        # 506-529 role): ONE Huffman table over the whole region's
        # literals; the first piece emits its description, later pieces
        # are treeless against it — small pieces' literals stay
        # compressible at zero per-piece table cost (per-piece tables
        # previously forced ~all pieces to raw literals at 1-4 KB
        # targets). The table is built over ALL region literals, so
        # treeless coverage is guaranteed for every piece.
        region = build_region_table(seqs.literals)
        emitted = [False]
        if (region is not None and state.huf.repeat == HufRepeat.VALID
                and state.huf.ctable is not None):
            # a prior region's table may already cover this region's
            # literals — then every piece can go treeless immediately
            arr = np.frombuffer(seqs.literals, dtype=np.uint8)
            cnt = np.bincount(arr, minlength=256).astype(np.int64)
            if huffman.huf_validate_ctable(state.huf.ctable, cnt,
                                           int(arr.max())):
                region = (state.huf.ctable, b"")
                emitted[0] = True

        region_ref = [region]
        _LBT_COMPRESSED = 2

        def encode_seeded(sub_, st_, emitted_now):
            """Literals against the region table (fallback: the plain
            per-piece path); sequences chained as before. Returns
            (payload, next_huf, next_fse, did_emit_table, plain_table):
            plain_table flags a fallback piece that emitted its OWN
            table — committing one invalidates region-treeless for the
            rest of the region (the decoder's 'previous table' moved)."""
            if region_ref[0] is not None:
                got = compress_literals_seeded(
                    sub_.literals, region_ref[0][0], region_ref[0][1],
                    not emitted_now, strategy)
                if got is not None:
                    lit_s, did_emit = got
                    seq_s, nf = write_sequences_section(sub_, st_.fse,
                                                        strategy)
                    nh = HufEntropyState(region_ref[0][0], HufRepeat.VALID)
                    return lit_s + seq_s, nh, nf, did_emit, False
            p_, nh, nf = encode(sub_, st_, False)
            plain_tab = bool(p_) and (p_[0] & 3) == _LBT_COMPRESSED
            return p_, nh, nf, False, plain_tab

        pieces = []
        st = state
        total = 0
        a = 0
        while a < nb:
            b = int(np.searchsorted(cum, cum[a] + tgt_bits, side="left"))
            b = min(max(b, a + 1), nb)

            def try_piece(bb):
                last_ = bb == nb
                sub_ = slice_seqstore(seqs, a, bb, last_)
                clen_ = segment_content_len(seqs, a, bb, last_, n, total)
                payload_, nh, nf, did, ptab = encode_seeded(sub_, st,
                                                            emitted[0])
                return payload_, nh, nf, clen_, did, ptab

            try:
                payload, next_huf, next_fse, clen, did, ptab = try_piece(b)
                actual = len(payload)
                if actual > target_cblock_size * 5 // 4 and b - a > 4:
                    b2 = a + max((b - a) * target_cblock_size
                                 * 8 // (actual * 8), 4)
                    if b2 < b:
                        b = b2
                        payload, next_huf, next_fse, clen, did, ptab = \
                            try_piece(b)
                elif (actual < target_cblock_size // 2 and b < nb):
                    b2 = min(a + max((b - a) * target_cblock_size
                                     * 8 // (max(actual, 1) * 8), b - a + 1),
                             nb)
                    if b2 > b:
                        b = b2
                        payload, next_huf, next_fse, clen, did, ptab = \
                            try_piece(b)
            except _EmitRawBlock:
                return whole
            if len(payload) >= clen:
                return whole
            pieces.append((payload, BT_COMPRESSED, clen))
            st = dataclasses.replace(st, huf=next_huf, fse=next_fse)
            emitted[0] = emitted[0] or did
            if ptab:
                region_ref[0] = None
            total += clen
            a = b
        return pieces, dataclasses.replace(st, reps=new_reps)
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
        pts = split_points(seqs, target_cblock_size=target_cblock_size)
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
    if (not target_cblock_size
            and sum(len(p) for p, _, _ in pieces) >= len(whole_payload)):
        # entropy-driven splitting must pay for itself; target-size
        # (superblock) splitting buys latency instead and keeps the split
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
