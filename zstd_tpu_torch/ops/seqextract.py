"""Match extraction for a batch of blocks into the seqstore.

Counterpart of zstd_tpu/ops/seqextract.py:
- `extract_batch` (extract_batch_pallas there): torch ops propose a candidate
  for every position (ops.match), `next_possible` builds the jump table, and
  ops.resolve.extract_compact (the CUDA kernel on a card) commits matches and
  compacts the literals.
- `extract_batch_xla` (extract_block / extract_batch there, the xla engine):
  ops.match.banned_candidates proposes, then `xla_extract` commits the
  greedy chain of capped matches, extends them backward, compacts the
  sequences and indexes the literals: one launch of csrc/xla_walk.cu on a
  card, the plain chain `xla_extract_plain` (ops.match.xla_walk_plain, then
  torch ops) on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from .match import (backward_extension, banned_candidates, halo_defaults,
                    hash_positions, prev_same_bucket, words_at, xla_walk_plain)
from .resolve import PAD, extract_compact


def next_possible(blocks: torch.Tensor, cands: torch.Tensor,
                  w32: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B, n]: nxt[i] = smallest j >= i whose candidate matches 4 bytes,
    else n + PAD (a reverse running minimum). Computed over every position,
    those at or past valid_len included (their candidate is -1)."""
    n = blocks.shape[1]
    if w32 is None:
        w32 = words_at(blocks)
    ok = (cands >= 0) & (w32 == w32.gather(1, cands.clamp(min=0).long()))
    pos = torch.arange(n, device=blocks.device)
    cand_pos = torch.where(ok, pos, n + PAD)
    return torch.cummin(cand_pos.flip(1), dim=1).values.flip(1).to(torch.int32)


def extract_batch(blocks: torch.Tensor, valid_lens: torch.Tensor,
                  hash_log: int, mls: int, seq_cap: int) -> dict:
    """blocks u8[B, n], valid_lens i32[B]. Returns nb_seq, ll, off, ml,
    lits (u8[B, n], zero past nb_lit) and nb_lit, as extract_batch_pallas
    does."""
    w32 = words_at(blocks)
    h = hash_positions(blocks, hash_log, mls, w32)
    cands = prev_same_bucket(h, valid_lens)
    nxt = next_possible(blocks, cands, w32)
    ll, off, ml, lits, nb, nb_lit = extract_compact(
        blocks.contiguous(), cands, nxt, valid_lens.to(torch.int32), seq_cap)
    return dict(nb_seq=nb, ll=ll, off=off, ml=ml, lits=lits, nb_lit=nb_lit)


def extract_batch_xla(blocks: torch.Tensor, valid_lens: torch.Tensor,
                      hash_log: int, mls: int, seq_cap: int, emit_from=None,
                      halo_ok=None) -> dict:
    """The xla engine over a batch: blocks u8[B, n], valid_lens i32[B], and
    optionally emit_from i32[B] / halo_ok bool[B] (default 0 / True).
    Positions below emit_from[b] are window context: candidates, never
    sequences or literals; halo_ok[b] False also bans candidates below
    emit_from[b] (a fabricated halo). The candidates (`banned_candidates`),
    then `xla_extract`: the csrc/xla_walk.cu kernel on a card, from the
    candidates to the seqstore and the literal index in one launch. Returns
    what extract_block returns per block (see `xla_extract`)."""
    B = blocks.shape[0]
    emit_from, halo_ok = halo_defaults(B, blocks.device, emit_from, halo_ok)
    valid_lens = valid_lens.to(torch.int32)
    cand = banned_candidates(blocks, valid_lens, hash_log, mls, emit_from,
                             halo_ok)
    return xla_extract(blocks.contiguous(), cand.contiguous(),
                       valid_lens.contiguous(), emit_from.contiguous(),
                       halo_ok.contiguous(), seq_cap)


def xla_extract(blocks: torch.Tensor, cands: torch.Tensor,
                valid_lens: torch.Tensor, emit_from: torch.Tensor,
                halo_ok: torch.Tensor, seq_cap: int) -> dict:
    """The xla engine from the candidates to the seqstore: blocks u8[B, n]
    (4-byte aligned), cands int32[B, n] (-1 or below the position, as
    prev_same_bucket gives them, after the halo ban), valid_lens and
    emit_from int32[B] (valid_len <= n), halo_ok bool[B]. Returns nb_seq,
    ll, off, ml (i32[B, seq_cap], zero past nb_seq), lit_idx (i32[B, n]: the
    literal positions in order, n - 1 past nb_lit), nb_lit and overflow
    (nb_seq > seq_cap; nb_seq counts every commit). CPU tensors take
    `xla_extract_plain`; CUDA tensors launch csrc/xla_walk.cu or raise."""
    if blocks.device.type == "cpu":
        return xla_extract_plain(blocks, cands, valid_lens, emit_from,
                                 halo_ok, seq_cap)
    return _xla_extract_cuda(blocks, cands, valid_lens, emit_from, halo_ok,
                             seq_cap, None)


def xla_extract_stats(blocks: torch.Tensor, cands: torch.Tensor,
                      valid_lens: torch.Tensor, emit_from: torch.Tensor,
                      halo_ok: torch.Tensor, seq_cap: int,
                      ctas: int | None = None):
    """`xla_extract` on CUDA tensors, plus the kernel's int32[B, 10] counts
    per row (XLA_STATS names them); `ctas` (2-4) overrides the CTAs a row
    that `xla_ctas` chooses."""
    if blocks.device.type == "cpu":
        raise ValueError("xla_extract_stats: the counts come from the CUDA "
                         "kernel; CPU tensors take xla_extract")
    stats = torch.zeros((blocks.shape[0], len(XLA_STATS)), dtype=torch.int32,
                        device=blocks.device)
    return _xla_extract_cuda(blocks, cands, valid_lens, emit_from, halo_ok,
                             seq_cap, stats, ctas), stats


# the kernel's counts per row: commits, segments with positions, the slowest
# warp's speculative steps (32-position ballots and length rounds),
# repair rounds, repair steps (all warps), the longest warp's SM cycles in
# the speculate, repair and emit phases, the CTAs a row and the longest
# CTA's SM cycles
XLA_STATS = ("commits", "segments", "spec_steps", "rounds", "repair_steps",
             "spec_cycles", "repair_cycles", "emit_cycles", "ctas",
             "cta_cycles")
CTAS = _kernels.CTAS        # the kernel's instantiations
_MAX_CLUSTERS: dict = {}


def xla_ctas(B: int, n: int, device) -> int:
    """CTAs a row (2-4) for a launch of B rows of n bytes: a row's 32 * C
    segments shorten its walk by C, and rows past the clusters of C CTAs
    that the card holds at once run in later waves, so the fewest
    ceil(B / clusters) / C, the larger C on a tie. The clusters come from
    the card's occupancy query, once per device and row size."""
    key = (torch.device(device).index, n)
    if key not in _MAX_CLUSTERS:
        lib = _kernels.get("xla_walk.cu")
        with torch.cuda.device(device):
            _MAX_CLUSTERS[key] = [lib.xla_walk_max_clusters(n, c)
                                  for c in CTAS]
    return _kernels.fewest_waves(B, _MAX_CLUSTERS[key])


def xla_extract_plain(blocks: torch.Tensor, cands: torch.Tensor,
                      valid_lens: torch.Tensor, emit_from: torch.Tensor,
                      halo_ok: torch.Tensor, seq_cap: int) -> dict:
    """`xla_extract`'s plain chain in torch ops: xla_walk_plain, then the
    backward extension (never past the previous committed end or
    emit_from), the compaction and the literal index of extract_block.

    One difference from zstd_tpu, where its frame would be corrupt: in a row
    whose halo_ok is False the backward extension stops where the
    candidate's side would pass below emit_from, so no match reaches into
    the fabricated halo (zstd_tpu only bounds the position's side)."""
    committed, take_len = xla_walk_plain(blocks, cands, valid_lens,
                                         emit_from)
    return xla_emit_plain(blocks, cands, valid_lens, emit_from, halo_ok,
                          seq_cap, committed, take_len)


def xla_emit_plain(blocks: torch.Tensor, cands: torch.Tensor,
                   valid_lens: torch.Tensor, emit_from: torch.Tensor,
                   halo_ok: torch.Tensor, seq_cap: int,
                   committed: torch.Tensor, take_len: torch.Tensor) -> dict:
    """The torch ops of `xla_extract_plain` after the walk (committed u8 and
    take_len int32 [B, n] of xla_walk_plain): what extract_block computes
    in XLA after its two loops. No op syncs with the host."""
    B, n = blocks.shape
    dev = blocks.device
    ef = emit_from.to(torch.int64)[:, None]
    pos = torch.arange(n, device=dev)[None, :]
    committed = committed.bool()
    take_len = take_len.to(torch.int64)
    c = cands.to(torch.int64)

    # backward extension, never past the previous committed end or emit_from
    back = backward_extension(blocks, cands).to(torch.int64)
    ends = torch.where(committed, pos + take_len, 0)
    prev_end = torch.nn.functional.pad(ends.cummax(dim=1).values[:, :-1],
                                       (1, 0))
    prev_end = torch.maximum(prev_end, ef)
    ext = torch.minimum(back, (pos - prev_end).clamp(min=0))
    ext = torch.where(halo_ok[:, None], ext,
                      torch.minimum(ext, (c - ef).clamp(min=0)))
    ext = torch.where(committed, ext, 0)
    start = pos - ext
    length = take_len + ext
    offset = torch.where(committed, pos - c, 0)

    # compaction: committed entries in position order, those past seq_cap
    # into a slot that is cut off
    rank = committed.to(torch.int64).cumsum(dim=1) - 1
    nb_seq = committed.sum(dim=1)
    idx = torch.where(committed, rank, seq_cap).clamp(max=seq_cap)

    def compact(vals):
        out = torch.zeros((B, seq_cap + 1), dtype=torch.int64, device=dev)
        return out.scatter_(1, idx, vals)[:, :seq_cap]

    seq_start, seq_len, seq_off = compact(start), compact(length), \
        compact(offset)
    s_rank = torch.arange(seq_cap, device=dev)[None, :]
    prev_match_end = torch.where(s_rank == 0, ef,
                                 torch.roll(seq_start + seq_len, 1, dims=1))
    valid_seq = s_rank < nb_seq[:, None]
    ll = torch.where(valid_seq, seq_start - prev_match_end, 0)
    ml = torch.where(valid_seq, seq_len, 0)
    off = torch.where(valid_seq, seq_off, 0)

    # literals: the positions no extended match covers
    delta = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    one = committed.to(torch.int32)
    delta.scatter_add_(1, start, one)
    delta.scatter_add_(1, start + length, -one)
    covered = delta[:, :n].cumsum(dim=1) > 0
    is_lit = ~covered & (pos >= ef) & \
        (pos < valid_lens.to(torch.int64)[:, None])
    nb_lit = is_lit.sum(dim=1)
    lit_rank = is_lit.to(torch.int64).cumsum(dim=1) - 1
    lit_idx = torch.full((B, n + 1), n - 1, dtype=torch.int64, device=dev)
    lit_idx.scatter_(1, torch.where(is_lit, lit_rank, n), pos.expand(B, n))

    i32 = torch.int32
    return dict(nb_seq=nb_seq.to(i32), ll=ll.to(i32), off=off.to(i32),
                ml=ml.to(i32), lit_idx=lit_idx[:, :n].to(i32),
                nb_lit=nb_lit.to(i32), overflow=nb_seq > seq_cap)


def _xla_extract_cuda(blocks, cands, valid_lens, emit_from, halo_ok, seq_cap,
                      stats, ctas=None):
    B, n = blocks.shape
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"xla_extract: unsupported device {dev}")
    for name, t, dtype, shape in (("blocks", blocks, torch.uint8, (B, n)),
                                  ("cands", cands, torch.int32, (B, n)),
                                  ("valid_lens", valid_lens, torch.int32,
                                   (B,)),
                                  ("emit_from", emit_from, torch.int32,
                                   (B,)),
                                  ("halo_ok", halo_ok, torch.bool, (B,))):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"xla_extract: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")
    if blocks.data_ptr() % 4:
        raise ValueError("xla_extract: blocks must be 4-byte aligned")
    if seq_cap < 1:
        raise ValueError("xla_extract: seq_cap must be positive")
    i32 = torch.int32
    out = dict(nb_seq=torch.empty(B, dtype=i32, device=dev),
               ll=torch.empty((B, seq_cap), dtype=i32, device=dev),
               off=torch.empty((B, seq_cap), dtype=i32, device=dev),
               ml=torch.empty((B, seq_cap), dtype=i32, device=dev),
               lit_idx=torch.empty((B, n), dtype=i32, device=dev),
               nb_lit=torch.empty(B, dtype=i32, device=dev),
               overflow=torch.empty(B, dtype=torch.bool, device=dev))
    if B * n == 0:            # no positions: no sequences, no literals
        for v in out.values():
            v.zero_()
        return out
    lib = _kernels.get("xla_walk.cu")
    if ctas is None:
        ctas = xla_ctas(B, n, dev)
    scratch = torch.empty(B * lib.xla_walk_scratch_bytes(n, ctas),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.xla_walk_launch(
            blocks.data_ptr(), cands.data_ptr(), valid_lens.data_ptr(),
            emit_from.data_ptr(), halo_ok.data_ptr(),
            out["nb_seq"].data_ptr(), out["ll"].data_ptr(),
            out["off"].data_ptr(), out["ml"].data_ptr(),
            out["lit_idx"].data_ptr(), out["nb_lit"].data_ptr(),
            out["overflow"].data_ptr(), scratch.data_ptr(),
            0 if stats is None else stats.data_ptr(), B, n, seq_cap, ctas,
            ctypes.c_void_p(stream))
    _kernels.check(err, "xla_walk_launch")
    _kernels.LAUNCHES["xla_walk"] += 1
    return out
