"""Match extraction for a batch of blocks into the seqstore.

Counterpart of zstd_tpu/ops/seqextract.py:
- `extract_batch` (extract_batch_pallas there): torch ops propose a candidate
  for every position (ops.match), `next_possible` builds the jump table, and
  ops.resolve.extract_compact (the CUDA kernel on a card) commits matches and
  compacts the literals.
- `extract_batch_xla` (extract_block / extract_batch there, the xla engine):
  ops.match.xla_walk commits the greedy chain of capped matches (the CUDA
  kernel on a card), and torch ops extend the matches backward, compact the
  sequences and index the literals.
"""

from __future__ import annotations

import torch

from .match import (backward_extension, banned_candidates, halo_defaults,
                    hash_positions, prev_same_bucket, words_at, xla_walk)
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
    emit_from[b] (a fabricated halo). Returns nb_seq, ll, off, ml
    (i32[B, seq_cap], zero past nb_seq), lit_idx (i32[B, n]: the literal
    positions in order, n - 1 past nb_lit), nb_lit and overflow
    (nb_seq > seq_cap), as extract_block does per block.

    One difference from zstd_tpu, where its frame would be corrupt: in a row
    whose halo_ok is False the backward extension stops where the
    candidate's side would pass below emit_from, so no match reaches into
    the fabricated halo (zstd_tpu only bounds the position's side)."""
    B, n = blocks.shape
    dev = blocks.device
    emit_from, halo_ok = halo_defaults(B, dev, emit_from, halo_ok)
    valid_lens = valid_lens.to(torch.int32)
    ef = emit_from.to(torch.int64)[:, None]
    pos = torch.arange(n, device=dev)[None, :]
    w32 = words_at(blocks)
    cand = banned_candidates(blocks, valid_lens, hash_log, mls, emit_from,
                             halo_ok, w32)
    committed, take_len = xla_walk(blocks.contiguous(), cand.contiguous(),
                                   valid_lens.contiguous(),
                                   emit_from.contiguous())
    committed = committed.bool()
    take_len = take_len.to(torch.int64)
    c = cand.to(torch.int64)

    # backward extension, never past the previous committed end or emit_from
    back = backward_extension(blocks, cand, w32=w32).to(torch.int64)
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
