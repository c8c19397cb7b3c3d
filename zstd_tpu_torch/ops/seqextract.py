"""Match extraction for a batch of blocks: propose + serial resolve.

Counterpart of extract_batch_pallas in zstd_tpu/ops/seqextract.py: torch ops
propose a candidate for every position (ops.match), `next_possible` builds
the jump table, and ops.resolve.extract_compact (the CUDA kernel on a card)
commits matches and compacts the literals.
"""

from __future__ import annotations

import torch

from .match import hash_positions, prev_same_bucket, words_at
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
