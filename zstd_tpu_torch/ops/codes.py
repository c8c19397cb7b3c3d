"""Sequence code conversion, repcode assignment and histograms, batched.

Counterpart of seq_codes_block in zstd_tpu/ops/codes.py (zstd's
lib/compress/zstd_compress.c ZSTD_seqToCodes:2683). The repcode rule is the
stateless intra-block one: off_base = 1 iff litLength > 0 and the offset
equals the previous sequence's offset. Histograms are exact integer
scatter-adds.
"""

from __future__ import annotations

import torch

from ..constants import (MAX_LL_CODE, MAX_ML_CODE, MAX_OFF_CODE,
                         _LL_CODE_TABLE, _ML_CODE_TABLE)
from . import device_table


def highbit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of max(x, 1) (exact: x < 2^53)."""
    return (torch.frexp(x.clamp(min=1).to(torch.float64)).exponent - 1
            ).to(torch.int32)


def histogram(codes: torch.Tensor, valid: torch.Tensor, nbins: int
              ) -> torch.Tensor:
    """int32[B, nbins]: per-row counts of codes[valid] (codes < nbins)."""
    idx = torch.where(valid, codes.to(torch.int64), nbins)
    h = torch.zeros((codes.shape[0], nbins + 1), dtype=torch.int64,
                    device=codes.device)
    h.scatter_add_(1, idx, torch.ones_like(idx))
    return h[:, :nbins].to(torch.int32)


def seq_codes(ll: torch.Tensor, off: torch.Tensor, ml: torch.Tensor,
              nb_seq: torch.Tensor) -> dict:
    """ll/off/ml i32[B, cap] (match length incl. MINMATCH), nb_seq i32[B].
    Returns the codes, extras, per-code histograms and the last sequence's
    codes (ll, of, ml), as seq_codes_block does per block."""
    B, cap = ll.shape
    dev = ll.device
    idx = torch.arange(cap, device=dev)[None, :]
    valid = idx < nb_seq[:, None]

    prev_off = torch.roll(off, 1, dims=1)
    is_rep1 = (idx > 0) & valid & (ll > 0) & (off == prev_off)
    ob = torch.where(is_rep1, 1, off + 3)
    ob = torch.where(valid, ob, 1)

    llt = device_table(_LL_CODE_TABLE, dev)
    mlt = device_table(_ML_CODE_TABLE, dev)
    mlb = (ml - 3).clamp(min=0)
    llc = torch.where(ll > 63, 19 + highbit(ll), llt[ll.clamp(0, 63).long()])
    mlc = torch.where(mlb > 127, 36 + highbit(mlb), mlt[mlb.clamp(0, 127).long()])
    ofc = highbit(ob)
    llc = torch.where(valid, llc, 0)
    mlc = torch.where(valid, mlc, 0)
    ofc = torch.where(valid, ofc, 0)

    last = (nb_seq.to(torch.int64) - 1).clamp(0, cap - 1)[:, None]
    last_codes = torch.cat([llc.gather(1, last), ofc.gather(1, last),
                            mlc.gather(1, last)], dim=1)
    return dict(ob=ob, llc=llc, mlc=mlc, ofc=ofc, mlb=mlb,
                ll_hist=histogram(llc, valid, MAX_LL_CODE + 1),
                ml_hist=histogram(mlc, valid, MAX_ML_CODE + 1),
                of_hist=histogram(ofc, valid, MAX_OFF_CODE + 1),
                last_codes=last_codes)
