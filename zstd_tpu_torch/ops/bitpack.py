"""Parallel packing of (value, nbits) fields into a little-endian bitstream.

Counterpart of pack_bits in zstd_tpu/ops/bitpack.py, batched over rows: an
exclusive prefix sum of the bit widths places every field, and a split
scatter-add (fields never overlap, so add == or) assembles u32 words. Words
are carried in int64 (torch has no uint32 shifts on the CPU). Words past
`out_words` are dropped, as the JAX version's mode="drop" does.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def pack_bits(values: torch.Tensor, nbits: torch.Tensor, out_words: int):
    """values/nbits: int32[R, m] (nbits <= 31; entries with nbits == 0 are
    skipped). Returns (words int64[R, out_words] holding u32 values,
    total_bits int32[R])."""
    nb = nbits.to(torch.int64)
    v = values.to(torch.int64) & ((1 << nb) - 1)
    offs = torch.cumsum(nb, dim=1) - nb
    total = (offs[:, -1] + nb[:, -1]).to(torch.int32)
    word = offs >> 5
    shift = offs & 31
    low = (v << shift) & _M32
    high = torch.where(shift == 0, 0, v >> (32 - shift))
    active = nb > 0
    # the extra column out_words collects every dropped part
    word_lo = torch.where(active, word, out_words).clamp_(max=out_words)
    word_hi = torch.where(active, word + 1, out_words).clamp_(max=out_words)
    words = torch.zeros((values.shape[0], out_words + 1), dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(1, word_lo, low)
    words.scatter_add_(1, word_hi, high)
    return words[:, :out_words], total


def bytes_of_words(words: torch.Tensor, nbytes_valid: torch.Tensor
                   ) -> torch.Tensor:
    """int64[R, w] u32 words -> u8[R, 4w] little-endian, zeroing bytes at or
    past nbytes_valid[R]."""
    R, w = words.shape
    sh = torch.arange(0, 32, 8, device=words.device)
    raw = ((words[:, :, None] >> sh) & 0xFF).reshape(R, 4 * w)
    j = torch.arange(4 * w, device=words.device)
    raw = torch.where(j[None, :] < nbytes_valid[:, None], raw, 0)
    return raw.to(torch.uint8)
