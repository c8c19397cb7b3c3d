"""Batched match proposal on device: words, hashes and the previous position
in the same hash bucket (the dense equivalent of a fully-updated hash table).

Counterpart of words_at, hash_positions and prev_same_bucket in
zstd_tpu/ops/match.py, batched over rows [B, n]. Torch has no uint32 shifts on
the CPU, so u32 values are carried in int64 and masked to 32 bits; every
product is split so that it never leaves the int64 range.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_P1 = 2654435761
_P2 = 2246822519
_TAIL_BUCKET = 0xFFFFFFFF   # bucket of positions at or past valid_len


def _mul32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 a in [0, 2^32): two 16-bit halves of p."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def words_at(blocks: torch.Tensor) -> torch.Tensor:
    """blocks u8[B, n] -> int64[B, n]: the little-endian u32 starting at every
    byte position (positions past the end read zeros)."""
    b = blocks.to(torch.int64)
    bp = torch.nn.functional.pad(b, (0, 3))
    n = blocks.shape[1]
    return (bp[:, 0:n] | (bp[:, 1:n + 1] << 8) | (bp[:, 2:n + 2] << 16)
            | (bp[:, 3:n + 3] << 24))


def hash_positions(blocks: torch.Tensor, hash_log: int, mls: int,
                   w32: torch.Tensor | None = None) -> torch.Tensor:
    """int64[B, n] bucket ids: hash of the mls bytes at every position
    (bytes 0-3 and 4-7 mixed with two primes, as zstd_tpu does)."""
    if w32 is None:
        w32 = words_at(blocks)
    lo = w32
    hi = torch.nn.functional.pad(w32[:, 4:], (0, 4))
    keep = max(0, min(mls, 8) - 4)
    if keep == 0:
        hi = torch.zeros_like(hi)
    elif keep < 4:
        hi = hi & ((1 << (8 * keep)) - 1)
    h = _mul32(lo, _P1) ^ _mul32(hi, _P2)
    return h >> (32 - hash_log)


def prev_same_bucket(h: torch.Tensor, valid_lens: torch.Tensor) -> torch.Tensor:
    """int32[B, n]: largest j < i with h[j] == h[i] (both < valid_len), else -1.
    A stable sort by bucket puts each position right after its predecessor
    in the same bucket."""
    n = h.shape[1]
    pos = torch.arange(n, device=h.device)
    valid = pos[None, :] < valid_lens[:, None].to(torch.int64)
    hv = torch.where(valid, h, torch.full_like(h, _TAIL_BUCKET))
    h_sorted, order = torch.sort(hv, dim=1, stable=True)
    same = h_sorted[:, 1:] == h_sorted[:, :-1]
    prev_sorted = torch.where(same, order[:, :-1], -1)
    prev_sorted = torch.cat(
        [torch.full_like(order[:, :1], -1), prev_sorted], dim=1)
    prev = torch.empty_like(order).scatter_(1, order, prev_sorted)
    return torch.where(valid, prev, -1).to(torch.int32)
