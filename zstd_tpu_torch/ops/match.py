"""Batched match finding on device: words, hashes and the previous position
in the same hash bucket (the dense equivalent of a fully-updated hash table),
and the xla engine's capped lengths, backward extension and greedy walk.

Counterpart of zstd_tpu/ops/match.py, batched over rows [B, n]. Torch has no
uint32 shifts on the CPU, so u32 values are carried in int64 and masked to 32
bits; every product is split so that it never leaves the int64 range.
"""

from __future__ import annotations

import math

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


# ---- the xla engine: capped lengths, backward extension, the greedy walk --
#
# Counterparts of match_lengths, backward_extension, greedy_resolve and
# find_matches_block in zstd_tpu/ops/match.py (:100-233), batched over rows.
# `xla_walk_plain` (match_lengths -> mask -> greedy_resolve) is the walk of
# seqextract.xla_extract_plain; on a card one launch of csrc/xla_walk.cu
# computes the walk and the emit after it (seqextract.xla_extract).

MIN_MATCH_EMIT = 4
MLEN_CAP = 4 + 4 * 8 * 255    # the JAX loop stops after 255 rounds of 32 bytes
TAIL_MARGIN = 8               # positions this close to valid_len never commit
_LCP_WORDS = 16               # words a round of the direct length loop


def _byte_runs(x: torch.Tensor, low: bool) -> torch.Tensor:
    """Equal bytes implied by an XOR x of u32 words (int64 in [0, 2^32)):
    from the low end (low=True: the lowest nonzero byte's index) or from the
    high end; 4 when x == 0."""
    out = torch.full_like(x, 4)
    for k in ((3, 2, 1, 0) if low else (0, 1, 2, 3)):
        out = torch.where(((x >> (8 * k)) & 0xFF) != 0, k if low else 3 - k,
                          out)
    return out


def _direct_lengths(w32: torch.Tensor, rows: torch.Tensor, p: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """min(lcp, MLEN_CAP) of positions p and c of rows `rows`, word by word as
    the JAX loop compares them: the word at min(i, n - 1) (zeros past n), the
    first unequal word's equal low bytes. Active pairs only, in rounds of
    _LCP_WORDS words."""
    n = w32.shape[1]
    flat = w32.reshape(-1)
    out = torch.zeros_like(p)
    act = torch.arange(p.shape[0], device=p.device)
    length = torch.zeros_like(p)
    k4 = 4 * torch.arange(_LCP_WORDS, device=p.device)[None, :]
    while act.numel():
        base = (rows[act] * n)[:, None]
        ia = ((p[act] + length)[:, None] + k4).clamp(max=n - 1) + base
        ib = ((c[act] + length)[:, None] + k4).clamp(max=n - 1) + base
        x = flat[ia] ^ flat[ib]
        nz = x != 0
        first = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1),
                            _LCP_WORDS)
        xf = x.gather(1, first.clamp(max=_LCP_WORDS - 1)[:, None])[:, 0]
        run = 4 * first + torch.where(first < _LCP_WORDS,
                                      _byte_runs(xf, True), 0)
        length = length + run
        done = (run < 4 * _LCP_WORDS) | (length >= MLEN_CAP)
        out[act[done]] = length[done].clamp(max=MLEN_CAP)
        act, length = act[~done], length[~done]
    return out


def match_lengths(blocks: torch.Tensor, cands: torch.Tensor,
                  valid_lens: torch.Tensor,
                  w32: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B, n]: min(lcp(p, cand[p]), MLEN_CAP, valid_len - p) where the
    4-byte words at p and cand[p] are equal (zeros past n), else 0; what the
    JAX loop computes.

    Closed form in O(n) for runs of candidates: where cand[p + 1] is
    cand[p] + 1 (and p + 1 < valid_len), lcp(p) = 1 + lcp(p + 1) if the
    bytes at p and cand[p] are equal, else 0. Each maximal run of such links
    ends at a position whose length is computed directly (`_direct_lengths`),
    and a reverse running minimum carries that end back along the run; past
    valid_len - p nothing is compared, and min(a + min(b, cap), cap) =
    min(a + b, cap) keeps the cap exact."""
    B, n = blocks.shape
    dev = blocks.device
    if w32 is None:
        w32 = words_at(blocks)
    pos = torch.arange(n, device=dev)[None, :]
    vl = valid_lens.to(torch.int64)[:, None]
    c = cands.to(torch.int64)
    has = c >= 0
    cc = c.clamp(min=0)
    matched = has & (w32 == w32.gather(1, cc))
    b = blocks.to(torch.int16)
    eq = b == b.gather(1, cc)
    c_next = torch.nn.functional.pad(c[:, 1:], (0, 1), value=-1)
    linked = has & (c < pos) & (pos + 1 < vl) & (c_next == c + 1)
    heads = has & ~linked
    r, p = heads.nonzero(as_tuple=True)
    raw = torch.zeros((B, n), dtype=torch.int64, device=dev)
    raw[r, p] = _direct_lengths(w32, r, p, c[r, p])
    tail = (vl - pos).clamp(min=0)
    # end of the common run: the first position >= p that does not carry
    stop = torch.where(linked, pos, pos + torch.minimum(raw, tail))
    carry = linked & eq
    first = torch.where(carry, n, pos).flip(1).cummin(dim=1).values.flip(1)
    run = stop.gather(1, first) - pos
    mlen = torch.minimum(run.clamp(max=MLEN_CAP), tail)
    return torch.where(matched, mlen, 0).to(torch.int32)


def backward_extension(blocks: torch.Tensor, cands: torch.Tensor,
                       max_back: int = 16,
                       w32: torch.Tensor | None = None) -> torch.Tensor:
    """int32[B, n]: how far the match (p, cand[p]) extends backwards, in
    max_back // 4 word passes: the equal high bytes of the words ending at
    each 4-byte boundary, while both sides stay at or above 0."""
    n = blocks.shape[1]
    if w32 is None:
        w32 = words_at(blocks)
    pos = torch.arange(n, device=blocks.device)[None, :]
    c = cands.to(torch.int64)
    cc = c.clamp(min=0)
    ext = torch.zeros_like(c)
    still = c >= 0
    for k in range(max_back // 4):
        back = 4 * (k + 1)
        ia = pos - back
        ib = cc - back
        ok = still & (ia >= 0) & (ib >= 0)
        x = w32.gather(1, ia.clamp(min=0).expand_as(c)) ^ \
            w32.gather(1, ib.clamp(min=0))
        ext = ext + torch.where(still & ok, _byte_runs(x, False), 0)
        still = ok & (x == 0)
    return ext.to(torch.int32)


def greedy_resolve(take_len: torch.Tensor, valid_lens: torch.Tensor,
                   n_log2: int) -> torch.Tensor:
    """bool[B, n]: the positions the greedy scan from 0 visits and takes a
    match at (take_len >= 4; it moves by take_len there, else by 1). As in
    JAX, the orbit of 0 in the graph i -> min(i + step, n) by pointer
    doubling: n_log2 + 1 rounds of a scatter-max of the reached set through
    the jumps, then jumps of jumps."""
    B, n = take_len.shape
    dev = take_len.device
    pos = torch.arange(n, device=dev)[None, :]
    tl = take_len.to(torch.int64)
    take = tl >= MIN_MATCH_EMIT
    nxt = torch.minimum(pos + torch.where(take, tl, 1),
                        torch.tensor(n, device=dev))
    jump = torch.cat([nxt, torch.full((B, 1), n, device=dev)], dim=1)
    reach = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    reach[:, 0] = 1
    reach = reach | (tl[:, :1] < 0).to(torch.int32)
    for _ in range(n_log2 + 1):
        add = torch.zeros_like(reach).scatter_reduce(1, jump, reach, "amax")
        reach = reach | add
        jump = jump.gather(1, jump)
    visited = (reach[:, :n] > 0) & (pos < valid_lens.to(torch.int64)[:, None])
    return visited & take


def _n_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _emit_mask(n: int, valid_lens: torch.Tensor, emit_from: torch.Tensor):
    """bool[B, n]: the positions that may commit a match."""
    pos = torch.arange(n, device=valid_lens.device)[None, :]
    return (pos < valid_lens.to(torch.int64)[:, None] - TAIL_MARGIN) & \
        (pos >= emit_from.to(torch.int64)[:, None])


def halo_defaults(B: int, device, emit_from=None, halo_ok=None):
    """(emit_from int32[B], halo_ok bool[B]), 0 and True where not given."""
    if emit_from is None:
        emit_from = torch.zeros(B, dtype=torch.int32, device=device)
    if halo_ok is None:
        halo_ok = torch.ones(B, dtype=torch.bool, device=device)
    return emit_from.to(torch.int32), halo_ok.to(torch.bool)


def find_matches_block(blocks: torch.Tensor, valid_lens: torch.Tensor,
                       hash_log: int, mls: int, emit_from=None, halo_ok=None):
    """Propose and resolve for a batch of padded blocks: (committed bool[B, n],
    match_len int32[B, n], cand int32[B, n]). Positions below emit_from[b]
    are window context: candidates, never commits; where halo_ok[b] is False,
    candidates below emit_from[b] are banned too. The plain composition on
    any device."""
    B, n = blocks.shape
    emit_from, halo_ok = halo_defaults(B, blocks.device, emit_from, halo_ok)
    w32 = words_at(blocks)
    cand = banned_candidates(blocks, valid_lens, hash_log, mls, emit_from,
                             halo_ok, w32)
    mlen = match_lengths(blocks, cand, valid_lens, w32)
    mlen = torch.where(_emit_mask(n, valid_lens, emit_from), mlen, 0)
    committed = greedy_resolve(mlen, valid_lens, _n_log2(n))
    return committed, mlen, cand


def banned_candidates(blocks, valid_lens, hash_log, mls, emit_from, halo_ok,
                      w32=None) -> torch.Tensor:
    """int32[B, n]: prev_same_bucket of the mls hash, -1 below emit_from in
    the rows whose halo_ok is False."""
    if w32 is None:
        w32 = words_at(blocks)
    cand = prev_same_bucket(hash_positions(blocks, hash_log, mls, w32),
                            valid_lens)
    keep = halo_ok[:, None] | (cand >= emit_from[:, None])
    return torch.where(keep, cand, -1)


def xla_walk_plain(blocks: torch.Tensor, cands: torch.Tensor,
                   valid_lens: torch.Tensor, emit_from: torch.Tensor):
    """The walk's plain chain: match_lengths, masked to
    emit_from <= p < valid_len - 8, then greedy_resolve. Returns (committed
    u8[B, n], take_len int32[B, n]: the length where committed, else 0)."""
    n = blocks.shape[1]
    mlen = match_lengths(blocks, cands, valid_lens)
    mlen = torch.where(_emit_mask(n, valid_lens, emit_from), mlen, 0)
    committed = greedy_resolve(mlen, valid_lens, _n_log2(n))
    return committed.to(torch.uint8), torch.where(committed, mlen, 0)
