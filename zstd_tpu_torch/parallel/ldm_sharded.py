"""Sharded long-distance matching: rank-parallel candidate discovery for
--long, on a torch.distributed process group.

Counterpart of zstd_tpu/parallel/ldm_sharded.py (the role of zstd's
lib/compress/zstd_ldm.c gear fingerprints and bucketed table, with
zstdmt's serially-maintained cross-job window). The input is cut into one
contiguous chunk of m positions a rank:

- each rank fingerprints its own positions (`ops.ldm.anchor_keys`: the
  host LDM's fingerprint, its anchor predicate and bucket key), compacts
  its anchors by owner rank (key range partition: owner s holds keys with
  key >> own_log == s, the top ranks' ranges clipped into the last) into
  [world, cap] buffers, dropping anchors past `cap` an owner in position
  order;
- an all_to_all_single routes each buffer row to its owner, which sorts
  what it receives by (key, pos) and looks 12 entries back for each
  anchor's LDM_BUCKET candidates (`ops.ldm.lookback`): the host table's
  recency semantics, the last entries inserted before the anchor's block;
- an all_gather gives every rank every owner's anchors and candidates, and
  `find_long_matches` replays the host greedy verify/commit walk against
  them (ShardedLdmState stands in for format/ldm.LdmState).

There is no halo collective. The JAX module fills each shard's 64-byte
fingerprint halo from the next shard with a ppermute, whose ring wraps: the
last shard receives shard 0's head instead of the bytes after its
positions, so its last valid positions are fingerprinted over wrong bytes
(ROADMAP §3). Here every rank holds the whole input (SPMD), so rank r's
chunk is data[r·m : r·m + m + 64] itself, zero-filled past the end, exactly
the bytes the JAX host fills before the ppermute overwrites them.

The layout is the JAX module's, because the outputs depend on it: n_pos =
n - 63 positions, m = ceil(ceil(n_pos / world) / 128) · 128, cap = max(m //
(32 · world), 8), block_size = min(window, 128 KiB), own_log = 20 -
bit_length(world - 1) above one rank. Compaction keys are int64 here,
where JAX's u32 route·2^26 + p overlaps once m passes 2^26 (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..constants import BLOCK_MAX_SIZE
from ..format.frame import compress_frame
from ..format.lazy import _ext_fwd
from ..format.ldm import LDM_MIN_MATCH
from ..ops.ldm import HASH_LOG, SPAN, anchor_keys, lookback, owner_entries
from ..params import get_cparams
from ..pipeline import _resolve_device
from .shard_compress import ShardGroup, gather_rows, make_group


def own_log(world: int) -> int:
    """Owner of a key: min(key >> own_log(world), world - 1)."""
    return HASH_LOG - (world - 1).bit_length() if world > 1 else HASH_LOG


def layout(n: int, world: int, window_size: int) -> dict:
    """The JAX module's layout of an n-byte input over `world` ranks:
    n_pos, m (positions a rank), cap (entries a rank sends an owner) and
    block_size."""
    n_pos = max(n - SPAN + 1, 0)
    m = -(-max(n_pos, 1) // world)
    m = -(-m // 128) * 128
    return dict(n_pos=n_pos, m=m, cap=max(m // (32 * world), 8),
                block_size=min(window_size, BLOCK_MAX_SIZE))


def _resolve_group(group: ShardGroup | None, device) -> ShardGroup | None:
    """group, else make_group(device) when a process group is initialised,
    else None: a world of one on `device`, with no collectives."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return make_group(device)
    return None


def owner_entries_of(chunk: torch.Tensor, valid: int, gbase: int,
                     group: ShardGroup | None, cap: int) -> torch.Tensor:
    """The entries this rank OWNS, sorted: chunk u8[m + SPAN] (this rank's m
    positions and the bytes after them), valid (its fingerprinted
    positions), gbase (the global offset of its first byte); group None is
    a world of one. Returns int64[world * cap] (`ops.ldm.owner_entries`,
    ascending)."""
    world = 1 if group is None else group.world
    dev = chunk.device
    flag, key = anchor_keys(chunk, valid)
    p = torch.nonzero(flag)[:, 0]                 # anchors, in p order
    k = key[p]
    owner = torch.clamp(k >> own_log(world), max=world - 1).long()
    order = torch.sort(owner, stable=True).indices
    so, sk, sp = owner[order], k[order], (p[order] + gbase).to(torch.int32)
    # rank of each anchor inside its owner's run; past cap it is dropped
    counts = torch.bincount(so, minlength=world)
    within = torch.arange(so.numel(), device=dev) \
        - (torch.cumsum(counts, 0) - counts)[so]
    keep = within < cap
    dst = so[keep] * cap + within[keep]
    send_k = torch.full((world * cap,), -1, dtype=torch.int32, device=dev)
    send_p = torch.full((world * cap,), -1, dtype=torch.int32, device=dev)
    send_k[dst] = sk[keep]
    send_p[dst] = sp[keep]
    if group is None:
        recv_k, recv_p = send_k, send_p
    else:
        # row j of what a rank receives comes from rank j
        recv_k, recv_p = torch.empty_like(send_k), torch.empty_like(send_p)
        dist.all_to_all_single(recv_k, send_k, group=group.pg)
        dist.all_to_all_single(recv_p, send_p, group=group.pg)
    return torch.sort(owner_entries(recv_k, recv_p)).values


def discover(chunk: torch.Tensor, valid: int, gbase: int,
             group: ShardGroup | None, cap: int, block_size: int,
             window_size: int):
    """One rank's part of the sharded discovery (`owner_entries_of`, then
    the look-back). Returns (pos int32[world * cap], cand int32[world * cap,
    LDM_BUCKET]): the anchors this rank OWNS, sorted by (key, pos), -1
    padded, and their candidates."""
    return lookback(owner_entries_of(chunk, valid, gbase, group, cap),
                    block_size, window_size)


class ShardedLdmState:
    """Drop-in for format/ldm.LdmState with rank-parallel discovery.

    Candidate lists are computed at construction by every rank of `group`
    (SPMD: each passes the same `full`; None takes the initialised default
    group, else a world of one on `device`, the card by default);
    find_long_matches replays the host greedy verify/commit walk against
    them (same cursor/backward-extension semantics, same size behavior)."""

    def __init__(self, full: np.ndarray, window_log: int,
                 group: ShardGroup | None = None, device=None):
        group = _resolve_group(group, device)
        dev = group.device if group is not None else _resolve_device(device)
        world = 1 if group is None else group.world
        rank = 0 if group is None else group.rank
        self.full = full
        self.window_size = 1 << window_log
        n = len(full)
        lay = layout(n, world, self.window_size)
        m = lay["m"]
        a = rank * m
        chunk = np.zeros(m + SPAN, dtype=np.uint8)
        if a < n:
            piece = full[a:min(a + m + SPAN, n)]
            chunk[:len(piece)] = piece
        valid = min(max(lay["n_pos"] - a, 0), m)
        pos, cand = discover(torch.from_numpy(chunk).to(dev), valid, a,
                             group, lay["cap"], lay["block_size"],
                             self.window_size)
        if group is not None:
            pos = gather_rows(pos, group)
            cand = gather_rows(cand, group)
        pos = pos.cpu().numpy()
        cand = cand.cpu().numpy()
        keep = pos >= 0
        pos, cand = pos[keep], cand[keep]
        order = np.argsort(pos, kind="stable")
        self.anchors = pos[order].astype(np.int64)
        self.cands = cand[order]

    # LdmState interface ------------------------------------------------
    def insert_upto(self, pos: int) -> None:
        pass    # candidates are precomputed with block-granular recency

    def find_long_matches(self, block_start: int, block_end: int
                          ) -> list[tuple[int, int, int]]:
        full = self.full
        n = len(full)
        lo = np.searchsorted(self.anchors, block_start)
        hi = np.searchsorted(self.anchors,
                             max(block_end - LDM_MIN_MATCH, block_start))
        out = []
        cursor = block_start
        for ai in range(lo, hi):
            p = int(self.anchors[ai])
            if p < cursor:
                continue
            best_len = 0
            best_c = -1
            for c in self.cands[ai]:
                c = int(c)
                if c < 0 or c >= p or p - c > self.window_size:
                    continue
                limit = min(block_end - p, n - p)
                ln = _ext_fwd(full, p, c, limit)
                if ln > best_len:
                    best_len = ln
                    best_c = c
            if best_len >= LDM_MIN_MATCH:
                s, c2 = p, best_c
                while s > cursor and c2 > 0 and full[s - 1] == full[c2 - 1]:
                    s -= 1
                    c2 -= 1
                    best_len += 1
                out.append((s, best_len, s - c2))
                cursor = s + best_len
        return out


def compress_long_sharded(data: bytes, level: int = 1, checksum: bool = False,
                          long_log: int = 27,
                          group: ShardGroup | None = None,
                          device=None) -> bytes:
    """--long=N through the sharded discovery: the candidates feed the host
    frame encoder, whose inner parser compresses the gaps. SPMD: every rank
    calls it with the same `data` and returns the same frame. group None:
    the initialised default group (make_group(device)), else a world of one
    on `device` (the card by default; device="cpu" runs the plain
    versions)."""
    n = len(data)
    cparams = get_cparams(level, n)
    wlog = max(cparams.window_log, min(long_log, max(n - 1, 1).bit_length()))
    cparams = dataclasses.replace(cparams, window_log=wlog)
    full = np.frombuffer(data, dtype=np.uint8)
    state = ShardedLdmState(full, wlog, group=group, device=device)
    return compress_frame(data, cparams, checksum=checksum, ldm_state=state)
