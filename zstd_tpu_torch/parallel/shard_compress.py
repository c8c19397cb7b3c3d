"""Sharded block extraction over a torch.distributed process group.

Counterpart of zstd_tpu/parallel/shard_compress.py. The mesh's `dp` axis is
the group's ranks: every rank owns a contiguous run of blocks, the previous
block's tail is window context only (a ring exchange that wraps as the JAX
ppermute's perm does: rank r receives rank r - 1's tail, rank 0 the last
rank's; with one rank, its own), and per-shard totals are exchanged with an
all_gather (the one-hot psum there) so every rank knows the global layout.

A group runs on one card per rank over NCCL (the default: `cuda:{local
rank}`), or on the CPU over gloo when the caller passes device="cpu". The
backend must fit the device; nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.seqextract import extract_batch_xla
from ..pipeline import _resolve_device

HALO = 128   # window-overlap bytes of the minimal step


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks a sharded call runs over: this process's rank, the world
    size, its device, and the process group (None: the default group)."""
    rank: int
    world: int
    device: torch.device
    pg: object = None


def _rank_device(device: torch.device, rank: int) -> torch.device:
    """A card without an index becomes this rank's: LOCAL_RANK, else the
    rank modulo the cards."""
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    return device


def make_group(device=None, pg=None) -> ShardGroup:
    """The counterpart of make_mesh: the world of an initialised process
    group `pg` (default: the default group). device None takes this rank's
    card, cuda:{LOCAL_RANK or rank % cards}, over NCCL; device="cpu" needs a
    gloo group. Raises without a card, without a process group, or where
    the group's backend does not serve the device."""
    device = _resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call init_group or "
                           "torch.distributed.init_process_group first")
    rank = dist.get_rank(pg)
    world = dist.get_world_size(pg)
    device = _rank_device(device, rank)
    backend = str(dist.get_backend(pg))
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(f"a {device.type} group needs the {need} backend; "
                         f"this one is {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ShardGroup(rank, world, device, pg)


def init_group(init_method: str, world_size: int, rank: int,
               device=None) -> ShardGroup:
    """Initialise the default process group (NCCL for a card, gloo for
    device="cpu") at `init_method` (tcp://host:port or file:///path) and
    return its ShardGroup."""
    device = _rank_device(_resolve_device(device), rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    return make_group(device)


def gather_rows(t: torch.Tensor, grp: ShardGroup) -> torch.Tensor:
    """Every rank's `t` (same shape on every rank), concatenated in rank
    order along dim 0, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(grp.world)]
    dist.all_gather(parts, t, group=grp.pg)
    return torch.cat(parts, dim=0)


def ring_prev(t: torch.Tensor, grp: ShardGroup) -> torch.Tensor:
    """Rank r - 1's `t` on rank r, rank world - 1's on rank 0 (ppermute with
    perm [(i, (i + 1) % world)]): an all_gather of the tails."""
    return gather_rows(t[None], grp)[(grp.rank - 1) % grp.world]


def halo_rows(own: torch.Tensor, halo: int, grp: ShardGroup) -> torch.Tensor:
    """u8[b, halo + n]: each of this rank's blocks own[b, n] behind the last
    `halo` bytes of the block before it; the rank's first block behind the
    previous rank's last block (the ring wraps: on rank 0 that tail is the
    last rank's, a fabricated history)."""
    prev_rank_tail = ring_prev(own[-1, -halo:], grp)
    prev_tails = torch.cat([prev_rank_tail[None], own[:-1, -halo:]], dim=0)
    return torch.cat([prev_tails, own], dim=1)


def gather_padded(data: torch.Tensor,
                  grp: ShardGroup) -> tuple[torch.Tensor, list[int]]:
    """Every rank's u8 tensor on grp.device (of any length), in rank order,
    on the device of every rank: (u8[world, longest], each padded to the
    longest, their lengths). The lengths are gathered first."""
    n = torch.tensor([data.numel()], dtype=torch.int64, device=grp.device)
    sizes = gather_rows(n, grp).cpu().tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=grp.device)
    buf[:data.numel()] = data
    return gather_rows(buf[None], grp), sizes


def gather_bytes(data: np.ndarray, grp: ShardGroup) -> list[np.ndarray]:
    """Every rank's u8 array (of any length), in rank order, on every rank
    (gather_padded, then to the host)."""
    rows, sizes = gather_padded(
        torch.from_numpy(np.ascontiguousarray(data)).to(grp.device), grp)
    rows = rows.cpu().numpy()
    return [rows[i, :s] for i, s in enumerate(sizes)]


def sharded_extract_fn(grp: ShardGroup, hash_log: int, mls: int,
                       seq_cap: int):
    """Returns fn(blocks u8[b, n], lens i32[b]) over this rank's blocks ->
    its seqstore arrays (nb_seq, ll, off, ml, nb_lit, lits) and the
    per-rank totals shard_seq_totals / shard_lit_totals i32[world] (the
    same on every rank). Each block sees the previous block's last HALO
    bytes as search context and emits only its own bytes; rank 0's first
    block has no real history, so its candidates in the halo are banned."""

    def fn(blocks: torch.Tensor, lens: torch.Tensor) -> dict:
        b_loc = blocks.shape[0]
        dev = blocks.device
        ext = halo_rows(blocks, HALO, grp)
        emit_from = torch.full((b_loc,), HALO, dtype=torch.int32, device=dev)
        halo_ok = (torch.arange(b_loc, device=dev) > 0) | (grp.rank > 0)
        res = extract_batch_xla(ext, lens + HALO, hash_log, mls, seq_cap,
                                emit_from=emit_from, halo_ok=halo_ok)
        lits = ext.gather(1, res["lit_idx"].to(torch.int64))
        totals = torch.stack([res["nb_seq"].sum(), res["nb_lit"].sum()])
        totals = gather_rows(totals.to(torch.int32)[None], grp)
        return dict(nb_seq=res["nb_seq"], ll=res["ll"], off=res["off"],
                    ml=res["ml"], nb_lit=res["nb_lit"], lits=lits,
                    shard_seq_totals=totals[:, 0],
                    shard_lit_totals=totals[:, 1])

    return fn


def compress_step(grp: ShardGroup, blocks: np.ndarray, lens: np.ndarray,
                  hash_log: int = 13, mls: int = 6) -> dict:
    """One sharded step over the group: every rank passes the same blocks
    u8[B, n] and lens i32[B] (B a multiple of the world size) and extracts
    its contiguous B / world of them. Returns the whole batch's arrays,
    gathered in rank order on every rank, as the JAX step's global arrays."""
    B, n = blocks.shape
    if B % grp.world:
        raise ValueError(f"{B} blocks do not shard over {grp.world} ranks")
    rows = B // grp.world
    mine = slice(grp.rank * rows, (grp.rank + 1) * rows)
    fn = sharded_extract_fn(grp, hash_log, mls, max(n // 4, 8))
    out = fn(torch.from_numpy(np.ascontiguousarray(blocks[mine])).to(
                 grp.device),
             torch.from_numpy(np.ascontiguousarray(lens[mine], np.int32)).to(
                 grp.device))
    return {k: v if k.startswith("shard_") else gather_rows(v, grp)
            for k, v in out.items()}
