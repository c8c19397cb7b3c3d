"""Multi-host runtime: joining a torch.distributed group and collecting each
process's compressed shard on process 0.

Counterpart of init_distributed and gather_and_concat in
zstd_tpu/parallel/multihost.py (the pzstd model, zstd's
contrib/pzstd/Pzstd.cpp:73,87: each process compresses an independent,
contiguous chunk range into frames, and the outputs are concatenated in
process order). jax.distributed becomes torch.distributed: the group's
address, size and rank come from the arguments or from the standard
MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK, over NCCL on a card or gloo
when the caller asks for the CPU. The JAX module's compress_my_shard and
decompress_stream wrap the host pzstd, which the port does not have yet
(ROADMAP item 12).
"""

from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from .shard_compress import ShardGroup, gather_bytes, init_group, make_group


def init_distributed(init_method: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None) -> tuple[int, int]:
    """Join (or start) the default torch.distributed process group.

    init_method defaults to tcp://MASTER_ADDR:MASTER_PORT, num_processes to
    WORLD_SIZE and process_id to RANK. NCCL on this rank's card, gloo with
    device="cpu". Returns (rank, world); safe to call when already
    initialized, and (0, 1) for a single process, which joins nothing."""
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0")) or None
    if process_id is None and os.environ.get("RANK") is not None:
        process_id = int(os.environ["RANK"])
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method and num_processes and num_processes > 1:
        if process_id is None:
            raise ValueError("init_distributed: no rank (RANK) for a group "
                             f"of {num_processes}")
        grp = init_group(init_method, num_processes, process_id,
                         device=device)
        return grp.rank, grp.world
    return 0, 1


def gather_and_concat(shard_bytes: bytes, group: ShardGroup | None = None
                      ) -> list[bytes] | None:
    """Every process's compressed shard, in process order, on process 0
    (None on the others): shard_compress.gather_bytes over `group` (None:
    the initialised default group on this rank's card; a single process
    returns [shard_bytes])."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return [shard_bytes]
        group = make_group()
    if group.world == 1:
        return [shard_bytes]
    parts = gather_bytes(np.frombuffer(shard_bytes, dtype=np.uint8), group)
    if group.rank != 0:
        return None
    return [p.tobytes() for p in parts]
