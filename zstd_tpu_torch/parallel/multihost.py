"""Multi-host runtime: pzstd-style frame data-parallelism across processes.

Counterpart of zstd_tpu/parallel/multihost.py (the pzstd model, zstd's
contrib/pzstd/Pzstd.cpp:73,87: each process compresses an independent,
contiguous chunk range into frames, and the outputs are concatenated in
process order). jax.distributed becomes torch.distributed: the group's
address, size and rank come from the arguments or from the standard
MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK, over NCCL on a card or gloo
when the caller asks for the CPU. Like zstd_tpu's, compress_my_shard and
decompress_stream run the host codec (parallel/pzstd.py): frames are
independent, so the group only gives each process its index and count, and
no compressed bytes cross a collective unless gather_and_concat is called.
"""

from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from .pzstd import pzstd_compress, pzstd_decompress
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


def compress_my_shard(data: bytes, level: int = 3, checksum: bool = False,
                      chunk_size: int = 1 << 22,
                      process_index: int | None = None,
                      process_count: int | None = None,
                      workers: int = 4) -> bytes:
    """Compress THIS process's contiguous chunk range of `data` into
    standard multi-frame zstd (with pzstd size-hint skippables).

    Every process calls this with the same `data` view (or its own slice
    read from shared storage); concatenating the outputs in process order
    yields one stream any zstd decoder reads. The index and count default
    to the rank and world size of the initialised default group, else
    (0, 1). The work is the host codec's on this process's CPU cores, as in
    zstd_tpu: no card takes part."""
    if process_index is None or process_count is None:
        rank, world = ((dist.get_rank(), dist.get_world_size())
                       if dist.is_available() and dist.is_initialized()
                       else (0, 1))
        process_index = rank if process_index is None else process_index
        process_count = world if process_count is None else process_count
    return pzstd_compress(data, level=level, checksum=checksum,
                          chunk_size=chunk_size, workers=workers,
                          shard_index=process_index,
                          shard_count=process_count)


def decompress_stream(blob: bytes, workers: int = 4,
                      window_log_max: int = 27) -> bytes:
    """Decode a multi-host-produced stream (plain multi-frame zstd) on the
    host."""
    return pzstd_decompress(blob, workers=workers,
                            window_log_max=window_log_max)
