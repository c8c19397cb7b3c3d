"""Ranks of a gloo process group in spawned processes, for the tests of
zstd_tpu_torch.parallel.

A spawned child imports this module to find its target, so it imports torch
and zstd_tpu_torch only (the test modules import JAX, and a forked child of
a process with JAX's threads is unsafe). Each group rendezvouses through its
own FileStore, and every join has a deadline that fails the test.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time

JOIN_TIMEOUT = 120.0   # seconds for all ranks of one group


def _rank_main(rank: int, world: int, store: str, jobs: list,
               out_path: str) -> None:
    import torch.distributed as dist

    from zstd_tpu_torch.parallel import shard_compress, zstdmt

    grp = shard_compress.init_group(f"file://{store}", world, rank,
                                    device="cpu")
    try:
        results = {}
        for name, kind, kwargs in jobs:
            if kind == "frame":
                results[name] = zstdmt.compress_sharded(group=grp, **kwargs)
            else:
                out = shard_compress.compress_step(grp, **kwargs)
                results[name] = {k: v.numpy() for k, v in out.items()}
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_groups(worlds, workdir: str, jobs: list) -> dict:
    """Run `jobs` ([(name, "frame" | "step", kwargs)]: compress_sharded or
    compress_step keyword arguments, `group` left out) on one group of
    spawned gloo ranks per world size, all groups at once. Returns
    {world: {name: rank 0's result}}. Raises if a rank fails or the groups
    outlive JOIN_TIMEOUT."""
    os.makedirs(workdir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    outs, procs = {}, []
    for world in worlds:
        store = os.path.join(workdir, f"store{world}")
        outs[world] = os.path.join(workdir, f"results{world}.pkl")
        procs += [ctx.Process(target=_rank_main,
                              args=(r, world, store, jobs, outs[world]))
                  for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = [p.pid for p in procs if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} still run after "
                               f"{JOIN_TIMEOUT} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = {}
    for world, path in outs.items():
        with open(path, "rb") as f:
            results[world] = pickle.load(f)
    return results
