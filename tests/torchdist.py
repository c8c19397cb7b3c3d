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
    import numpy as np
    import torch
    import torch.distributed as dist

    from zstd_tpu_torch.parallel import (ldm_sharded, multihost,
                                         shard_compress, zstdmt)

    # one thread a rank: the ranks share the host with each other and with
    # the test workers
    torch.set_num_threads(1)
    grp = shard_compress.init_group(f"file://{store}", world, rank,
                                    device="cpu")
    try:
        results = {}
        for name, kind, kwargs in jobs:
            if kind == "frame":
                results[name] = zstdmt.compress_sharded(group=grp, **kwargs)
            elif kind == "ldm":
                results[name] = _ldm_job(ldm_sharded, grp, **kwargs)
            elif kind == "long":
                frame = ldm_sharded.compress_long_sharded(group=grp, **kwargs)
                every = shard_compress.gather_bytes(
                    np.frombuffer(frame, np.uint8), grp)
                if any(f.tobytes() != frame for f in every):
                    raise AssertionError(f"{name}: the ranks' frames differ")
                results[name] = frame
            elif kind == "traced":
                results[name] = _traced_job(zstdmt, shard_compress, grp,
                                            **kwargs)
            elif kind == "shard":
                # index and count from the initialised default group
                mine = multihost.compress_my_shard(**kwargs)
                results[name] = multihost.gather_and_concat(mine, grp)
            elif kind == "gather":
                if multihost.init_distributed() != (rank, world):
                    raise AssertionError(f"{name}: init_distributed")
                mine = kwargs["shards"][rank]
                got = multihost.gather_and_concat(mine, grp)
                if (got is None) != (rank != 0):
                    raise AssertionError(f"{name}: rank {rank} got {got!r}")
                results[name] = got
            else:
                out = shard_compress.compress_step(grp, **kwargs)
                results[name] = {k: v.numpy() for k, v in out.items()}
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _ldm_job(ldm_sharded, grp, data: bytes, window_log: int,
             block_size: int = 128 * 1024) -> dict:
    """ShardedLdmState of `data` over the group: its anchors and candidates,
    and find_long_matches of every block of `block_size` bytes."""
    import numpy as np
    full = np.frombuffer(data, dtype=np.uint8)
    st = ldm_sharded.ShardedLdmState(full, window_log, group=grp)
    n = len(full)
    return dict(anchors=st.anchors, cands=st.cands,
                matches=[st.find_long_matches(b0, min(b0 + block_size, n))
                         for b0 in range(0, n, block_size)])


# the functions compress_sharded calls through zstdmt's globals, and how
# often a call: the ring; stage A; the gathers of the stats and of the
# parts' sizes; stage B and its pack; the parts' gather; rank 0's stitch
PHASES = {"halo_rows": 1, "analyze_sharded": 1, "gather_rows": 2,
          "_pack_sharded": 1, "_pack": 1, "gather_padded": 1, "stitch": 1}


def _traced_job(zstdmt, shard_compress, grp, data: bytes, **kwargs) -> list:
    """compress_sharded of `data` with recording off, then on, then with
    every phase function of PHASES wrapped in the module: each rank's
    frames of the three calls, the spans of the first (none) and of the
    recorded one, what COUNTS moved by in it, the wrapped functions' calls
    and the bytes of the parts gathered. Returns every rank's, in rank
    order."""
    import pickle

    import numpy as np

    from zstd_tpu_torch import trace
    trace.take_spans()
    off = zstdmt.compress_sharded(data, group=grp, **kwargs)
    off_spans = trace.take_spans()
    before = dict(zstdmt.COUNTS)
    with trace.recording():
        on = zstdmt.compress_sharded(data, group=grp, **kwargs)
    spans = [tuple(s) for s in trace.take_spans()]
    moved = {k: zstdmt.COUNTS[k] - v for k, v in before.items()}
    calls, saved, part_bytes = {}, {}, []
    for name in PHASES:
        fn = saved[name] = getattr(zstdmt, name)

        def run(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            out = _fn(*a, **k)
            if _name == "gather_padded":
                part_bytes.append(sum(out[1]))
            return out
        setattr(zstdmt, name, run)
    try:
        wrapped = zstdmt.compress_sharded(data, group=grp, **kwargs)
    finally:
        for name, fn in saved.items():
            setattr(zstdmt, name, fn)
    mine = dict(rank=grp.rank, frames=(off, on, wrapped), spans=spans,
                off_spans=off_spans,
                moved=moved, calls=calls, part_bytes=part_bytes)
    every = shard_compress.gather_bytes(
        np.frombuffer(pickle.dumps(mine), np.uint8), grp)
    return [pickle.loads(b.tobytes()) for b in every]


def run_groups(worlds, workdir: str, jobs: list) -> dict:
    """Run `jobs` ([(name, kind, kwargs)]) on one group of spawned gloo
    ranks per world size, all groups at once. Kinds: "frame"
    (compress_sharded), "step" (compress_step), "long"
    (ldm_sharded.compress_long_sharded; every rank's frame must be rank
    0's), each with its keyword arguments, `group` left out; "ldm"
    (`_ldm_job`); "gather" (multihost.gather_and_concat of
    kwargs["shards"][rank]; rank 0 must get the list, the others None, and
    init_distributed() must return (rank, world)); "shard"
    (multihost.compress_my_shard with the group's rank and world; rank
    0's result is every rank's shard in rank order); "traced"
    (`_traced_job`: compress_sharded's frames, spans, COUNTS and phase
    calls on every rank).
    Returns {world: {name: rank 0's result}}. Raises if a rank fails or the
    groups outlive JOIN_TIMEOUT."""
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
