"""The helper ranks of a sharded operation (ops/compress_sharded.py): ranks
1 .. world - 1 of one process group, each a spawned daemonic process on a
card of its own (cuda:<rank>, NCCL), or on the CPU over gloo for the tests,
driven by rank 0, the benchmark's own process, which is the caller.

The group rendezvouses on a FileStore in a private temporary directory,
with a timeout (TIMEOUT_S) on the rendezvous and on every collective. Rank
0 broadcasts each order over the group (an int64 on the group's device):

  POOL, then the count and each input (its length, then its bytes): the
      pool, once, in set-up;
  a pool index, or SEND followed by an input's length and bytes (an input
      outside the pool, as a control's): then every rank calls
      zstdmt.compress_sharded on that input;
  REPORT: every rank's counts (calls of compress_sharded and launches of
      kernel xla_walk since it joined, its card's index, its peak device
      memory) all_gathered, in rank order;
  STOP: the helpers exit 0 (os._exit, without the group's teardown).

No rank outlives a run or hangs it. A thread of rank 0 waits on the
helpers' sentinels: where one exits before STOP, it kills the others and
ends rank 0 at once with EXIT_LOST. A thread of each helper waits on rank
0's sentinel and ends the helper where rank 0 is gone. A call that raises
on rank 0 leaves the ranks out of step, so it ends the run the same way. A
rank stuck in a collective whose peers live fails at the group's timeout.
Imports neither JAX nor zstd_tpu.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import traceback
from multiprocessing.connection import wait

import numpy as np
import torch
import torch.distributed as dist

from zstd_tpu_torch import _kernels
from zstd_tpu_torch.parallel import shard_compress, zstdmt

TIMEOUT_S = 600.0          # the rendezvous and any one collective
JOIN_S = 60.0              # the helpers' exit after STOP
EXIT_LOST = 1              # rank 0's exit code where a rank is lost
POOL, SEND, REPORT, STOP = -1, -2, -3, -4
REPORT_KEYS = ("calls", "xla_walk", "card", "memory_peak_bytes")


def _device(rank: int, cuda: bool):
    return torch.device("cuda", rank) if cuda else torch.device("cpu")


def _join(rank: int, world: int, store: str, cuda: bool):
    """This process as `rank` of the group at `store`; its ShardGroup."""
    device = _device(rank, cuda)
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(store, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return shard_compress.make_group(device)


def _order(grp, value: int) -> None:
    """Rank 0: broadcast one order."""
    dist.broadcast(torch.tensor([value], dtype=torch.int64,
                                device=grp.device), 0, group=grp.pg)


def _next(grp) -> int:
    """A helper: the next order from rank 0."""
    t = torch.zeros(1, dtype=torch.int64, device=grp.device)
    dist.broadcast(t, 0, group=grp.pg)
    return int(t.item())


def _put(grp, data: bytes) -> None:
    """Rank 0: broadcast `data`, its length first."""
    _order(grp, len(data))
    if data:
        buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        dist.broadcast(buf.to(grp.device), 0, group=grp.pg)


def _get(grp) -> bytes:
    """A helper: the bytes rank 0 broadcasts with _put."""
    n = _next(grp)
    buf = torch.empty(n, dtype=torch.uint8, device=grp.device)
    if n:
        dist.broadcast(buf, 0, group=grp.pg)
    return buf.cpu().numpy().tobytes()


def counts_row(grp, start: dict) -> list:
    """This rank's REPORT_KEYS since `start` (calls and launches)."""
    cuda = grp.device.type == "cuda"
    return [zstdmt.COUNTS["calls"] - start["calls"],
            _kernels.LAUNCHES["xla_walk"] - start["xla_walk"],
            grp.device.index if cuda else -1,
            torch.cuda.max_memory_allocated(grp.device) if cuda else 0]


def snapshot() -> dict:
    """This process's calls of compress_sharded and xla_walk launches."""
    return {"calls": zstdmt.COUNTS["calls"],
            "xla_walk": _kernels.LAUNCHES["xla_walk"]}


def _gather_counts(grp, row: list) -> list:
    t = torch.tensor([row], dtype=torch.int64, device=grp.device)
    return shard_compress.gather_rows(t, grp).cpu().tolist()


def _watch_parent(sentinel) -> None:
    wait([sentinel])
    os._exit(EXIT_LOST)


def _helper(rank: int, world: int, store: str, cuda: bool, threads: int,
            kwargs: dict) -> None:
    """A helper rank: join, then follow rank 0's orders until STOP."""
    try:
        torch.set_num_threads(threads)
        threading.Thread(target=_watch_parent, daemon=True, args=(
            multiprocessing.parent_process().sentinel,)).start()
        grp = _join(rank, world, store, cuda)
        start = snapshot()
        pool = []
        while True:
            order = _next(grp)
            if order == STOP:
                break
            if order == POOL:
                pool = [_get(grp) for _ in range(_next(grp))]
            elif order == REPORT:
                _gather_counts(grp, counts_row(grp, start))
            else:
                data = pool[order] if order >= 0 else _get(grp)
                zstdmt.compress_sharded(data, group=grp, **kwargs)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(EXIT_LOST)
    # out without the group's teardown: on four cards an NCCL helper's
    # destroy_process_group or exit outlived a minute after STOP
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Ranks:
    """Rank 0's side: starts the helpers at construction; join() makes this
    process rank 0 of the group (`group`)."""

    def __init__(self, world: int, device, threads: int, kwargs: dict):
        self.world = world
        self.cuda = device.type == "cuda"
        self.dir = tempfile.mkdtemp(prefix="gpubench-ranks-")
        self.store = os.path.join(self.dir, "store")
        self.group = None
        self.stopping = False
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_helper, name=f"rank {r}",
                                  args=(r, world, self.store, self.cuda,
                                        threads, kwargs), daemon=True)
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch, daemon=True).start()

    def join(self) -> None:
        self.group = _join(0, self.world, self.store, self.cuda)

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def _watch(self) -> None:
        left = {p.sentinel: p for p in self.procs}
        while left:
            for s in wait(list(left)):
                p = left.pop(s)
                if not self.stopping:
                    self.lost(f"{p.name} exited with code {p.exitcode}")

    def lost(self, why: str) -> None:
        """End the run: the ranks are out of step."""
        print(f"sharded ranks: {why}; the run ends", file=sys.stderr,
              flush=True)
        for p in self.procs:
            if p.is_alive():
                p.kill()
        os._exit(EXIT_LOST)

    def send_pool(self, pool: list) -> None:
        _order(self.group, POOL)
        _order(self.group, len(pool))
        for data in pool:
            _put(self.group, data)

    def order_call(self, index: int | None, data: bytes) -> None:
        """Every helper compresses pool[index], or `data` where index is
        None."""
        if index is None:
            _order(self.group, SEND)
            _put(self.group, data)
        else:
            _order(self.group, index)

    def report(self, row: list) -> list:
        """Every rank's counts (REPORT_KEYS), rank 0's `row` first."""
        _order(self.group, REPORT)
        return _gather_counts(self.group, row)

    def stop(self) -> list:
        """STOP the helpers, wait for them, leave the group. Returns their
        exit codes (None: still running JOIN_S after STOP, then killed)."""
        self.stopping = True
        _order(self.group, STOP)
        for p in self.procs:
            p.join(JOIN_S)
        codes = [p.exitcode for p in self.procs]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)
        return codes
