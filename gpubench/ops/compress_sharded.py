"""The operation `compress_sharded`: parallel.zstdmt.compress_sharded (`zstd
-T#`, one frame written by `world` workers) as the configuration states it
(level, checksum, overlap_log, world), on a raw pool input, over one
process group of `world` ranks, one card a rank (NCCL; gloo on the CPU for
the tests). This process is rank 0 and the caller: the operation starts
ranks 1 .. world - 1 (shard_ranks.py), sends them the pool once in set-up,
and in each call orders them to compress the same input; rank 0's frame is
the answer. Its end-to-end metrics, its judge and its control are
ops/compress.py's: every frame has to decode to its input by the plain
reference (refdecode.py).

The window has to run the sharded path as the cell states it: over the
warm-up and the window, the group is `world` ranks over NCCL, each on its
own card (gloo on the CPU); zstdmt.COUNTS["calls"] moves on rank 0, and
kernel xla_walk launches once a call there (on the CPU, which only the
tests use, the plain version runs and it does not launch); and each helper
ran as many calls as rank 0. check_path gathers the ranks' counts, stops
the helpers and raises CellError otherwise. A program without
zstdmt.COUNTS cannot show that, and is refused at construction."""

from __future__ import annotations

import json
import os

import harness
import shard_ranks

_BASE = harness.module_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "compress")
frame_of, end_to_end, judge = _BASE.frame_of, _BASE.end_to_end, _BASE.judge
control = _BASE.control


class Op:
    def __init__(self, config: dict, device):
        import torch
        import torch.distributed as dist

        from zstd_tpu_torch import _kernels
        from zstd_tpu_torch.parallel import zstdmt
        if not hasattr(zstdmt, "COUNTS"):
            raise harness.CellError("zstdmt has no COUNTS: the cell's path "
                                    "check reads its calls")
        if config["engine"] != "xla":
            raise harness.CellError("compress_sharded runs the xla engine "
                                    "at every level: `engine` is \"xla\"")
        self._world = config["world"]
        if self._world < 2:
            raise harness.CellError("a sharded cell needs a world of 2 or "
                                    "more ranks")
        self._compress = zstdmt.compress_sharded
        self._dist = dist
        self._kw = dict(level=config["level"], checksum=config["checksum"],
                        overlap_log=config["overlap_log"])
        dev = torch.device(device)
        self._cuda = dev.type == "cuda"
        self._ranks = shard_ranks.Ranks(self._world, dev,
                                        config["host_threads"], self._kw)
        # built once here, while the helpers start, for every rank to load
        if self._cuda:
            _kernels.build_all()
        _kernels.build_host()
        self._ranks.join()
        self._group = self._ranks.group
        self._pool, self._index = [], {}
        self._start = shard_ranks.snapshot()

    def inputs(self, pool: list) -> list:
        self._ranks.send_pool(pool)
        self._pool = pool
        self._index = {id(x): i for i, x in enumerate(pool)}
        return pool

    def __call__(self, data: bytes) -> bytes:
        index = self._index.get(id(data))
        if index is not None and self._pool[index] is not data:
            index = None
        try:
            self._ranks.order_call(index, data)
            return self._compress(data, group=self._group, **self._kw)
        except Exception as e:
            self._ranks.lost(f"rank 0's call raised {e!r}")

    def check_path(self) -> None:
        grp = self._group
        backend = str(self._dist.get_backend(grp.pg))
        try:
            rows = self._ranks.report(shard_ranks.counts_row(grp,
                                                             self._start))
        finally:
            codes = self._ranks.stop()
        table = [dict(zip(shard_ranks.REPORT_KEYS, r)) for r in rows]
        print("sharded path over the warm-up and the window: " + json.dumps(
            {"world": grp.world, "backend": backend, "ranks": table,
             "helper_exit_codes": codes}), flush=True)
        want = "nccl" if self._cuda else "gloo"
        if grp.world != self._world or backend != want:
            raise harness.CellError(
                f"the group is {grp.world} ranks over {backend}; the cell "
                f"states {self._world} over {want}")
        if self._cuda and len({r["card"] for r in table}) != grp.world:
            raise harness.CellError("two ranks shared a card: "
                                    f"{[r['card'] for r in table]}")
        calls = table[0]["calls"]
        if not calls:
            raise harness.CellError("zstdmt.COUNTS['calls'] did not move on "
                                    "rank 0")
        for rank, r in enumerate(table[1:], 1):
            if r["calls"] != calls:
                raise harness.CellError(
                    f"rank {rank} ran {r['calls']} calls of compress_sharded,"
                    f" rank 0 {calls}")
        if table[0]["xla_walk"] != (calls if self._cuda else 0):
            raise harness.CellError(
                f"kernel xla_walk launched {table[0]['xla_walk']} times in "
                f"{calls} calls on rank 0: each call's stage A runs it once "
                "on the card, the plain version on the CPU")
        if any(c != 0 for c in codes):
            raise harness.CellError(
                f"the helpers exited {codes} after STOP (None: still running "
                f"{shard_ranks.JOIN_S:.0f} s after it, then killed)")
