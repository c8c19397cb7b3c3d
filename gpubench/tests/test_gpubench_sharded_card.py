"""On a host with four cards: the sharded cell's frames
(silesia-l1-t4.compress-sharded-64mib) byte for byte against a world of
one. Two 64 MiB inputs of the cell's corpus (two seeds) and a 1 MiB prefix
of the first are compressed by the cell's operation over four NCCL ranks,
one card each; then by compress_sharded in an NCCL group of one rank on
one card; the prefix also in a gloo group of one rank on the CPU (the
kernels' plain versions). The frames have to be equal, decode by the plain
reference, and their sha1 and ratio are printed.

    python -m pytest gpubench/tests/test_gpubench_sharded_card.py -q -m card -s
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import pytest
from conftest import BENCH, ROOT

import harness
import refdecode

CELL = "silesia-l1-t4.compress-sharded-64mib"
SEEDS = (2**31 + 4401, 2**33 + 4402)


def _world_of_one(inputs: list, device: str, kw: dict) -> list:
    """compress_sharded of each input in a group of one rank on `device`."""
    import torch.distributed as dist

    from zstd_tpu_torch.parallel import shard_compress, zstdmt
    with tempfile.TemporaryDirectory() as d:
        grp = shard_compress.init_group(f"file://{os.path.join(d, 's')}", 1,
                                        0, device=device)
        try:
            return [zstdmt.compress_sharded(x, group=grp, **kw)
                    for x in inputs]
        finally:
            dist.destroy_process_group()


@pytest.mark.card
def test_four_cards_equal_one(card):
    import torch
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards on one host")
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.cell_of(spec, CELL)
    config = harness.config_of(BENCH, cell["config"])
    traffic = harness.traffic_of(BENCH, cell["traffic"])
    make = harness.module_of(BENCH, "corpora", config["corpus"]).make
    big = [make(traffic["call_bytes"], seed=harness.draw(s, 1, 0))
           for s in SEEDS]
    prefix = big[0][:1 << 20]
    inputs = big + [prefix]

    op = harness.module_of(BENCH, "ops", "compress_sharded").Op(config,
                                                                "cuda")
    four = [op(x) for x in op.inputs(inputs)]
    op.check_path()
    kw = dict(level=config["level"], checksum=config["checksum"],
              overlap_log=config["overlap_log"])
    one = _world_of_one(inputs, "cuda:0", kw)
    cpu = _world_of_one([prefix], "cpu", kw)[0]
    for name, seed, x, a, b in zip(("64 MiB", "64 MiB", "1 MiB prefix"),
                                   (*SEEDS, SEEDS[0]), inputs, four, one):
        print(f"seed {seed} {name}: four cards sha1 "
              f"{hashlib.sha1(a).hexdigest()}, one card sha1 "
              f"{hashlib.sha1(b).hexdigest()}, {len(a)} B, ratio "
              f"{len(x) / len(a):.5f}", flush=True)
    print(f"1 MiB prefix on the CPU (gloo) sha1 "
          f"{hashlib.sha1(cpu).hexdigest()}", flush=True)
    assert four == one
    assert four[2] == cpu
    assert refdecode.verdicts(four, inputs) == [True] * len(inputs)
