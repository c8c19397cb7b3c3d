"""On a card: each cell's control (its operation's `control`) at the cell's
own size, on three seeds. Its wrong_calls is the upper reading of the limit
(PERF.md); the benchmark's own runs never run it.

    python -m pytest gpubench/tests/test_gpubench_card.py -q -m card -s
"""

from __future__ import annotations

import json
import os

import pytest
from conftest import BENCH, ROOT

import harness

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_control_fails_at_the_cells_size(card, capsys, cell):
    traffic = harness.traffic_of(BENCH, harness.cell_of(SPEC, cell)["traffic"])
    control = harness.module_of(BENCH, "ops", traffic["op"]).control
    readings = []
    for seed in SEEDS:
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", "5"], wrap=control)
        out, _ = capsys.readouterr()
        assert rc == 0
        res = json.loads(out.strip().splitlines()[-1])
        assert res["correct"] is False
        readings.append((res["checks"]["wrong_calls"]["value"],
                         res["attempted"]))
    with capsys.disabled():
        print(f"\ncontrol {cell}: wrong_calls, attempted by seed: "
              f"{readings}")
