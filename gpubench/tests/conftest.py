"""Shared fixtures of the benchmark's tests.

    python -m pytest gpubench/tests -q             # on the CPU
    python -m pytest gpubench/tests -q -m card -s  # on a machine with a card

Tests marked `card` need a CUDA card; the `card` fixture decides at run
time whether there is one and skips without it.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' own "
                    "size on the card")
    return "cuda"


# tiny mixes for the CPU, one for each operation: a call of 128 KiB, a
# pool of two
TINY = {f"tiny-{op}": {"op": op, "call_bytes": 131072,
                       "corpus_bytes": 262144, "corpora": 1,
                       "trace_calls": 2}
        for op in ("compress", "decompress")}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's files in tmp_path with a tiny cell for each
    operation added as a new traffic file (and its lines in BENCHMARK.json:
    a tiny cell joins the metrics of the cells of its operation). Returns
    (bench_dir, root)."""
    root = tmp_path
    bench = root / "gpubench"
    for sub in ("configs", "traffic", "metrics", "ops", "corpora"):
        shutil.copytree(os.path.join(BENCH, sub), bench / sub)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    op_of = {c["name"]: json.loads((bench / "traffic" /
                                    f"{c['traffic']}.json").read_text())["op"]
             for c in spec["workloads"]}
    for name, mix in TINY.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        cell = f"silesia-l1.{name}"
        spec["workloads"].append({"name": cell, "config": "silesia-l1",
                                  "traffic": name, "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(op_of.get(c) == mix["op"] for c in m.get("workloads", ())):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(bench), str(root)
