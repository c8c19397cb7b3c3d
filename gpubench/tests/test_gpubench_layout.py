"""Every cell's configuration, traffic mix, operation, corpus and per-layer
readers are files found by their names, and a new one is picked up without
an edit."""

from __future__ import annotations

import json
import os

import pytest
from conftest import BENCH, ROOT

import harness

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.cell_of(SPEC, cell)
    config = harness.config_of(BENCH, c["config"])
    traffic = harness.traffic_of(BENCH, c["traffic"])
    assert config["name"] == c["config"]
    op = harness.module_of(BENCH, "ops", traffic["op"])
    for attr in ("Op", "frame_of", "end_to_end", "judge"):
        assert callable(getattr(op, attr)), attr
    assert callable(harness.module_of(BENCH, "corpora", config["corpus"]).make)
    readers = harness.readers_of(SPEC, BENCH, cell)
    assert readers, "every cell reports a per-layer metric"
    for name, mod in readers.items():
        assert callable(mod.read)
    e2e = {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2


def test_metrics_list_only_cells_that_exist():
    """A metric lists only cells of BENCHMARK.json, and a reader declares
    what BENCHMARK.json says of its metric."""
    cells = {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    for c in SPEC["workloads"]:
        harness.readers_of(SPEC, BENCH, c["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_moves_an_end_to_end_metric_of_its_cells(metric):
    """A per-layer metric moves an end-to-end metric that every cell it
    lists reports."""
    m = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    for cell in m.get("workloads", [c["name"] for c in SPEC["workloads"]]):
        e2e = {e["name"] for e in
               harness.metrics_of(SPEC, cell, "end_to_end")}
        assert m["moves"] in e2e, (metric, cell)


def test_every_file_is_read():
    """Each config, mix, operation, corpus and reader is used by a cell of
    BENCHMARK.json."""
    cells = SPEC["workloads"]
    configs = [harness.config_of(BENCH, c["config"]) for c in cells]
    mixes = [harness.traffic_of(BENCH, c["traffic"]) for c in cells]
    used = {("configs", c["config"]) for c in cells} | \
        {("traffic", c["traffic"]) for c in cells} | \
        {("metrics", m["name"]) for m in SPEC["per_layer"]} | \
        {("ops", t["op"]) for t in mixes} | \
        {("corpora", c["corpus"]) for c in configs}
    found = {(sub, f.rsplit(".", 1)[0])
             for sub in ("configs", "traffic", "metrics", "ops", "corpora")
             for f in os.listdir(os.path.join(BENCH, sub))
             if f.endswith((".json", ".py"))}
    assert found == used


def test_config_files_state_their_reductions():
    for cfg in SPEC["configs"]:
        data = json.load(open(os.path.join(ROOT, cfg["file"])))
        assert sorted(data["reduced"]) == sorted(cfg["reduced"])


def test_new_files_are_picked_up(tmp_path, tiny_bench):
    """A new config, mix and metric reader, each a new file, join a new
    cell that the harness runs without an edit of its code."""
    bench, root = tiny_bench
    with open(os.path.join(bench, "configs", "silesia-l1.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "silesia-l2"
    cfg["level"] = 2
    with open(os.path.join(bench, "configs", "silesia-l2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "metrics", "calls_traced.py"), "w") as f:
        f.write('LAYER = "entry point"\nUNIT = "calls"\nMOVES = "encode_mbps"\n'
                'SOURCE = "host_clock"\nSPANS = {}\n\n\n'
                'def read(t):\n    return float(t.calls)\n')
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "silesia-l2.tiny-compress",
                              "config": "silesia-l2",
                              "traffic": "tiny-compress", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry point", "moves": "encode_mbps",
                              "workloads": ["silesia-l2.tiny-compress"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    readers = harness.readers_of(spec, bench, "silesia-l2.tiny-compress")
    assert list(readers) == ["calls_traced"]
    assert harness.config_of(bench, "silesia-l2")["level"] == 2
    rc = harness.main(["--workload", "silesia-l2.tiny-compress", "--seed",
                       "3", "--seconds", "0.5"], device="cpu",
                      bench_dir=bench, root=root)
    assert rc == 0


def test_reader_that_disagrees_is_refused(tiny_bench):
    bench, root = tiny_bench
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["per_layer"][0]["unit"] = "s"
    with pytest.raises(harness.CellError):
        harness.readers_of(spec, bench, spec["per_layer"][0]["workloads"][0])


@pytest.mark.parametrize("sub,key", [("ops", "op"), ("corpora", "corpus")])
def test_unknown_op_or_corpus_names_its_file(capsys, tiny_bench, sub, key):
    """A mix whose operation, or a configuration whose corpus, has no file
    is refused with the file's name."""
    bench, root = tiny_bench
    where = "traffic" if key == "op" else "configs"
    name = "tiny-compress" if key == "op" else "silesia-l1"
    path = os.path.join(bench, where, name + ".json")
    with open(path) as f:
        data = json.load(f)
    data[key] = "no-such"
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(harness.CellError, match=f"{sub}/no-such.py"):
        harness.main(["--workload", "silesia-l1.tiny-compress", "--seed", "3",
                      "--seconds", "0.5"], device="cpu", bench_dir=bench,
                     root=root)


TOY_OP = '''"""A toy operation: the answer is the input reversed."""


class Op:
    def __init__(self, config, device):
        pass

    def inputs(self, pool):
        return pool

    def __call__(self, data):
        return data[::-1]

    def check_path(self):
        pass


def frame_of(data, answer):
    return answer


def end_to_end(in_bytes, out_bytes, wall_s):
    return {"toy_mbps": (in_bytes / 1e6 / wall_s, "MB/s")}


def judge(kept, inputs, pool):
    return {"wrong_calls": {"value": sum(out != pool[i][::-1]
                                         for i, _, _, out, _ in kept),
                            "limit": 0}}
'''


def test_a_new_operation_is_a_file(capsys, tiny_bench):
    """An operation and a corpus, each a new file, run in a new cell
    with no edit of the harness."""
    bench, root = tiny_bench
    with open(os.path.join(bench, "ops", "reverse.py"), "w") as f:
        f.write(TOY_OP)
    with open(os.path.join(bench, "corpora", "zeros.py"), "w") as f:
        f.write("def make(size, seed):\n    return bytes(size)\n")
    with open(os.path.join(bench, "traffic", "tiny-reverse.json"), "w") as f:
        json.dump({"op": "reverse", "call_bytes": 4096,
                   "corpus_bytes": 8192, "corpora": 1, "trace_calls": 2}, f)
    with open(os.path.join(bench, "configs", "silesia-l1.json")) as f:
        cfg = json.load(f)
    cfg.update(name="zeros", corpus="zeros")
    with open(os.path.join(bench, "configs", "zeros.json"), "w") as f:
        json.dump(cfg, f)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "zeros.tiny-reverse",
                              "config": "zeros", "traffic": "tiny-reverse",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "toy_mbps", "unit": "MB/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["zeros.tiny-reverse"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    rc = harness.main(["--workload", "zeros.tiny-reverse", "--seed", "3",
                       "--seconds", "0.2"], device="cpu", bench_dir=bench,
                      root=root)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"call_p90_ms", "setup_s", "toy_mbps"}
