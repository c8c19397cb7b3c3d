"""The sharded cell, silesia-l1-t4.compress-sharded-64mib, on the CPU: the
cell run whole at a small size (512 KiB calls, one block a rank) over a
gloo world of 4 (rank 0 the harness's process, ranks 1-3 spawned by the
operation), the judge catching the control, the path check, the readers'
spans and the roofline's bytes, and a lost rank ending the run without a
process left behind."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import devtrace
import harness
import roofline
import shard_bytes
import shard_ranks
from conftest import BENCH, ROOT

CELL = "silesia-l1-t4.compress-sharded-64mib"
TINY = "silesia-l1-t4.tiny-compress-sharded"
MIX = {"op": "compress_sharded", "call_bytes": 524288,
       "corpus_bytes": 524288, "corpora": 2, "trace_calls": 2}
SEED = 2**31 + 9
# a lost rank has to end the run long before the group's timeout
DEADLINE_S = 90.0


@pytest.fixture
def sharded_bench(tiny_bench):
    """tiny_bench with the cell at 512 KiB calls: a mix, and the cell in
    the metrics of CELL."""
    bench, root = tiny_bench
    with open(os.path.join(bench, "traffic", "tiny-compress-sharded.json"),
              "w") as f:
        json.dump(MIX, f)
    path = os.path.join(root, "BENCHMARK.json")
    spec = harness.load_json(path)
    spec["workloads"].append({"name": TINY, "config": "silesia-l1-t4",
                              "traffic": "tiny-compress-sharded", "chips": 4,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    with open(path, "w") as f:
        json.dump(spec, f)
    return bench, root


def run(capsys, bench, root, wrap=None, seconds="1.5"):
    rc = harness.main(["--workload", TINY, "--seed", str(SEED),
                       "--seconds", seconds], device="cpu", wrap=wrap,
                      bench_dir=bench, root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), out


def path_line(out: str) -> dict:
    line = next(x for x in out.splitlines()
                if x.startswith("sharded path over the warm-up"))
    return json.loads(line.split(": ", 1)[1])


def test_result_line(capsys, sharded_bench):
    res, out = run(capsys, *sharded_bench)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"call_p90_ms", "setup_s", "encode_mbps",
                                   "ratio"}
    assert res["metrics"]["ratio"]["value"] > 2
    assert res["device"]["count"] == 4
    path = path_line(out)
    assert path["world"] == 4 and path["backend"] == "gloo"
    assert path["helper_exit_codes"] == [0, 0, 0]
    # every rank ran the two warm calls and the window's
    assert [r["calls"] for r in path["ranks"]] == [res["attempted"] + 2] * 4
    assert [r["xla_walk"] for r in path["ranks"]] == [0] * 4


def test_judge_catches_the_control(capsys, sharded_bench):
    """The control's input is not in the pool: rank 0 sends it to the
    helpers with the call, and the judge finds the changed byte."""
    ops = harness.module_of(sharded_bench[0], "ops", "compress_sharded")
    assert ops.control is harness.module_of(sharded_bench[0], "ops",
                                            "compress").control
    res, out = run(capsys, *sharded_bench, wrap=ops.control)
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] >= min(res["attempted"], 2)
    assert path_line(out)["helper_exit_codes"] == [0, 0, 0]


def _op(bench, **over):
    mod = harness.module_of(bench, "ops", "compress_sharded")
    cfg = dict(harness.config_of(bench, "silesia-l1-t4"), **over)
    return mod, mod.Op(cfg, "cpu")


def _pool(bench) -> list:
    return harness.pool_of(harness.config_of(bench, "silesia-l1-t4"), MIX,
                           SEED, bench)


def test_check_path_raises_where_a_helper_ran_fewer_calls(sharded_bench,
                                                          monkeypatch):
    """A call that ran on rank 0 alone is refused; the helpers stop all the
    same."""
    from zstd_tpu_torch.parallel import zstdmt
    bench, _ = sharded_bench
    _, op = _op(bench)
    pool = op.inputs(_pool(bench))
    for x in pool:
        op(x)
    monkeypatch.setitem(zstdmt.COUNTS, "calls", zstdmt.COUNTS["calls"] + 1)
    with pytest.raises(harness.CellError, match="rank 1 ran 2 calls of "
                       "compress_sharded, rank 0 3"):
        op.check_path()
    assert not any(p.is_alive() for p in op._ranks.procs)


def test_check_path_raises_where_a_helper_did_not_stop(sharded_bench,
                                                      monkeypatch):
    """A helper still running after STOP (killed: exit code None) fails the
    path check."""
    bench, _ = sharded_bench
    _, op = _op(bench)
    op(op.inputs(_pool(bench))[0])
    stop = op._ranks.stop
    monkeypatch.setattr(op._ranks, "stop", lambda: [None] + stop()[1:])
    with pytest.raises(harness.CellError, match=r"exited \[None, 0, 0\]"):
        op.check_path()


def test_refused_without_counts_or_xla(sharded_bench, monkeypatch):
    """A program whose zstdmt has no COUNTS, as before the cell, fails at
    once; so does a configuration that states another engine."""
    from zstd_tpu_torch.parallel import zstdmt
    bench, _ = sharded_bench
    with pytest.raises(harness.CellError, match="engine"):
        _op(bench, engine="pallas")
    monkeypatch.delattr(zstdmt, "COUNTS")
    with pytest.raises(harness.CellError, match="no COUNTS"):
        _op(bench)


def test_readers(sharded_bench):
    """Each reader's SPANS wraps a function that rank 0's call reaches (the
    accepted plan_ms_per_mib and finalize_ms_per_mib through the
    TorchCompressor that zstdmt builds); the host readers read their spans
    per MiB, the collectives their device time per MiB, the rooflines'
    bytes are rank 0's rows with their halos and the sequences, literals
    and payloads of its blocks (no reading on the CPU: no card, no
    peak)."""
    from zstd_tpu_torch.parallel import zstdmt
    bench, root = sharded_bench
    spec = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    readers = harness.readers_of(spec, bench, CELL)
    assert sorted(readers) == ["device_idle_pct.compress",
                               "exchange_ms_per_mib.sharded",
                               "finalize_ms_per_mib", "plan_ms_per_mib",
                               "stage_a_roofline_pct.sharded",
                               "stage_b_roofline_pct.sharded",
                               "stitch_ms_per_mib.sharded"]
    targets = {}
    for mod in readers.values():
        targets.update(mod.SPANS)
    _, op = _op(bench)
    pool = op.inputs(_pool(bench))
    before = dict(zstdmt.COUNTS)
    try:
        with devtrace.Spans(targets, ranges=False) as spans:
            frames = [op(x) for x in pool]
    finally:
        op.check_path()
    s = spans.seconds
    assert set(s) == {"halo_exchange", "gathers", "parts_gather", "plan",
                      "finalize", "stitch", "stage_a", "stage_b"}
    assert all(v > 0 for v in s.values())
    assert s["finalize"] < s["stitch"]
    moved = {k: zstdmt.COUNTS[k] - v for k, v in before.items()}
    assert moved["calls"] == 2 and moved["blocks"] == 2
    assert moved["halo_bytes"] == 2 * 65536
    mib = 2 * MIX["call_bytes"] / 2**20

    class View:
        kind, calls, in_bytes = "cpu", 2, 2 * MIX["call_bytes"]
        host_s, wall_s, busy_s = dict(s), 2.0, 0.5
        device_s = {"stage_a": 1e-3, "stage_b": 2e-3, "halo_exchange": 5e-4,
                    "gathers": 1e-3, "parts_gather": 2e-3}
    View.frames = frames
    got = {k: m.read(View) for k, m in readers.items()}
    assert got["exchange_ms_per_mib.sharded"] == pytest.approx(3.5 / mib)
    assert got["plan_ms_per_mib"] == pytest.approx(s["plan"] * 1e3 / mib)
    assert got["finalize_ms_per_mib"] == pytest.approx(
        s["finalize"] * 1e3 / mib)
    assert got["stitch_ms_per_mib.sharded"] == pytest.approx(
        s["stitch"] * 1e3 / mib)
    assert got["device_idle_pct.compress"] == pytest.approx(75.0)
    assert got["stage_a_roofline_pct.sharded"] is None      # no card
    assert got["stage_b_roofline_pct.sharded"] is None
    # rank 0's one block a call: 128 KiB and a 64 KiB halo read, its
    # sequences and literals handed on; stage B reads those and writes the
    # block's payload
    first = [roofline.blocks(f)[0] for f in frames]
    assert all(b[0] == 2 for b in first)
    handed = sum(roofline.SEQ_BYTES * b[3] + b[2] for b in first)
    want_a = 2 * (131072 + 65536) + handed
    want_b = handed + sum(b[1] for b in first)
    assert sum(shard_bytes.stage_a_bytes(f, 1, 65536) for f in frames) \
        == want_a
    assert sum(shard_bytes.stage_b_bytes(f, 1) for f in frames) == want_b
    assert shard_bytes.layout() == (zstdmt.COUNTS["blocks"]
                                    // zstdmt.COUNTS["calls"], 65536)
    View.kind = "NVIDIA H100 80GB HBM3"
    assert readers["stage_a_roofline_pct.sharded"].read(View) \
        == pytest.approx(roofline.share_pct(want_a, 1e-3, View.kind))
    assert readers["stage_b_roofline_pct.sharded"].read(View) \
        == pytest.approx(roofline.share_pct(want_b, 2e-3, View.kind))


def test_roofline_reads_nothing_without_counts(monkeypatch):
    """A program without zstdmt.COUNTS, or whose calls differ in blocks,
    gives no layout and neither roofline a reading; a frame without a
    content size gives no stage A bytes."""
    from zstd_tpu_torch.parallel import zstdmt

    class View:
        kind, frames = "NVIDIA H100 80GB HBM3", [b"frame"]
        device_s = {"stage_a": 1e-3, "stage_b": 1e-3}
    readers = [harness.reader_of(BENCH, f"stage_{x}_roofline_pct.sharded")
               for x in "ab"]
    monkeypatch.setattr(zstdmt, "COUNTS", {"calls": 4, "blocks": 512,
                                           "halo_bytes": 512 * 65536,
                                           "gathered_bytes": 0})
    assert shard_bytes.layout() == (128, 65536)
    monkeypatch.setitem(zstdmt.COUNTS, "blocks", 513)
    assert shard_bytes.layout() is None
    assert [r.read(View) for r in readers] == [None, None]
    monkeypatch.delattr(zstdmt, "COUNTS")
    assert shard_bytes.layout() is None
    assert [r.read(View) for r in readers] == [None, None]
    assert shard_bytes.stage_a_bytes(b"\x28\xb5\x2f\xfd\x04\x50", 1, 0) \
        is None


SCRIPT = '''import json, os, signal, sys, time
sys.path[:0] = [{bench_code!r}, {root_repo!r}]
import harness

KILL_AT = {kill_at}


def wrap(op):
    n = [0]
    print("pids " + json.dumps(op._ranks.pids), flush=True)

    def call(data):
        n[0] += 1
        if n[0] == KILL_AT:
            os.kill(op._ranks.pids[0], signal.SIGKILL)
        return op(data)
    return call


if __name__ == "__main__":
    sys.exit(harness.main(["--workload", {cell!r}, "--seed", "5",
                           "--seconds", "30"], device="cpu", wrap=wrap,
                          bench_dir={bench!r}, root={root!r}))
'''


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _gone(pids, within: float) -> bool:
    end = time.monotonic() + within
    while time.monotonic() < end:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


def _script(tmp_path, bench, root, kill_at: int):
    path = tmp_path / "lose_a_rank.py"
    path.write_text(SCRIPT.format(bench=bench, root=root, bench_code=BENCH,
                                  root_repo=ROOT,
                                  cell=TINY, kill_at=kill_at))
    return str(path)


def test_a_helper_lost_mid_window_ends_the_run(tmp_path, sharded_bench):
    """Rank 1 killed at the window's second call: the run exits nonzero at
    once, prints no result, and leaves no rank behind."""
    script = _script(tmp_path, *sharded_bench, kill_at=4)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=DEADLINE_S + 120)
    took = time.monotonic() - t0
    assert p.returncode == shard_ranks.EXIT_LOST, p.stderr[-2000:]
    assert "sharded ranks: rank 1 exited with code -9" in p.stderr
    assert '"correct"' not in p.stdout
    assert took < DEADLINE_S
    pids = json.loads(next(x for x in p.stdout.splitlines()
                           if x.startswith("pids "))[5:])
    assert _gone(pids, 10.0)


def test_rank_0_lost_ends_the_helpers(tmp_path, sharded_bench):
    """Rank 0 killed mid-window: every helper exits within seconds."""
    script = _script(tmp_path, *sharded_bench, kill_at=-1)
    p = subprocess.Popen([sys.executable, script], stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("pids "), line
        pids = json.loads(line[5:])
        time.sleep(8.0)                    # set-up, then into the window
        os.kill(p.pid, signal.SIGKILL)
        p.wait(30)
        assert _gone(pids, 20.0)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
