"""The benchmark of zstd_tpu_torch: one run of one cell.

A cell of BENCHMARK.json joins a configuration (configs/<name>.json: the
level, the engine, the checksum flag, the corpus, the host's threads) and a
traffic mix (traffic/<name>.json: the operation, the call size, the pool of
distinct inputs, the traced stretch). The operation is ops/<op>.py, the
corpus corpora/<corpus>.py, and the per-layer metrics are read by the
readers in metrics/<name>.py. Everything is found by its name, so a new
configuration, mix, operation, corpus or metric is a new file.

A run makes its raw inputs from the seed (the pool), has the operation make
its call inputs from them, warms up on each, and then runs a closed loop,
one caller with back-to-back calls, until the window is over (--trace 0),
or times a stretch of whole calls by the host's clock and then profiles the
same calls again (--trace 1). Then the operation judges the answers with
the plain reference (refdecode.py), and no call may fail. Rates and the
readers' bytes count each call's raw pool input, whatever the operation.
The last line of standard output is the result, in JSON; the numbers
compared, each beside its limit, are also the last lines of standard error.

An operation module gives:
  Op(config, device): its inputs(pool), the call inputs made from the raw
      pool before the warm-up; the timed call, op(input) -> bytes; and
      check_path(), which raises CellError where the warm-up and the
      window did not run the path that the cell states;
  frame_of(input, answer): the zstd frame of a call, for the readers;
  end_to_end(in_bytes, out_bytes, wall_s): its own end-to-end metrics,
      {name: (value, unit)};
  judge(kept, inputs, pool): {name: {"value", "limit"}} over the kept
      answers, (pool index, start, end, answer, size) each.
  control: the wrapper of faults.py that plants the cell's control.
A corpus module gives make(size, seed) -> bytes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import platform
import statistics
import subprocess
import sys
import time

import numpy as np

import devtrace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "zstd_tpu")
# the share of a window's answers kept for the judge, past the first round
KEEP_ONE_IN = 8
READER_KEYS = {"LAYER": "layer", "UNIT": "unit", "MOVES": "moves",
               "SOURCE": "source"}


class CellError(Exception):
    """The cell cannot be run as BENCHMARK.json and its files state it."""


# ---- the files of a cell -----------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise CellError(f"no cell {name!r} in BENCHMARK.json")


def config_of(bench_dir: str, name: str) -> dict:
    return load_json(os.path.join(bench_dir, "configs", name + ".json"))


def traffic_of(bench_dir: str, name: str) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", name + ".json"))


def module_of(bench_dir: str, sub: str, name: str):
    """The module of <sub>/<name>.py, loaded by its path."""
    path = os.path.join(bench_dir, sub, name + ".py")
    if not os.path.isfile(path):
        raise CellError(f"no file {sub}/{name}.py in {bench_dir}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{sub}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_of(bench_dir: str, name: str):
    """The module of metrics/<name>.py."""
    return module_of(bench_dir, "metrics", name)


def metrics_of(spec: dict, cell: str, kind: str) -> list:
    """The cell's entries of `end_to_end` or `per_layer`: those whose
    `workloads` list it, or that list none."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def readers_of(spec: dict, bench_dir: str, cell: str) -> dict:
    """{metric name: reader} of the cell's per-layer metrics; each reader
    has to declare what BENCHMARK.json says of its metric."""
    out = {}
    for m in metrics_of(spec, cell, "per_layer"):
        mod = reader_of(bench_dir, m["name"])
        for attr, key in READER_KEYS.items():
            if getattr(mod, attr) != m[key]:
                raise CellError(f"metrics/{m['name']}.py declares {attr} "
                                f"{getattr(mod, attr)!r}, BENCHMARK.json "
                                f"{m[key]!r}")
        out[m["name"]] = mod
    return out


# ---- inputs ------------------------------------------------------------------

def draw(seed: int, *keys: int) -> int:
    """A whole number drawn from the run's seed and keys."""
    ss = np.random.SeedSequence([seed % (1 << 64), *keys])
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return lo | (hi << 32)


def pool_of(config: dict, traffic: dict, seed: int,
            bench_dir: str = BENCH_DIR) -> list:
    """The traffic's distinct raw inputs: `corpora` corpora of
    `corpus_bytes` each, cut into calls of `call_bytes`."""
    make = module_of(bench_dir, "corpora", config["corpus"]).make
    size, step = traffic["corpus_bytes"], traffic["call_bytes"]
    if size % step:
        raise CellError("corpus_bytes is not a multiple of call_bytes")
    pool = []
    for c in range(traffic["corpora"]):
        data = make(size, seed=draw(seed, 1, c))
        pool += [data[i:i + step] for i in range(0, size, step)]
    return pool


def order_of(n: int, seed: int) -> list:
    """The order in which the calls take the pool's inputs, round after
    round: one permutation drawn from the seed."""
    return np.random.default_rng(draw(seed, 2)).permutation(n).tolist()


# ---- the window -------------------------------------------------------------

def run_calls(call, args, order, stop, keep=lambda k: True) -> list:
    """Back-to-back calls, one caller, taking the call inputs (one for each
    pool input) in `order` round after round, until stop(number made, time
    after the last) is true. Returns per call (pool index, start, end,
    output, its size): the output is the exception of a call that raised,
    and None where keep(k) is false for the k-th call (the answer is
    dropped at once, as a user would consume it)."""
    recs = []
    k = 0
    while True:
        idx = order[k % len(order)]
        t0 = time.perf_counter()
        try:
            out = call(args[idx])
            size = len(out)
        except Exception as e:        # a failed call is counted and judged
            out, size = e, 0
        t1 = time.perf_counter()
        recs.append((idx, t0, t1, out if size == 0 or keep(k) else None,
                     size))
        out = None
        k += 1
        if stop(len(recs), t1):
            return recs


def sample_of(seed: int, first: int):
    """keep(k) of the window's calls whose answers are judged: the first
    round (one call on each pool input) and one call in KEEP_ONE_IN after
    it, drawn from the seed."""
    mask = np.random.default_rng(draw(seed, 3)).random(1 << 16) \
        < 1.0 / KEEP_ONE_IN
    return lambda k: k < first or bool(mask[k % len(mask)])


# ---- judging ---------------------------------------------------------------------

def judge(mod, recs: list, inputs: list, pool: list) -> dict:
    """The numbers compared, each with its limit: the operation's, over the
    kept answers, and the calls that raised (failed)."""
    failed = sum(isinstance(r[3], Exception) for r in recs)
    kept = [r for r in recs if isinstance(r[3], bytes)]
    print(f"judge: {len(kept)} of {len(recs)} answers kept", flush=True)
    return {**mod.judge(kept, inputs, pool),
            "failed_calls": {"value": failed, "limit": 0}}


# ---- the end-to-end metrics --------------------------------------------------------

def end_to_end(mod, recs: list, pool: list, t_start: float,
               setup_s: float) -> dict:
    """The end-to-end metrics of the window, {name: {value, unit}}, from
    every call of `recs`: the harness's and the operation's; the window ran
    from t_start to the last call's end."""
    ok = [r for r in recs if not isinstance(r[3], Exception)]
    wall = recs[-1][2] - t_start
    lat = [(r[2] - r[1]) * 1e3 for r in recs]
    in_bytes = sum(len(pool[r[0]]) for r in ok)
    out_bytes = sum(r[4] for r in ok)
    m = {"call_p90_ms": (float(np.percentile(lat, 90)), "ms"),
         "setup_s": (setup_s, "s"),
         **mod.end_to_end(in_bytes, out_bytes, wall)}
    print(f"window: {len(recs)} calls in {wall:.6f} s; call latency median "
          f"{statistics.median(lat):.4f} ms, p90 over {len(lat)} calls",
          flush=True)
    tenths = [[] for _ in range(10)]
    for (_, t0, *_), ms in zip(recs, lat):
        tenths[min(int(10 * (t0 - t_start) / wall), 9)].append(ms)
    print("window: median call ms by tenth of the window: " + " ".join(
        f"{statistics.median(x):.1f}" if x else "-" for x in tenths),
        flush=True)
    return {k: {"value": v, "unit": u} for k, (v, u) in m.items()}


# ---- the traced stretch ----------------------------------------------------------

class TraceView:
    """What a per-layer reader reads: the traced stretch's calls, bytes and
    frames; the host's seconds by span and its wall, timed without the
    profiler; the device's seconds by span and its busy seconds, from the
    profiled run of the same calls."""

    def __init__(self, kind, recs, pool, frames, host_s, wall_s, session):
        ok = [r for r in recs if not isinstance(r[3], Exception)]
        self.kind = kind
        self.calls = len(recs)
        self.in_bytes = sum(len(pool[r[0]]) for r in ok)
        self.frames = frames
        self.host_s = dict(host_s)
        self.wall_s = wall_s
        self.device_s = session.device_s_by_span()
        self.busy_s = session.busy_s


def traced(kind, traffic, readers, call, inputs, pool, frame_of, order):
    """`trace_calls` whole calls with the readers' spans, twice: timed by
    the host's clock alone, then the same calls under the profiler, whose
    own cost would slow the host's part. Returns (the profiled calls,
    per-layer metrics, extra result keys)."""
    import torch
    from zstd_tpu_torch import _kernels
    targets = {}
    for mod in readers.values():
        targets.update(mod.SPANS)
    n = traffic["trace_calls"]
    with devtrace.Spans(targets, ranges=False) as spans:
        launches0 = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        run_calls(call, inputs, order, lambda k, t: k >= n)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _kernels.LAUNCHES.items()
                    if v != launches0[k]}
    host_s = dict(spans.seconds)
    box = {}
    with devtrace.Spans(targets) as spans:
        def stretch():
            spans.seconds.clear()            # a rerun session counts once
            box["recs"] = run_calls(call, inputs, order,
                                    lambda k, t: k >= n)
        session, empty = devtrace.profile_calls(stretch)
    recs = box["recs"]
    print(f"traced stretch: {n} calls in {wall_s:.6f} s by the host's clock, "
          f"{session.wall_s:.6f} s under the profiler; host s by span "
          f"{json.dumps(host_s)}, under the profiler "
          f"{json.dumps(spans.seconds)}", flush=True)
    frames = [frame_of(inputs[r[0]], r[3]) for r in recs
              if not isinstance(r[3], Exception)]
    view = TraceView(kind, recs, pool, frames, host_s, wall_s, session)
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(view)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    if empty:
        print(f"profiler: {empty} session(s) recorded no device activity "
              "and ran again", flush=True)
    matched = sum(c in session.launches for c in session.corr)
    print(f"profiler: {len(session.device)} device intervals, {matched} "
          f"matched to their launch; device s by span "
          f"{json.dumps(view.device_s)}", flush=True)
    mib = view.in_bytes / 2**20
    print("launches per MiB: " + json.dumps(
        {k: v / mib for k, v in launches.items()}), flush=True)
    return recs, metrics, {"device": {"busy_s": session.busy_s,
                                      "window_s": session.wall_s},
                           "breakdown": breakdown(session)}


def breakdown(session) -> dict:
    ops = sorted(session.by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(session.idle_gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def host_line() -> str:
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip().lower()
                if key in ("model name", "hardware", "cpu model"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return (f"host: {model or platform.processor() or 'model not given'} "
            f"({platform.machine()}), {os.cpu_count()} CPUs")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    return "card: " + out.replace("\n", "; ")


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


# ---- one run -----------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, wrap=None, bench_dir: str = BENCH_DIR,
         root: str = ROOT) -> int:
    """One run of one cell. `device` None is the card (a run without enough
    cards exits 2 and prints no result); "cpu" runs the kernels' plain
    versions and serves the tests. `wrap`, for the tests, takes the timed
    call and returns the call the window drives."""
    t_top = time.perf_counter() - process_age()     # the process's start
    args = parse_args(argv)
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = cell_of(spec, args.workload)
    config = config_of(bench_dir, cell["config"])
    traffic = traffic_of(bench_dir, cell["traffic"])
    readers = readers_of(spec, bench_dir, cell["name"]) if args.trace else {}

    # the host's threads for torch's intra-op work, as the configuration
    # states them (before torch is loaded, for its OpenMP pool)
    threads = config["host_threads"]
    os.environ["OMP_NUM_THREADS"] = str(threads)
    import torch
    import zstd_tpu_torch  # noqa: F401  (a checkout without it fails here)
    torch.set_num_threads(threads)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        kind = torch.cuda.get_device_name(0)
    else:
        kind = str(device)

    mod = module_of(bench_dir, "ops", traffic["op"])
    op = mod.Op(config, device)
    pool = pool_of(config, traffic, args.seed, bench_dir)
    inputs = op.inputs(pool)
    call = op if wrap is None else wrap(op)
    order = order_of(len(pool), args.seed)
    for idx in order:                           # warm-up: each input once
        call(inputs[idx])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()

    t_start = time.perf_counter()
    if args.trace:
        recs, metrics, extra = traced(kind, traffic, readers, call, inputs,
                                      pool, mod.frame_of, order)
    else:
        cpu0 = time.process_time()
        recs = run_calls(call, inputs, order,
                         lambda k, t: t - t_start >= args.seconds,
                         sample_of(args.seed, len(order)))
        print(f"window: process CPU {time.process_time() - cpu0:.3f} s",
              flush=True)
        metrics = end_to_end(mod, recs, pool, t_start, t_start - t_top)
        wanted = {m["name"] for m in
                  metrics_of(spec, cell["name"], "end_to_end")}
        metrics = {k: v for k, v in metrics.items() if k in wanted}
        extra = {"device": {}}
    op.check_path()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"memory_peak_bytes: {peak}", flush=True)
    del call, op
    if cuda:
        torch.cuda.empty_cache()

    print(host_line(), flush=True)
    if cuda:
        print(card_line(), flush=True)
    t_ref = time.perf_counter()
    checks = judge(mod, recs, inputs, pool)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", flush=True)
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        print(f"modules that no run may load: {', '.join(held)}",
              file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = checks["failed_calls"]["value"]
    result = {"correct": correct, "attempted": len(recs), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else str(device),
                         "kind": kind, "count": cell["chips"],
                         "memory_peak_bytes": peak, **extra.pop("device")},
              **extra, "checks": checks}
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
