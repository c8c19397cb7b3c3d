#!/usr/bin/env python3
"""Where a device encode's time goes, by the program's own spans
(zstd_tpu_torch/trace.py), on the card, for the benchmark's cells.

    python3 tools/torch_trace_spans.py [cell ...] [--runs 3] [--seed N]

Each cell (a name of BENCHMARK.json's workloads; all of them by default)
runs as gpubench/harness.py runs it: the same configuration, inputs from
the seed, torch on the configuration's host threads, each input warmed
once, then stretches of `trace_calls` whole calls. Without the profiler it
times the stretch --runs times with recording off and --runs times with it
on (off, on, on, off, ...): the recorder's cost, and from the recorded
calls the host's seconds by span and the share of the calls' wall that the
spans cover. Under torch.profiler it runs the stretch once with recording
on and once off: the device's idle time inside the program's ranges, the
idle gaps by innermost range, and the CUDA runtime calls of each
(instrumentation may add none). It also times a span site on this host's
CPU. Prints the card, the site's cost and one JSON line a cell.

The arithmetic is gpubench/progspans.py's, which the benchmark's own
readers of these spans will use; once they exist this tool goes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "gpubench")
SEED = 4190000001
RUNTIME = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cudaMemcpyAsync", "cudaEventSynchronize", "cudaStreamSynchronize",
           "cudaEventRecord")
STRETCH = "torch_trace_spans/stretch"


def site_cost_ns(reps: int = 1_000_000) -> dict:
    """ns a span site, as pipeline.py writes it, costs with recording off
    and with it on (in calls of 1,000 spans, the root's and the take's
    share included), over an empty loop, best of 5."""
    from zstd_tpu_torch import trace
    rec = trace.RECORDER

    def empty():
        for k in range(reps):
            pass

    def span():
        for k in range(reps):
            t = rec.on and rec.begin("plan", k)
            if t:
                rec.end(t)

    def span_on():
        with trace.recording():
            for _ in range(reps // 1000):
                with trace.GLOBAL_TRACER.span("compress"):
                    for k in range(1000):
                        t = rec.on and rec.begin("plan", k)
                        if t:
                            rec.end(t)
                trace.take_spans()

    def best(fn):
        out = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            fn()
            out.append(time.perf_counter_ns() - t0)
        return min(out) / reps

    assert not rec.on
    base = best(empty)
    return {"span_site_ns": best(span) - base,
            "span_site_on_ns": best(span_on) - base, "empty_loop_ns": base}


def stretch(call, pool, order, n):
    """(calls' (start, end) by the host's clock, the stretch's wall)."""
    import torch
    walls = []
    t_start = time.perf_counter()
    for k in range(n):
        t0 = time.perf_counter()
        call(pool[order[k % len(order)]])
        walls.append((t0, time.perf_counter()))
    torch.cuda.synchronize()
    return walls, time.perf_counter() - t_start


def profiled(call, pool, order, n, record: bool) -> dict:
    """One stretch under torch.profiler, reduced: runtime calls by name,
    device busy and idle, and progspans.idle_reading of the program's
    ranges (ns on the profiler's clock, given here in seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import devtrace
    import progspans
    from zstd_tpu_torch import trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(STRETCH):
            if record:
                with trace.recording():
                    stretch(call, pool, order, n)
            else:
                stretch(call, pool, order, n)
    trace.take_spans()
    prefix = progspans.RANGE_PREFIX
    device, ranges, runtime, images = [], [], {}, 0
    window = None
    for ev in prof.profiler.kineto_results.events():
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(prefix) or name == STRETCH:
                images += 1             # a range's device-side image
            else:
                device.append((s, e))
        elif name == STRETCH:
            window = (s, e)
        elif name.startswith(prefix):
            ranges.append((s, e, name[len(prefix):]))
        elif name.startswith("cu"):
            runtime[name] = runtime.get(name, 0) + 1
    busy = devtrace.union(device)
    idle = progspans.idle_intervals(busy, *window)
    out = {"record": record, "window_s": (window[1] - window[0]) / 1e9,
           "busy_s": devtrace.total(busy) / 1e9,
           "idle_s": devtrace.total(idle) / 1e9,
           "runtime_calls": {k: runtime.get(k, 0) for k in RUNTIME},
           "range_device_images": images, "ranges": len(ranges)}
    if ranges:
        got = progspans.idle_reading(idle, ranges, *window)
        got["idle_by_range"] = {k: v / 1e9
                                for k, v in got["idle_by_range"].items()}
        got["longest_gaps"] = [[k, g / 1e9] for k, g in got["longest_gaps"]]
        out.update(got)
    return out


def run_cell(cell_name: str, runs: int, seed: int, device) -> dict:
    import harness
    import progspans
    import torch

    from zstd_tpu_torch import trace
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.cell_of(spec, cell_name)
    config = harness.config_of(BENCH, cell["config"])
    traffic = harness.traffic_of(BENCH, cell["traffic"])
    call = harness.prepare(config, traffic, device)
    pool = harness.pool_of(config, traffic, seed)
    order = harness.order_of(len(pool), seed)
    n = traffic["trace_calls"]
    for idx in order:
        call(pool[idx])
    in_bytes = sum(len(pool[order[k % len(order)]]) for k in range(n))
    walls = {"off": [], "on": []}
    split = []
    for leg in ["off", "on", "on", "off"] * (runs // 2) + \
            ["off", "on"] * (runs % 2):
        if leg == "on":
            trace.take_spans()
            with trace.recording():
                calls, wall = stretch(call, pool, order, n)
            split.append(progspans.host_split(trace.take_spans(), calls,
                                              in_bytes))
        else:
            calls, wall = stretch(call, pool, order, n)
        walls[leg].append(wall)
    prof = [profiled(call, pool, order, n, True),
            profiled(call, pool, order, n, False)]
    return {"cell": cell_name, "seed": seed, "calls": n,
            "mib": in_bytes / 2**20, "stretch_wall_s": walls,
            "recording_cost": statistics.median(walls["on"])
            / statistics.median(walls["off"]) - 1,
            "host": split, "profiled": prof,
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*",
                    help="cells of BENCHMARK.json (default: all)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import harness
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = args.cells or [c["name"] for c in spec["workloads"]]
    threads, = {harness.config_of(BENCH, harness.cell_of(spec, c)["config"])
                ["host_threads"] for c in cells}
    os.environ["OMP_NUM_THREADS"] = str(threads)    # before torch loads
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(threads)
    from zstd_tpu_torch import _kernels
    print(harness.card_line(), flush=True)
    print(f"build: {_kernels.build_all():.1f} s", flush=True)
    print(json.dumps({"sites": site_cost_ns()}), flush=True)
    for cell in cells:
        print(json.dumps(run_cell(cell, args.runs, args.seed, "cuda")),
              flush=True)
    print(harness.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
