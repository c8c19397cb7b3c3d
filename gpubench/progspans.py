"""The reduction of the program's own spans: zstd_tpu_torch/trace.py's
recorder, which TorchCompressor.compress fills per batch (stage_in, stage_a,
stats_wait, plan, stage_b, fetch_wait, finalize, then assemble) under the
root `compress`, and which a profiled stretch sees as record_function
ranges named RANGE_PREFIX + span.

For the readers launch_ms_per_mib, host_wait_ms_per_mib and plan_idle_pct
(and their .page twins), which the harness does not run yet: they need
harness.traced to record and TraceView to carry the spans (PERF.md, open
questions). Until then tools/torch_trace_spans.py computes their values
with these functions on the card.

Plain arithmetic on numbers in any one unit; imports nothing of the program
or of torch.
"""

from __future__ import annotations

RANGE_PREFIX = "zstd_tpu_torch/"
OUTSIDE = "other host"       # the label of a stretch that no range covers


def segments(ranges) -> list:
    """(start, end, label) of the stretches between the ranges' edges, each
    named by the innermost range open over it (ranges of one thread nest);
    OUTSIDE between ranges."""
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    edges = sorted({t for s, e, _ in rs for t in (s, e)})
    stack, i, out = [], 0, []
    for a, b in zip(edges, edges[1:]):
        while i < len(rs) and rs[i][0] <= a:
            while stack and stack[-1][1] <= rs[i][0]:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        out.append((a, b, stack[-1][2] if stack else OUTSIDE))
    return out


def idle_intervals(busy, start, end) -> list:
    """(start, end) of the gaps between the sorted, merged busy intervals
    inside [start, end]; busy time outside it is ignored."""
    idle, at = [], start
    for s, e in list(busy) + [(end, end)]:
        if s > at and at < end:
            idle.append((at, min(s, end)))
        at = max(at, e)
    return idle


def idle_by_range(idle, ranges, start, end) -> tuple[dict, list]:
    """Idle time split by the innermost range over each part of it:
    ({label: idle time}, [(gap length, label) per gap]). A gap takes the
    label that holds most of it; idle time outside every range is OUTSIDE."""
    segs = segments(list(ranges) + [(start, end, OUTSIDE)])
    by_label, gaps, j = {}, [], 0
    for s, e in idle:
        parts = {}
        while segs[j][1] <= s:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < e:
            a, b, label = segs[i]
            d = min(b, e) - max(a, s)
            parts[label] = parts.get(label, 0) + d
            by_label[label] = by_label.get(label, 0) + d
            i += 1
        gaps.append((e - s, max(parts, key=parts.get)))
    return by_label, gaps


def idle_reading(idle, ranges, start, end) -> dict:
    """What the profiled stretch gives: the share of the idle time inside
    a program range, plan_idle_pct (idle time inside `plan` ranges as a
    share of the stretch's wall), idle time by innermost range (largest
    first) and the ten longest gaps [label, length]."""
    by_label, gaps = idle_by_range(idle, ranges, start, end)
    idle_t = sum(e - s for s, e in idle)
    return {"idle_in_program_share":
            1 - by_label.get(OUTSIDE, 0) / idle_t if idle_t else 0.0,
            "plan_idle_pct": 100.0 * by_label.get("plan", 0) / (end - start),
            "idle_by_range": dict(sorted(by_label.items(),
                                         key=lambda kv: -kv[1])),
            "longest_gaps": [[n, g] for g, n in sorted(gaps)[::-1][:10]]}


def host_split(spans, walls, in_bytes) -> dict:
    """From the spans of an unprofiled stretch (trace.take_spans(): name,
    start_ns, end_ns, parent, ...) and the callers' (start, end) walls in
    seconds: per call, the host's ms by span; the share of the callers'
    wall that the roots and their children cover; and in ms per MiB of
    input the spans that launch_ms_per_mib (stage_a + stage_b),
    host_wait_ms_per_mib (stats_wait + fetch_wait) and plan_ms_per_mib
    (plan) read."""
    roots = [s for s in spans if s.parent == -1]
    calls = len(roots)
    by = {}
    for s in spans:
        if s.parent != -1:
            by[s.name] = by.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    wall = sum(b - a for a, b in walls)
    root_s = sum(s.end_ns - s.start_ns for s in roots) / 1e9
    mib = in_bytes / 2**20
    return {"calls": calls,
            "call_ms": {k: v * 1e3 / calls for k, v in sorted(by.items())},
            "call_wall_ms": wall * 1e3 / calls,
            "root_share_of_call_wall": root_s / wall,
            "children_share_of_call_wall": sum(by.values()) / wall,
            "launch_ms_per_mib": (by.get("stage_a", 0) + by.get("stage_b", 0))
            * 1e3 / mib,
            "host_wait_ms_per_mib": (by.get("stats_wait", 0)
                                     + by.get("fetch_wait", 0)) * 1e3 / mib,
            "plan_ms_per_mib": by.get("plan", 0) * 1e3 / mib}
