"""The arithmetic of gpubench/progspans.py, which tools/torch_trace_spans.py
runs on the card, on hand-made spans and ranges: where a device encode's
idle time falls and how much of a call's wall the spans cover."""

import importlib.util
import os

import pytest

from zstd_tpu_torch.trace import RANGE_PREFIX, Span

_SPEC = importlib.util.spec_from_file_location(
    "progspans", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "gpubench", "progspans.py"))
ps = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ps)


def test_range_prefix_is_the_programs():
    assert ps.RANGE_PREFIX == RANGE_PREFIX


def test_segments_name_the_innermost_range():
    ranges = [(0, 100, "outside"), (10, 90, "compress"), (20, 40, "plan"),
              (40, 50, "stage_b"), (60, 70, "finalize")]
    assert ps.segments(ranges) == [
        (0, 10, "outside"), (10, 20, "compress"), (20, 40, "plan"),
        (40, 50, "stage_b"), (50, 60, "compress"), (60, 70, "finalize"),
        (70, 90, "compress"), (90, 100, "outside")]


def test_segments_of_back_to_back_calls():
    ranges = [(0, 30, "w"), (0, 10, "compress"), (5, 10, "plan"),
              (10, 20, "compress"), (10, 12, "stage_in")]
    assert ps.segments(ranges) == [
        (0, 5, "compress"), (5, 10, "plan"), (10, 12, "stage_in"),
        (12, 20, "compress"), (20, 30, "w")]


def test_idle_intervals_inside_the_window():
    busy = [[5, 10], [20, 30], [35, 50]]
    assert ps.idle_intervals(busy, 0, 40) == [(0, 5), (10, 20), (30, 35)]
    assert ps.idle_intervals([], 0, 40) == [(0, 40)]
    assert ps.idle_intervals([[0, 40]], 0, 40) == []
    # busy time that runs past the window's end leaves no gap after it
    assert ps.idle_intervals([[-5, 3], [30, 45], [50, 60]], 0, 40) == \
        [(3, 30)]


def test_idle_by_innermost_range_and_plan_idle_pct():
    """Two calls in a window of 100: a gap that spans plan and stage_b
    takes plan's name (it holds most of it); idle time between the calls
    falls outside every range."""
    ranges = [(0, 40, "compress"), (5, 25, "plan"), (25, 30, "stage_b"),
              (50, 90, "compress"), (58, 70, "plan")]
    busy = [[0, 5], [28, 45], [70, 100]]
    idle = ps.idle_intervals(busy, 0, 100)
    assert idle == [(5, 28), (45, 70)]
    by, gaps = ps.idle_by_range(idle, ranges, 0, 100)
    assert by == {"plan": 32, "stage_b": 3, ps.OUTSIDE: 5, "compress": 8}
    assert gaps == [(23, "plan"), (25, "plan")]
    got = ps.idle_reading(idle, ranges, 0, 100)
    assert got["idle_in_program_share"] == pytest.approx(1 - 5 / 48)
    assert got["plan_idle_pct"] == pytest.approx(32.0)
    assert list(got["idle_by_range"]) == ["plan", "compress", ps.OUTSIDE,
                                          "stage_b"]
    assert got["longest_gaps"] == [["plan", 25], ["plan", 23]]


def test_host_split_per_call_and_coverage():
    ms = 1_000_000
    spans = [Span("compress", 0, 10 * ms, 0, -1, 1, -1),
             Span("stage_a", 0, 2 * ms, 1, 0, 1, 0),
             Span("plan", 2 * ms, 9 * ms, 2, 0, 1, 0),
             Span("compress", 20 * ms, 30 * ms, 0, -1, 2, -1),
             Span("stage_b", 20 * ms, 24 * ms, 1, 0, 2, 0),
             Span("stats_wait", 24 * ms, 25 * ms, 2, 0, 2, 0)]
    walls = [(0.0, 0.0105), (0.020, 0.0305)]
    got = ps.host_split(spans, walls, 2**20)
    assert got["calls"] == 2
    assert got["call_ms"] == pytest.approx(
        {"plan": 3.5, "stage_a": 1.0, "stage_b": 2.0, "stats_wait": 0.5})
    assert got["call_wall_ms"] == pytest.approx(10.5)
    assert got["root_share_of_call_wall"] == pytest.approx(20 / 21)
    assert got["children_share_of_call_wall"] == pytest.approx(14 / 21)
    assert got["launch_ms_per_mib"] == pytest.approx(6.0)
    assert got["host_wait_ms_per_mib"] == pytest.approx(1.0)
    assert got["plan_ms_per_mib"] == pytest.approx(7.0)
