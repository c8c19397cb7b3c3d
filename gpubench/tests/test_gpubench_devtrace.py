"""The reduction of a profiled stretch, on synthetic intervals, and the
spans' wrappers."""

from __future__ import annotations

import types

import pytest

import devtrace


def session():
    return devtrace.Session(
        wall_s=1.0, start=0.0, end=1.0,
        device=[(0.1, 0.2, "k1"), (0.15, 0.3, "k2"), (0.5, 0.6, "k3"),
                (0.7, 0.75, "k4")],
        ranges=[(0.0, 0.4, "outer"), (0.05, 0.1, "inner"),
                (0.45, 0.9, "outer"), (0.46, 0.8, "plan")],
        launches={1: 0.06, 2: 0.2, 3: 0.47, 4: 0.95}, corr=[1, 2, 3, 4])


def test_busy_is_the_union():
    s = session()
    assert s.busy == [[0.1, 0.3], [0.5, 0.6], [0.7, 0.75]]
    assert s.busy_s == pytest.approx(0.35)
    assert s.by_name()["k2"] == pytest.approx(0.15)


def test_device_time_by_span_counts_every_open_span():
    got = session().device_s_by_span()
    assert got["inner"] == pytest.approx(0.1)
    assert got["outer"] == pytest.approx(0.3)      # k1, k2 and k3
    assert got["plan"] == pytest.approx(0.1)


def test_idle_gaps_take_the_innermost_span():
    got = session().idle_gaps()
    assert [g[0] for g in got] == ["inner", "outer", "plan", "outer"]
    assert sum(g[1] for g in got) == pytest.approx(1.0 - 0.35)
    bare = session()
    bare.ranges = []
    assert {g[0] for g in bare.idle_gaps()} == {"other host"}


class Owner:
    def method(self, x):
        return x + 1


@pytest.mark.parametrize("ranges", [True, False])
def test_spans_wrap_and_restore(ranges):
    mod = types.ModuleType("gpubench_test_owner")
    mod.Owner = Owner
    mod.fn = lambda x: 2 * x
    import sys
    sys.modules[mod.__name__] = mod
    try:
        before = Owner.__dict__["method"], mod.fn
        with devtrace.Spans({"m": (mod.__name__, "Owner.method"),
                             "f": (mod.__name__, "fn")},
                            ranges=ranges) as spans:
            assert Owner().method(1) == 2 and mod.fn(3) == 6
        assert set(spans.seconds) == {"m", "f"}
        assert (Owner.__dict__["method"], mod.fn) == before
    finally:
        del sys.modules[mod.__name__]
