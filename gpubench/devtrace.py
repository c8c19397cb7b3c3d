"""Spans around the program's functions, and the reduction of a
torch.profiler session to device busy time, device time by span and by
operation name, and idle gaps.

The interval arithmetic (busy time as the union of the device's kernel and
copy intervals; a session that records no device activity runs again) and
the wrapping of functions by attribute are copied from chip_smoke.py's
profile_run and timed_calls (see README.md for the origin commit). The
attribution of device time to a span is the benchmark's own: a device
interval belongs to the span that was open on the host when its launch (the
CUDA runtime call with the same correlation id) was made.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field

PREFIX = "gpubench/"
STRETCH = "stretch"          # the range around a whole profiled stretch


def resolve(module: str, attr: str):
    """(owner object, attribute name) of "Class.method" or "function" in
    `module`."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, name


class Spans:
    """While open, each call of a wrapped function adds its host wall time
    to `seconds[label]`, and runs inside a record_function range named
    PREFIX + label where `ranges` is true (for a profiled stretch).
    targets: {label: (module, attribute)}."""

    def __init__(self, targets: dict, ranges: bool = True):
        self.targets = targets
        self.ranges = ranges
        self.seconds: dict[str, float] = {}
        self.saved = []

    def __enter__(self):
        import torch
        for label, (module, attr) in self.targets.items():
            owner, name = resolve(module, attr)
            fn = getattr(owner, name)
            if isinstance(owner, type) and not callable(
                    owner.__dict__.get(name)):
                raise TypeError(f"{module}.{attr}: only functions and "
                                "plain methods can be wrapped")
            self.saved.append((owner, name, fn))

            def run(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    if not self.ranges:
                        return _fn(*args, **kwargs)
                    with torch.profiler.record_function(PREFIX + _label):
                        return _fn(*args, **kwargs)
                finally:
                    self.seconds[_label] = self.seconds.get(_label, 0.0) \
                        + time.perf_counter() - t0
            setattr(owner, name, run)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            if isinstance(owner, type):
                delattr(owner, name)
                if getattr(owner, name, None) is not fn:
                    setattr(owner, name, fn)
            else:
                setattr(owner, name, fn)
        self.saved = []


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


@dataclass
class Session:
    """One profiled stretch, in seconds on the profiler's clock."""
    wall_s: float
    start: float
    end: float
    device: list                     # (start, end, name) of device intervals
    ranges: list                     # (start, end, label) of the spans
    launches: dict                   # correlation id -> host launch time
    corr: list = field(default_factory=list)   # of each device interval

    @property
    def busy(self) -> list:
        return union((s, e) for s, e, _ in self.device)

    @property
    def busy_s(self) -> float:
        return total(self.busy)

    def by_name(self) -> dict:
        out: dict[str, float] = {}
        for s, e, name in self.device:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def _open(self, times) -> dict:
        """{label: per time, the start of the label's span open at it, or
        -inf}. A label's spans never overlap: calls are sequential."""
        import numpy as np
        t = np.asarray(times, np.float64)
        out = {}
        for label in {r[2] for r in self.ranges}:
            rs = sorted((s, e) for s, e, lab in self.ranges if lab == label)
            starts = np.array([r[0] for r in rs])
            ends = np.array([r[1] for r in rs])
            i = np.searchsorted(starts, t, side="right") - 1
            inside = (i >= 0) & (t <= ends[np.maximum(i, 0)])
            out[label] = np.where(inside, starts[np.maximum(i, 0)], -np.inf)
        return out

    def device_s_by_span(self) -> dict:
        """Device busy seconds of the work launched while each span was
        open on the host (an interval counts for every span open at its
        launch, so an outer span holds its inner spans' work too)."""
        import numpy as np
        known = [(d, self.launches[c]) for d, c in zip(self.device, self.corr)
                 if c in self.launches]
        if not known:
            return {}
        opened = self._open([t for _, t in known])
        return {label: total(union((d[0], d[1]) for (d, _), o
                                   in zip(known, np.isfinite(starts)) if o))
                for label, starts in opened.items()}

    def idle_gaps(self) -> list:
        """(label, seconds) of each gap between device intervals in the
        stretch, labelled by the innermost span open on the host at its
        middle ("other host" where none was)."""
        import numpy as np
        gaps = []
        at = self.start
        for s, e in self.busy + [[self.end, self.end]]:
            if s > at:
                gaps.append(((at + s) / 2, s - at))
            at = max(at, e)
        if not gaps:
            return []
        opened = self._open([m for m, _ in gaps])
        labels = list(opened)
        if not labels:
            return [("other host", g) for _, g in gaps]
        starts = np.stack([opened[k] for k in labels])
        best = starts.argmax(axis=0)
        return [(labels[b] if np.isfinite(starts[b, j]) else "other host", g)
                for j, (b, (_, g)) in enumerate(zip(best, gaps))]


def profile_calls(fn, retries: int = 6):
    """Run fn() under torch.profiler and reduce the session. A session that
    records no device activity runs fn() again in a new one, up to
    `retries` times; the count of such sessions is returned beside it.
    Returns (Session, empty sessions)."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    empty = 0
    for _ in range(retries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + STRETCH):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.profiler.kineto_results.events()
        device, corr, ranges, launches = [], [], [], {}
        stretch = None
        for ev in events:
            name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
            if ev.device_type() == DeviceType.CUDA:
                if name.startswith(PREFIX):   # a range's device-side image
                    continue
                device.append((s / 1e9, e / 1e9, name))
                corr.append(ev.correlation_id())
            elif name == PREFIX + STRETCH:
                stretch = (s / 1e9, e / 1e9)
            elif name.startswith(PREFIX):
                ranges.append((s / 1e9, e / 1e9, name[len(PREFIX):]))
            elif name.startswith("cu"):
                launches[ev.correlation_id()] = s / 1e9
        if device:
            break
        empty += 1
    if not device:
        raise RuntimeError(f"{empty} profiler sessions recorded no device "
                           "activity; device time not measured")
    if stretch is None:
        raise RuntimeError("the profiler lost the stretch's own range")
    return Session(wall_s=wall, start=stretch[0], end=stretch[1],
                   device=device, ranges=ranges, launches=launches,
                   corr=corr), empty
