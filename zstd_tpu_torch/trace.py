"""Tracing hooks: the trace payload, the --trace CSV writer and the frame
progression counters.

Copy of TraceEvent, Tracer, GLOBAL_TRACER, FrameProgression,
GLOBAL_PROGRESSION and get_frame_progression in zstd_tpu/trace.py: zstd's
weak-symbol hooks ZSTD_trace_compress_begin/end (lib/common/zstd_trace.h:
127-146) with the ZSTD_Trace payload, the CLI's --trace CSV writer
(programs/zstdcli_trace.c:56), and ZSTD_getFrameProgression's live counters
(lib/compress/zstd_compress.c:1862), which --adapt reads. The CSV has
zstd_tpu's columns and rows, its Algorithm column included: both write the
same frames on the host codec. The port's device encode
(pipeline.TorchCompressor.compress) emits its event and advances the
progression too, which zstd_tpu's does not.

The port's own: the spans inside a call (`Recorder`, `recording`,
`take_spans`), which the device encode records per batch under the root
span that Tracer.span opens. Recording is off by default; a span site then
costs a test of `RECORDER.on` and one of its token.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

ALGORITHM = "zstd_tpu"


@dataclasses.dataclass
class TraceEvent:
    """ZSTD_Trace payload analog."""
    version: str
    method: str          # "compress" | "decompress"
    streaming: bool
    src_size: int
    dst_size: int
    level: int
    window_log: int
    duration_ns: int


class Tracer:
    """Process-wide trace sink; register callbacks or a CSV file."""

    def __init__(self) -> None:
        self._callbacks: list = []
        self._csv = None
        self._lock = threading.Lock()

    def register(self, cb) -> None:
        self._callbacks.append(cb)

    def unregister(self, cb) -> None:
        if cb in self._callbacks:
            self._callbacks.remove(cb)

    def open_csv(self, path: str) -> None:
        self._csv = open(path, "a")
        if self._csv.tell() == 0:
            self._csv.write("Algorithm,Version,Method,Mode,Level,Workers,"
                            "Dictionary Size,Uncompressed Size,"
                            "Compressed Size,Duration Nanos,Speed MB/s,"
                            "Ratio\n")

    def emit(self, ev: TraceEvent) -> None:
        with self._lock:
            for cb in self._callbacks:
                cb(ev)
            if self._csv:
                speed = (ev.src_size * 1000.0 / ev.duration_ns
                         if ev.duration_ns else 0.0)
                ratio = ev.src_size / ev.dst_size if ev.dst_size else 0.0
                self._csv.write(
                    f"{ALGORITHM},{ev.version},{ev.method},"
                    f"{'streaming' if ev.streaming else 'block'},"
                    f"{ev.level},0,0,{ev.src_size},{ev.dst_size},"
                    f"{ev.duration_ns},{speed:.2f},{ratio:.4f}\n")
                self._csv.flush()

    @contextmanager
    def span(self, method: str, level: int = 0, window_log: int = 0,
             streaming: bool = False):
        """Begin/end hook pair; fill sizes on the returned record. While
        recording is on, the pair is also the root span of the call, on
        the same two clock readings."""
        from . import __version__
        rec = TraceEvent(__version__, method, streaming, 0, 0, level,
                         window_log, 0)
        t0 = time.perf_counter_ns()
        root = RECORDER.on and RECORDER.begin_call(method, t0)
        try:
            yield rec
        finally:
            t1 = time.perf_counter_ns()
            if root:
                RECORDER.end(root, t1)
            rec.duration_ns = t1 - t0
            self.emit(rec)


GLOBAL_TRACER = Tracer()


@dataclasses.dataclass
class FrameProgression:
    """ZSTD_frameProgression analog: live counters for --adapt-style control."""
    ingested: int = 0
    consumed: int = 0
    produced: int = 0
    flushed: int = 0
    current_job: int = 0
    nb_active_workers: int = 0


GLOBAL_PROGRESSION = FrameProgression()


def get_frame_progression() -> FrameProgression:
    """ZSTD_getFrameProgression analog: live counters of the most recent /
    in-flight frame compression (ingested/consumed/produced/flushed)."""
    return GLOBAL_PROGRESSION


# ---- spans inside a call ----------------------------------------------------

RANGE_PREFIX = "zstd_tpu_torch/"
SPANS_PER_CALL = 1 << 14     # a 2 GiB device encode records 3,586


class Span(NamedTuple):
    """A finished span. `id` and `parent` index the spans of one call in
    the order they opened (the root is 0; its parent is -1); `call` is the
    call's id; `batch` is -1 where the span belongs to no batch. Times are
    time.perf_counter_ns()."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int
    batch: int


class _Call:
    """The spans of the call running in one thread."""
    __slots__ = ("id", "spans", "stack", "dropped")

    def __init__(self, call_id: int):
        self.id = call_id
        # [name, start, end, parent, batch, record_function range or None]
        self.spans: list[list] = []
        self.stack: list[int] = []    # indices of the open spans
        self.dropped = 0


def _profiling() -> bool:
    """Whether a torch.profiler session records this thread."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class Recorder:
    """Spans inside calls. Off by default: a span site then reads

        t = RECORDER.on and RECORDER.begin(name, batch)
        ...
        if t:
            RECORDER.end(t)

    and calls nothing. While on, Tracer.span opens a call's root span, and
    each begin()/end() pair inside it is a child of the innermost open span.
    When the root closes, the call's spans (the first SPANS_PER_CALL; the
    rest are counted in `dropped`) are kept until take_spans(). Outside a
    call nothing is kept. A span left open by an exception closes with its
    parent. While a torch.profiler session is active, each span is also a
    record_function range named RANGE_PREFIX + name, which the profiler
    puts on the clock of the device's intervals."""

    def __init__(self) -> None:
        self.on = False
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._last_call = 0
        self._spans: list[Span] = []

    def begin(self, name: str, batch: int = -1) -> int:
        """Open a span in this thread's running call; returns the token
        for end(), 0 where nothing is kept."""
        if not self.on:
            return 0
        call = getattr(self._local, "call", None)
        if call is None:
            return 0
        return self._open(call, name, batch, time.perf_counter_ns())

    def begin_call(self, name: str, start_ns: int) -> int:
        """Open the root span of a call (a child span where this thread
        already runs one); returns its token for end()."""
        if not self.on:
            return 0
        call = getattr(self._local, "call", None)
        if call is None:
            with self._lock:
                self._last_call += 1
                call = self._local.call = _Call(self._last_call)
        return self._open(call, name, -1, start_ns)

    def end(self, token: int, end_ns: int | None = None) -> None:
        """Close the span of `token` and any span still open inside it;
        closing the root keeps the call's spans."""
        if not token:
            return
        t = time.perf_counter_ns() if end_ns is None else end_ns
        call = self._local.call
        while True:
            i = call.stack.pop()
            span = call.spans[i]
            span[2] = t
            if span[5] is not None:
                span[5].__exit__(None, None, None)
                span[5] = None
            if i == token - 1:
                break
        if not call.stack:
            self._local.call = None
            with self._lock:
                self._spans += [Span(n, s, e, i, p, call.id, b)
                                for i, (n, s, e, p, b, _) in
                                enumerate(call.spans)]
                self.dropped += call.dropped

    def _open(self, call: _Call, name: str, batch: int, t: int) -> int:
        if len(call.spans) >= SPANS_PER_CALL:
            call.dropped += 1
            return 0
        rng = None
        if _profiling():
            import torch
            rng = torch.profiler.record_function(RANGE_PREFIX + name)
            rng.__enter__()
        call.spans.append([name, t, 0, call.stack[-1] if call.stack else -1,
                           batch, rng])
        call.stack.append(len(call.spans) - 1)
        return len(call.spans)

    def take_spans(self) -> list[Span]:
        with self._lock:
            out, self._spans = self._spans, []
        return out


RECORDER = Recorder()


@contextmanager
def recording():
    """Record the spans of the calls made within the block."""
    was = RECORDER.on
    RECORDER.on = True
    try:
        yield RECORDER
    finally:
        RECORDER.on = was


def take_spans() -> list[Span]:
    """The spans of the calls finished since the last take, and forget them."""
    return RECORDER.take_spans()
