"""Tracing hooks: the trace payload, the --trace CSV writer and the frame
progression counters.

Copy of TraceEvent, Tracer, GLOBAL_TRACER, FrameProgression,
GLOBAL_PROGRESSION and get_frame_progression in zstd_tpu/trace.py: zstd's
weak-symbol hooks ZSTD_trace_compress_begin/end (lib/common/zstd_trace.h:
127-146) with the ZSTD_Trace payload, the CLI's --trace CSV writer
(programs/zstdcli_trace.c:56), and ZSTD_getFrameProgression's live counters
(lib/compress/zstd_compress.c:1862), which --adapt reads. The CSV has
zstd_tpu's columns and rows, its Algorithm column included: both write the
same frames.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager

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
        """Begin/end hook pair; fill sizes on the returned record."""
        from . import __version__
        rec = TraceEvent(__version__, method, streaming, 0, 0, level,
                         window_log, 0)
        t0 = time.perf_counter_ns()
        try:
            yield rec
        finally:
            rec.duration_ns = time.perf_counter_ns() - t0
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
