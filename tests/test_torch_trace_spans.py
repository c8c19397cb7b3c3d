"""The spans, trace event and frame progression of the device encode (zstd_tpu_torch.trace's Recorder inside pipeline.TorchCompressor),
on the CPU with the kernels' plain versions.

Every call compresses four blocks in batches of one, so the batch window of
three and its tail both run.
"""

import csv
import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

import zstd_tpu_torch
from zstd_tpu_torch import cli as tcli
from zstd_tpu_torch import pipeline, trace
from zstd_tpu_torch.params import get_cparams

from tests.conftest import gen_text

BLOCK = 131072


def _data() -> bytes:
    """Four blocks: a repeated random stretch; text, then zeros; random
    bytes that end in a copy of their last KB (stage B packs the block,
    and the frame stores it raw: it saves less than the minimal gain); and
    a short one of random bytes (which stage B does not pack)."""
    rng = np.random.default_rng(1)
    text = gen_text(60000, seed=1)
    noise = rng.bytes(BLOCK - 1024)
    return (rng.bytes(8192) * 16 + text + bytes(BLOCK - len(text))
            + noise + noise[-1024:] + rng.bytes(60000))


DATA = _data()
NB = -(-len(DATA) // BLOCK)

# (name, batch) in the order the batch window opens them: stage A of batch k,
# then the plan and stage B of batch k - 2, then the fetch and finalize of
# batch k - 3; the tail plans the last two batches and finishes the last three
ORDER = [("compress", -1),
         ("stage_in", 0), ("stage_a", 0),
         ("stage_in", 1), ("stage_a", 1),
         ("stage_in", 2), ("stage_a", 2),
         ("stats_wait", 0), ("plan", 0), ("stage_b", 0),
         ("stage_in", 3), ("stage_a", 3),
         ("stats_wait", 1), ("plan", 1), ("stage_b", 1),
         ("fetch_wait", 0), ("finalize", 0),
         ("stats_wait", 2), ("plan", 2), ("stage_b", 2),
         ("stats_wait", 3), ("plan", 3), ("stage_b", 3),
         ("fetch_wait", 1), ("finalize", 1),
         ("fetch_wait", 2), ("finalize", 2),
         ("fetch_wait", 3), ("finalize", 3),
         ("assemble", -1)]


def _compressor():
    return pipeline.TorchCompressor(level=1, device="cpu", batch_blocks=1)


@functools.lru_cache(maxsize=1)
def _frame_off() -> bytes:
    return _compressor().compress(DATA)


@pytest.fixture
def recorded():
    """(frame, spans) of one call made while recording."""
    trace.take_spans()
    with trace.recording():
        frame = _compressor().compress(DATA)
    return frame, trace.take_spans()


def test_span_tree_follows_the_window(recorded):
    frame, spans = recorded
    assert NB == 4 and frame == _frame_off()
    assert [(s.name, s.batch) for s in spans] == ORDER
    assert [s.id for s in spans] == list(range(len(ORDER)))
    assert spans[0].parent == -1
    assert all(s.parent == 0 for s in spans[1:])
    assert len({s.call for s in spans}) == 1


def test_spans_nest_and_siblings_do_not_overlap(recorded):
    _, spans = recorded
    root = spans[0]
    for s in spans[1:]:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
        assert s.call == root.call
    children = sorted(spans[1:], key=lambda s: s.start_ns)
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns, (a, b)


def test_recording_off_keeps_nothing():
    assert not trace.RECORDER.on
    trace.take_spans()
    frame = _compressor().compress(DATA)
    assert trace.take_spans() == []
    assert frame == _frame_off()


def test_span_sites_call_nothing_with_recording_off(monkeypatch):
    """Off, a span site tests the flag and calls neither begin nor end."""
    def refuse(*a, **k):
        raise AssertionError("a span site called the recorder")

    monkeypatch.setattr(trace.RECORDER, "begin", refuse)
    monkeypatch.setattr(trace.RECORDER, "end", refuse)
    assert _compressor().compress(DATA) == _frame_off()


def test_frames_identical_with_recording_on_and_off(recorded):
    frame, _ = recorded
    assert frame == _frame_off()
    assert zstd_tpu_torch.decompress(frame) == DATA


@pytest.mark.parametrize("record", (True, False), ids=("on", "off"))
def test_profiler_ranges_are_the_spans(record):
    """Under torch.profiler each span is one range named zstd_tpu_torch/<name>,
    in the same order; with recording off there is none."""
    from torch.profiler import ProfilerActivity, profile
    trace.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if record:
            with trace.recording():
                frame = _compressor().compress(DATA)
        else:
            frame = _compressor().compress(DATA)
    assert frame == _frame_off()
    ranges = sorted((ev.start_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(trace.RANGE_PREFIX))
    spans = trace.take_spans()
    assert [n for _, n in ranges] == \
        [trace.RANGE_PREFIX + s.name for s in spans]
    assert len(ranges) == (len(ORDER) if record else 0)


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with trace.recording():
        _compressor().compress(DATA)
    assert len(trace.take_spans()) == len(ORDER) and opened == []


def test_refetch_runs_inside_fetch_wait(monkeypatch):
    """Batch 0's estimate patched to 0 and the fetch step to one byte: its
    prefix holds the sizes header alone, so _fetch_regions fetches the
    streams again, synchronously, inside the span fetch_wait of batch 0."""
    plans_of = pipeline.TorchCompressor._build_plans
    batches = []

    def low(self, stats, lens, *a, **k):
        out = plans_of(self, stats, lens, *a, **k)
        rec = out[0][0]
        rec[:, pipeline._R_EST] = 0 if not batches else lens + 16
        batches.append(len(rec))
        return out

    fetches = []
    cpu = torch.Tensor.cpu

    def timed_cpu(self, *a, **k):
        t0 = time.perf_counter_ns()
        out = cpu(self, *a, **k)
        fetches.append((t0, time.perf_counter_ns(), self.numel()))
        return out

    monkeypatch.setattr(pipeline, "FETCH_STEP", 1)
    monkeypatch.setattr(pipeline.TorchCompressor, "_build_plans", low)
    monkeypatch.setattr(torch.Tensor, "cpu", timed_cpu)
    trace.take_spans()
    with trace.recording():
        frame = _compressor().compress(DATA)
    monkeypatch.undo()
    spans = trace.take_spans()
    assert frame == _frame_off()
    wait = {s.batch: s for s in spans if s.name == "fetch_wait"}
    inside = [f for f in fetches
              if wait[0].start_ns <= f[0] and f[1] <= wait[0].end_ns]
    assert len(inside) == 1
    assert inside[0][2] > 7 * 4          # more than the sizes header
    assert not [f for f in fetches for k in (1, 2, 3)
                if wait[k].start_ns <= f[0] <= wait[k].end_ns]


def test_progression_advances_and_never_decreases(monkeypatch):
    """GLOBAL_PROGRESSION, read at each planning and assembly step of the
    call: no counter goes back, ingested and consumed reach the input's
    size batch by batch, and produced and flushed end at the frame's."""
    prog = trace.GLOBAL_PROGRESSION
    seen = []
    for name in ("_build_plans", "_finalize", "_fetch_regions"):
        orig = getattr(pipeline.TorchCompressor, name)

        def snap(self, *a, _orig=orig, **k):
            seen.append(dataclasses.astuple(prog)[:4])
            out = _orig(self, *a, **k)
            seen.append(dataclasses.astuple(prog)[:4])
            return out
        monkeypatch.setattr(pipeline.TorchCompressor, name, snap)
    frame = _compressor().compress(DATA)
    seen.append(dataclasses.astuple(prog)[:4])
    for a, b in zip(seen, seen[1:]):
        assert all(x <= y for x, y in zip(a, b)), (a, b)
    assert seen[-1] == (len(DATA), len(DATA), len(frame), len(frame))
    assert any(0 < s[1] < len(DATA) for s in seen)       # consumed by batch
    assert any(0 < s[2] < len(frame) and s[3] == 0 for s in seen)


def test_resident_call_leaves_the_progression_alone():
    """compress_resident writes no frame: the progression keeps the last
    frame's counters."""
    prog = trace.GLOBAL_PROGRESSION
    frame = _compressor().compress(DATA)
    before = dataclasses.astuple(prog)[:4]
    assert before == (len(DATA), len(DATA), len(frame), len(frame))
    assert _compressor().compress_resident(DATA) > 0
    assert dataclasses.astuple(prog)[:4] == before


def test_one_trace_event_per_frame():
    events = []
    trace.GLOBAL_TRACER.register(events.append)
    try:
        frame = pipeline.compress(DATA[:50000], level=2, device="cpu")
    finally:
        trace.GLOBAL_TRACER.unregister(events.append)
    assert len(events) == 1
    ev = events[0]
    assert (ev.method, ev.level, ev.src_size, ev.dst_size, ev.streaming) == \
        ("compress", 2, 50000, len(frame), False)
    assert ev.window_log == get_cparams(2, 50000).window_log
    assert ev.duration_ns > 0


def test_cli_engine_gpu_trace_writes_its_row(tmp_path, monkeypatch):
    """zstd --engine gpu --trace f.csv: one row for the device encode."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.bin").write_bytes(DATA[:50000])
    try:
        rc = tcli.main(["--engine", "gpu", "--trace", "t.csv", "-q", "-1",
                        "-o", "s.zst", "s.bin"], device="cpu")
    finally:
        tracer = trace.GLOBAL_TRACER
        if tracer._csv is not None:
            tracer._csv.close()
            tracer._csv = None
    assert rc == 0
    rows = list(csv.reader(open("t.csv")))
    assert len(rows) == 2, rows
    row = dict(zip(rows[0], rows[1]))
    assert (row["Method"], row["Level"], row["Uncompressed Size"],
            row["Compressed Size"]) == \
        ("compress", "1", "50000", str(os.path.getsize("s.zst")))


def test_span_left_open_closes_with_its_call():
    """A span that an exception leaves open closes at its root's end, and
    the call's spans are kept."""
    rec = trace.RECORDER
    trace.take_spans()
    with trace.recording(), pytest.raises(KeyError):
        with trace.GLOBAL_TRACER.span("compress"):
            rec.begin("plan", 0)
            raise KeyError
    root, plan = trace.take_spans()
    assert (plan.name, plan.parent, plan.end_ns) == ("plan", 0, root.end_ns)
    assert getattr(rec._local, "call", None) is None


def test_spans_past_the_bound_are_dropped(monkeypatch):
    monkeypatch.setattr(trace, "SPANS_PER_CALL", 3)
    rec = trace.RECORDER
    trace.take_spans()
    dropped = rec.dropped
    with trace.recording():
        with trace.GLOBAL_TRACER.span("compress"):
            for k in range(4):
                rec.end(rec.begin("plan", k))
    assert [s.batch for s in trace.take_spans()] == [-1, 0, 1]
    assert rec.dropped == dropped + 2
