"""The spans and counters of the port's long path
(parallel.compress_long_sharded: zstd_tpu_torch.trace's Recorder and
ldm_sharded.COUNTS), on the CPU with the kernels' plain versions, on
long_corpus(512 KiB, seg=128 KiB) at level 3 and long_log 20: the span
tree, its cover of the call, the counts against a recount, and the frame
against zstd_tpu's at mesh 1 with recording on and off."""

from collections import Counter

import numpy as np
import pytest

from tests.longcorpus import long_corpus
from tests.refnative import reference_native
from zstd_tpu.parallel import ldm_sharded as jl
from zstd_tpu.parallel.shard_compress import make_mesh
from zstd_tpu_torch import trace
from zstd_tpu_torch.format import ldm as tldm
from zstd_tpu_torch.parallel import ldm_sharded as tl

DATA = long_corpus(512 * 1024, seg=128 * 1024)
KW = dict(level=3, checksum=True, long_log=20)
DISCOVERY = ["ldm_stage_in", "ldm_fingerprint", "ldm_lookback", "ldm_fetch"]
PER_BLOCK = ["ldm_walk", "gap_parse", "entropy"]
INNER = ("find_sequences_fast", "find_sequences_chainlazy",
         "find_sequences_opt")


def _moved(before: dict) -> dict:
    return {k: tl.COUNTS[k] - v for k, v in before.items()}


@pytest.fixture(scope="module")
def recorded():
    """One call with recording on: its frame and spans, what COUNTS moved
    by, each block's bounds and window as find_long_matches saw them, and
    the gaps the inner parser was handed (or the block's one C call
    parsed)."""
    blocks, gaps = [], []
    mp = pytest.MonkeyPatch()
    walk = tl.ShardedLdmState.find_long_matches

    def spy_walk(self, b, e):
        blocks.append((b, e, self.window_size))
        return walk(self, b, e)

    def spy_inner(fn):
        def run(full, gs, ge, *a, **k):
            if not gaps or gaps[-1] != (gs, ge):   # a declined parse's retry
                gaps.append((gs, ge))
            return fn(full, gs, ge, *a, **k)
        return run

    parse_block = tldm.GapTables.parse_block

    def spy_block(self, full, b, e, wl, reps, cparams, longs):
        """The gaps that the block's one C call parses: the non-empty
        stretches between its long matches."""
        gs = b
        for pos, ln, _ in [*longs, (e, 0, 0)]:
            if pos > gs:
                gaps.append((gs, pos))
            gs = pos + ln
        return parse_block(self, full, b, e, wl, reps, cparams, longs)

    mp.setattr(tl.ShardedLdmState, "find_long_matches", spy_walk)
    mp.setattr(tldm.GapTables, "parse_block", spy_block)
    for name in INNER:
        mp.setattr(tldm, name, spy_inner(getattr(tldm, name)))
    before = dict(tl.COUNTS)
    before_gaps = dict(tldm.COUNTS)
    trace.take_spans()
    try:
        with trace.recording():
            frame = tl.compress_long_sharded(DATA, device="cpu", **KW)
    finally:
        mp.undo()
    return dict(frame=frame, spans=trace.take_spans(), moved=_moved(before),
                gaps_moved={k: tldm.COUNTS[k] - v
                            for k, v in before_gaps.items()},
                blocks=blocks, gaps=gaps)


def test_span_tree(recorded):
    spans = recorded["spans"]
    names = [s.name for s in spans]
    assert names[0] == "compress_long" and spans[0].parent == -1
    assert len({s.call for s in spans}) == 1
    parent = {s.id: s.name for s in spans}
    kids = [s.name for s in spans if s.parent == 0]
    n = len(recorded["blocks"])
    assert n >= 4
    assert kids == ["ldm_discover"] + PER_BLOCK * n + ["checksum"]
    assert [s.name for s in spans if parent.get(s.parent) == "ldm_discover"] \
        == DISCOVERY
    assert Counter(names) == Counter(
        ["compress_long", "ldm_discover", *DISCOVERY, "checksum"]
        + PER_BLOCK * n)


def test_spans_nest_and_children_cover_the_root(recorded):
    spans = recorded["spans"]
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    root = spans[0]
    kids = [s for s in spans if s.parent == 0]
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    covered = sum(s.end_ns - s.start_ns for s in kids)
    assert covered >= 0.95 * (root.end_ns - root.start_ns)


def test_counts_equal_a_recount(recorded):
    """Anchors kept and long matches over every block, from a state built
    again; the long matches and the gaps the inner parser was handed cover
    the input; at level 3 one C call parsed each block's gaps
    (format/ldm.COUNTS)."""
    moved, blocks = recorded["moved"], recorded["blocks"]
    assert recorded["gaps_moved"] == {"c_blocks": len(blocks), "py_blocks": 0,
                                      "gaps": len(recorded["gaps"])}
    window = blocks[0][2]
    full = np.frombuffer(DATA, dtype=np.uint8)
    state = tl.ShardedLdmState(full, window.bit_length() - 1, device="cpu")
    matches = [m for b, e, _ in blocks for m in state.find_long_matches(b, e)]
    assert moved == {"calls": 1, "anchors": len(state.anchors),
                     "long_matches": len(matches)}
    assert sum(ln for _, ln, _ in matches) + sum(
        e - b for b, e in recorded["gaps"]) == len(DATA)
    assert moved["long_matches"] > 0 and moved["anchors"] > 0


def test_frames_equal_jax_with_recording_on_and_off(recorded):
    assert reference_native() is not None
    before = dict(tl.COUNTS)
    off = tl.compress_long_sharded(DATA, device="cpu", **KW)
    assert off == recorded["frame"]
    assert _moved(before) == recorded["moved"]
    assert off == jl.compress_long_sharded(DATA, mesh=make_mesh(1), **KW)


def test_span_sites_call_nothing_with_recording_off(monkeypatch, recorded):
    def refuse(*a, **k):
        raise AssertionError("a span site called the recorder")

    for name in ("begin", "begin_call", "end"):
        monkeypatch.setattr(trace.RECORDER, name, refuse)
    assert tl.compress_long_sharded(DATA, device="cpu", **KW) \
        == recorded["frame"]


def test_root_closes_when_a_call_raises(monkeypatch):
    """A call that raises inside the discovery still closes its root, so the
    next call's spans start a tree of their own."""
    def fail(*a, **k):
        raise RuntimeError("planted")

    trace.take_spans()
    with trace.recording():
        with monkeypatch.context() as m:
            m.setattr(tl, "lookback", fail)
            with pytest.raises(RuntimeError, match="planted"):
                tl.compress_long_sharded(DATA[:4096], device="cpu", **KW)
        tl.compress_long_sharded(DATA[:4096], device="cpu", **KW)
    spans = trace.take_spans()
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["compress_long"] * 2
    assert len({s.call for s in spans}) == 2
