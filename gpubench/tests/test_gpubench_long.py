"""The long-distance cell, long27-l3.compress-long-16mib, on the CPU: the
cell run whole at a small size (512 KiB calls over a 128 KiB segment) on
the kernels' plain versions, the judge catching the control, the path
check, the corpus, the readers' spans and the roofline's bytes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import devtrace
import faults
import harness
import ldm_bytes
import roofline
from conftest import BENCH

CELL = "long27-l3.compress-long-16mib"
TINY = "long27-l3-tiny.tiny-compress-long"
SEGMENT = 128 * 1024
MIX = {"op": "compress_long", "call_bytes": 524288, "corpus_bytes": 524288,
       "corpora": 2, "trace_calls": 2}
TINY_CORPUS = f'''import os
import harness
_LONG = harness.module_of(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpora", "long-range")


def make(size, seed):
    return _LONG.make(size, seed, segment={SEGMENT})
'''
# a corpus in which the long matcher finds nothing to match
NO_REPEATS = '''import numpy as np


def make(size, seed):
    return np.random.default_rng(seed).bytes(size)
'''


@pytest.fixture
def long_bench(tiny_bench):
    """tiny_bench with the cell at 512 KiB calls: a config over a corpus of
    128 KiB segments, a mix, and the cell in the metrics of CELL."""
    bench, root = tiny_bench
    for name, text in (("long-range-tiny", TINY_CORPUS),
                       ("no-repeats", NO_REPEATS)):
        with open(os.path.join(bench, "corpora", name + ".py"), "w") as f:
            f.write(text)
    cfg = harness.config_of(bench, "long27-l3")
    for name, corpus in (("long27-l3-tiny", "long-range-tiny"),
                         ("long27-l3-flat", "no-repeats")):
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump(dict(cfg, name=name, corpus=corpus), f)
    with open(os.path.join(bench, "traffic", "tiny-compress-long.json"),
              "w") as f:
        json.dump(MIX, f)
    path = os.path.join(root, "BENCHMARK.json")
    spec = harness.load_json(path)
    for cfg_name in ("long27-l3-tiny", "long27-l3-flat"):
        cell = f"{cfg_name}.tiny-compress-long"
        spec["workloads"].append({"name": cell, "config": cfg_name,
                                  "traffic": "tiny-compress-long",
                                  "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if CELL in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(spec, f)
    return bench, root


def run(capsys, bench, root, cell, wrap=None, seed=2**31 + 9):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.5"], device="cpu", wrap=wrap,
                      bench_dir=bench, root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), out


def test_result_line(capsys, long_bench):
    res, out = run(capsys, *long_bench, TINY)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"call_p90_ms", "setup_s", "encode_mbps",
                                   "ratio"}
    assert res["metrics"]["ratio"]["value"] > 4
    path = next(line for line in out.splitlines()
                if line.startswith("long path over the warm-up"))
    moved = json.loads(path.split(": ", 1)[1])
    assert moved["calls"] == res["attempted"] + 2      # the two warm calls
    assert moved["long_matches"] > 0
    assert moved["ldm_fingerprint"] == moved["ldm_lookback"] == 0


def test_judge_catches_the_control(capsys, long_bench):
    ops = harness.module_of(long_bench[0], "ops", "compress_long")
    assert ops.control is faults.control
    res, _ = run(capsys, *long_bench, TINY, wrap=ops.control)
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] >= min(res["attempted"], 2)


def test_check_path_raises_without_long_matches(capsys, long_bench):
    with pytest.raises(harness.CellError, match="no long match"):
        harness.main(["--workload", "long27-l3-flat.tiny-compress-long",
                      "--seed", "5", "--seconds", "0.2"], device="cpu",
                     bench_dir=long_bench[0], root=long_bench[1])


def test_check_path_raises_where_the_card_ran_no_kernel(long_bench):
    """On the card each call launches both kernels; a call that ran the
    plain versions there is refused."""
    bench, _ = long_bench
    mod = harness.module_of(bench, "ops", "compress_long")
    cfg = harness.config_of(bench, "long27-l3-tiny")
    op = mod.Op(cfg, "cpu")
    op(harness.module_of(bench, "corpora", "long-range-tiny").make(
        MIX["call_bytes"], 3))
    op.check_path()                     # the CPU: no launch is right
    op._cuda = True
    with pytest.raises(harness.CellError, match="ldm_fingerprint launched 0"):
        op.check_path()


def test_readers_spans_are_where_the_program_calls():
    """Each reader's SPANS wraps a function that a call reaches, and the gap
    parse's block span holds the walk's."""
    from zstd_tpu_torch.parallel import ldm_sharded
    spec = harness.load_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    readers = harness.readers_of(spec, BENCH, CELL)
    assert sorted(readers) == ["device_idle_pct.compress",
                               "gap_parse_ms_per_mib",
                               "ldm_discover_ms_per_mib",
                               "ldm_roofline_pct", "ldm_walk_ms_per_mib"]
    targets = {}
    for mod in readers.values():
        targets.update(mod.SPANS)
    make = harness.module_of(BENCH, "corpora", "long-range").make
    data = make(MIX["call_bytes"], 11, segment=SEGMENT)
    with devtrace.Spans(targets, ranges=False) as spans:
        frame = ldm_sharded.compress_long_sharded(
            data, level=3, checksum=True, long_log=27, device="cpu")
    assert set(spans.seconds) == {"ldm_discover", "ldm_walk", "ldm_block",
                                  "ldm_device"}
    s = spans.seconds
    assert s["ldm_block"] > s["ldm_walk"] > 0
    assert s["ldm_discover"] > s["ldm_device"] > 0

    class View:
        kind, calls, in_bytes, frames = "cpu", 1, len(data), [frame]
        host_s, wall_s, device_s, busy_s = dict(s), 1.0, {}, 0.0
    assert readers["gap_parse_ms_per_mib"].read(View) == pytest.approx(
        (s["ldm_block"] - s["ldm_walk"]) * 1e3 * 2)
    assert readers["ldm_roofline_pct"].read(View) is None    # no card


def test_roofline_bytes(monkeypatch):
    """The input read once and 28 B an anchor kept, the anchors a call
    keeps from the program's counter; frames declare their content size."""
    from zstd_tpu_torch.parallel import ldm_sharded
    assert ldm_bytes.discovery_bytes(16 << 20, 141_562) \
        == (16 << 20) + 28 * 141_562
    reader = harness.reader_of(BENCH, "ldm_roofline_pct")
    monkeypatch.setattr(ldm_sharded, "COUNTS",
                        {"calls": 4, "anchors": 4 * 1000, "long_matches": 9})
    assert reader.anchors_per_call() == 1000
    from zstd_tpu_torch.format.frame import write_frame_header
    frame = write_frame_header(1 << 20, 24, True) + bytes(8)

    class View:
        kind, frames, device_s = "NVIDIA H100 80GB HBM3", [frame] * 2, {
            "ldm_device": 1e-3}
    want = 2 * ((1 << 20) + 28 * 1000)
    assert reader.read(View) == pytest.approx(
        roofline.share_pct(want, 1e-3, View.kind))
    monkeypatch.setattr(ldm_sharded, "COUNTS", {"calls": 4})
    assert reader.read(View) is None      # a program without the counter
    for n in (0, 200, 300, 70_000, 16 << 20, 1 << 33):
        assert ldm_bytes.content_size(write_frame_header(n, 24, True)) == n
    # a checksum, a window byte and no content size
    assert ldm_bytes.content_size(b"\x28\xb5\x2f\xfd\x04\x50") is None


def test_judge_catches_a_wrong_checksum(capsys, long_bench):
    """A frame that decodes to its input but whose content checksum is not
    its input's, or that carries none, is wrong."""
    def flip_checksum(call):
        return lambda data: (lambda f: f[:-4] + bytes(
            b ^ 0x5A for b in f[-4:]))(call(data))

    res, _ = run(capsys, *long_bench, TINY, wrap=flip_checksum)
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] == 0
    assert res["checks"]["bad_checksums"]["value"] >= min(res["attempted"], 2)
    ops = harness.module_of(long_bench[0], "ops", "compress_long")
    cfg = harness.config_of(long_bench[0], "long27-l3-tiny")
    data = harness.module_of(long_bench[0], "corpora",
                             "long-range-tiny").make(MIX["call_bytes"], 3)
    from zstd_tpu_torch.parallel import ldm_sharded
    frames = [ldm_sharded.compress_long_sharded(
        data, level=3, checksum=c, long_log=27, device="cpu")
        for c in (True, False)]
    kept = [(0, 0, 0, f, 0) for f in frames]
    checks = ops.judge(kept, [data], [data])
    assert checks["bad_checksums"]["value"] == 1       # the bare frame
    assert checks["wrong_calls"]["value"] == 0
    assert ops.judge(kept, [data], [data[:-1] + b"\0"])[
        "bad_checksums"]["value"] == 2
    with pytest.raises(harness.CellError, match="checksum"):
        ops.Op(dict(cfg, checksum=False), "cpu")


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4099])
def test_plain_xxh64(n):
    """The judge's XXH64 against the program's, and its published values."""
    import xxh64
    from zstd_tpu_torch import xxhash64
    data = np.random.default_rng(n).bytes(n)
    for seed in (0, 1, 2**63 + 5):
        assert xxh64.xxh64(data, seed) == xxhash64.xxh64(data, seed)
    assert xxh64.xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64.xxh64(b"abc") == 0x44BC2CF5AD770999


def test_long_range_corpus():
    """Copies a segment apart differ in at most 8 x 4 bytes each; the first
    is the silesia-like segment of the seed, mutated; the seed moves both."""
    import corpus
    make = harness.module_of(BENCH, "corpora", "long-range").make
    seed = 2**33 + 5
    a = np.frombuffer(make(5 * SEGMENT + 100, seed, segment=SEGMENT),
                      dtype=np.uint8)
    assert len(a) == 5 * SEGMENT + 100
    assert make(5 * SEGMENT + 100, seed, segment=SEGMENT) == a.tobytes()
    base = np.frombuffer(corpus.big_corpus(SEGMENT, seed=seed), np.uint8)
    assert 0 < np.count_nonzero(a[:SEGMENT] != base) <= 32
    for k in range(1, 5):
        diff = np.count_nonzero(a[k * SEGMENT:(k + 1) * SEGMENT]
                                != a[(k - 1) * SEGMENT:k * SEGMENT])
        assert 0 < diff <= 64
    b = make(5 * SEGMENT + 100, seed + 1, segment=SEGMENT)
    assert b != a.tobytes()
