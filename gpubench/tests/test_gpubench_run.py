"""Whole runs on the CPU (the kernels' plain versions, through harness.main
with device="cpu"): the result line, and the judge catching the control and
each planted fault. Then run.py as a command: without a card, and without
the program, it exits non-zero and prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

import faults
import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(capsys, bench, root, cell, wrap=None, seed=7, seconds="0.5"):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", seconds], device="cpu", wrap=wrap,
                      bench_dir=bench, root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


def test_result_line(capsys, tiny_bench):
    bench, root = tiny_bench
    res, err = run(capsys, bench, root, "silesia-l1.tiny-compress",
                   seed=2**31 + 9)
    assert list(res) == KEYS                 # the checks come last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"call_p90_ms", "setup_s", "encode_mbps",
                                   "ratio"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = err.strip().splitlines()[-2:]
    assert tail == [f"{k} {c['value']} limit {c['limit']}"
                    for k, c in res["checks"].items()]


@pytest.mark.parametrize("fault", ["control", *faults.FAULTS])
def test_judge_catches(capsys, tiny_bench, fault):
    bench, root = tiny_bench
    make = faults.control if fault == "control" else faults.FAULTS[fault]
    res, err = run(capsys, bench, root, "silesia-l1.tiny-compress",
                   wrap=make)
    assert res["correct"] is False
    # the judge keeps the first round of calls, one on each pool input
    assert res["checks"]["wrong_calls"]["value"] >= min(res["attempted"], 2)
    assert "wrong_calls" in err.strip().splitlines()[-2]


def test_sample_keeps_the_first_round_and_one_in_eight():
    keep = harness.sample_of(2**31 + 5, 16)
    assert all(keep(k) for k in range(16))
    share = sum(keep(k) for k in range(16, 40016)) / 40000
    assert abs(share - 1 / harness.KEEP_ONE_IN) < 0.01
    assert [keep(k) for k in range(16, 200)] == \
        [harness.sample_of(2**31 + 5, 16)(k) for k in range(16, 200)]


def test_a_call_that_raises_is_failed(capsys, tiny_bench):
    bench, root = tiny_bench
    calls = []

    def wrap(call):
        def flaky(arg):
            calls.append(1)
            if len(calls) > 2:             # after the two warm calls
                raise RuntimeError("planted")
            return call(arg)
        return flaky
    res, _ = run(capsys, bench, root, "silesia-l1.tiny-compress", wrap=wrap)
    assert res["correct"] is False
    assert res["failed"] == res["checks"]["failed_calls"]["value"] >= 1


def command(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "gpubench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_without_a_card_no_result():
    p = command(["--workload", "silesia-l1.compress-16mib", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(["--workload", "silesia-l1.compress-16mib", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_imports_hold_no_jax():
    """What run.py imports, the program's modules the harness drives, and
    every operation, corpus and metric reader: no top-level module named
    jax, jaxlib, flax or zstd_tpu (compared whole: zstd_tpu_torch is the
    program)."""
    code = f"""
import os, sys
sys.argv = ["run.py"]
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import runpy
runpy.run_path({os.path.join(BENCH, "run.py")!r}, run_name="not_main")
import harness, faults
import zstd_tpu_torch.pipeline, zstd_tpu_torch._kernels
import zstd_tpu_torch.device_decoder
for sub in ("metrics", "ops", "corpora"):
    for name in os.listdir(os.path.join({BENCH!r}, sub)):
        if name.endswith(".py"):
            harness.module_of({BENCH!r}, sub, name[:-3])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    names = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "zstd_tpu_torch" in names and "torch" in names
    assert not names & set(harness.FORBIDDEN)


# ---- the decode -------------------------------------------------------------

DECODE = "silesia-l1.tiny-decompress"


def test_decode_result_line(capsys, tiny_bench):
    bench, root = tiny_bench
    res, err = run(capsys, bench, root, DECODE, seed=2**31 + 9)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"call_p90_ms", "setup_s"}
    assert list(res["checks"]) == ["wrong_calls", "encoder_frames_refused",
                                   "failed_calls"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    tail = err.strip().splitlines()[-3:]
    assert tail == [f"{k} {c['value']} limit {c['limit']}"
                    for k, c in res["checks"].items()]


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_decode_judge_catches(capsys, tiny_bench, fault):
    """altered, the decode's control: the decoded answer with one byte
    changed; unchanged: the frame returned as it came."""
    bench, root = tiny_bench
    res, err = run(capsys, bench, root, DECODE, wrap=faults.FAULTS[fault])
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] >= min(res["attempted"], 2)
    assert res["checks"]["encoder_frames_refused"]["value"] == 0


def test_decode_call_that_raises_is_failed(capsys, tiny_bench):
    """half: the frame's first half, which the decoder refuses."""
    bench, root = tiny_bench
    calls = []

    def wrap(call):
        half = faults.half(call)

        def flaky(frame):
            calls.append(1)
            return call(frame) if len(calls) <= 2 else half(frame)
        return flaky
    res, _ = run(capsys, bench, root, DECODE, wrap=wrap)
    assert res["correct"] is False
    assert res["failed"] == res["checks"]["failed_calls"]["value"] >= 1


def test_decode_frame_the_reference_refuses(capsys, tiny_bench,
                                            monkeypatch):
    """A frame that the decoder decodes and the reference refuses fails the
    run, and the line names the encoder."""
    import refdecode

    def refuse(*args, **kwargs):
        raise refdecode.FormatError("planted")
    monkeypatch.setattr(refdecode, "decode_each", refuse)
    monkeypatch.setattr(refdecode, "decode", refuse)
    bench, root = tiny_bench
    res, err = run(capsys, bench, root, DECODE)
    assert res["correct"] is False
    assert res["checks"]["wrong_calls"]["value"] == 0
    assert res["checks"]["encoder_frames_refused"]["value"] == 2
    assert "encoder_frames_refused 2 limit 0" in err
    assert "the fault is the encoder's" in err


def test_decode_host_fallback_raises(capsys, tiny_bench, monkeypatch):
    """Frames over the device's literal-stream cap go to the host decoder:
    the run raises instead of timing the host decode."""
    from zstd_tpu_torch import device_decoder
    monkeypatch.setattr(device_decoder, "_STREAM_CAP", 16)
    bench, root = tiny_bench
    with pytest.raises(harness.CellError, match="host decoder"):
        harness.main(["--workload", DECODE, "--seed", "7", "--seconds",
                      "0.5"], device="cpu", bench_dir=bench, root=root)
    assert '"correct"' not in capsys.readouterr().out
