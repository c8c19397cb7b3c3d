"""zstd_tpu_torch stands alone: it imports neither JAX nor zstd_tpu."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from zstd_tpu_torch import pipeline

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "zstd_tpu_torch"


def test_import_leaves_out_jax_and_zstd_tpu():
    modules = sorted(
        "zstd_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in ['zstd_tpu_torch'] + {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'zstd_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for m in ("pipeline", "parallel.shard_compress", "parallel.zstdmt",
              "parallel.ldm_sharded", "parallel.multihost", "parallel.pzstd",
              "native", "ops.ldm", "format.ldm", "format.opt",
              "format.frame", "format.lazy", "format.split", "format.block",
              "format.codec"):
        assert f"zstd_tpu_torch.{m}" in modules


def test_sources_name_neither_jax_nor_zstd_tpu():
    pattern = re.compile(r"zstd_tpu\.|^\s*(import|from)\s+jax\b", re.M)
    sources = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_host_c_is_whole_and_reads_no_environment():
    """The host library builds every csrc/host/*.c, and no copied C reads
    the environment (the reference's knobs are constants)."""
    from zstd_tpu_torch import _kernels
    host = sorted(p.name for p in (PORT / "csrc" / "host").glob("*.c"))
    assert [s.split("/")[1] for s in _kernels.HOST_SOURCES] == host
    for name in host:
        text = (PORT / "csrc" / "host" / name).read_text()
        assert "getenv" not in text, name


def test_host_codec_imports_no_torch():
    """pzstd's spawned workers import the host codec without torch."""
    code = ("import sys, zstd_tpu_torch.parallel.pzstd\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_card_raises(monkeypatch):
    """With no device given the port runs on the card, and never falls back
    to the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.compress(b"x")
