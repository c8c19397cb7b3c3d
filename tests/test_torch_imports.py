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
              "format.codec", "cli", "trace", "streaming", "fileio_async",
              "rsync", "lz4frame", "dictionary", "dict_builder.fastcover",
              "dict_builder.cover", "dict_builder.zdict", "seekable",
              "format.matchfinder"):
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
    assert "host/lz4.c" in _kernels.HOST_SOURCES
    for name in host:
        text = (PORT / "csrc" / "host" / name).read_text()
        assert "getenv" not in text, name


def test_cuda_sources_are_registered():
    """Every csrc/*.cu is built (SOURCES), has its C entry points
    (_SIGNATURES), and each names its kernel's launch counter."""
    from zstd_tpu_torch import _kernels
    cuda = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sorted(_kernels.SOURCES) == cuda
    assert sorted(_kernels._SIGNATURES) == cuda
    assert {"seq_merge.cu", "seq_finish.cu"} <= set(cuda)
    for src in cuda:
        assert f"{src[:-3]}_launch" in _kernels._SIGNATURES[src], src
    assert {"seq_merge", "seq_finish"} <= set(_kernels.LAUNCHES)


def test_host_codec_imports_no_torch():
    """pzstd's spawned workers import the host codec without torch; so do
    the dictionary trainers and the seekable format."""
    code = ("import sys, zstd_tpu_torch.parallel.pzstd\n"
            "import zstd_tpu_torch.dict_builder.zdict\n"
            "import zstd_tpu_torch.dict_builder.cover\n"
            "import zstd_tpu_torch.seekable\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("argv", (
    ["-3", "-c", "in.bin"], ["-d", "-c", "in.bin.zst"],
    ["--format", "lz4", "-c", "in.bin"],
    ["-T2", "--rsyncable", "-o", "out.zst", "in.bin"],
    ["--train", "-o", "d.dict", "in.bin", "in.bin.zst"]),
    ids=("compress", "decompress", "lz4", "rsyncable", "train"))
def test_cli_host_paths_import_no_torch(tmp_path, argv):
    """`python -m zstd_tpu_torch.cli` on a host path runs without torch."""
    from zstd_tpu_torch.format import codec
    data = bytes(range(256)) * 400
    (tmp_path / "in.bin").write_bytes(data)
    (tmp_path / "in.bin.zst").write_bytes(codec.compress(data))
    code = ("import runpy, sys\n"
            f"sys.argv = ['zstd'] + {argv!r}\n"
            "try:\n"
            "    runpy.run_module('zstd_tpu_torch.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "sys.exit(rc if rc else 2 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_cli_engine_gpu_imports_torch_and_needs_a_card(tmp_path):
    """The device path imports torch and runs on the card: without one,
    `python -m zstd_tpu_torch.cli --engine gpu -1 f` reports the missing
    device and exits 1; nothing falls back to the CPU."""
    (tmp_path / "f").write_bytes(b"abc" * 1000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "zstd_tpu_torch.cli",
                        "--engine", "gpu", "-1", "f"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "f.zst").exists()


def test_no_card_raises(monkeypatch):
    """With no device given the port runs on the card, and never falls back
    to the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.compress(b"x")
