"""zstd_tpu_torch's command line on the CPU, against zstd_tpu's.

Every command line runs twice on the same files, each in a directory of its
own: through `zstd_tpu.cli.main(argv)` and through
`zstd_tpu_torch.cli.main(argv, device="cpu")`. The exit codes, standard
output (bytes), standard error and every file left in the directory must be
equal. `--engine tpu` / `gpu` is held to zstd_tpu with the jax_reference
fixture's setting (ZSTD_TPU_ENGINE=pallas, the Pallas kernel interpreted).
The dictionary trainers (--train, --train-cover, --train-fastcover,
--train-legacy, --optimize-cover) must write the same dictionary file.

Where the two differ by design, the test shows both:
- ZSTD_TPU_ENGINE=host moves zstd_tpu's encode onto its device pipeline
  (zstd_tpu/cli.py:146); the port's CLI reads no environment variable to
  choose its path;
- --long under --engine tpu at levels 1-2 is dropped by zstd_tpu for its
  device encode (zstd_tpu/cli.py:235); the port's --engine gpu/tpu runs
  --long through the sharded long-distance matcher at every level;
- lz4 input with bytes after its last frame decodes to partial output and
  exits 0 in zstd_tpu (:274-280); the port reports the trailing bytes and
  exits 1, as both do after zstd frames;
- --version names the package.
"""

import contextlib
import functools
import gzip
import io
import lzma
import os
import re
import sys
import time

import numpy as np
import pytest

from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from tests.longcorpus import long_corpus
from tests.refnative import reference_native
from zstd_tpu import cli as jcli
from zstd_tpu import dictionary as jdict
from zstd_tpu import fileio_async as jfio
from zstd_tpu import lz4frame as jlz4
from zstd_tpu import pipeline as jpipe
from zstd_tpu.dict_builder.fastcover import train_from_samples
from zstd_tpu.dict_builder.zdict import finalize_dictionary
from zstd_tpu.format import codec as jcodec
from zstd_tpu.ops import seqextract
from zstd_tpu_torch import _kernels
from zstd_tpu_torch import cli as tcli
from zstd_tpu_torch import fileio_async as tfio
from zstd_tpu_torch import trace as ttrace
from zstd_tpu import trace as jtrace

SMALL = gen_text(40_000, seed=21)
A = big_corpus(200 * 1024)
OLD = bytes(b ^ (0x33 if i % 25_013 == 7 else 0) for i, b in enumerate(A))
BIG9 = big_corpus(9 * 1024 * 1024)
RAND9 = np.random.default_rng(9).integers(0, 256, 9 * 1024 * 1024,
                                          dtype=np.uint8).tobytes()


def _dictionary() -> bytes:
    samples = [gen_text(1500 + 97 * i, seed=300 + i) for i in range(40)]
    return finalize_dictionary(train_from_samples(samples,
                                                  max_dict_size=8192),
                               samples, dict_id=31337)


FILES = {"a.bin": A, "s.bin": SMALL, "old.bin": OLD,
         "a.zst": jcodec.compress(A, level=3, checksum=True),
         "l.zst": jcodec.compress(A, level=5, window_log=24,
                                  long_mode=True),
         "p.zst": jcodec.compress_patch(A, OLD, level=3),
         "multi.zst": (jcodec.compress(A[:5000], level=1)
                       + jcodec.compress(A[5000:], level=9, checksum=True)),
         "bad.zst": jcodec.compress(A, level=3, checksum=True)[:-3] + b"xyz",
         "trail.zst": jcodec.compress(A, level=1) + b"garbage!",
         "a.lz4": jlz4.compress_lz4(A),
         "trail.lz4": jlz4.compress_lz4(A) + b"junk",
         "a.gz": gzip.compress(A, mtime=0),
         "a.xz": lzma.compress(A),
         "dict": _dictionary(),
         "dir/x.bin": SMALL, "dir/sub/y.bin": A[:30_000],
         "dir/sub/z.zst": jcodec.compress(b"zz" * 99),
         "list.txt": b"s.bin\ndir/x.bin\n"}
FILES["d.zst"] = jdict.compress_with_dict(
    SMALL, jdict.load_dictionary(FILES["dict"]), level=3, checksum=True)


@pytest.fixture(scope="module", autouse=True)
def _native():
    """zstd_tpu's frames are those of its C parsers; the port's host
    library is built before any test patches the clock."""
    assert reference_native() is not None, \
        "zstd_tpu's C library is not built"
    _kernels.host()


class _Out:
    """sys.stdout with a binary buffer, as the CLI writes both."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s: str) -> int:
        return self.buffer.write(s.encode())

    def flush(self) -> None:
        pass


def _tree(root: str) -> dict:
    out = {}
    for base, _dirs, names in os.walk(root):
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _run(monkeypatch, root, main, argv, files, stdin=b"", prog="zstd"):
    os.makedirs(root)
    for name, data in files.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    out, err = _Out(), io.StringIO()
    stdin_obj = io.TextIOWrapper(io.BytesIO(stdin))
    with monkeypatch.context() as m:
        m.chdir(root)
        m.setattr(sys, "stdout", out)
        m.setattr(sys, "stdin", stdin_obj)
        m.setattr(sys, "argv", [prog])
        with contextlib.redirect_stderr(err):
            rc = main(list(argv))
    return rc, out.buffer.getvalue(), err.getvalue(), _tree(root)


def both(tmp_path, monkeypatch, argv, files=None, stdin=b"", prog="zstd",
         port_argv=None):
    files = FILES if files is None else files
    want = _run(monkeypatch, str(tmp_path / "j"), jcli.main, argv, files,
                stdin, prog)
    got = _run(monkeypatch, str(tmp_path / "t"),
               functools.partial(tcli.main, device="cpu"),
               argv if port_argv is None else port_argv, files, stdin, prog)
    return want, got


def _same(want, got):
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[1] == want[1]
    assert sorted(got[3]) == sorted(want[3])
    for name in want[3]:
        assert got[3][name] == want[3][name], name


COMMANDS = {
    "default": ["a.bin"],
    "l1_stdout": ["-1", "-c", "a.bin"],
    "l3_o": ["-3", "-o", "out.zst", "a.bin"],
    "l19": ["-19", "-c", "s.bin"],
    "ultra22": ["--ultra", "-22", "-c", "s.bin"],
    "fast": ["--fast=3", "-c", "a.bin"],
    "no_check": ["--no-check", "-5", "-c", "a.bin"],
    "verbose": ["-v", "-4", "a.bin"],
    "decompress": ["-d", "a.zst"],
    "decompress_stdout": ["-d", "-c", "multi.zst"],
    "unzstd_suffix": ["-d", "-o", "plain.out", "a.zst"],
    "test_ok": ["-t", "a.zst", "multi.zst"],
    "test_bad": ["-t", "bad.zst"],
    "trailing_zstd": ["-d", "-c", "trail.zst"],
    "memory_limit": ["-d", "-M", "10", "-c", "l.zst"],
    "memory_mib": ["-d", "-M", "64", "-c", "l.zst"],
    "list": ["-l", "a.zst", "multi.zst", "bad.zst"],
    "exists": ["a.bin", "a.bin"],
    "force": ["-f", "-o", "a.zst", "s.bin"],
    "rm": ["--rm", "s.bin"],
    "keep": ["-k", "-d", "a.zst"],
    "dir_no_r": ["dir"],
    "recursive": ["-r", "dir"],
    "filelist": ["--filelist", "list.txt", "-1"],
    "dir_flat": ["--output-dir-flat", "flat", "dir/x.bin", "dir/sub/y.bin"],
    "dir_mirror": ["--output-dir-mirror", "mir", "-r", "dir"],
    "exclude_compressed": ["--exclude-compressed", "-r", "dir"],
    "threads": ["-T4", "-c", "a.bin"],
    "threads_d": ["-T3", "-d", "-c", "multi.zst"],
    "single_thread": ["--single-thread", "-c", "a.bin"],
    "rsyncable": ["--rsyncable", "-c", "a.bin"],
    "rsyncable_t2": ["--rsyncable", "-T2", "-6", "-c", "a.bin"],
    "long": ["--long=24", "-5", "-c", "a.bin"],
    "long_d": ["-d", "--long=24", "-c", "l.zst"],
    "patch": ["--patch-from", "old.bin", "-c", "a.bin"],
    "patch_19": ["--patch-from", "old.bin", "-19", "-c", "s.bin"],
    "patch_d": ["-d", "--patch-from", "old.bin", "-c", "p.zst"],
    "dict": ["-D", "dict", "-c", "s.bin"],
    "dict_no_id": ["-D", "dict", "--no-dictID", "-7", "-c", "s.bin"],
    "dict_d": ["-d", "-D", "dict", "-c", "d.zst"],
    "dict_missing": ["-d", "-c", "d.zst"],
    "target_block": ["--target-compressed-block-size", "2048", "-c", "a.bin"],
    "target_block_19": ["--target-compressed-block-size", "4096", "-19",
                        "-c", "s.bin"],
    "gzip": ["--format", "gzip", "a.bin"],
    "xz": ["--format", "xz", "-c", "s.bin"],
    "lzma": ["--format", "lzma", "-c", "s.bin"],
    "lz4": ["--format", "lz4", "a.bin"],
    "lz4_d": ["-d", "-c", "a.lz4"],
    "gzip_d": ["-d", "a.gz"],
    "xz_d": ["-d", "-c", "a.xz"],
    "engine_host": ["--engine", "host", "-1", "-c", "a.bin"],
    "no_mtime": ["--no-mtime", "s.bin"],
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_command_equals_jax(tmp_path, monkeypatch, name):
    # gzip's header holds the time it was written
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    want, got = both(tmp_path, monkeypatch, COMMANDS[name])
    _same(want, got)


@pytest.mark.parametrize("case", ("match", "mismatch", "decompress"))
def test_stdin_stream_size_equals_jax(tmp_path, monkeypatch, case):
    if case == "decompress":
        argv, stdin = ["-d"], FILES["a.zst"]
    else:
        size = len(A) if case == "match" else len(A) - 1
        argv, stdin = ["--stream-size", str(size), "-c"], A
    want, got = both(tmp_path, monkeypatch, argv, stdin=stdin)
    _same(want, got)


@pytest.mark.parametrize("prog", ("zstdcat", "unzstd"))
def test_personalities_equal_jax(tmp_path, monkeypatch, prog):
    argv = ["multi.zst"] if prog == "zstdcat" else ["multi.zst", "-o", "m"]
    want, got = both(tmp_path, monkeypatch, argv, prog=prog)
    _same(want, got)


def test_help_equals_jax(tmp_path, monkeypatch):
    want, got = both(tmp_path, monkeypatch, ["-h"])
    assert got[0] == want[0] == 0
    # the usage text differs only in the description line and the --engine
    # choices
    assert got[1].splitlines()[0] == want[1].splitlines()[0]


def test_bench_equals_jax(tmp_path, monkeypatch):
    """-b1 -e2: the rows without their speeds."""
    want, got = both(tmp_path, monkeypatch, ["-b1", "-e2", "-i0", "a.bin"])
    assert got[0] == want[0] == 0
    strip = re.compile(rb" *[0-9.]+ MB/s")
    assert strip.sub(b"", got[1]) == strip.sub(b"", want[1])
    assert got[1].count(b"\n") == 2


def test_trace_rows_equal_jax(tmp_path, monkeypatch):
    """--trace: one CSV row a frame, equal without the time columns."""
    rows = []
    try:
        want, got = both(tmp_path, monkeypatch,
                         ["--trace", "t.csv", "-3", "-c", "multi.zst", "-d"])
    finally:
        for tracer in (jtrace.GLOBAL_TRACER, ttrace.GLOBAL_TRACER):
            if tracer._csv is not None:
                tracer._csv.close()
                tracer._csv = None
    for res in (want, got):
        text = res[3].pop("t.csv").decode()
        rows.append([",".join(c for i, c in enumerate(ln.split(","))
                              if i not in (9, 10))
                     for ln in text.splitlines()])
    _same(want, got)
    assert rows[1] == rows[0] and len(rows[0]) == 3


# ---- the 9 MiB file paths ------------------------------------------------------

@pytest.mark.parametrize("mode", ("compress", "decompress"))
def test_async_file_path_equals_jax(tmp_path, monkeypatch, mode):
    """Plain files of 8 MiB and more stream through the async reader and
    writer threads."""
    if mode == "compress":
        files, argv = {"big.bin": BIG9}, ["-3", "big.bin"]
    else:
        # incompressible, so that the frame too passes 8 MiB
        blob = jcodec.compress(RAND9, level=1, checksum=True)
        files, argv = {"big.bin.zst": blob}, ["-d", "big.bin.zst"]
    calls = []
    for mod in (jfio, tfio):
        name = "compress_file_async" if mode == "compress" \
            else "decompress_file_async"
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, orig=orig, **k:
                            calls.append(1) or orig(*a, **k))
    want, got = both(tmp_path, monkeypatch, argv, files=files)
    _same(want, got)
    assert len(calls) == 2
    if mode == "compress":
        assert jcodec.decompress(got[3]["big.bin.zst"]) == BIG9
    else:
        assert got[3]["big.bin"] == RAND9


def _steady_clock(monkeypatch):
    """time.time() advancing by a fixed sequence, so the in-memory --adapt
    loop sees the same rates in both packages."""
    ticks = iter(range(10 ** 6))
    steps = [0.0, 0.05, 0.05, 0.2, 0.2, 0.3, 0.3, 0.31]
    now = [0.0]

    def fake():
        now[0] += steps[next(ticks) % len(steps)]
        return now[0]
    monkeypatch.setattr(jcli.time, "time", fake)


@pytest.mark.parametrize("where", ("memory", "file"))
def test_adapt_equals_jax(tmp_path, monkeypatch, where):
    """--adapt: on stdout the level follows the codec's own rate (a fixed
    clock here); on a file of 8 MiB and more, the async queues' fill (one
    fixed decision rule here)."""
    files = {"big.bin": BIG9}
    if where == "memory":
        argv = ["--adapt=min=1,max=4", "-c", "big.bin"]
        clock = []

        def run(main, *a, **k):
            _steady_clock(monkeypatch)
            clock.append(1)
            return main(*a, **k)
        wrap_j = functools.partial(run, jcli.main)
        wrap_t = functools.partial(run, functools.partial(tcli.main,
                                                          device="cpu"))
        want = _run(monkeypatch, str(tmp_path / "j"), wrap_j, argv, files)
        got = _run(monkeypatch, str(tmp_path / "t"), wrap_t, argv, files)
        assert len(clock) == 2
    else:
        argv = ["--adapt=min=1,max=3", "big.bin"]
        for mod in (jfio, tfio):
            it = iter([1, -1, 1, 1, -1, -1, 1] * 20)
            monkeypatch.setattr(mod, "_adapt_decide",
                                lambda s, w, b, level, lo, hi, it=it:
                                min(max(level + next(it), lo), hi))
        want, got = both(tmp_path, monkeypatch, argv, files=files)
    _same(want, got)
    blob = got[1] if where == "memory" else got[3]["big.bin.zst"]
    assert jcodec.decompress(blob) == BIG9
    assert blob.count(b"\x28\xb5\x2f\xfd") >= 3


# ---- the device path -------------------------------------------------------------

@pytest.fixture
def jax_reference(monkeypatch):
    """zstd_tpu.pipeline with ZSTD_TPU_ENGINE=pallas and the Pallas kernel
    interpreted (tests/test_torch_pipeline.py's fixture)."""
    monkeypatch.setenv("ZSTD_TPU_ENGINE", "pallas")
    monkeypatch.setattr(seqextract, "extract_batch_pallas",
                        functools.partial(seqextract.extract_batch_pallas,
                                          interpret=True))
    jpipe._engine_kind.cache_clear()
    try:
        yield jpipe
    finally:
        monkeypatch.undo()
        jpipe._engine_kind.cache_clear()


_DEVICE_WANT = {}


@pytest.mark.parametrize("argv", (["-1", "-c", "s.bin"],
                                  ["-2", "-o", "s2.zst", "s.bin"],
                                  ["-d", "-c", "s.zst"]),
                         ids=("l1", "l2", "decompress"))
@pytest.mark.parametrize("engine", ("tpu", "gpu"))
def test_device_engine_equals_jax(tmp_path, monkeypatch, jax_reference,
                                  engine, argv):
    """--engine gpu takes the device encode at levels 1-2 and the device
    decode; tpu is its other name. zstd_tpu runs --engine tpu, once for
    both names."""
    calls = []
    for mod, name in (("zstd_tpu_torch.pipeline", "compress"),
                      ("zstd_tpu_torch.device_decoder", "device_decompress")):
        target = sys.modules.get(mod) or __import__(mod, fromlist=["x"])
        orig = getattr(target, name)
        monkeypatch.setattr(target, name, lambda *a, orig=orig, **k:
                            calls.append(k.get("device")) or orig(*a, **k))
    files = {"s.bin": SMALL,
             "s.zst": jcodec.compress(SMALL, level=3, checksum=True)}
    key = tuple(argv)
    if key not in _DEVICE_WANT:
        _DEVICE_WANT[key] = _run(monkeypatch, str(tmp_path / "j"), jcli.main,
                                 ["--engine", "tpu", *argv], files)
    got = _run(monkeypatch, str(tmp_path / "t"),
               functools.partial(tcli.main, device="cpu"),
               ["--engine", engine, *argv], files)
    _same(_DEVICE_WANT[key], got)
    assert calls == ["cpu"]
    assert not any(_kernels.LAUNCHES.values())   # plain versions on the CPU


def test_device_engine_without_a_card_raises(tmp_path, monkeypatch):
    """main() with no device runs on the card, and raises without one: the
    CLI reports the missing device and exits 1, with no CPU fallback."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = _run(monkeypatch, str(tmp_path / "t"), tcli.main,
               ["--engine", "gpu", "-1", "-c", "s.bin"], {"s.bin": SMALL})
    assert res[0] == 1 and res[1] == b""
    assert "no CUDA device" in res[2]
    res = _run(monkeypatch, str(tmp_path / "t2"), tcli.main,
               ["--engine", "gpu", "-d", "-c", "a.zst"],
               {"a.zst": FILES["a.zst"]})
    assert res[0] == 1 and "no CUDA device" in res[2]


LONG = long_corpus(256 * 1024, seg=64 * 1024)


@pytest.mark.parametrize("level", (3, 1))
def test_device_engine_long_takes_the_long_matcher(tmp_path, monkeypatch,
                                                   level):
    """--engine gpu --long=N writes compress_long_sharded's frame (the
    sharded discovery on the device, its plain versions on the CPU, and the
    host's gap parse) at level 3, and at level 1, where the device encode
    would otherwise take the call."""
    from zstd_tpu_torch.parallel import ldm_sharded as tl
    calls = []
    orig = tl.compress_long_sharded
    monkeypatch.setattr(tl, "compress_long_sharded",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    got = _run(monkeypatch, str(tmp_path / "t"),
               functools.partial(tcli.main, device="cpu"),
               ["--engine", "gpu", "--long=20", f"-{level}", "-c", "l.bin"],
               {"l.bin": LONG})
    assert got[0] == 0 and got[2] == ""
    assert calls == [dict(level=level, checksum=True, long_log=20,
                          device="cpu")]
    assert got[1] == orig(LONG, level=level, checksum=True, long_log=20,
                          device="cpu")
    assert jcodec.decompress(got[1]) == LONG
    assert len(got[1]) < len(LONG) // 3


# ---- where the port differs by design --------------------------------------------

def test_engine_env_pins_reference_fault(tmp_path, monkeypatch):
    """ZSTD_TPU_ENGINE=host puts zstd_tpu's encode on its device pipeline;
    the port's stays on the host codec."""
    monkeypatch.setenv("ZSTD_TPU_ENGINE", "host")
    jpipe._engine_kind.cache_clear()
    try:
        want, got = both(tmp_path, monkeypatch, ["-1", "-c", "s.bin"])
    finally:
        jpipe._engine_kind.cache_clear()
    host = jcodec.compress(SMALL, level=1, checksum=True)
    assert want[0] == got[0] == 0
    assert got[1] == host
    assert want[1] != host and jcodec.decompress(want[1]) == SMALL


def test_engine_tpu_long_pins_reference_fault(tmp_path, monkeypatch,
                                             jax_reference):
    """zstd_tpu's CLI under --engine tpu --long=20 -1 drops the long
    matcher: its frame is its device encode's without --long. The port's
    is the long matcher's."""
    from zstd_tpu_torch.parallel import ldm_sharded as tl
    files = {"s.bin": SMALL}
    want = _run(monkeypatch, str(tmp_path / "j"), jcli.main,
                ["--engine", "tpu", "--long=20", "-1", "-c", "s.bin"], files)
    plain = _run(monkeypatch, str(tmp_path / "j2"), jcli.main,
                 ["--engine", "tpu", "-1", "-c", "s.bin"], files)
    got = _run(monkeypatch, str(tmp_path / "t"),
               functools.partial(tcli.main, device="cpu"),
               ["--engine", "tpu", "--long=20", "-1", "-c", "s.bin"], files)
    assert want[0] == plain[0] == got[0] == 0
    assert want[1] == plain[1]
    assert got[1] == tl.compress_long_sharded(SMALL, level=1, checksum=True,
                                              long_log=20, device="cpu")
    assert got[1] != want[1]
    assert jcodec.decompress(got[1]) == jcodec.decompress(want[1]) == SMALL


def test_lz4_trailing_bytes_pin_reference_fault(tmp_path, monkeypatch):
    """zstd_tpu decodes the lz4 frame, drops the trailing bytes and exits 0;
    the port exits 1 and writes nothing, as both do after zstd frames."""
    want, got = both(tmp_path, monkeypatch, ["-d", "-c", "trail.lz4"])
    assert want[0] == 0 and want[1] == A and want[2] == ""
    assert got[0] == 1 and got[1] == b""
    assert got[2] == "zstd: trail.lz4: prefix_unknown: 4 bytes after the " \
                     "last lz4 frame\n"
    zstd_want, zstd_got = both(tmp_path / "z", monkeypatch,
                               ["-d", "-c", "trail.zst"])
    assert zstd_want[0] == zstd_got[0] == 1


TRAIN = {f"t/{i:02d}.txt": gen_text(1200 + 131 * i, seed=500 + i)
         for i in range(16)}
TRAIN.update({f"t/c{i}.bin": A[i * 3000:(i + 1) * 3000] for i in range(8)})
TRAINING = {
    "train": ["--train"],
    "train_fastcover": ["--train-fastcover"],
    "train_cover": ["--train-cover"],
    "train_legacy": ["--train-legacy"],
    "optimize_cover": ["--optimize-cover"],
    "dict_id_maxdict": ["--train", "--dictID", "777", "--maxdict", "4096"],
}


@pytest.mark.parametrize("case", sorted(TRAINING) + ["no_training_files"])
def test_training_flags_equal_jax(tmp_path, monkeypatch, case):
    """The trainers' exit code, messages and dictionary file."""
    if case == "no_training_files":
        argv = ["--train", "-o", "dict.out"]
    else:
        argv = TRAINING[case] + ["-o", "dict.out"] + sorted(TRAIN)
    want, got = both(tmp_path, monkeypatch, argv, files=TRAIN)
    _same(want, got)
    if case == "no_training_files":
        assert got[0] == 1 and got[2] == "zstd: no training files\n"
    else:
        assert got[0] == 0 and b"Save dictionary of size" in got[1]
        assert got[3]["dict.out"][:4] == b"\x37\xa4\x30\xec"


def test_version_names_the_port(tmp_path, monkeypatch):
    want, got = both(tmp_path, monkeypatch, ["--version"])
    assert want[0] == got[0] == 0
    assert b"zstd_tpu (TPU-native" in want[1]
    assert got[1] == b"*** zstd_tpu_torch (Zstandard on PyTorch/CUDA) " \
                     b"v0.1.0 ***\n"
