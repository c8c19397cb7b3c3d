"""zstd_tpu's C library for the port's tests, built once across workers.

zstd_tpu.native.get_native() runs `make -C native` on first use and, when
that make fails, remembers the failure for the life of the process. Under
pytest-xdist every worker imports every test file at collection, and
tests/test_native_encode.py and tests/test_lz4.py call get_native() at
import, so one make per worker can run in native/ at the same time; a make
that links while another is still writing an object file fails. zstd_tpu
then runs without its C in that worker: its host codec takes its Python
branches, whose frames differ, and the port's tests that hold the port's C
against zstd_tpu's fail there.

A race can also leave a library that is there but partial: linked while
another make was still writing an object file, it lacks that file's
symbols, ctypes loads it and zstd_tpu's binding raises AttributeError; and
every later process loads the same file. So before any worker collects,
the root conftest.py's pytest_configure makes sure the library is whole
(ensure_whole: loaded in a subprocess with every symbol bound, else
removed and built again), and reference_native() takes an AttributeError
or OSError from the load as a lost build too.

reference_native() serialises the port's tests on a file lock and, where
this process's build failed, builds again under it: a make that finds the
objects built only links them. A library that cannot be built still gives
None, and the caller's assertion fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

from zstd_tpu import native as jnative

LOCK = (pathlib.Path(__file__).resolve().parent.parent / "zstd_tpu_torch"
        / "_build" / "reference-native.lock")
NATIVE_DIR = os.path.join(jnative._REPO_ROOT, "native")
# the binding that zstd_tpu runs on its library, loaded by its path alone
_BIND = """import ctypes, importlib.util, sys
spec = importlib.util.spec_from_file_location("native_check", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._Native(ctypes.CDLL(sys.argv[2]))
"""


@contextlib.contextmanager
def locked():
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def is_whole(so_path: str) -> bool:
    """Whether the library at so_path loads and binds every symbol that
    zstd_tpu.native._Native binds (in a subprocess: a partial library,
    once loaded, stays mapped under its name for the life of a process)."""
    if not os.path.exists(so_path):
        return False
    p = subprocess.run([sys.executable, "-c", _BIND, jnative.__file__,
                        so_path], capture_output=True, timeout=120)
    return p.returncode == 0


def _rebuild(so_path: str, native_dir: str) -> bool:
    """Remove the library and make it again; where the objects themselves
    are at fault, make every one of them again. Whether it is whole."""
    for flags in ([], ["-B"]):
        if os.path.exists(so_path):
            os.remove(so_path)
        try:
            subprocess.run(["make", *flags, "-C", native_dir],
                           capture_output=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if is_whole(so_path):
            return True
    return False


def ensure_whole(so_path: str = jnative._SO_PATH,
                 native_dir: str = NATIVE_DIR) -> bool:
    """Under LOCK: the library at so_path (zstd_tpu's) is whole, made again
    where it is missing or partial. Whether it is whole now."""
    with locked():
        return is_whole(so_path) or _rebuild(so_path, native_dir)


def _load_fresh(so_path: str):
    """zstd_tpu's binding of a copy of the library under a name of its own,
    which no earlier load in this process has mapped."""
    tmp = tempfile.mkdtemp(prefix="reference-native-")
    try:
        copy = os.path.join(tmp, os.path.basename(so_path))
        shutil.copy(so_path, copy)
        return jnative._Native(ctypes.CDLL(copy))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference_native(attempts: int = 3, so_path: str = jnative._SO_PATH,
                     native_dir: str = NATIVE_DIR):
    """zstd_tpu's loaded C library, or None when `attempts` builds fail."""
    with locked():
        for i in range(attempts):
            try:
                lib = jnative.get_native()
            except (AttributeError, OSError):
                # a partial library, loaded: made whole, then bound under a
                # name of its own
                lib = None
                if is_whole(so_path) or _rebuild(so_path, native_dir):
                    lib = jnative._native = _load_fresh(so_path)
            if lib is not None:
                return lib
            # a make of another worker outside the lock broke this try, or
            # left a library that does not load
            if not is_whole(so_path):
                _rebuild(so_path, native_dir)
            jnative._tried = False
            time.sleep(1.0 + i)
    return None
