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

reference_native() serialises the port's tests on a file lock and, where
this process's build failed, builds again under it: a make that finds the
objects built only links them. A library that cannot be built still gives
None, and the caller's assertion fails.
"""

from __future__ import annotations

import fcntl
import pathlib
import time

from zstd_tpu import native as jnative

LOCK = (pathlib.Path(__file__).resolve().parent.parent / "zstd_tpu_torch"
        / "_build" / "reference-native.lock")


def reference_native(attempts: int = 3):
    """zstd_tpu's loaded C library, or None when `attempts` builds fail."""
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for i in range(attempts):
                lib = jnative.get_native()
                if lib is not None:
                    return lib
                # a make of another worker outside the lock broke this try
                jnative._tried = False
                time.sleep(1.0 + i)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return None
