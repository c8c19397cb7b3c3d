"""Session set-up of the repository's test suites.

Where a session collects the port's tests (tests/), zstd_tpu's C library
is made whole before any worker collects: the port's tests compare with
it, and a library that a lost build race left partial would fail every
worker that loads it (tests/refnative.py). The reference is imported only
then: gpubench/tests holds the benchmark to importing none of it.
"""

from __future__ import annotations

import os

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def _collects_tests(config) -> bool:
    """Whether one of the session's paths is tests/, lies under it or
    holds it."""
    for arg in config.args:
        path = os.path.abspath(os.path.join(str(config.invocation_params.dir),
                                            arg.split("::")[0]))
        if os.path.commonpath([path, TESTS]) in (path, TESTS):
            return True
    return False


def pytest_configure(config):
    """In the controller (or a run without workers), before any worker
    collects."""
    if not hasattr(config, "workerinput") and _collects_tests(config):
        from tests import refnative
        refnative.ensure_whole()
