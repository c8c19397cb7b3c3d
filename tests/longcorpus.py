"""Long-range-redundant corpus for the --long path, numpy only.

The shape of tests/test_ldm_sharded.py::_long_corpus (one unique segment
that recurs at multi-megabyte distances, 8 point mutations of 4 random
bytes in each repeat, so repeats are not byte-identical: the data shape
--long exists for), with tests/bigcorpus.big_corpus as the segment so that
chip_smoke.py can build it without the JAX test configuration.
"""

from __future__ import annotations

import numpy as np

try:                    # as the tests import it
    from tests.bigcorpus import big_corpus
except ImportError:     # as chip_smoke.py does, with tests/ on sys.path
    from bigcorpus import big_corpus


def long_corpus(total: int, seg: int = 4 * 1024 * 1024) -> bytes:
    """`total` bytes: big_corpus(seg), repeated with 8 point mutations each
    time (seed 63), cut to length."""
    base = np.frombuffer(big_corpus(seg), dtype=np.uint8)
    rng = np.random.default_rng(63)
    parts, size = [], 0
    while size < total:
        chunk = base.copy()
        for _ in range(8):
            at = int(rng.integers(0, len(chunk) - 16))
            chunk[at:at + 4] = rng.integers(0, 256, 4, dtype=np.uint8)
        parts.append(chunk)
        size += len(chunk)
    return np.concatenate(parts)[:total].tobytes()
