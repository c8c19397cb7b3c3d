"""The long-range corpus: one segment of the Silesia-like corpus
(corpus.big_corpus, its classes drawn from `seed`), repeated, with 8 point
mutations of 4 random bytes in every copy (drawn from `seed`), cut to
`size`. Repeats lie a segment apart, so at the 4 MiB segment they are past
level 3's 2 MiB window and the gap parser's 1 MiB cap: only the long
matcher reaches them, the data shape `zstd --long` exists for (versioned
backups, tarballs of near-identical trees, VM and container images).

A frozen copy of tests/longcorpus.long_corpus's shape (commit
a091d158eea99f28aa370f1065de7eb46a835d74), with the segment and the
mutations drawn from the run's seed where the original fixes them.
"""

from __future__ import annotations

import numpy as np

import corpus

SEGMENT = 4 * 1024 * 1024
MUTATIONS = 8          # a copy's point mutations, each of 4 random bytes


def make(size: int, seed: int, segment: int = SEGMENT) -> bytes:
    base = np.frombuffer(corpus.big_corpus(segment, seed=seed),
                         dtype=np.uint8)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 63]))
    parts, total = [], 0
    while total < size:
        chunk = base.copy()
        for _ in range(MUTATIONS):
            at = int(rng.integers(0, len(chunk) - 16))
            chunk[at:at + 4] = rng.integers(0, 256, 4, dtype=np.uint8)
        parts.append(chunk)
        total += len(chunk)
    return np.concatenate(parts)[:size].tobytes()
