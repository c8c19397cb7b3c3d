"""The Silesia-like corpus: corpus.big_corpus, the frozen copy of
tests/bigcorpus.py (README.md); its raster keeps its original seed, the
other seven classes draw theirs from `seed`."""

from __future__ import annotations

import corpus


def make(size: int, seed: int) -> bytes:
    return corpus.big_corpus(size, seed=seed)
