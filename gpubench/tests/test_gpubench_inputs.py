"""The inputs: the frozen corpus, seeded pools and call orders, and the
frames the compress cells make, pinned to what the harness made before
operations and corpora were files of their own (commit 19da34c)."""

from __future__ import annotations

import hashlib
import json
import os
import sys

import pytest
from conftest import BENCH, ROOT

import corpus
import harness

sys.path.insert(0, ROOT)
from tests import bigcorpus  # noqa: E402

CONFIG = {"corpus": "silesia-like"}
MIX = {"call_bytes": 65536, "corpus_bytes": 262144, "corpora": 2}


@pytest.mark.parametrize("size", [8 * 4096, 262144 + 24])
def test_corpus_equals_the_original_at_its_seeds(size):
    assert corpus.big_corpus(size) == bigcorpus.big_corpus(size)


@pytest.mark.parametrize("name", [n for n, _ in corpus.SEGMENTS])
def test_segments_equal_the_original(name):
    assert getattr(corpus, name)(20000) == getattr(bigcorpus, name)(20000)


def test_pool_is_deterministic_and_differs_between_seeds():
    seed = 2**31 + 12345
    a = harness.pool_of(CONFIG, MIX, seed)
    assert a == harness.pool_of(CONFIG, MIX, seed)
    b = harness.pool_of(CONFIG, MIX, seed + 1)
    assert len(a) == len(b) == 8
    assert all(len(x) == 65536 for x in a + b)
    assert all(x != y for x, y in zip(a, b))
    assert a[0] != a[4]           # the two corpora differ


def test_seeded_corpus_keeps_the_classes():
    """Another seed gives other bytes of the same eight classes: the
    segments' structure (e.g. the xml records) stays."""
    a = corpus.big_corpus(8 * 8192, seed=7)
    b = corpus.big_corpus(8 * 8192, seed=8)
    assert a != b
    for blob in (a, b):
        assert blob[2 * 8192:2 * 8192 + 21] == b'<?xml version="1.0"?>'


def test_raster_keeps_its_original_seed():
    """Every seeded corpus holds the original raster; the other classes
    change with the seed."""
    seg = 8192
    original = bigcorpus.big_corpus(8 * seg)
    for seed in (7, 2**31 + 3):
        blob = corpus.big_corpus(8 * seg, seed=seed)
        for i, (name, _) in enumerate(corpus.SEGMENTS):
            same = blob[i * seg:(i + 1) * seg] == original[i * seg:(i + 1) * seg]
            assert same == (name in corpus.FIXED), name


def test_level_1_ratio_is_near_silesias():
    """The stand-in compresses at level 1 near silesia.tar's 2.887 (the
    configuration's source): the port's encoder on 16 MiB, on its CPU path,
    whose frames are the card's."""
    from zstd_tpu_torch.pipeline import TorchCompressor
    data = corpus.big_corpus(16 << 20, seed=2**31 + 11)
    frame = TorchCompressor(level=1, device="cpu").compress(data)
    assert 2.8 < len(data) / len(frame) < 3.0


def test_order_is_a_seeded_permutation():
    o = harness.order_of(16, 5)
    assert sorted(o) == list(range(16))
    assert o == harness.order_of(16, 5)
    assert o != harness.order_of(16, 6)


def test_large_and_negative_seeds():
    for seed in (2**31 + 1, 2**33 + 7, -5):
        assert harness.draw(seed, 1) == harness.draw(seed, 1)
        assert harness.draw(seed, 1) != harness.draw(seed, 2)


SEED = 2**31 + 2021
# sha256 of the pool's inputs, one after another, at each cell's own sizes
POOLS = {"compress-16mib":
         "5a085e9aa52e8ca4c1540c3d33f7cb0353b483814c7e336e63fd4e6d2e27cb44",
         "compress-1mib":
         "17eee6dda8768d84af6f1a2770064a201d9626c300ff5d214c1ac3f07cacbfd7"}
# sha256 of the frames of a pool of two 128 KiB calls, by configuration
FRAMES = {"silesia-l1": [
    "453c004b4eab7e1084c8826fc71e8363a98bdbe5f862a582e6fb12683dc60521",
    "55ac7170527c54c2a731e898121136ec3ad4ea85988a7703708a67b2ae3916d5"],
    "silesia-l5": [
    "0dba78364ff7372e7a35b3d8761c78ea95b494c63b7334eb00c728cce9fd1d96",
    "cf03408a767d51814addc69475046aa25ab01b07c19a94407251969ac622128c"]}
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [c for c in SPEC["workloads"]
                                  if c["traffic"] in POOLS],
                         ids=lambda c: c["name"])
def test_compress_cells_pools_are_pinned(cell):
    config = harness.config_of(BENCH, cell["config"])
    traffic = harness.traffic_of(BENCH, cell["traffic"])
    h = hashlib.sha256()
    for x in harness.pool_of(config, traffic, SEED):
        h.update(x)
    assert h.hexdigest() == POOLS[cell["traffic"]]


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_compress_frames_are_pinned(name):
    config = harness.config_of(BENCH, name)
    tiny = {"call_bytes": 131072, "corpus_bytes": 262144, "corpora": 1}
    op = harness.module_of(BENCH, "ops", "compress").Op(config, "cpu")
    frames = [op(x) for x in op.inputs(harness.pool_of(config, tiny, SEED))]
    assert [hashlib.sha256(f).hexdigest() for f in frames] == FRAMES[name]
