"""zstd_tpu_torch.parallel on the CPU: the one-frame sharded encode and the
minimal sharded step in gloo process groups of world sizes 1, 2 and 4
(spawned ranks, tests/torchdist.py), against zstd_tpu.parallel on meshes of
the same size.

Frames must be byte-identical, except where zstd_tpu's frame is corrupt:
its first block's backward extension reaches into the fabricated halo
(ROADMAP §3); there the port's frame decodes and is the same for both world
sizes (`test_fabricated_halo_pins_reference_fault`).
"""

import numpy as np
import pytest
import torch

import zstd_tpu
from tests.conftest import gen_mixed, gen_text
from tests.torchdist import run_groups
from zstd_tpu.errors import Corruption
from zstd_tpu.parallel import shard_compress as jshard
from zstd_tpu.parallel import zstdmt as jz
from zstd_tpu_torch.parallel import shard_compress as tshard
from zstd_tpu_torch.parallel import zstdmt as tz

WORLDS = (1, 2, 4)
TEXT = gen_text(400_000, seed=11)
CORPUS = gen_text(200_000, seed=11) + gen_mixed(200_000, seed=12)
# inputs whose zstd_tpu frame refers to bytes before the frame's start
CORRUPT = {"zeros": b"\x00" * 262_144, "period8_256k": b"abcdefgh" * 32_768,
           "period8_128k": b"abcdefgh" * 16_384}
FRAMES = {"text": dict(data=TEXT, level=1, checksum=True),
          "corpus": dict(data=CORPUS, level=1),
          "overlap9": dict(data=TEXT, level=1, overlap_log=9),
          "empty": dict(data=b"", checksum=True),
          "tiny": dict(data=b"abc", checksum=True),
          **{k: dict(data=v, level=1) for k, v in CORRUPT.items()}}


def _step_input():
    """__graft_entry__.dryrun_multichip's step input, for a world of 2."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 32, 2048 // 4, dtype=np.uint8)
    return np.tile(base, (4, 4)), np.full(4, 2048, dtype=np.int32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: {name: rank 0's result}} of every job, one spawned group per
    world size."""
    blocks, lens = _step_input()
    jobs = [(name, "frame", kw) for name, kw in FRAMES.items()]
    jobs.append(("step", "step", dict(blocks=blocks, lens=lens, hash_log=10,
                                      mls=5)))
    return run_groups(WORLDS, str(tmp_path_factory.mktemp("groups")), jobs)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["text", "corpus", "overlap9"])
def test_frames_equal_jax(port, name, world):
    kw = FRAMES[name]
    want = jz.compress_sharded(mesh=jshard.make_mesh(world), **kw)
    got = port[world][name]
    assert got == want
    assert zstd_tpu.decompress(got) == kw["data"]


@pytest.mark.parametrize("name", ["empty", "tiny"])
def test_empty_and_tiny(port, name):
    kw = FRAMES[name]
    frames = [port[w][name] for w in WORLDS]
    assert frames == [jz.compress_sharded(mesh=jshard.make_mesh(1), **kw)] \
        * len(WORLDS)
    assert zstd_tpu.decompress(frames[0]) == kw["data"]


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_fabricated_halo_pins_reference_fault(port, name):
    """zstd_tpu's first block extends a match backward into its fabricated
    halo (the last rank's zero padding), so its frame points before the
    frame's start; the port caps that extension, and its frame decodes."""
    data = CORRUPT[name]
    jax_frame = jz.compress_sharded(data, level=1, mesh=jshard.make_mesh(1))
    with pytest.raises(Corruption, match="offset beyond window"):
        zstd_tpu.decompress(jax_frame)
    frames = [port[w][name] for w in WORLDS]
    assert frames == [frames[0]] * len(WORLDS)
    assert zstd_tpu.decompress(frames[0]) == data


def _sources(ll, ml, off, nb_seq):
    """Each sequence's source position in its extended row."""
    ll, ml, off = (x[:nb_seq].astype(np.int64) for x in (ll, ml, off))
    start = tshard.HALO + np.cumsum(ll + ml) - ml
    return start - off


@pytest.mark.parametrize("world", WORLDS)
def test_compress_step_equal_jax(port, world):
    """Every block equals zstd_tpu's but block 0 of rank 0, whose halo is
    fabricated: there zstd_tpu's first match extends back into the halo
    and the port's stops at it (the same sequences, fewer extended
    bytes)."""
    blocks, lens = _step_input()
    want = {k: np.asarray(v) for k, v in jshard.compress_step(
        jshard.make_mesh(world), blocks, lens, hash_log=10, mls=5).items()}
    got = port[world]["step"]
    assert set(got) == set(want)
    for k in ("nb_seq", "ll", "off", "ml", "nb_lit", "lits"):
        np.testing.assert_array_equal(got[k][1:], want[k][1:], err_msg=k)
    np.testing.assert_array_equal(got["shard_seq_totals"],
                                  want["shard_seq_totals"])
    extra = int(got["nb_lit"][0]) - int(want["nb_lit"][0])
    np.testing.assert_array_equal(
        got["shard_lit_totals"],
        want["shard_lit_totals"] + extra * (np.arange(world) == 0))
    nb = int(got["nb_seq"][0])
    assert nb == int(want["nb_seq"][0]) > 0
    assert _sources(*(want[k][0] for k in ("ll", "ml", "off")), nb).min() \
        < tshard.HALO
    assert _sources(*(got[k][0] for k in ("ll", "ml", "off")), nb).min() \
        >= tshard.HALO
    assert extra > 0


def test_overlap_size_rule():
    for args in [(1, 20, 0), (8, 20, 0), (6, 18, 0), (4, 19, 0), (1, 20, 9),
                 (1, 20, 1), (1, 10, 3)]:
        assert tz.overlap_size(*args) == jz.overlap_size(*args)


def test_no_card_or_group_raises(monkeypatch):
    """compress_sharded runs on the card unless asked for the CPU, and never
    falls back: without a card it raises, and without a process group too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.compress_sharded(b"x" * 1000)
    with pytest.raises(RuntimeError, match="no process group"):
        tz.compress_sharded(b"x" * 1000, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tshard.make_group(device="cpu")
