"""zstd_tpu_torch's device encode, end to end on the CPU, against
zstd_tpu's pipeline.

Levels below strategy 3 are held to zstd_tpu's `pallas` engine in
interpret mode: the xla engine caps matches at 8164 bytes and backward
extension at 16, so its frames differ (150,000 zero bytes: 90 B there,
37 B here). Levels 5 and up (and level 4 up to 256 KB, greedy there) take
the lazy engine in both packages, with ZSTD_TPU_ENGINE and
ZSTD_TPU_DEV_ROW_WIDTH unset; the v3 engine is held to ZSTD_TPU_ENGINE=v3.
Frames must be byte-identical, and zstd_tpu decodes them.
"""

import functools

import pytest

import zstd_tpu
from tests.test_tpu_pipeline import CASES
from zstd_tpu import pipeline as jpipe
from zstd_tpu.ops import seqextract
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.params import get_cparams


@pytest.fixture
def jax_reference(monkeypatch):
    """zstd_tpu.pipeline with ZSTD_TPU_ENGINE=pallas and the Pallas kernel
    interpreted; the engine choice is uncached again afterwards."""
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


@pytest.fixture
def jax_engine(monkeypatch):
    """zstd_tpu.pipeline with the engine chosen by level (ZSTD_TPU_ENGINE and
    ZSTD_TPU_DEV_ROW_WIDTH unset); `set_engine("v3")` forces one."""
    monkeypatch.delenv("ZSTD_TPU_ENGINE", raising=False)
    monkeypatch.delenv("ZSTD_TPU_DEV_ROW_WIDTH", raising=False)
    jpipe._engine_kind.cache_clear()

    def set_engine(name):
        monkeypatch.setenv("ZSTD_TPU_ENGINE", name)
        jpipe._engine_kind.cache_clear()

    try:
        yield jpipe, set_engine
    finally:
        monkeypatch.undo()
        jpipe._engine_kind.cache_clear()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_frame_matches_jax_pallas(jax_reference, i):
    data = CASES[i]
    want = jax_reference.compress(data, level=1, checksum=True)
    got = tpipe.compress(data, level=1, checksum=True, device="cpu")
    assert got == want
    assert zstd_tpu.decompress(got) == data


@pytest.mark.parametrize("level", [2, 4, -1])
def test_other_fast_levels_match(jax_reference, level):
    data = CASES[1] + CASES[2]     # > 256 KB: level 4 is dfast there
    want = jax_reference.compress(data, level=level)
    got = tpipe.compress(data, level=level, device="cpu")
    assert got == want
    assert zstd_tpu.decompress(got) == data


def test_compress_resident_matches(jax_reference):
    data = CASES[1]
    want = jax_reference.TpuCompressor(level=1).compress_resident(data)
    comp = tpipe.TorchCompressor(level=1, device="cpu")
    assert comp.compress_resident(data) == want > 0


def test_small_batches_and_empty_input():
    data = CASES[1] + CASES[3] + CASES[2]      # four blocks: four batches of one
    one = tpipe.compress(data, level=1, device="cpu")
    assert tpipe.compress(data, level=1, batch_blocks=1, device="cpu") == one
    assert zstd_tpu.decompress(one) == data
    empty = tpipe.compress(b"", checksum=True, device="cpu")
    assert zstd_tpu.decompress(empty) == b""


@pytest.mark.parametrize("level, case", [(5, 0), (4, 2)])
def test_lazy_levels_match(jax_engine, level, case):
    """Strategy >= 3 (greedy and up) takes the lazy engine; level 4 is
    greedy for inputs up to 256 KB."""
    jp, _ = jax_engine
    data = CASES[case]
    assert get_cparams(level, len(data)).strategy >= 3
    want = jp.compress(data, level=level)
    got = tpipe.compress(data, level=level, device="cpu")
    assert got == want
    assert zstd_tpu.decompress(got) == data


@pytest.mark.parametrize("level, hash_log", [(5, 19), (9, 20), (19, 20)])
def test_lazy_levels_340k(jax_engine, level, hash_log):
    """Three blocks of 340 KB: greedy (level 5), lazy (9), and a level >= 18
    (the literals' min-gain branch); hash_log 20 at 9 and 19, where the
    bucket hash's products pass 2^24."""
    jp, _ = jax_engine
    data = CASES[1] + CASES[2]
    assert get_cparams(level, len(data)).hash_log == hash_log
    want = jp.compress(data, level=level, checksum=True)
    got = tpipe.compress(data, level=level, checksum=True, device="cpu")
    assert got == want
    assert zstd_tpu.decompress(got) == data


def test_lazy_small_batches():
    """One block a batch gives the same lazy frame as 32 blocks a batch."""
    data = CASES[1] + CASES[2]
    one = tpipe.compress(data, level=5, batch_blocks=1, device="cpu")
    assert one == tpipe.compress(data, level=5, device="cpu")


def test_lazy_compress_resident(jax_engine):
    jp, _ = jax_engine
    data = CASES[1]
    want = jp.TpuCompressor(level=5).compress_resident(data)
    comp = tpipe.TorchCompressor(level=5, device="cpu")
    assert comp.compress_resident(data) == want > 0


@pytest.mark.parametrize("level", [1, 3])
def test_v3_engine_matches(jax_engine, level):
    jp, set_engine = jax_engine
    set_engine("v3")
    data = CASES[1] + CASES[2]
    want = jp.compress(data, level=level)
    got = tpipe.compress(data, level=level, device="cpu", engine="v3")
    assert got == want
    assert zstd_tpu.decompress(got) == data


def test_engine_argument():
    xla = tpipe.compress(CASES[0], level=1, device="cpu", engine="xla")
    assert zstd_tpu.decompress(xla) == CASES[0]
    with pytest.raises(ValueError, match="unknown engine"):
        tpipe.compress(CASES[0], level=1, device="cpu", engine="lazy")
    forced = tpipe.compress(CASES[0], level=5, device="cpu", engine="pallas")
    assert zstd_tpu.decompress(forced) == CASES[0]
