"""zstd_tpu_torch's level-1 device encode, end to end on the CPU, against
zstd_tpu's pipeline with the `pallas` engine in interpret mode.

That engine is the reference: the xla engine caps matches at 8164 bytes and
backward extension at 16, so its frames differ (150,000 zero bytes: 90 B
there, 37 B here). Frames must be byte-identical, and zstd_tpu decodes them.
"""

import functools

import pytest

import zstd_tpu
from tests.test_tpu_pipeline import CASES
from zstd_tpu import pipeline as jpipe
from zstd_tpu.ops import seqextract
from zstd_tpu_torch import pipeline as tpipe


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


@pytest.mark.parametrize("level, data", [(5, CASES[0]), (4, CASES[2])])
def test_lazy_levels_raise(level, data):
    """Strategy >= 3 (greedy and up) takes zstd_tpu's lazy engine, which the
    port does not have; level 4 is greedy for inputs up to 256 KB."""
    with pytest.raises(NotImplementedError, match="lazy"):
        tpipe.compress(data, level=level, device="cpu")
