"""zstd_tpu_torch's device encode under engine="xla", end to end on the CPU,
against zstd_tpu.pipeline with ZSTD_TPU_ENGINE=xla, at levels 1, 2 and 5
(the engine overrides the level in both packages) on the six CASES of
tests/test_tpu_pipeline.py and a 16 KiB zero block.

Frames must be byte-identical, except where zstd_tpu's frame is corrupt: a
block with more sequences than its seqstore's seq_cap columns (the xla
engine does not stop at the cap). zstd_tpu packs it anyway and no decoder
takes the frame; the port stores that block raw (ROADMAP §3), and its
frame decodes (`test_seqstore_overflow_pins_reference_fault`).
"""

import numpy as np
import pytest
import torch

import zstd_tpu
from tests.test_tpu_pipeline import CASES
from zstd_tpu import pipeline as jpipe
from zstd_tpu.errors import Corruption
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.params import get_cparams

INPUTS = list(CASES) + [b"\x00" * 16384]
# (level, input) whose zstd_tpu frame overflows a seqstore: short text
# matches at mls 4 (level 2) and 5 (level 5) pass block_size / 8
OVERFLOW = {(2, 0), (2, 1), (5, 0), (5, 1)}


@pytest.fixture
def jax_xla(monkeypatch):
    """zstd_tpu.pipeline under ZSTD_TPU_ENGINE=xla; the engine choice is
    uncached again afterwards."""
    monkeypatch.setenv("ZSTD_TPU_ENGINE", "xla")
    jpipe._engine_kind.cache_clear()
    try:
        yield jpipe
    finally:
        monkeypatch.undo()
        jpipe._engine_kind.cache_clear()


@pytest.mark.parametrize("level, i", [
    (level, i) for level in (1, 2, 5) for i in range(len(INPUTS))
    if (level, i) not in OVERFLOW])
def test_xla_frames_match(jax_xla, level, i):
    data = INPUTS[i]
    want = jax_xla.compress(data, level=level, checksum=True)
    got = tpipe.compress(data, level=level, checksum=True, device="cpu",
                         engine="xla")
    assert got == want
    assert zstd_tpu.decompress(got) == data


@pytest.mark.parametrize("level, i", sorted(OVERFLOW))
def test_seqstore_overflow_pins_reference_fault(jax_xla, level, i):
    data = INPUTS[i]
    cp = get_cparams(level, len(data))
    block_size = min(1 << cp.window_log, 128 * 1024)
    seq_cap = max(block_size // 8, 8)
    n = min(len(data), block_size)
    blocks = torch.zeros((1, block_size), dtype=torch.uint8)
    blocks[0, :n] = torch.from_numpy(np.frombuffer(data[:n], np.uint8).copy())
    stats, _ = tpipe._analyze(blocks, torch.tensor([n], dtype=torch.int32),
                              cp.hash_log, min(max(cp.min_match, 4), 8),
                              seq_cap, "xla")
    assert int(stats[0, tpipe._STATS_TAIL + 3]) > seq_cap   # nb_seq
    with pytest.raises(Corruption):
        zstd_tpu.decompress(jax_xla.compress(data, level=level,
                                             checksum=True))
    got = tpipe.compress(data, level=level, checksum=True, device="cpu",
                         engine="xla")
    assert zstd_tpu.decompress(got) == data
