"""The spans and counters of the one-frame sharded encode
(parallel.zstdmt.compress_sharded: zstd_tpu_torch.trace's Recorder and
zstdmt.COUNTS) in a gloo group of 2 spawned ranks on the CPU
(tests/torchdist.py, job kind "traced"): each rank's span tree, the counts
against a recount, the phase functions called through the module's
globals, and the frames with recording off, on and with every phase
wrapped against zstd_tpu's on a mesh of 2."""

import pytest

import zstd_tpu
from tests.conftest import gen_text
from tests.torchdist import PHASES, run_groups
from zstd_tpu.parallel import shard_compress as jshard
from zstd_tpu.parallel import zstdmt as jz
from zstd_tpu_torch.params import get_cparams
from zstd_tpu_torch.pipeline import STATS_LEN
from zstd_tpu_torch.parallel import zstdmt as tz

WORLD = 2
DATA = gen_text(400_000, seed=23)
KW = dict(level=1, checksum=True)
BLOCK = 128 * 1024
PHASE_SPANS = ["stage_in", "halo_exchange", "stage_a", "stats_gather", "plan",
               "stage_b", "parts_gather"]
STITCH_SPANS = ["finalize", "assemble"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's result of the traced job, in rank order."""
    out = run_groups([WORLD], str(tmp_path_factory.mktemp("traced")),
                     [("traced", "traced", dict(data=DATA, **KW))])
    return out[WORLD]["traced"]


def test_frames_with_recording_off_and_on(ranks):
    """Recording and wrapping change no byte: rank 0's three frames equal
    zstd_tpu's on a mesh of 2; the other rank returns None."""
    want = jz.compress_sharded(DATA, mesh=jshard.make_mesh(WORLD), **KW)
    assert ranks[0]["frames"] == (want, want, want)
    assert ranks[1]["frames"] == (None, None, None)
    assert zstd_tpu.decompress(want) == DATA
    assert [r["off_spans"] for r in ranks] == [[]] * WORLD


@pytest.mark.parametrize("rank", range(WORLD))
def test_span_tree(ranks, rank):
    """One call, one root `compress_sharded`; its children the phases in
    order, the stitch's two on rank 0 only; spans nest in their parent and
    the children do not overlap."""
    spans = ranks[rank]["spans"]
    names = [s[0] for s in spans]
    assert names[0] == "compress_sharded" and spans[0][4] == -1
    assert len({s[5] for s in spans}) == 1
    kids = [s for s in spans if s[4] == 0]
    want = PHASE_SPANS + (STITCH_SPANS if rank == 0 else [])
    assert [s[0] for s in kids] == want
    assert sorted(names) == sorted(["compress_sharded"] + want)
    root = spans[0]
    for s in kids:
        assert root[1] <= s[1] <= s[2] <= root[2]
    for a, b in zip(kids, kids[1:]):
        assert a[2] <= b[1]


@pytest.mark.parametrize("rank", range(WORLD))
def test_counts_equal_a_recount(ranks, rank):
    """calls 1; blocks: the rank's blocks with content; halo_bytes: one
    halo (the level's overlap) in front of each; gathered_bytes: every
    block's stats and sizes rows and every rank's part."""
    r = ranks[rank]
    n = len(DATA)
    cp = get_cparams(KW["level"], n)
    halo = tz.overlap_size(cp.strategy, cp.window_log)
    assert halo == 65536
    nb = -(-n // BLOCK)
    b_pad = -(-nb // WORLD) * WORLD
    rows = b_pad // WORLD
    own = max(min(rows * (rank + 1), nb) - rows * rank, 0)
    assert own == 2
    assert r["part_bytes"]
    assert len({x["part_bytes"][0] for x in ranks}) == 1
    assert r["moved"] == {
        "calls": 1, "blocks": own, "halo_bytes": own * halo,
        "gathered_bytes": b_pad * (STATS_LEN + 7) * 4 + r["part_bytes"][0]}


@pytest.mark.parametrize("rank", range(WORLD))
def test_phases_are_called_through_the_module(ranks, rank):
    """A wrapper set on the module sees each phase as often as PHASES says
    a call; the stitch runs on rank 0 only."""
    calls = ranks[rank]["calls"]
    want = {p: k for p, k in PHASES.items() if p != "stitch" or rank == 0}
    assert calls == want
