"""zstd_tpu_torch's host codec (format/codec.py over the C of csrc/host) on
the CPU, against zstd_tpu's with its C library loaded.

- `format.codec.compress` frames equal zstd_tpu's at levels -5 to 22 on
  0 B, 90 B (the per-block loop below 128 B), 64 KiB of gen_text and
  200 KiB of big_corpus (the three whole-frame C paths, and the two-pass
  portfolio of strategies 6 and up), 300 KiB at level 19 (past the
  portfolio) and long_mode at level 5; the port's `decompress` inverts
  each frame.
- The C copies equal zstd_tpu's call by call: the fast, double-fast, row
  and chain-lazy parses and the DP (with and without a carried context, and
  the keep-min candidates) over a chain of blocks whose tables carry
  across, and the three whole-frame calls; the Python lazy ladder equals
  zstd_tpu's.
"""

import dataclasses

import numpy as np
import pytest

import zstd_tpu
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from zstd_tpu import params as jparams
from zstd_tpu.format import block as jblock
from zstd_tpu.format import codec as jcodec
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import lazy as jlazy
from zstd_tpu.format import opt as jopt
from zstd_tpu.native import get_native
from tests.refnative import reference_native
from zstd_tpu_torch import native as tnative
from zstd_tpu_torch import params as tparams
from zstd_tpu_torch.errors import ZstdError
from zstd_tpu_torch.format import block as tblock
from zstd_tpu_torch.format import codec as tcodec
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.format import lazy as tlazy
from zstd_tpu_torch.format import opt as topt

LEVELS = (-5, 1, 3, 5, 9, 13, 19, 22)
INPUTS = {"empty": b"", "tiny": gen_text(90, seed=1),
          "text64k": gen_text(64 * 1024, seed=2),
          "big200k": big_corpus(200 * 1024)}
FULL = np.frombuffer(big_corpus(320 * 1024), dtype=np.uint8)
# (window_low, block_start, block_end): a chain whose tables carry across
BLOCKS = ((0, 0, 131_072), (0, 131_072, 262_144),
          (100_000, 262_144, len(FULL)))


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert reference_native() is not None, \
        "zstd_tpu's C library is not built"


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
def test_compress_equals_jax(level, name):
    data = INPUTS[name]
    want = jcodec.compress(data, level=level, checksum=True)
    got = tcodec.compress(data, level=level, checksum=True)
    assert got == want
    assert tcodec.decompress(got) == data


def test_past_the_portfolio_equals_jax():
    data = big_corpus(300 * 1024)
    want = jcodec.compress(data, level=19)
    assert tcodec.compress(data, level=19) == want
    assert tcodec.decompress(want) == data


def test_long_mode_equals_jax():
    data = INPUTS["big200k"] * 2
    want = jcodec.compress(data, level=5, long_mode=True, window_log=20)
    got = tcodec.compress(data, level=5, long_mode=True, window_log=20)
    assert got == want
    assert tcodec.decompress(got) == data


def test_decompress_frames_and_errors():
    a = tcodec.compress(INPUTS["text64k"], level=3)
    skip = jframe.write_skippable_frame(b"user data")
    assert tcodec.decompress(a + skip + a) == INPUTS["text64k"] * 2
    with pytest.raises(ZstdError, match="empty"):
        tcodec.decompress(b"")
    with pytest.raises(ZstdError, match="legacy"):
        tcodec.decompress((0xFD2FB523).to_bytes(4, "little") + b"\0" * 8)
    with pytest.raises(ZstdError, match="truncated skippable"):
        tcodec.decompress(skip[:-1])


@pytest.mark.parametrize("threshold", (0.35, 0.45))
def test_split_points_threshold_equals_jax(threshold):
    full = np.frombuffer(INPUTS["text64k"] + bytes(FULL[:200_000]),
                         dtype=np.uint8)
    seen = 0
    for bs in range(0, len(full) - 131_072, 20_000):
        want = jframe._split_points(full, bs, bs + 131_072,
                                    threshold=threshold)
        assert tframe._split_points(full, bs, bs + 131_072,
                                    threshold=threshold) == want
        seen += bool(want)
    assert seen


# ---- the C copies, call by call ---------------------------------------------

def _cparams(level: int, n: int = len(FULL), **over):
    j = dataclasses.replace(jparams.get_cparams(level, n), **over)
    t = dataclasses.replace(tparams.get_cparams(level, n), **over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _same_store(got, want):
    assert got is not None and want is not None
    assert got[1] == want[1]
    for f in ("lit_length", "off_base", "ml_base", "literals"):
        assert np.array_equal(np.asarray(getattr(got[0], f)),
                              np.asarray(getattr(want[0], f))), f


PARSERS = [
    # (finder, level, cparams overrides): every level's own C parser
    ("find_sequences_fast", 1, {}),
    ("find_sequences_fast", -5, {}),
    ("find_sequences_dfast", 3, {}),
    ("find_sequences_row", 3, {}),
    ("find_sequences_row", 5, {}),
    ("find_sequences_row", 9, {}),                   # strategy 5
    ("find_sequences_chainlazy", 3, {}),
    ("find_sequences_chainlazy", 5, {}),
    ("find_sequences_chainlazy", 9, {"search_log": 6}),
    ("find_sequences_shallow_dp", 9, {"search_log": 6}),
    ("find_sequences_opt", 13, {}),
    ("find_sequences_opt", 19, {}),
]


@pytest.mark.parametrize("case,carried", [
    (k, c) for k, (fn, _, _) in enumerate(PARSERS) for c in (True, False)
    # the shallow DP runs only with a carried context
    if c or fn != "find_sequences_shallow_dp"])
def test_parsers_equal_c(case, carried):
    """Each block's parse equals zstd_tpu's; with `carried`, a BlockCState
    carries the tables / the DP context across the chain (stale entries
    under a raised window_low included); without, fresh tables index the
    window prefix."""
    fn, level, over = PARSERS[case]
    cj, ct = _cparams(level, **over)
    js = jblock.BlockCState() if carried else None
    ts = tblock.BlockCState() if carried else None
    reps = (1, 4, 8)
    nb_seq = 0
    for wl, bs, be in BLOCKS:
        want = getattr(jopt, fn)(FULL, bs, be, wl, reps, cj, state=js)
        got = getattr(topt, fn)(FULL, bs, be, wl, reps, ct, state=ts)
        _same_store(got, want)
        nb_seq += got[0].nb_seq
        reps = want[1]
    assert nb_seq > 5000


@pytest.mark.parametrize("level", (3, 5, 9, 19))
def test_lazy_ladder_equals_jax(level):
    """The Python lazy ladder (find_sequences_opt's branch where the C DP
    declines) on a block after a window prefix, and on a block too short to
    parse."""
    cj, ct = _cparams(level, 40_000)
    full = FULL[:40_000]
    for wl, bs, be in ((0, 0, 24_000), (4_000, 24_000, 40_000),
                       (0, 100, 103)):
        want = jlazy.find_sequences_lazy(full, bs, be, wl, (1, 4, 8), cj)
        got = tlazy.find_sequences_lazy(full, bs, be, wl, (1, 4, 8), ct)
        _same_store(got, want)


def test_opt_dual_candidates_equal_c():
    """The keep-min parse's candidates block by block, with the winner's
    context committed on both sides."""
    cj, ct = _cparams(19)
    js, ts = jblock.BlockCState(), tblock.BlockCState()
    reps = (1, 4, 8)
    for k, (wl, bs, be) in enumerate(BLOCKS):
        want = jopt.find_sequences_opt_dual(FULL, bs, be, wl, reps, cj, js)
        got = topt.find_sequences_opt_dual(FULL, bs, be, wl, reps, ct, ts)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same_store(g[:2], w[:2])
        pick = k % 3                  # keep 0, then a re-parse, then another
        want[pick][2]()
        got[pick][2]()
        reps = want[pick][1]


def test_opt_parse_without_context_equals_c():
    nat = get_native()
    for wl, bs, be in BLOCKS:
        for strategy, sl in ((7, 4), (9, 8)):
            want = nat.opt_parse(FULL, wl, bs, be, (1, 4, 8), 20, sl, 3,
                                 256, strategy)
            got = tnative.opt_parse(FULL, wl, bs, be, (1, 4, 8), 20, sl, 3,
                                    256, strategy)
            assert got[3] == want[3]
            for g, w in zip(got[:3], want[:3]):
                assert np.array_equal(g, w)


def test_lazy_parse_without_long_table_equals_c():
    nat = get_native()
    for wl, bs, be in BLOCKS:
        heads = [np.full(1 << 16, -1, np.int32) for _ in range(2)]
        chains = [np.full(1 << 16, -1, np.int32) for _ in range(2)]
        nat.lazy_fill(FULL, wl, bs, 16, 16, 5, heads[0], chains[0])
        tnative.lazy_fill(FULL, wl, bs, 16, 16, 5, heads[1], chains[1])
        assert np.array_equal(heads[0], heads[1])
        assert np.array_equal(chains[0], chains[1])
        want = nat.lazy_parse(FULL, wl, bs, be, (1, 4, 8), 16, 16, 5, 64, 1,
                              8, heads[0], chains[0])
        got = tnative.lazy_parse(FULL, wl, bs, be, (1, 4, 8), 16, 16, 5, 64,
                                 1, 8, heads[1], chains[1])
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w)


FRAME_INPUTS = {"text64k": INPUTS["text64k"], "big320k": bytes(FULL)}


@pytest.mark.parametrize("name", sorted(FRAME_INPUTS))
def test_whole_frame_calls_equal_c(name):
    nat = get_native()
    full = np.frombuffer(FRAME_INPUTS[name], dtype=np.uint8)
    n = len(full)
    for hash_log, mls, step0 in ((17, 4, 1), (14, 6, 3)):
        tabs = [np.full(2 << hash_log, -1, np.int32) for _ in range(2)]
        want = nat.compress_fast_frame(full, 0, n, 1 << 19, 131_072,
                                       hash_log, 8, mls, step0, 1, tabs[0])
        got = tnative.compress_fast_frame(full, 0, n, 1 << 19, 131_072,
                                          hash_log, 8, mls, step0, 1, tabs[1])
        assert got == want and want is not None
        assert np.array_equal(tabs[0], tabs[1])
    for strategy, row_log, width_log, attempts, defer in (
            (2, 13, 4, 8, 1), (3, 14, 4, 16, 1), (5, 13, 5, 32, 2)):
        args = [strategy, row_log, width_log, 5, attempts, defer]
        tabs = [(np.full(1 << (row_log + width_log), -1, np.int32),
                 np.zeros(1 << (row_log + width_log), np.uint8),
                 np.zeros(1 << row_log, np.uint8),
                 np.full(2 << 17, -1, np.int32)) for _ in range(2)]
        want = nat.compress_row_frame(full, 0, n, 1 << 19, 131_072, *args,
                                      *tabs[0], 17)
        got = tnative.compress_row_frame(full, 0, n, 1 << 19, 131_072,
                                         *args, *tabs[1], 17)
        assert got == want
    for strategy, sl, tl in ((8, 4, 32), (6, 11, 999), (7, 8, 256)):
        want = nat.compress_dp_frame(full, 0, n, 1 << 19, 131_072, strategy,
                                     18, sl, 4, tl)
        got = tnative.compress_dp_frame(full, 0, n, 1 << 19, 131_072,
                                        strategy, 18, sl, 4, tl)
        assert got == want
        # the near-random tail of big320k makes the C decline (None)
        if name == "text64k":
            assert zstd_tpu.decompress(jframe.write_frame_header(
                n, 19, False) + got) == FRAME_INPUTS[name]
