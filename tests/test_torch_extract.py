"""zstd_tpu_torch's match proposal and serial extract against zstd_tpu's.

The JAX side is extract_batch_pallas with the Pallas kernel in interpret
mode; a spy on its extract_compact records the candidate and jump tables it
hands the kernel, so the port's propose ops and its plain scan
(extract_plain, what the CUDA kernel computes) are each held to their JAX
counterpart on the same rows. A Python model of the CUDA kernel's
segment-parallel walk (speculate, repair, emit) is held to extract_plain.
zstd is an exact codec: every comparison is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import gen_mixed, gen_text
from tests.walkmodel import propose_np, segment_walk
from zstd_tpu.ops import match as jmatch
from zstd_tpu.ops import resolve_pallas, seqextract
from zstd_tpu_torch.ops import match as tmatch
from zstd_tpu_torch.ops.resolve import (_lcp, extract_compact,
                                        extract_compact_stats, extract_plain)
from zstd_tpu_torch.ops.seqextract import extract_batch, next_possible

N = 8192
CAP = N // 8     # the pipeline's seq_cap (block_size // 8)


def _seed_rows(seed):
    """tests/test_pallas_kernel.py's seeded rows (two per seed)."""
    data = gen_text(N, seed) + gen_mixed(N, seed + 10)
    return np.frombuffer(data, np.uint8).reshape(2, N)


def _adversarial_rows():
    """tests/test_pallas_kernel.py's adversarial rows at width N, one zero
    row longer than the xla engine's 8164-byte match cap, and a row whose
    valid length stops short of N (zero-padded, as the pipeline pads)."""
    rng = np.random.default_rng(5)
    rle = (b"\x00" * 1000 + b"ab" * 500
           + rng.integers(0, 256, N - 2000, dtype=np.uint8).tobytes())
    m = rng.integers(0, 256, 128, dtype=np.uint8).tobytes()
    periodic = (m * (N // len(m) + 1))[:N]
    short = gen_text(5000, seed=7) + b"\x00" * (N - 5000)
    rows = np.frombuffer(rle + periodic + bytes(N) + short, np.uint8)
    return rows.reshape(4, N), np.array([N, N, N, 5000], np.int32)


def _overflow_rows():
    """Rows of 4-byte tokens from a small dictionary, each followed by a
    random byte: about one sequence per 5 bytes, so the scan reaches CAP and
    the rest of the row becomes trailing literals. Then random bytes and a
    row too short to hold a match."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    rows = []
    for _ in range(2):
        units = np.concatenate(
            [tokens[rng.integers(0, 16, N // 5 + 1)],
             rng.integers(0, 256, (N // 5 + 1, 1), dtype=np.uint8)], axis=1)
        rows.append(units.reshape(-1)[:N])
    rows.append(rng.integers(0, 256, N, dtype=np.uint8))
    rows.append(np.frombuffer(gen_text(N, seed=3), np.uint8))
    return np.stack(rows), np.array([N, N, N, 3], np.int32)


CASES = {
    "seeds": lambda: (np.concatenate([_seed_rows(0), _seed_rows(1)]),
                      np.full(4, N, np.int32), 11, 6),
    "adversarial": lambda: (*_adversarial_rows(), 10, 5),
    "overflow": lambda: (*_overflow_rows(), 12, 4),
}


def _jax_extract(monkeypatch, blocks, lens, hash_log, mls):
    """extract_batch_pallas (interpret mode) on numpy rows: its result as
    numpy, plus the unpadded cands and nxt that it passed to the kernel."""
    seen = {}
    kernel = resolve_pallas.extract_compact

    def spy(bp, cp, xp, vl, cap, interpret=False):
        seen["cands"] = np.asarray(cp)[:, :N]
        seen["nxt"] = np.asarray(xp)[:, :N]
        return kernel(bp, cp, xp, vl, cap, interpret=True)

    monkeypatch.setattr(resolve_pallas, "extract_compact", spy)
    res = seqextract.extract_batch_pallas(
        jnp.asarray(blocks), jnp.asarray(lens), hash_log, mls, CAP,
        interpret=True)
    return {k: np.asarray(v) for k, v in res.items()}, seen


def _assert_same_extract(got: dict, want: dict):
    for k in ("nb_seq", "nb_lit", "ll", "off", "ml"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for b, nl in enumerate(want["nb_lit"]):
        # the Pallas kernel never writes lits past nb_lit; the port zeroes them
        np.testing.assert_array_equal(got["lits"][b, :nl],
                                      want["lits"][b, :nl], err_msg=f"lits {b}")
        assert not got["lits"][b, nl:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_propose_ops_match_jax(monkeypatch, case):
    blocks, lens, hash_log, mls = CASES[case]()
    _, seen = _jax_extract(monkeypatch, blocks, lens, hash_log, mls)
    tb = torch.from_numpy(blocks.copy())
    tl = torch.from_numpy(lens)

    w32 = tmatch.words_at(tb)
    np.testing.assert_array_equal(
        w32.numpy(), np.asarray(jax.vmap(jmatch.words_at)(blocks), np.int64))
    h = tmatch.hash_positions(tb, hash_log, mls, w32)
    want_h = jax.vmap(lambda b: jmatch.hash_positions(b, hash_log, mls))(
        jnp.asarray(blocks))
    np.testing.assert_array_equal(h.numpy(), np.asarray(want_h, np.int64))
    cands = tmatch.prev_same_bucket(h, tl)
    np.testing.assert_array_equal(cands.numpy(), seen["cands"])
    np.testing.assert_array_equal(next_possible(tb, cands, w32).numpy(),
                                  seen["nxt"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_plain_matches_pallas_kernel(monkeypatch, case):
    blocks, lens, hash_log, mls = CASES[case]()
    want, _ = _jax_extract(monkeypatch, blocks, lens, hash_log, mls)
    got = extract_batch(torch.from_numpy(blocks.copy()),
                        torch.from_numpy(lens), hash_log, mls, CAP)
    _assert_same_extract({k: v.numpy() for k, v in got.items()}, want)
    if case == "overflow":
        assert list(want["nb_seq"][:2]) == [CAP, CAP]
    if case == "adversarial":     # one match across the whole zero row
        assert want["nb_seq"][2] == 1 and want["ml"][2, 0] == N - 1


def test_extract_compact_takes_plain_version_on_cpu():
    blocks, lens, hash_log, mls = CASES["seeds"]()
    tb = torch.from_numpy(blocks.copy())
    tl = torch.from_numpy(lens)
    w32 = tmatch.words_at(tb)
    cands = tmatch.prev_same_bucket(
        tmatch.hash_positions(tb, hash_log, mls, w32), tl)
    nxt = next_possible(tb, cands, w32)
    got = extract_compact(tb, cands, nxt, tl, CAP)
    want = extract_plain(tb, cands, nxt, tl, CAP)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert torch.equal(g, w)


def test_extract_compact_stats_needs_the_kernel():
    blocks = torch.zeros((1, 64), dtype=torch.uint8)
    cands = torch.full((1, 64), -1, dtype=torch.int32)
    lens = torch.full((1,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        extract_compact_stats(blocks, cands, cands, lens, 8)


def test_extract_compact_rejects_other_devices():
    meta = torch.empty((1, 64), dtype=torch.uint8, device="meta")
    cands = torch.empty((1, 64), dtype=torch.int32, device="meta")
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        extract_compact(meta, cands, cands, lens, 8)


# ---- the segment-parallel walk of csrc/extract.cu (tests/walkmodel.py) ----

def _long_run_rows():
    """Random rows with zero runs that start in the middle of a segment and
    cover several segments (at S = 7 and 32), one of them running to the end
    of the row, and one row whose valid length cuts a run short."""
    rng = np.random.default_rng(17)
    rows = rng.integers(0, 256, (3, N), dtype=np.uint8)
    rows[0, 1000:3000] = 0
    rows[0, 5500:5700] = 0
    rows[1, 4321:] = 0
    rows[2, 777:6001] = 0
    return rows, np.array([N, N, 6000], np.int32), 12, 6


MODEL_CASES = {**CASES, "long_runs": _long_run_rows}


@pytest.mark.parametrize("S", [1, 2, 7, 32, 1024])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_segment_walk_model_matches_extract_plain(case, S):
    blocks, lens, hash_log, mls = MODEL_CASES[case]()
    cands, nxt = propose_np(blocks, lens, hash_log, mls)
    want = extract_plain(torch.from_numpy(blocks.copy()),
                         torch.from_numpy(cands), torch.from_numpy(nxt),
                         torch.from_numpy(lens), CAP)
    want = [w.numpy() for w in want]
    rounds = []
    for b in range(len(blocks)):
        ll, off, ml, lits, stats = segment_walk(
            blocks[b].tobytes(), cands[b].tolist(), nxt[b].tolist(),
            int(lens[b]), CAP, S)
        k = want[4][b]
        assert len(ll) == k, (b, len(ll), k)
        np.testing.assert_array_equal(ll, want[0][b, :k])
        np.testing.assert_array_equal(off, want[1][b, :k])
        np.testing.assert_array_equal(ml, want[2][b, :k])
        assert len(lits) == want[5][b]
        assert lits == want[3][b, :len(lits)].tobytes()
        rounds.append(stats[2])
    if case == "overflow":
        assert list(want[4][:2]) == [CAP, CAP]
    if case == "seeds" and S == 1024:   # 8-byte segments: chains meet late
        assert max(rounds) > 2


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_jump_table_reduces_walk_to_one_step_per_match(case):
    """On the serial scan's own path: ip matches iff nxt[ip] == ip, and a
    miss jumps straight to nxt[ip]; so the walk is p -> m = nxt[p] -> m + l."""
    blocks, lens, hash_log, mls = MODEL_CASES[case]()
    cands, nxt = propose_np(blocks, lens, hash_log, mls)
    for b in range(len(blocks)):
        buf, cd, nx = blocks[b].tobytes(), cands[b], nxt[b]
        vl = int(lens[b])
        ip = 0
        while ip < vl - 8:
            c = int(cd[ip])
            l = _lcp(buf, ip, c, vl - ip) if c >= 0 else 0
            assert (l >= 4) == (nx[ip] == ip), (b, ip)
            if l >= 4:
                ip += l
            else:
                assert max(int(nx[ip + 1]), ip + 1) == nx[ip]
                ip = int(nx[ip])
