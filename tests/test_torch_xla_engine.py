"""The xla match engine of zstd_tpu_torch (ops/match.py, ops/seqextract.
extract_batch_xla) against zstd_tpu.ops.match and zstd_tpu.ops.seqextract
on the CPU, on the same seeded rows: exact equality.

Rows of 16 KiB: zeros (every length reaches the 8164 cap), period 4 and 8,
random over alphabets of 3 and 256, text; valid lengths n, n - 5 and
n - 3000. The one difference is the port's repair of a fabricated halo (a
row whose halo_ok is False): its backward extension never takes the
candidate's side below emit_from, where zstd_tpu's does
(`test_fabricated_halo_extension_is_capped`). tests/xlaextractmodel.py, a
model of csrc/xla_walk.cu (segments, speculate, repair rounds, emit), is
held to the kernel's plain chain, seqextract.xla_extract_plain.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import gen_text
from tests.xlaextractmodel import extract_row
from zstd_tpu.ops import match as jm
from zstd_tpu.ops import seqextract as js
from zstd_tpu_torch.ops import match as tm
from zstd_tpu_torch.ops import seqextract as ts

N = 16384
VLENS = np.array([N, N - 5, N - 3000], np.int32)
KINDS = ["zero", "period4", "period8", "alphabet3", "random", "text"]
HASH_LOG, MLS = 13, 5


def rows(kind: str) -> np.ndarray:
    """u8[3, N]: three rows of one kind, seeded."""
    out = []
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        if kind == "zero":
            r = np.zeros(N, np.uint8)
        elif kind.startswith("period"):
            p = int(kind[6:])
            r = np.tile(rng.integers(0, 256, p, dtype=np.uint8), N // p)
        elif kind == "alphabet3":
            r = rng.integers(0, 3, N, dtype=np.uint8)
        elif kind == "random":
            r = rng.integers(0, 256, N, dtype=np.uint8)
        else:
            r = np.frombuffer(gen_text(N, seed=seed), np.uint8)
        out.append(r)
    return np.stack(out)


# zstd_tpu's per-block functions, vmapped over the rows and compiled once
J_CANDS = jax.jit(jax.vmap(lambda b, v: jm.prev_same_bucket(
    jm.hash_positions(b, HASH_LOG, MLS), v)))
J_MLEN = jax.jit(jax.vmap(jm.match_lengths))
J_BACK = jax.jit(jax.vmap(jm.backward_extension))
J_GREEDY = jax.jit(jax.vmap(jm.greedy_resolve, in_axes=(0, 0, None)),
                   static_argnums=2)
J_FIND = jax.jit(jax.vmap(
    lambda b, v, e, h: jm.find_matches_block(b, v, HASH_LOG, MLS,
                                             emit_from=e, halo_ok=h)))
J_EXTRACT = jax.jit(js.extract_batch, static_argnums=(2, 3, 4))


def jax_cands(blocks: np.ndarray, vlens) -> np.ndarray:
    return np.asarray(J_CANDS(jnp.asarray(blocks), jnp.asarray(vlens)))


HALOS = [(0, True), (3000, False), (3000, True), (N - 12, False)]
KEYS = ("nb_seq", "ll", "off", "ml", "lit_idx", "nb_lit", "overflow")


@functools.lru_cache(maxsize=None)
def jax_find(kind: str) -> list:
    """zstd_tpu's find_matches_block of rows(kind) for each of HALOS:
    [(committed, match_len, cand)] as numpy arrays, computed once."""
    blocks = rows(kind)
    return [tuple(np.asarray(x) for x in J_FIND(
        jnp.asarray(blocks), jnp.asarray(VLENS), jnp.full(3, ef, jnp.int32),
        jnp.full(3, hok))) for ef, hok in HALOS]


# the model's cases, one emit_from / halo_ok per row (valid lengths N,
# N - 5, N - 3000): emit_from at 0, inside the row, at valid_len - 12 and
# past it; a fabricated halo; seq_cap 64 overflows
MODEL_CASES = [(np.array([0, 3000, N - 3012], np.int32),
                np.array([True, False, True]), 2048),
               (np.array([N - 12, 0, 100], np.int32),
                np.array([False, True, False]), 64)]


@functools.lru_cache(maxsize=None)
def plain_extracts(kind: str) -> list:
    """For each of MODEL_CASES: (cands, xla_extract_plain's outputs) on
    rows(kind), as numpy arrays, computed once."""
    blocks = rows(kind)
    out = []
    for efs, hoks, cap in MODEL_CASES:
        cands = tm.banned_candidates(t(blocks), t(VLENS), HASH_LOG, MLS,
                                     t(efs), t(hoks))
        res = ts.xla_extract_plain(t(blocks), cands, t(VLENS), t(efs),
                                   t(hoks), cap)
        out.append((cands.numpy(), {k: v.numpy() for k, v in res.items()}))
    return out


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", KINDS)
def test_match_lengths_and_backward_extension(kind):
    blocks = rows(kind)
    cands = jax_cands(blocks, VLENS)
    got = tm.match_lengths(t(blocks), t(cands), t(VLENS)).numpy()
    back = tm.backward_extension(t(blocks), t(cands)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J_MLEN(
        jnp.asarray(blocks), jnp.asarray(cands), jnp.asarray(VLENS))))
    np.testing.assert_array_equal(back, np.asarray(J_BACK(
        jnp.asarray(blocks), jnp.asarray(cands))))
    if kind == "zero":
        assert got.max() == tm.MLEN_CAP == 8164


@pytest.mark.parametrize("seed", range(4))
def test_greedy_resolve(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    take = rng.integers(0, 12, (3, n)).astype(np.int32)
    take[rng.random((3, n)) < 0.6] = 0
    take[0, ::97] = 300
    vlens = np.array([n, n - 7, 100], np.int32)
    got = tm.greedy_resolve(t(take), t(vlens), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(J_GREEDY(
        jnp.asarray(take), jnp.asarray(vlens), 12)))


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_block(kind):
    blocks = rows(kind)
    for (ef, hok), want in zip(HALOS, jax_find(kind)):
        got = tm.find_matches_block(t(blocks), t(VLENS), HASH_LOG, MLS,
                                    torch.full((3,), ef, dtype=torch.int32),
                                    torch.full((3,), hok))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
def test_walk_plain_is_the_jax_chain(kind):
    """The walk's plain chain: committed and take_len = where(committed,
    mlen, 0) of zstd_tpu's find_matches_block."""
    blocks = rows(kind)
    for (ef, hok), (jc, jl, _) in zip(HALOS, jax_find(kind)):
        efs = np.full(3, ef, np.int32)
        cands = tm.banned_candidates(t(blocks), t(VLENS), HASH_LOG, MLS,
                                     t(efs), torch.full((3,), hok))
        com, take = tm.xla_walk_plain(t(blocks), cands, t(VLENS), t(efs))
        assert com.dtype == torch.uint8 and take.dtype == torch.int32
        np.testing.assert_array_equal(com.numpy(), jc)
        np.testing.assert_array_equal(take.numpy(), np.where(jc, jl, 0))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("segs", [1, 7, 32, 128])
def test_kernel_model_matches_plain(kind, segs):
    """The kernel's segments, speculate, repair rounds and emit
    (tests/xlaextractmodel.py) give xla_extract_plain's seven keys, for any
    segment count (the kernel's is 128), at the emit_from and valid_len
    edges, in a row whose halo is fabricated and past seq_cap."""
    blocks = rows(kind)
    for (efs, hoks, cap), (cands, want) in zip(MODEL_CASES,
                                               plain_extracts(kind)):
        for b in range(3):
            got, counts = extract_row(blocks[b], cands[b], int(VLENS[b]),
                                      int(efs[b]), bool(hoks[b]), cap, segs)
            for k in KEYS:
                np.testing.assert_array_equal(np.asarray(got[k]), want[k][b],
                                              err_msg=k)
            assert counts["commits"] == int(want["nb_seq"][b])
            assert counts["segments"] <= segs
            if segs == 1:
                assert counts["rounds"] == 0


def test_xla_extract_dispatch():
    """CPU tensors take the plain chain; the counts exist only on a card;
    a tensor on any other device raises, it never falls back."""
    blocks = rows("text")
    efs, hoks, cap = MODEL_CASES[0]
    cands, want = plain_extracts("text")[0]
    args = (t(blocks), t(cands), t(VLENS), t(efs), t(hoks), cap)
    got = ts.xla_extract(*args)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    with pytest.raises(ValueError):
        ts.xla_extract_stats(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        ts.xla_extract(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                         for a in args))


def _sources(res: dict, b: int, ef: int) -> np.ndarray:
    """Each sequence's source (start - offset) in row b."""
    nb = int(res["nb_seq"][b])
    ll, ml, off = (np.asarray(res[k][b][:nb]).astype(np.int64)
                   for k in ("ll", "ml", "off"))
    return ef + np.cumsum(ll + ml) - ml - off


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seq_cap", [2048, 64])
def test_extract_batch_xla(kind, seq_cap):
    """Equal to zstd_tpu's extract_batch in every row whose halo is real,
    and in every other row where zstd_tpu's sequences stay at or above
    emit_from; where they do not, the port's sequences end where zstd_tpu's
    do, with the same offsets, and never start their source below
    emit_from."""
    blocks = rows(kind)
    for emit_from, halo_ok in (
            (None, None),
            (np.array([3000, 0, 100], np.int32),
             np.array([False, True, False])),
            (np.array([N - 12, 700, 2], np.int32),
             np.array([True, False, False]))):
        want = J_EXTRACT(
            jnp.asarray(blocks), jnp.asarray(VLENS), HASH_LOG, MLS, seq_cap,
            emit_from=None if emit_from is None else jnp.asarray(emit_from),
            halo_ok=None if halo_ok is None else jnp.asarray(halo_ok))
        want = {k: np.asarray(v) for k, v in want.items()}
        got = ts.extract_batch_xla(
            t(blocks), t(VLENS), HASH_LOG, MLS, seq_cap,
            emit_from=None if emit_from is None else t(emit_from),
            halo_ok=None if halo_ok is None else t(halo_ok))
        got = {k: v.numpy() for k, v in got.items()}
        for b in range(3):
            ef = 0 if emit_from is None else int(emit_from[b])
            real = halo_ok is None or halo_ok[b]
            if real or (_sources(want, b, ef) >= ef).all():
                for k in KEYS:
                    np.testing.assert_array_equal(got[k][b], want[k][b],
                                                  err_msg=k)
                continue
            nb = int(want["nb_seq"][b])
            assert int(got["nb_seq"][b]) == nb
            ends = lambda r: np.cumsum(r["ll"][b][:nb] + r["ml"][b][:nb])
            np.testing.assert_array_equal(ends(got), ends(want))
            np.testing.assert_array_equal(got["off"][b], want["off"][b])
            assert (_sources(got, b, ef) >= ef).all()


def test_fabricated_halo_extension_is_capped():
    """A zero row behind a zero halo, halo_ok False: emit_from has no
    candidate (its previous position is banned), so the first match commits
    at emit_from + 1; zstd_tpu extends it one byte back, its source one byte
    into the banned halo; the port's extension stops there, so its source
    is emit_from and its first literal length 1."""
    blocks = np.zeros((1, N), np.uint8)
    vl, ef = np.array([N], np.int32), np.array([4096], np.int32)
    hok = np.array([False])
    want = J_EXTRACT(jnp.asarray(blocks), jnp.asarray(vl), HASH_LOG, MLS,
                     2048, emit_from=jnp.asarray(ef), halo_ok=jnp.asarray(hok))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in ts.extract_batch_xla(
        t(blocks), t(vl), HASH_LOG, MLS, 2048, emit_from=t(ef),
        halo_ok=t(hok)).items()}
    assert _sources(want, 0, 4096).min() == 4096 - 1
    assert _sources(got, 0, 4096).min() == 4096
    assert (int(want["ll"][0, 0]), int(got["ll"][0, 0])) == (0, 1)
    assert int(got["nb_seq"][0]) == int(want["nb_seq"][0])
    assert int(got["nb_lit"][0]) == int(want["nb_lit"][0]) + 1
