"""zstd_tpu_torch.ops.fastmatch (the lazy and v3 match engines) against
zstd_tpu.ops.fastmatch on the CPU.

Each step of the engines gets the same numpy inputs in both packages (the
JAX functions batched with vmap, as the JAX engines run them); equality is
exact throughout. The JAX module reads ZSTD_TPU_NOECON and
ZSTD_TPU_MLEN_PASSES when it is imported, and its pipeline reads
ZSTD_TPU_DEV_ROW_WIDTH: the port fixes all three at their defaults, so the
tests check that they are unset.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import gen_text
from tests.test_tpu_pipeline import CASES
from zstd_tpu import pipeline as jpipe
from zstd_tpu.ops import fastmatch as jfm
from zstd_tpu_torch import pipeline as tpipe
from zstd_tpu_torch.ops import fastmatch as tfm

N = 32 * 1024
HASH_LOG = 17
MLS = 5
SEQ_CAP = N // 8


def _rows():
    """The CASES rows cut to N (CASES[0] is 1,000 B: valid_len < N; CASES[3]
    is zeros; CASES[5] has period 256), then period 4, then random."""
    rng = np.random.default_rng(11)
    rows, lens = [], []
    for c in CASES:
        r = np.zeros(N, np.uint8)
        r[:min(len(c), N)] = np.frombuffer(c[:N], np.uint8)
        rows.append(r)
        lens.append(min(len(c), N))
    rows.append(np.tile(rng.integers(0, 256, 4, dtype=np.uint8), N // 4))
    rows.append(rng.integers(0, 256, N, dtype=np.uint8))
    lens += [N, N]
    return np.stack(rows), np.array(lens, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@functools.cache
def _jax_steps():
    """The v3 engine's intermediates of every step, from the JAX functions."""
    blocks, lens = _rows()

    @jax.jit
    def run(b, v):
        def one(block, vl):
            tri, b3, tri3, b6 = jfm._tri_arrays(block)
            h = jfm._hash_f32(tri, tri3, b3, b6, HASH_LOG, MLS)
            cand = jfm._candidates(h, HASH_LOG, vl)
            row8 = jfm._candidates_row(h, HASH_LOG, vl, 8)
            mlen = jfm._capped_mlen(tri, b3, cand, vl, 0)
            mlen_at = jfm._capped_mlen_at(tri, b3, cand, vl, 0,
                                          jfm.LAZY_PASSES)
            nxt = jfm._next_matchable(mlen)
            yp, yl = jfm._resolve(mlen, nxt)
            comp = jfm._compact(yp, yl, cand, SEQ_CAP, N)
            rep = jfm._rep_rewrite(tri, *comp, N)
            merged = jfm._merge_chains(comp[0], comp[1], rep, comp[3],
                                       SEQ_CAP, N)
            fin = jfm._finish_sequences(block, tri, *merged, vl, 0, SEQ_CAP,
                                        N)
            return dict(tri=(tri, b3, tri3, b6), h=h, cand=cand, row8=row8,
                        mlen=mlen, mlen_at=mlen_at, nxt=nxt, y=(yp, yl),
                        comp=comp, rep=rep, merged=merged, fin=fin)
        return jax.vmap(one)(b, v)

    out = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(blocks),
                                                 jnp.asarray(lens)))
    return blocks, lens, out


@pytest.fixture(scope="module")
def steps():
    return _jax_steps()


def test_settings_are_the_defaults():
    for var in ("ZSTD_TPU_NOECON", "ZSTD_TPU_MLEN_PASSES",
                "ZSTD_TPU_DEV_ROW_WIDTH"):
        assert not os.environ.get(var), var
    assert jfm._ECON_FILTER
    assert jfm.MLEN_PASSES == tfm.MLEN_PASSES
    assert jfm.LAZY_PASSES == tfm.LAZY_PASSES
    for name in ("MIN_EMIT", "CAP_MLEN", "RESOLVE_CHUNK", "RESOLVE_STEPS"):
        assert getattr(jfm, name) == getattr(tfm, name), name


def test_tri_arrays(steps):
    blocks, _, out = steps
    for want, got in zip(out["tri"], tfm.tri_arrays(_t(blocks))):
        _eq(want, got)


def _mixed_block():
    """128 KiB: 40,000 bytes of text, then random bytes."""
    rng = np.random.default_rng(5)
    n = 128 * 1024
    return np.frombuffer(gen_text(40000, seed=1) + rng.integers(
        0, 256, n - 40000, dtype=np.uint8).tobytes(), np.uint8)


@pytest.mark.parametrize("mls", [4, 5, 6])
@pytest.mark.parametrize("hash_log", [11, 17, 19, 20, 21, 22, 23])
def test_hash_bucket_ids(hash_log, mls):
    """Above hash_log 19 the linear forms pass 2^24: the bucket ids still
    equal JAX's at every position."""
    blk = _mixed_block()
    tri, b3, tri3, b6 = jfm._tri_arrays(jnp.asarray(blk))
    want = jax.jit(jfm._hash_f32, static_argnums=(4, 5))(
        tri, tri3, b3, b6, hash_log, mls)
    t = tfm.tri_arrays(_t(blk[None]))
    got = tfm.hash_f32(t[0], t[2], t[1], t[3], hash_log, mls)
    _eq(np.asarray(want)[None], got)


def test_hash_mod_needs_one_rounding():
    """Rounding mod_p's x - q * prime twice (two f32 ops) gives other bucket
    ids above hash_log 19, so the port's single rounding is what matches."""
    blk = _mixed_block()
    tri, b3, tri3, b6 = tfm.tri_arrays(_t(blk[None]))
    for hash_log in (20, 21, 22, 23):
        prime = (1 << hash_log) - 5

        def mod_p(x):
            return x - torch.floor(x / prime) * prime

        t_hi = torch.floor(tri / 4096.0)
        x = mod_p((tri - t_hi * 4096.0) * 739.0 + t_hi * 523.0)
        x = mod_p(x * 31.0 + b3 * 173.0)
        twice = x.clamp(0, prime - 1).to(torch.int32)
        once = tfm.hash_f32(tri, tri3, b3, b6, hash_log, 4)
        assert int((twice != once).sum()) > 1000, hash_log


def test_candidates(steps):
    blocks, lens, out = steps
    (cand,) = tfm.candidate_rows(_t(out["h"]), _t(lens), 1)
    _eq(out["cand"], cand)
    rows = tfm.candidate_rows(_t(out["h"]), _t(lens), 8)
    _eq(out["row8"], torch.stack(rows, dim=2))


def test_capped_mlen(steps):
    _, lens, out = steps
    tri, b3 = _t(out["tri"][0]), _t(out["tri"][1])
    cand = _t(out["cand"])
    _eq(out["mlen"], tfm.capped_mlen(tri, b3, cand, _t(lens)))
    _eq(out["mlen_at"], tfm.capped_mlen_at(tri, b3, cand, _t(lens)))


def test_next_matchable(steps):
    _, _, out = steps
    _eq(out["nxt"], tfm.next_matchable(_t(out["mlen"])))


def test_resolve(steps):
    """Every row: the CASES rows (text, mixed, zeros, random, period 256, a
    short valid length), period 4 and random."""
    _, _, out = steps
    yp, yl = tfm.resolve(_t(out["mlen"]), _t(out["nxt"]))
    _eq(out["y"][0], yp)
    _eq(out["y"][1], yl)


def test_resolve_steps_stay_below_the_cap(steps):
    """A chunk's steps with ip < end: every one takes >= 4 bytes or is one
    of at most 3 steps with end - ip < 4, so at most 131 of the 160. The
    kernel's counts come from the fused entry, on CUDA tensors only; the
    standalone walk runs on the CPU only."""
    blocks, lens, out = steps
    mlen, nxt = _t(out["mlen"]), _t(out["nxt"])
    active = torch.empty((mlen.shape[0], N // tfm.RESOLVE_CHUNK),
                         dtype=torch.int32)
    yp, yl = tfm.resolve_plain(mlen, nxt, active)
    taken = (yl > 0).reshape(mlen.shape[0], -1, tfm.RESOLVE_STEPS).sum(2)
    assert int(active.max()) <= 131
    assert bool((active - taken <= 3).all())
    assert int(active.max()) > 0
    rows = _t(out["cand"])[None]
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfm.select_resolve_stats(_t(blocks), rows, _t(lens), "v3")
    with pytest.raises(ValueError, match="inside select_resolve"):
        tfm.resolve(mlen.to("meta"), nxt.to("meta"))


def test_compact(steps):
    _, _, out = steps
    yp, yl = (_t(a) for a in out["y"])
    got = tfm.compact(yp, yl, _t(out["cand"]), SEQ_CAP, N)
    for want, g in zip(out["comp"], got):
        _eq(want, g)


def test_rep_rewrite(steps):
    _, _, out = steps
    comp = [_t(a) for a in out["comp"]]
    _eq(out["rep"], tfm.rep_rewrite(_t(out["tri"][0]), *comp, N))


def test_merge_chains(steps):
    _, _, out = steps
    pos, ln, _, nb = (_t(a) for a in out["comp"])
    got = tfm.merge_chains(pos, ln, _t(out["rep"]), nb, SEQ_CAP, N)
    for want, g in zip(out["merged"], got):
        _eq(want, g)


def test_finish_sequences(steps):
    blocks, lens, out = steps
    got = tfm.finish_sequences(_t(blocks), _t(out["tri"][0]),
                               *(_t(a) for a in out["merged"]), _t(lens),
                               SEQ_CAP)
    for k, want in out["fin"].items():
        _eq(want, got[k])


def _synthetic(n=4096):
    """Random bytes with [2000, 2100) a copy of [1000, 1100) (offset 1000),
    and [3000, 3030) of [2950, 2980) (offset 50)."""
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    b[2000:2100] = b[1000:1100]
    b[3000:3030] = b[2950:2980]
    return b


def test_finish_sequences_loops_reach_their_caps():
    """A match at 2040 (10 bytes, offset 1000) inside a 100-byte copy: the
    forward loops add 7 * 3 + 2 bytes and the backward ones 5 * 3 + 2, each
    stopped by its pass cap, not by the data."""
    n, cap = 4096, 8
    blk = _synthetic(n)
    seq = (np.array([2040, 3010] + [n] * 6, np.int32),
           np.array([10, 4] + [0] * 6, np.int32),
           np.array([1000, 50] + [0] * 6, np.int32), np.int32(2))
    tri = jfm._tri_arrays(jnp.asarray(blk))[0]
    want = jax.jit(jfm._finish_sequences, static_argnums=(8, 9))(
        jnp.asarray(blk), tri, *(jnp.asarray(a) for a in seq), n, 0, cap, n)
    got = tfm.finish_sequences(
        _t(blk[None]), _t(np.asarray(tri)[None]),
        *(_t(np.asarray(a)[None]) for a in seq), torch.tensor([n]), cap)
    for k, w in want.items():
        _eq(np.asarray(w)[None], got[k])
    assert int(got["ml"][0, 0]) == 10 + 23 + 17
    assert int(got["ll"][0, 0]) == 2040 - 17


@pytest.mark.parametrize("length", [18, 19])
def test_rep_rewrite_length_cap(length):
    """Sequence 1 (at 3005, offset 50) also matches at sequence 0's offset
    1000 over the whole length: rewritten at 18 bytes, not at 19."""
    n, cap = 4096, 4
    blk = _synthetic(n)
    blk[3005:3005 + 40] = blk[2005:2005 + 40]
    pos = np.array([2040, 3005, n, n], np.int32)
    ln = np.array([10, length, 0, 0], np.int32)
    dist = np.array([1000, 50, 0, 0], np.int32)
    tri = jfm._tri_arrays(jnp.asarray(blk))[0]
    want = np.asarray(jax.jit(jfm._rep_rewrite, static_argnums=5)(
        tri, *(jnp.asarray(a) for a in (pos, ln, dist)), jnp.int32(2), n))
    got = tfm.rep_rewrite(_t(np.asarray(tri)[None]),
                          *(_t(a[None]) for a in (pos, ln, dist)),
                          torch.tensor([2], dtype=torch.int32), n)
    _eq(want[None], got)
    assert int(got[0, 1]) == (1000 if length == 18 else 50)


def test_gain_bit_length_at_powers_of_two():
    """ceil(log2(d + 1)) in f32, as JAX computes it, equals the bit length
    the port takes from frexp, around every power of two below 2^18."""
    d = np.unique(np.concatenate(
        [np.array([1 << k, (1 << k) - 1, (1 << k) + 1]) for k in range(18)]))
    d = d[(d >= 1) & (d < 1 << 18)].astype(np.int32)
    want = 7.5 * 8.0 - (8.0 + np.asarray(jnp.ceil(jnp.log2(
        jnp.asarray(d, jnp.float32) + 1.0))))
    pos = torch.from_numpy(d.astype(np.int64))[None]
    n = int(d.max()) + 1
    ml = torch.full((1, n), 8, dtype=torch.int32)
    cand = torch.zeros((1, n), dtype=torch.int32)
    got = tfm.gain(ml, cand)[0, pos[0]]
    np.testing.assert_array_equal(want.astype(np.float32), got.numpy())


ENGINES = {"lazy": (jfm.extract_batch_lazy, tfm.extract_batch_lazy,
                    dict(depth=8)),
           "v3": (jfm.extract_batch_v3, tfm.extract_batch_v3, {})}


@pytest.mark.parametrize("hash_log, mls, seq_cap",
                         [(HASH_LOG, MLS, SEQ_CAP), (20, 6, 256)])
@pytest.mark.parametrize("engine", ["lazy", "v3"])
def test_seqstore(steps, engine, hash_log, mls, seq_cap):
    """The whole engine on every row; seq_cap 256 overflows the text rows."""
    blocks, lens, _ = steps
    jfn, tfn, kw = ENGINES[engine]
    want = jax.jit(lambda b, v: jfn(b, v, hash_log, mls, seq_cap, **kw))(
        jnp.asarray(blocks), jnp.asarray(lens))
    got = tfn(_t(blocks), _t(lens), hash_log, mls, seq_cap)
    for k, w in want.items():
        _eq(w, got[k])
    if seq_cap == 256:
        assert bool(got["overflow"][1]) and not bool(got["overflow"][3])


@pytest.mark.parametrize("engine", ["lazy", "v3"])
def test_analyze(steps, engine, monkeypatch):
    """Stage A's stats and resident arrays, with no mask: both engines
    gather `lits` through lit_idx, so every byte and first_lit are defined."""
    monkeypatch.delenv("ZSTD_TPU_DEV_ROW_WIDTH", raising=False)
    blocks, lens, _ = steps
    j_stats, j_res = jpipe._analyze_jit(jnp.asarray(blocks),
                                        jnp.asarray(lens), HASH_LOG, MLS,
                                        SEQ_CAP, engine=engine)
    t_stats, t_res = tpipe._analyze(_t(blocks), _t(lens), HASH_LOG, MLS,
                                    SEQ_CAP, engine)
    _eq(j_stats, t_stats)
    assert set(j_res) == set(t_res)
    for k in j_res:
        _eq(j_res[k], t_res[k])
