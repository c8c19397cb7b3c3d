"""csrc/exec_seq.cu's design, on the CPU: tests/execmodel.py (placement
from the sequences, in-place pointer jumping over a shrinking worklist, the
doubling's rounds and ok in closed form) against the port's
plain versions, exec_prepare + exec_resolve_plain, and that composition
against zstd_tpu's exec_sequences. zstd is exact, so equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import execmodel
from tests.test_torch_decode import _chain, _pad, _sequences
from zstd_tpu.ops import decode_dev as jops
from zstd_tpu_torch.ops import decode_dev as tops


def _plain(lits, ll, ml, off, nb, out_len, n, hist, rounds):
    """exec_prepare + exec_resolve_plain, and the number of pointers that
    each round changed."""
    args = [torch.from_numpy(a) for a in (lits, ll, ml, off)]
    ptr, in_match, placed = tops.exec_prepare(*args, nb, out_len, n)
    out, ok, r = tops.exec_resolve_plain(ptr, in_match, placed,
                                         torch.from_numpy(hist), out_len,
                                         rounds)
    p, changed = ptr.long(), []
    for _ in range(r):
        nxt = torch.where(p < 0, p, p[p.clamp(0, n - 1)])
        changed.append(int((nxt != p).sum()))
        p = nxt
    return (ptr.numpy(), in_match.numpy(), placed.numpy()), \
        (out.numpy(), bool(ok), r), changed


def _case(seed, h, cut, n=2048, seq_cap=128):
    rng = np.random.default_rng(seed)
    ll, ml, off, total = _sequences(rng, n, h, seq_cap)
    lits = rng.integers(0, 256, n, np.uint8)
    hist = rng.integers(0, 256, h, np.uint8)
    return lits, ll, ml, off, total - cut, n, hist, seq_cap


def _check_model(lits, ll, ml, off, nb, out_len, n, hist, rounds):
    want_place, want, changed = _plain(lits, ll, ml, off, nb, out_len, n,
                                       hist, rounds)
    ptr, in_match, placed, wl = execmodel.place(lits, ll, ml, off, nb,
                                                out_len, n)
    for got, w in zip((ptr, in_match, placed), want_place):
        np.testing.assert_array_equal(got, w)
    for order in (1, -1):
        out, ok, r, passes, hops = execmodel.resolve(
            ptr, in_match, placed, hist, out_len, rounds, wl, order)
        np.testing.assert_array_equal(out, want[0])
        assert (ok, r) == want[1:]
        # the hop counts give the pointers each out-of-place round changed
        assert execmodel.round_changes(hops, r) == changed
        if order == 1 and len(wl):
            assert len(passes) == 1            # sources come first
    return ok, r


@pytest.mark.parametrize("seed, h, cut", [(0, 1, 0), (1, 64, 0), (2, 64, 100),
                                          (3, 300, 7), (4, 1, 3000)])
def test_model_matches_plain(seed, h, cut):
    """Random sequences: zero-match pseudo-sequences, overlapping matches,
    history sources; out_len cut below the total (past n for seed 4)."""
    lits, ll, ml, off, out_len, n, hist, seq_cap = _case(seed, h, cut)
    seqs = [_pad(a, seq_cap) for a in (ll, ml, off)]
    ok, r = _check_model(lits, *seqs, len(ll), out_len, n, hist,
                         tops.EXEC_ROUNDS)
    assert ok and r >= 1


@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("depth", [2, 4, 8, 16])
def test_model_depth_boundary(rounds, depth):
    """ok turns false at the same depth, and the rounds run are the same."""
    n, seq_cap = 512, 32
    ll, ml, off, total = _chain(depth)
    seqs = [_pad(a, seq_cap) for a in (ll, ml, off)]
    lits = np.random.default_rng(depth).integers(0, 256, n, np.uint8)
    ok, _ = _check_model(lits, *seqs, len(ll), total, n,
                         np.zeros(1, np.uint8), rounds)
    assert ok == (depth <= 2 ** (rounds + 1))


def _edge_sequences():
    """Sequences that stress the placement: zero-length (0, 0) sequences,
    runs of literal-only pseudo-sequences, a match whose offset exceeds
    its start (history), off <= 0 (clamped to 1), a last sequence that
    runs past n, and nonzero garbage in the padding past nb_seq."""
    ll = np.array([0, 5, 0, 0, 3, 7, 0, 2, 0, 400], np.int32)
    ml = np.array([0, 0, 0, 4, 9, 0, 0, 30, 0, 200], np.int32)
    off = np.array([1, 1, 1, 9, 2, -4, 1, 0, 1, 17], np.int32)
    pad = np.array([11, 300, 5], np.int32)
    return [np.concatenate([a, pad]) for a in (ll, ml, off)], len(ll)


@pytest.mark.parametrize("out_len", [0, 40, 512, 600])
def test_model_edge_sequences(out_len):
    (ll, ml, off), nb = _edge_sequences()
    n = 512
    rng = np.random.default_rng(out_len)
    lits = rng.integers(0, 256, 300, np.uint8)         # fewer than n
    hist = rng.integers(0, 256, 16, np.uint8)
    _check_model(lits, ll, ml, off, nb, out_len, n, hist, tops.EXEC_ROUNDS)


@pytest.mark.parametrize("seed, h, cut", [(0, 1, 0), (2, 64, 100),
                                          (3, 300, 7)])
def test_plain_matches_jax(seed, h, cut):
    """The plain composition, now with the rounds run, against zstd_tpu."""
    lits, ll, ml, off, out_len, n, hist, seq_cap = _case(seed, h, cut)
    seqs = [_pad(a, seq_cap) for a in (ll, ml, off)]
    want = jops.exec_sequences(
        jnp.asarray(lits), int(ll.sum()), *map(jnp.asarray, seqs), len(ll),
        out_len, n, jnp.asarray(hist), h)
    out, ok, r = tops.exec_sequences(
        torch.from_numpy(lits), *map(torch.from_numpy, seqs), len(ll),
        out_len, n, torch.from_numpy(hist))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want[0]))
    assert bool(ok) == bool(want[1]) is True
    assert isinstance(r, int) and r >= 1


def test_plain_edge_matches_jax():
    (ll, ml, off), nb = _edge_sequences()
    n, h = 512, 16
    rng = np.random.default_rng(9)
    lits = rng.integers(0, 256, n, np.uint8)
    hist = rng.integers(0, 256, h, np.uint8)
    want = jops.exec_sequences(
        jnp.asarray(lits), 0, *map(jnp.asarray, (ll, ml, off)), nb, 600, n,
        jnp.asarray(hist), h)
    out, ok, _ = tops.exec_sequences(
        torch.from_numpy(lits), *map(torch.from_numpy, (ll, ml, off)), nb,
        600, n, torch.from_numpy(hist))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want[0]))
    assert bool(ok) == bool(want[1])


def test_no_fallback_off_the_cpu():
    """Tensors that are not on the CPU never reach a plain version: a device
    without a kernel raises (a CUDA tensor launches csrc/exec_seq.cu)."""
    meta = torch.device("meta")
    z = torch.zeros(4, dtype=torch.int32, device=meta)
    lits = torch.zeros(64, dtype=torch.uint8, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.exec_sequences(lits, z, z, z, 0, 64, 64,
                            torch.zeros(1, dtype=torch.uint8, device=meta))
