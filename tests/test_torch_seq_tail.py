"""The lazy and v3 engines' seqstore tail on the CPU: `seq_merge_plain`
(compact, rep_rewrite, merge_chains) and `finish_sequences_plain` of
zstd_tpu_torch.ops.fastmatch against zstd_tpu.ops.fastmatch's `_compact` ->
`_rep_rewrite` -> `_merge_chains` and `_finish_sequences` (vmapped over the
rows), both engines' seqstores through the wrappers against the JAX
engines, tests/seqtailmodel.py (the algorithm of csrc/seq_merge.cu and
csrc/seq_finish.cu, literals gap by gap) against the plain versions, and
the wrappers' input checks. Equality is exact throughout (tolerance 0).

Rows (HASH_LOG 17, MLS 5, both engines' slots from the plain resolve):
big_corpus blocks, zero, period-4 and random rows, gen_text rows with
valid_len below n, at n = 16,384 and 8,192, at seq_cap = n / 8; the
16 KiB rows also at seq_cap 64, the overflow case, where compact drops
groups.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import seqtailmodel
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from zstd_tpu.ops import fastmatch as jfm
from zstd_tpu_torch.ops import fastmatch as tfm

HASH_LOG = 17
MLS = 5
OVERFLOW_CAP = 64


def _corpus():
    """16 KiB rows: three big_corpus blocks from three of its segments, and
    gen_text with valid_len 12,345."""
    n = 16384
    arr = np.frombuffer(big_corpus(8 * n), np.uint8).reshape(8, n)
    text = np.frombuffer(gen_text(n, seed=21)[:n], np.uint8)
    return np.stack([arr[0], arr[2], arr[5], text]), \
        np.array([n, n, n, 12345], np.int32)


def _synthetic():
    """8 KiB rows: zero, period-4, random, and gen_text with valid_len
    3,001."""
    n = 8192
    rng = np.random.default_rng(16)
    text = np.frombuffer(gen_text(n, seed=5)[:n], np.uint8)
    return np.stack([np.zeros(n, np.uint8),
                     np.tile(rng.integers(0, 256, 4, dtype=np.uint8), n // 4),
                     rng.integers(0, 256, n, dtype=np.uint8), text]), \
        np.array([n, n, n, 3001], np.int32)


ROWS = {"corpus": _corpus, "synthetic": _synthetic}
CASES = [(rows, mode, cap) for mode in tfm.MODES
         for rows, cap in (("corpus", "n/8"), ("corpus", OVERFLOW_CAP),
                           ("synthetic", "n/8"))]


def _cap(blocks, cap):
    return blocks.shape[1] // 8 if cap == "n/8" else cap


@functools.cache
def _slots(rows, mode):
    """(blocks, lens, tri, yp, yl, cand) as torch tensors: the engine's
    committed slots from the port's plain resolve."""
    blocks, lens = ROWS[rows]()
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    tri, cand_rows = tfm.engine_rows(tb, tl, HASH_LOG, MLS, mode)
    yp, yl, cand = tfm.select_resolve_plain(tb, cand_rows, tl, mode)
    return tb, tl, tri, yp, yl, cand


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_merge(yp, yl, cand, tri, cap):
    n = tri.shape[1]

    def one(yp, yl, cand, tri):
        c_pos, c_len, c_dist, c_nb = jfm._compact(yp, yl, cand, cap, n)
        c_dist = jfm._rep_rewrite(tri, c_pos, c_len, c_dist, c_nb, n)
        return jfm._merge_chains(c_pos, c_len, c_dist, c_nb, cap, n)
    return jax.vmap(one)(yp, yl, cand, tri)


@functools.partial(jax.jit, static_argnums=(7,))
def _jax_finish(blocks, tri, pos, ln, off, nb, lens, cap):
    n = blocks.shape[1]
    return jax.vmap(lambda b, t, p, l, o, c, v: jfm._finish_sequences(
        b, t, p, l, o, c, v, 0, cap, n))(blocks, tri, pos, ln, off, nb, lens)


@functools.cache
def _tail(rows, mode, cap):
    """The plain merge and finish of one case (numpy), and the JAX ones."""
    tb, tl, tri, yp, yl, cand = _slots(rows, mode)
    cap = _cap(tb, cap)
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap)
    fin = tfm.finish_sequences_plain(tb, tri, *merged, tl, cap)
    j = [jnp.asarray(t.numpy()) for t in (yp, yl, cand, tri)]
    j_merged = _jax_merge(*j, cap)
    j_fin = _jax_finish(jnp.asarray(tb.numpy()), j[3],
                        *(jnp.asarray(t.numpy()) for t in merged),
                        jnp.asarray(tl.numpy()), cap)
    np_ = lambda x: np.asarray(x)          # noqa: E731
    return ([t.numpy() for t in merged], {k: v.numpy() for k, v in fin.items()},
            [np_(a) for a in j_merged], {k: np_(v) for k, v in j_fin.items()})


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_seq_merge_plain_equals_jax(rows, mode, cap):
    merged, _, j_merged, _ = _tail(rows, mode, cap)
    for want, got in zip(j_merged, merged):
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_finish_sequences_plain_equals_jax(rows, mode, cap):
    _, fin, _, j_fin = _tail(rows, mode, cap)
    assert set(fin) == set(j_fin)
    for k, want in j_fin.items():
        np.testing.assert_array_equal(want, fin[k], err_msg=k)


def test_overflow_case_drops_groups():
    """At seq_cap 64 compact drops the groups past the cap (the slot rows
    hold more), and the seqstore says overflow."""
    tb, _, _, yp, yl, cand = _slots("corpus", "lazy")
    c_nb = tfm.compact(yp, yl, cand, OVERFLOW_CAP, tb.shape[1])[3]
    assert (c_nb == OVERFLOW_CAP).all()
    merged, fin, _, _ = _tail("corpus", "lazy", OVERFLOW_CAP)
    assert fin["overflow"].tolist() == (merged[3] >= OVERFLOW_CAP).tolist()
    assert (fin["nb_lit"] > 0).all()


@pytest.mark.parametrize("rows, mode, cap", CASES)
def test_kernel_model_equals_plain(rows, mode, cap):
    """tests/seqtailmodel.py, the kernels' algorithm (group lengths from
    ends, the rewrite's compares to the first mismatch, each sequence's
    extension alone, literals gap by gap), against the plain versions on
    every row, the overflow and short rows included."""
    tb, tl, _, yp, yl, cand = _slots(rows, mode)
    c = _cap(tb, cap)
    merged, fin, _, _ = _tail(rows, mode, cap)
    blocks = tb.numpy()
    for b in range(blocks.shape[0]):
        m = seqtailmodel.merge_row(yp[b].numpy(), yl[b].numpy(),
                                   cand[b].numpy(), blocks[b], c)
        for want, got in zip(merged, m):
            np.testing.assert_array_equal(want[b], got)
        f = seqtailmodel.finish_row(blocks[b], merged[0][b], merged[1][b],
                                    merged[2][b], int(merged[3][b]),
                                    int(tl[b]), c)
        for k, got in f.items():
            np.testing.assert_array_equal(fin[k][b], got, err_msg=k)


ENGINES = {"lazy": (jfm.extract_batch_lazy, tfm.extract_batch_lazy,
                    dict(depth=8)),
           "v3": (jfm.extract_batch_v3, tfm.extract_batch_v3, {})}


@pytest.mark.parametrize("engine, rows, cap", [
    ("lazy", "synthetic", "n/8"), ("v3", "corpus", OVERFLOW_CAP)])
def test_seqstore_through_the_wrappers(engine, rows, cap):
    """extract_batch_lazy (depth 8) and extract_batch_v3, whose tail is now
    seq_merge and finish_sequences, equal the JAX engines."""
    blocks, lens = ROWS[rows]()
    c = _cap(blocks, cap)
    jfn, tfn, kw = ENGINES[engine]
    want = jax.jit(lambda b, v: jfn(b, v, HASH_LOG, MLS, c, **kw))(
        jnp.asarray(blocks), jnp.asarray(lens))
    got = tfn(torch.from_numpy(blocks), torch.from_numpy(lens), HASH_LOG,
              MLS, c)
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(w), got[k].numpy(),
                                      err_msg=k)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    tb, tl, tri, yp, yl, cand = _slots("synthetic", "lazy")
    cap = tb.shape[1] // 8
    merged = tfm.seq_merge(yp, yl, cand, tb, tri, cap)
    for want, got in zip(tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap),
                         merged):
        assert torch.equal(want, got)
    fin = tfm.finish_sequences(tb, tri, *merged, tl, cap)
    want = tfm.finish_sequences_plain(tb, tri, *merged, tl, cap)
    for k in want:
        assert torch.equal(want[k], fin[k]), k


def _meta(*ts):
    return [t.to("meta") for t in ts]


def test_wrappers_raise_off_the_cpu_and_never_run_the_plain():
    """A tensor on the meta device raises (not run on the CPU); a wrong
    dtype or shape raises before that."""
    tb, tl, tri, yp, yl, cand = _slots("synthetic", "lazy")
    cap = tb.shape[1] // 8
    merged = tfm.seq_merge_plain(yp, yl, cand, tb, tri, cap)
    m_args = _meta(yp, yl, cand, tb, tri)
    f_args = _meta(tb, tri, *merged, tl)
    with pytest.raises(ValueError, match="seq_merge: unsupported device"):
        tfm.seq_merge(*m_args, cap)
    with pytest.raises(ValueError,
                       match="finish_sequences: unsupported device"):
        tfm.finish_sequences(*f_args, cap)
    bad = dict(yp=m_args[0].to(torch.int64), yl=m_args[1][:, :-4],
               cand=m_args[2].to(torch.float32), blocks=m_args[3][:1])
    for i, name in enumerate(("yp", "yl", "cand", "blocks")):
        args = list(m_args)
        args[i] = bad[name]
        with pytest.raises(ValueError, match="must be a contiguous"):
            tfm.seq_merge(*args, cap)
    for i, name in ((1, "tri"), (2, "seq_pos"), (5, "nb_seq"),
                    (6, "valid_lens")):
        args = list(f_args)
        args[i] = args[i].to(torch.int64) if name != "tri" else \
            args[i].to(torch.uint8)
        with pytest.raises(ValueError, match=f"{name} must be a contiguous"):
            tfm.finish_sequences(*args, cap)
    args = list(f_args)
    args[3] = args[3][:, :-1]                       # seq_len of cap - 1
    with pytest.raises(ValueError, match="seq_len must be a contiguous"):
        tfm.finish_sequences(*args, cap)
