"""zstd_tpu_torch's dictionary trainers on the CPU, against zstd_tpu's.

The same seeded samples go through zstd_tpu.dict_builder and
zstd_tpu_torch.dict_builder: the greedy match finder that the finalizer
gathers its statistics with (format/matchfinder.find_sequences), the d-mer
hashes and keys, the fastCover and COVER trainers, the k/d sweep, the
finalized dictionary and a frame compressed with it. Every comparison is
exact: the same arrays, bytes, parameters and error messages. The host
helpers that came with them (params' context-size estimates,
sequences.seq_to_codes, huffman.ctable_to_dtable) are held here too.
"""

import dataclasses

import numpy as np
import pytest

from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from zstd_tpu import dictionary as jdict
from zstd_tpu import params as jparams
from zstd_tpu.dict_builder import cover as jcover
from zstd_tpu.dict_builder import fastcover as jfast
from zstd_tpu.dict_builder import zdict as jzdict
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.format import matchfinder as jmf
from zstd_tpu.format import sequences as jseq
from zstd_tpu_torch import dictionary as tdict
from zstd_tpu_torch import params as tparams
from zstd_tpu_torch.dict_builder import cover as tcover
from zstd_tpu_torch.dict_builder import fastcover as tfast
from zstd_tpu_torch.dict_builder import zdict as tzdict
from zstd_tpu_torch.format import huffman as thuf
from zstd_tpu_torch.format import matchfinder as tmf
from zstd_tpu_torch.format import sequences as tseq

BIG = big_corpus(96 * 1024)
_NOISE = np.random.default_rng(79)
SAMPLES = {
    # big_corpus cut into 2 KiB samples
    "big_corpus": [BIG[i:i + 2048] for i in range(0, len(BIG), 2048)],
    "gen_text": [gen_text(1500 + 97 * i, seed=300 + i) for i in range(40)],
    # tests/test_dictionary.py's incompressible set: flat literals
    "noise": [_NOISE.integers(0, 256, 4000, dtype=np.uint8).tobytes()
              for _ in range(24)],
}
KD = ((1024, 8), (256, 6))
TRAINERS = {"fastcover": (jfast.train_from_samples,
                          tfast.train_from_samples),
            "cover": (jcover.train_from_samples_cover,
                      tcover.train_from_samples_cover)}
PROBE = gen_text(6000, seed=99) + BIG[:4000]


def _seqstore(res):
    seqs, reps = res
    return (seqs.lit_length.tolist(), seqs.off_base.tolist(),
            seqs.ml_base.tolist(), seqs.literals, tuple(reps))


def _arr(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


RAND = np.random.default_rng(5).integers(0, 256, 24_000,
                                         dtype=np.uint8).tobytes()
TEXT = gen_text(40_000, seed=4)
# (full, block_start, block_end, window_low, reps, hash_log, mls)
FIND_CASES = {
    "gen_text": (TEXT, 0, 32_768, 0, (1, 4, 8), 17, 5),
    "big_corpus": (BIG, 0, 32_768, 0, (1, 4, 8), 16, 6),
    "random": (RAND, 0, len(RAND), 0, (1, 4, 8), 15, 4),
    "window_prefix": (TEXT, 16_384, 36_000, 4_000, (1, 4, 8), 17, 5),
    "reps": (BIG, 40_000, 60_000, 20_000, (7, 33, 1021), 14, 8),
    "short_block": (TEXT, 100, 103, 0, (2, 5, 9), 17, 5),
    "tail_only": (TEXT, 500, 510, 0, (1, 4, 8), 17, 5),
}


@pytest.mark.parametrize("case", sorted(FIND_CASES))
def test_find_sequences_equals_jax(case):
    data, bs, be, wl, reps, hlog, mls = FIND_CASES[case]
    full = _arr(data[:be])
    want = jmf.find_sequences(full, bs, be, wl, reps, hlog, mls)
    got = tmf.find_sequences(full, bs, be, wl, reps, hlog, mls)
    assert _seqstore(got) == _seqstore(want)
    if be - bs > 8:
        assert want[0].nb_seq > 0 or case == "random"


def test_matchfinder_steps_equal_jax():
    full = _arr(TEXT[:20_000])
    for mls, hlog in ((4, 12), (5, 17), (6, 20), (8, 14)):
        h = tmf.hash_positions(full, len(full), mls, hlog)
        assert np.array_equal(h, jmf.hash_positions(full, len(full), mls,
                                                    hlog))
        assert np.array_equal(tmf.prev_same_bucket(h),
                              jmf.prev_same_bucket(h))
    assert tmf.hash_positions(full, 0, 5, 17).shape == (0,)
    assert tmf.prev_same_bucket(np.zeros(0, np.uint64)).shape == (0,)
    for d in range(0, 12):
        for ll in (0, 3):
            for reps in ((1, 4, 8), (4, 1, 8), (8, 4, 1), (5, 9, 2)):
                assert tmf._ob_for_dist(d, ll, *reps) == \
                    jmf._ob_for_dist(d, ll, *reps)
    for a, b, limit in ((0, 1, 500), (0, 2_000, 5_000), (10, 10, 777),
                        (100, 7_000, 0)):
        assert tmf._match_len(full, a, b, limit) == \
            jmf._match_len(full, a, b, limit)


@pytest.mark.parametrize("d", (6, 8, 12, 16))
def test_dmer_hashes_and_keys_equal_jax(d):
    arr = _arr(BIG[:20_000])
    assert np.array_equal(tfast._dmer_hashes(arr, d, 20),
                          jfast._dmer_hashes(arr, d, 20))
    assert np.array_equal(tcover._dmer_keys(arr, d),
                          jcover._dmer_keys(arr, d))
    for t, j in zip(tcover._dmer_key_pair(arr, d),
                    jcover._dmer_key_pair(arr, d)):
        assert np.array_equal(t, j)
    short = arr[:d - 1]
    assert tfast._dmer_hashes(short, d, 20).shape == (0,)
    assert tcover._dmer_keys(short, d).shape == (0,)
    assert all(x.shape == (0,) for x in tcover._dmer_key_pair(short, d))


@pytest.mark.parametrize("k,d", KD)
@pytest.mark.parametrize("trainer", sorted(TRAINERS))
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_trainer_equals_jax(name, trainer, k, d):
    """The content, the finalized dictionary and a frame compressed with
    it."""
    samples = SAMPLES[name]
    jtrain, ttrain = TRAINERS[trainer]
    content = ttrain(samples, 8192, k=k, d=d)
    assert content == jtrain(samples, 8192, k=k, d=d)
    dict_id = 4000 + k + d
    blob = tzdict.finalize_dictionary(content, samples, dict_id=dict_id)
    assert blob == jzdict.finalize_dictionary(content, samples,
                                              dict_id=dict_id)
    frame = tdict.compress_with_dict(PROBE, tdict.load_dictionary(blob),
                                     level=3, checksum=True)
    assert frame == jdict.compress_with_dict(
        PROBE, jdict.load_dictionary(blob), level=3, checksum=True)
    assert tdict.decompress_with_dict(
        frame, tdict.load_dictionary(blob)) == PROBE


def test_noise_reaches_the_flat_literal_branch():
    """The noise set's literal histogram builds an 8-bit table, which the
    finalizer replaces with ZDICT_flatLit's."""
    samples = SAMPLES["noise"]
    content = tfast.train_from_samples(samples, 4096)
    lit, *_ = tzdict._gather_stats(content, samples, 3)
    assert thuf.build_huf_ctable(lit, 255,
                                 thuf.HUF_TABLELOG_DEFAULT).table_log == 8
    blob = tzdict.finalize_dictionary(content, samples, dict_id=1234)
    assert blob == jzdict.finalize_dictionary(content, samples, dict_id=1234)


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_no_usable_samples_raise_as_jax(trainer):
    jtrain, ttrain = TRAINERS[trainer]
    for samples in ([], [b"abc", b"1234567"]):
        with pytest.raises(ValueError) as want:
            jtrain(samples, 4096)
        with pytest.raises(ValueError) as got:
            ttrain(samples, 4096)
        assert str(got.value) == str(want.value) == \
            "no usable training samples"


@pytest.mark.parametrize("cover", (False, True))
def test_optimize_train_equals_jax(cover):
    samples = [gen_text(1500, s) for s in range(20)]
    content, params = tcover.optimize_train(samples, 4096, cover=cover)
    assert (content, params) == jcover.optimize_train(samples, 4096,
                                                      cover=cover)
    assert params["k"] in (256, 512, 1024, 2048) and params["d"] in (6, 8)


@pytest.mark.parametrize("dict_id", (0, 777))
def test_finalize_dictionary_equals_jax(dict_id):
    samples = SAMPLES["gen_text"][:20]
    content = tcover.train_from_samples_cover(samples, 4096)
    blob = tzdict.finalize_dictionary(content, samples, dict_id=dict_id,
                                      level=5)
    assert blob == jzdict.finalize_dictionary(content, samples,
                                              dict_id=dict_id, level=5)
    d = tdict.load_dictionary(blob)
    assert d.dict_id == (dict_id or jdict.load_dictionary(blob).dict_id)
    assert d.dict_id >= 32768 or dict_id


def test_finalize_short_content_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jzdict.finalize_dictionary(b"1234567", SAMPLES["gen_text"])
    with pytest.raises(ValueError) as got:
        tzdict.finalize_dictionary(b"1234567", SAMPLES["gen_text"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("src_size", (-1, 1_000, 128 * 1024, 1 << 24))
def test_estimate_cctx_size_equals_jax(src_size):
    for level in range(-5, 23):
        assert tparams.estimate_cctx_size(level, src_size) == \
            jparams.estimate_cctx_size(level, src_size)
    assert tparams.estimate_cctx_size(3) == jparams.estimate_cctx_size(3)


def test_estimate_dctx_size_and_frame_params_equal_jax():
    assert tparams.estimate_dctx_size() == jparams.estimate_dctx_size()
    assert tparams.FrameParams() == tparams.FrameParams(True, False, False)
    assert dataclasses.astuple(tparams.FrameParams()) == \
        dataclasses.astuple(jparams.FrameParams())
    assert [f.name for f in dataclasses.fields(tparams.FrameParams)] == \
        [f.name for f in dataclasses.fields(jparams.FrameParams)]


def test_seq_to_codes_equals_jax():
    rng = np.random.default_rng(2)
    n = 3000
    ll = np.concatenate([np.arange(70), rng.integers(0, 1 << 17, n)])
    ob = np.concatenate([np.arange(1, 71), rng.integers(1, 1 << 27, n)])
    ml = np.concatenate([np.arange(70), rng.integers(0, 1 << 17, n)])
    seqs = tseq.SeqStore(ll.astype(np.int32), ob.astype(np.int32),
                         ml.astype(np.int32), b"")
    jseqs = jseq.SeqStore(ll.astype(np.int32), ob.astype(np.int32),
                          ml.astype(np.int32), b"")
    got = tseq.seq_to_codes(seqs)
    for t, j, v in zip(got, jseq.seq_to_codes(jseqs),
                       tseq.seq_to_codes_np(ll, ob, ml)):
        assert t.dtype == j.dtype and np.array_equal(t, j)
        assert np.array_equal(t, v)


@pytest.mark.parametrize("case", ("text", "skewed", "two_symbols"))
def test_ctable_to_dtable_equals_jax(case):
    if case == "text":
        count = np.bincount(_arr(TEXT), minlength=256).astype(np.int64)
    elif case == "skewed":
        count = (np.arange(256, dtype=np.int64) ** 3) % 1000 + 1
    else:
        count = np.zeros(256, np.int64)
        count[[7, 200]] = (9, 1)
    max_symbol = int(np.nonzero(count)[0].max())
    tct = thuf.build_huf_ctable(count, max_symbol)
    jct = jhuf.build_huf_ctable(count, max_symbol)
    t, j = thuf.ctable_to_dtable(tct), jhuf.ctable_to_dtable(jct)
    assert t.table_log == j.table_log
    assert np.array_equal(t.symbol, j.symbol)
    assert np.array_equal(t.length, j.length)
