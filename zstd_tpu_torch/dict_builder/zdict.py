"""Dictionary finalization: entropy analysis + zstd dictionary serialization.

Copy of zstd_tpu/dict_builder/zdict.py. ZDICT_finalizeDictionary analog
(zstd's lib/dictBuilder/zdict.c:858, ZDICT_analyzeEntropy:659): run the
greedy match finder over the samples (with the dictionary content as window
prefix) to gather literal/LL/ML/OF statistics, normalize with +1 smoothing
over the FULL code alphabets (so repeat mode is always valid, mirroring
ZSTD_loadCEntropy's coverage requirement), and write magic + dictID +
tables + rep offsets + content.
"""

from __future__ import annotations

import numpy as np

from ..constants import (LL_FSE_LOG, MAX_LL_CODE, MAX_ML_CODE,
                         ML_FSE_LOG, OF_FSE_LOG)
from ..format import fse, huffman
from ..format.matchfinder import find_sequences
from ..format.sequences import seq_to_codes_np
from ..dictionary import write_dictionary
from ..params import get_cparams


def _gather_stats(content: bytes, samples: list[bytes], level: int):
    lit_hist = np.ones(256, dtype=np.int64)  # +1 smoothing
    ll_hist = np.ones(MAX_LL_CODE + 1, dtype=np.int64)
    ml_hist = np.ones(MAX_ML_CODE + 1, dtype=np.int64)
    # offsets: cover codes 0..28 (predefined policy ceiling; windowLog <= 27
    # keeps every producible code within range)
    of_hist = np.ones(29, dtype=np.int64)

    prefix = np.frombuffer(content, dtype=np.uint8)
    budget = 0
    for s in samples:
        if budget > 8 * 1024 * 1024:
            break
        budget += len(s)
        if len(s) < 16:
            continue
        cparams = get_cparams(level, len(s), len(content))
        full = np.concatenate([prefix, np.frombuffer(s, dtype=np.uint8)])
        seqs, _ = find_sequences(full, len(prefix), len(full), 0, (1, 4, 8),
                                 cparams.hash_log,
                                 min(max(cparams.min_match, 4), 8))
        lit = np.frombuffer(seqs.literals, dtype=np.uint8)
        if len(lit):
            lit_hist += np.bincount(lit, minlength=256)
        if seqs.nb_seq:
            llc, ofc, mlc = seq_to_codes_np(seqs.lit_length, seqs.off_base,
                                            seqs.ml_base)
            ll_hist += np.bincount(llc, minlength=MAX_LL_CODE + 1)
            ml_hist += np.bincount(mlc, minlength=MAX_ML_CODE + 1)
            ofc = np.minimum(ofc, 28)
            of_hist += np.bincount(ofc, minlength=29)
    return lit_hist, ll_hist, ml_hist, of_hist


def finalize_dictionary(content: bytes, samples: list[bytes],
                        dict_id: int = 0, level: int = 3) -> bytes:
    if len(content) < 8:
        raise ValueError("dictionary content must be at least 8 bytes")
    if dict_id == 0:
        from ..xxhash64 import xxh64
        dict_id = (xxh64(content) % ((1 << 31) - 32768)) + 32768

    lit_hist, ll_hist, ml_hist, of_hist = _gather_stats(content, samples, level)

    huf_ct = huffman.build_huf_ctable(lit_hist, 255, huffman.HUF_TABLELOG_DEFAULT)
    if huf_ct.table_log == 8:
        # flat distribution: HUF_writeCTable cannot encode it — replace
        # with the reference's fake mostly-flat-but-compressible one
        # (ZDICT_flatLit, zstd's lib/dictBuilder/zdict.c:649,733)
        lit_hist = np.full(256, 2, dtype=np.int64)
        lit_hist[0] = 4
        lit_hist[253] = 1
        lit_hist[254] = 1
        huf_ct = huffman.build_huf_ctable(lit_hist, 255,
                                          huffman.HUF_TABLELOG_DEFAULT)

    def norm_for(hist, fse_log):
        total = int(hist.sum())
        table_log = fse.optimal_table_log(fse_log, total, len(hist) - 1)
        return fse.normalize_count(hist, table_log, total, len(hist) - 1,
                                   use_low_prob_count=False), table_log

    norm_of, log_of = norm_for(of_hist, OF_FSE_LOG)
    norm_ml, log_ml = norm_for(ml_hist, ML_FSE_LOG)
    norm_ll, log_ll = norm_for(ll_hist, LL_FSE_LOG)

    reps = (1, 4, 8)
    return write_dictionary(dict_id, content, huf_ct,
                            norm_of, log_of, norm_ml, log_ml,
                            norm_ll, log_ll, reps)
