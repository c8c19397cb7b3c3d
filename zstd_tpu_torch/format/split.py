"""Cost-driven block splitting over a ready seqstore.

Copy of zstd_tpu/format/split.py without its target-block-size cuts (the
port has no target_cblock_size), with ZT_SPLIT_OVH and ZT_SPLIT_MINSEQ
constants at their defaults (56 and 150). Role of ZSTD_deriveBlockSplits /
ZSTD_deriveBlockSplitsHelper (zstd's lib/compress/zstd_compress.c:4118-4157):
recursively split a block's sequence array at midpoints whenever the entropy-estimated cost of
the halves (plus per-block overhead) beats the whole, so each emitted block
gets tables adapted to its local statistics. The estimator is ours: exact
Shannon cost of the segment's literal/code histograms + extra bits +
a fixed table/header overhead; the reference instead re-runs its entropy
sizer (ZSTD_estimateSubBlockSize) — same decision shape, different engine.
"""

from __future__ import annotations

import numpy as np

from .sequences import SeqStore, seq_to_codes_np

_LL_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64)
_ML_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
     1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64)

# per extra block: 3B block header + literals header + fresh-ish tables.
_SPLIT_OVERHEAD_BITS = 8 * 56
# recurse while a half keeps >= 150 sequences (i.e. split segments of >= 300,
# the reference's MIN_SEQUENCES_BLOCK_SPLITTING; depth is then bounded by the
# sequence count, not a fixed fan-out, zstd_compress.c:4122)
_MIN_SEQS = 150


def _h_bits(counts: np.ndarray) -> float:
    tot = counts.sum()
    if tot <= 0:
        return 0.0
    nz = counts[counts > 0].astype(np.float64)
    return float((nz * np.log2(tot / nz)).sum())


class _Est:
    """Segment cost estimator over precomputed per-sequence code arrays."""

    def __init__(self, seqs: SeqStore, lit_arr: np.ndarray):
        self.llc, self.ofc, self.mlc = seq_to_codes_np(
            seqs.lit_length, seqs.off_base, seqs.ml_base)
        self.lit_arr = lit_arr
        self.lit_starts = np.concatenate(
            [[0], np.cumsum(seqs.lit_length)]).astype(np.int64)
        self.extra_bits = (_LL_BITS[self.llc] + _ML_BITS[self.mlc]
                           + self.ofc.astype(np.int64))

    def cost_bits(self, a: int, b: int, lit_end: int | None = None) -> float:
        ls = self.lit_starts[a]
        le = self.lit_starts[b] if lit_end is None else lit_end
        lits = self.lit_arr[ls:le]
        lit_cost = _h_bits(np.bincount(lits, minlength=256))
        code_cost = (_h_bits(np.bincount(self.llc[a:b], minlength=36))
                     + _h_bits(np.bincount(self.mlc[a:b], minlength=53))
                     + _h_bits(np.bincount(self.ofc[a:b], minlength=32)))
        return lit_cost + code_cost + float(self.extra_bits[a:b].sum())


def split_points(seqs: SeqStore, max_depth: int = 10) -> list[int]:
    """Sequence-index split points (interior), or [] when one block wins."""
    n = seqs.nb_seq
    lit_arr = np.frombuffer(seqs.literals, dtype=np.uint8)
    est = _Est(seqs, lit_arr)
    out: list[int] = []

    if n < 2 * _MIN_SEQS:
        return []

    def rec(a: int, b: int, depth: int) -> None:
        if depth >= max_depth or b - a < 2 * _MIN_SEQS:
            return
        m = (a + b) // 2
        whole = est.cost_bits(a, b)
        halves = (est.cost_bits(a, m) + est.cost_bits(m, b)
                  + _SPLIT_OVERHEAD_BITS)
        if halves < whole:
            rec(a, m, depth + 1)
            out.append(m)
            rec(m, b, depth + 1)

    rec(0, n, 0)
    return sorted(out)


def slice_seqstore(seqs: SeqStore, a: int, b: int, last: bool) -> SeqStore:
    """Sub-seqstore for sequences [a, b); trailing literals go to the last
    slice only. Offsets/ob codes stay valid: the decoder's repcode state and
    window persist across in-frame block boundaries."""
    lit_arr = np.frombuffer(seqs.literals, dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(seqs.lit_length)]).astype(np.int64)
    ls = int(starts[a])
    le = len(lit_arr) if last else int(starts[b])
    return SeqStore(seqs.lit_length[a:b], seqs.off_base[a:b],
                    seqs.ml_base[a:b],
                    lit_arr[ls:le].tobytes())


def segment_content_len(seqs: SeqStore, a: int, b: int, last: bool,
                        total_len: int, prefix_len: int) -> int:
    """Source bytes covered by sequences [a, b) (+ trailing lits if last)."""
    if last:
        return total_len - prefix_len
    span = int((seqs.lit_length[a:b] + seqs.ml_base[a:b] + 3).sum())
    return span
