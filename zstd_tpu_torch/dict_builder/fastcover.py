"""fastCover-style dictionary content selection.

Copy of zstd_tpu/dict_builder/fastcover.py. Same role as
ZDICT_trainFromBuffer_fastCover (zstd's lib/dictBuilder/fastcover.c:549):
hash d-mers into a 2^f frequency table, then greedily pick the
highest-scoring k-byte segments per epoch, suppressing already-covered
d-mers. Counting and scoring are numpy-vectorized; the greedy epoch loop is
tiny.
"""
from __future__ import annotations

import numpy as np

_PRIME64 = np.uint64(0xCF1BBCDCB7A56463)


def _dmer_hashes(arr: np.ndarray, d: int, f: int) -> np.ndarray:
    """uint64[len(arr)-d+1] bucket ids of every d-mer (d <= 8)."""
    n = len(arr) - d + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    v = np.zeros(n, dtype=np.uint64)
    for k in range(d):
        v |= arr[k : k + n].astype(np.uint64) << np.uint64(8 * k)
    return (v * _PRIME64) >> np.uint64(64 - f)


def train_from_samples(samples: list[bytes], max_dict_size: int = 112640,
                       k: int = 1024, d: int = 8, f: int = 20,
                       split: float = 0.75) -> bytes:
    """Returns raw dictionary *content* (most valuable segments, in reverse
    recency order: best segments at the END, nearest to the data)."""
    samples = [s for s in samples if len(s) >= d]
    if not samples:
        raise ValueError("no usable training samples")
    n_train = max(1, int(len(samples) * split))
    train = samples[:n_train]

    freqs = np.zeros(1 << f, dtype=np.int64)
    arrs = []
    for s in train:
        a = np.frombuffer(s, dtype=np.uint8)
        arrs.append(a)
        h = _dmer_hashes(a, d, f)
        np.add.at(freqs, h, 1)

    chosen: list[bytes] = []
    used = 0
    epochs = max(1, max_dict_size // k)

    # Precompute per-sample dmer hash arrays once
    hashes = [_dmer_hashes(a, d, f) for a in arrs]

    for _ in range(epochs):
        best = None  # (score, sample_idx, start)
        for si, h in enumerate(hashes):
            if len(h) < 1:
                continue
            fh = freqs[h]
            # sliding-window sum of d-mer scores; samples shorter than k
            # contribute their full span as one window (the reference's
            # k-sweep covers this; a fixed k must not skip short samples)
            w = min(k - d + 1, len(h))
            cs = np.concatenate([[0], np.cumsum(fh)])
            scores = cs[w:] - cs[:-w]
            if len(scores) == 0:
                continue
            # stride candidates to bound work (fastcover uses every position;
            # k/4 stride keeps quality while cutting cost)
            stride = max(k // 4, 1)
            idx = np.arange(0, len(scores), stride)
            loc = idx[np.argmax(scores[idx])]
            sc = int(scores[loc])
            if best is None or sc > best[0]:
                best = (sc, si, int(loc))
        if best is None or best[0] <= 0:
            break
        sc, si, start = best
        seg = arrs[si][start : start + k]
        chosen.append(seg.tobytes())
        used += len(seg)
        # suppress the chosen segment's d-mers
        h = _dmer_hashes(seg, d, f)
        freqs[h] = 0
        if used >= max_dict_size:
            break

    if not chosen:
        # degenerate: use the tail of the largest sample
        big = max(samples, key=len)
        return big[-max_dict_size:]
    # most valuable content at the end (closest offsets)
    content = b"".join(reversed(chosen))
    return content[-max_dict_size:]
