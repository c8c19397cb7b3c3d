"""COVER-style dictionary training with exact d-mer statistics.

Copy of zstd_tpu/dict_builder/cover.py. Same role as
ZDICT_trainFromBuffer_cover (zstd's lib/dictBuilder/cover.c:779:
suffix-sorted exact d-mer frequencies, epoch partitioning
COVER_computeEpochs, greedy segment scoring COVER_selectSegment:466) built
vectorized: d-mer keys are sorted once to get exact global counts (no hash
collisions — the quality edge over fastCover), epochs partition the
training data, and the best k-segment per epoch is chosen by sliding-window
frequency score with chosen d-mers suppressed.

The k/d hyper-parameter sweep (ZDICT_optimizeTrainFromBuffer_cover:1167)
is grid-parallel: each (k, d) cell is independent."""

from __future__ import annotations

import numpy as np

from .fastcover import train_from_samples as _fastcover_train


def _dmer_keys(arr: np.ndarray, d: int) -> np.ndarray:
    """Exact u64 keys of every d-mer for d <= 8 (value itself)."""
    n = len(arr) - d + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    v = np.zeros(n, dtype=np.uint64)
    for j in range(min(d, 8)):
        v |= arr[j : j + n].astype(np.uint64) << np.uint64(8 * j)
    if d > 8:
        # fold the tail bytes in multiplicatively (near-exact for d <= 16)
        w = np.zeros(n, dtype=np.uint64)
        for j in range(8, d):
            w |= arr[j : j + n].astype(np.uint64) << np.uint64(8 * (j - 8))
        v ^= w * np.uint64(0x9E3779B97F4A7C15)
    return v


def _dmer_key_pair(arr: np.ndarray, d: int):
    """EXACT two-u64 key of every d-mer for d <= 16 (the divsufsort role:
    the reference suffix-sorts to get collision-free d-mer counts,
    cover.c:779; a radix pair-sort over (first 8, last d-8 bytes) gives
    the identical equivalence classes for the COVER d range 6..16
    without the suffix array)."""
    n = len(arr) - d + 1
    if n <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z
    hi = np.zeros(n, dtype=np.uint64)
    for j in range(min(d, 8)):
        hi |= arr[j : j + n].astype(np.uint64) << np.uint64(8 * j)
    lo = np.zeros(n, dtype=np.uint64)
    for j in range(8, d):
        lo |= arr[j : j + n].astype(np.uint64) << np.uint64(8 * (j - 8))
    return hi, lo


def train_from_samples_cover(samples: list[bytes],
                             max_dict_size: int = 112640,
                             k: int = 1024, d: int = 8) -> bytes:
    """Returns raw dictionary content (best segments last)."""
    samples = [s for s in samples if len(s) >= d]
    if not samples:
        raise ValueError("no usable training samples")
    arrs = [np.frombuffer(s, dtype=np.uint8) for s in samples]

    # exact global d-mer counts via one (pair-)sort over all samples —
    # collision-free for the whole COVER d range (d <= 16), the quality
    # contract divsufsort provides in the reference
    pairs = [_dmer_key_pair(a, d) for a in arrs]
    keys = np.concatenate([p[0] for p in pairs])
    keys_lo = np.concatenate([p[1] for p in pairs])
    if len(keys) == 0:
        raise ValueError("samples too small for d")
    order = np.lexsort((keys_lo, keys))
    ks = keys[order]
    ks_lo = keys_lo[order]
    boundary = np.concatenate(
        [[True], (ks[1:] != ks[:-1]) | (ks_lo[1:] != ks_lo[:-1])])
    group = np.cumsum(boundary) - 1
    counts_per_group = np.bincount(group)
    freq_sorted = counts_per_group[group]
    freqs = np.empty(len(keys), dtype=np.int64)
    freqs[order] = freq_sorted
    # map group ids back to positions (for suppression)
    gids = np.empty(len(keys), dtype=np.int64)
    gids[order] = group
    n_groups = int(group[-1]) + 1
    alive = np.ones(n_groups, dtype=bool)

    # per-sample views
    offs = np.cumsum([0] + [len(a) - d + 1 for a in arrs])

    epochs = max(1, min(max_dict_size // max(min(k, 256), 1), 64))
    chosen: list[bytes] = []
    used = 0
    for _ in range(epochs):
        best = None
        for si, a in enumerate(arrs):
            m = len(a) - d + 1
            if m < 1:
                continue
            # samples shorter than k contribute their full span (the
            # reference's k-sweep covers short-sample corpora; a fixed k
            # must not skip them entirely)
            w = min(k - d + 1, m)
            f = np.where(alive[gids[offs[si] : offs[si] + m]],
                         freqs[offs[si] : offs[si] + m], 0)
            cs = np.concatenate([[0], np.cumsum(f)])
            scores = cs[w:] - cs[:-w]
            if len(scores) == 0:
                continue
            stride = max(k // 8, 1)
            idx = np.arange(0, len(scores), stride)
            loc = int(idx[np.argmax(scores[idx])])
            sc = int(scores[loc])
            if best is None or sc > best[0]:
                best = (sc, si, loc, w)
        if best is None or best[0] <= 0:
            break
        sc, si, start, w = best
        seg = arrs[si][start : start + k]
        chosen.append(seg.tobytes())
        used += len(seg)
        alive[gids[offs[si] + start : offs[si] + start + w]] = False
        if used >= max_dict_size:
            break

    if not chosen:
        big = max(samples, key=len)
        return big[-max_dict_size:]
    content = b"".join(reversed(chosen))
    return content[-max_dict_size:]


def optimize_train(samples: list[bytes], max_dict_size: int = 112640,
                   cover: bool = False, steps: int = 8) -> tuple[bytes, dict]:
    """k/d grid sweep (ZDICT_optimizeTrainFromBuffer_* analog). Scores each
    candidate dictionary by total compressed size of a held-out subset.
    Returns (content, {'k':…, 'd':…}). Grid cells are independent."""
    from ..dictionary import compress_with_dict, load_dictionary

    ks = [256, 512, 1024, 2048][: max(steps // 2, 2)]
    ds = [6, 8]
    holdout = samples[: max(1, len(samples) // 4)]
    best = None
    for k in ks:
        for d in ds:
            try:
                if cover:
                    content = train_from_samples_cover(
                        samples, max_dict_size, k=k, d=d)
                else:
                    content = _fastcover_train(
                        samples, max_dict_size, k=k, d=d)
            except ValueError:
                continue
            dd = load_dictionary(content)
            total = sum(len(compress_with_dict(s, dd, level=3))
                        for s in holdout)
            if best is None or total < best[0]:
                best = (total, content, {"k": k, "d": d})
    if best is None:
        raise ValueError("no trainable configuration")
    return best[1], best[2]
