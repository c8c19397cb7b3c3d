"""Rsyncable mode: content-defined synchronization points.

Copy of zstd_tpu/rsync.py (numpy, host). Role of ZSTD_c_rsyncable /
findSynchronizationPoint (zstd's lib/compress/zstdmt_compress.c:833-1799):
zstd rolls a 32-byte multiplicative hash byte-at-a-time and cuts a job
wherever (hash & hitMask) == hitMask, with jobs never smaller than 128 KiB
(RSYNC_MIN_BLOCK_SIZE) and never larger than the target section size.
Because cut positions depend only on the local 32 bytes of content, a
local edit re-synchronizes the chunking within about one chunk, so rsync
re-transfers only the frames that actually changed.

All window hashes are computed at once. With an odd multiplier P
(invertible mod 2^64),

    hash(i) = sum_{j=0..W-1} b[i+j] * P^(W-1-j)
            = P^(W-1+i) * (A[i+W] - A[i])        (mod 2^64)

where A is the wrapping prefix sum of b[j] * P^-j. Two cumulative ops and
elementwise multiplies replace the per-byte loop; the scan runs in bounded
memory by segmenting the buffer (exponents are segment-local). The greedy
min/max spacing pass then walks only the sparse hit list.
"""

from __future__ import annotations

import numpy as np

WINDOW = 32                      # RSYNC_LENGTH
MIN_BLOCK = 1 << 17              # RSYNC_MIN_BLOCK_SIZE (128 KiB)
_PRIME = np.uint64(0x9E3779B97F4A7C15)          # odd => invertible mod 2^64
_PRIME_INV = np.uint64(pow(0x9E3779B97F4A7C15, -1, 1 << 64))
_SEG = 1 << 22                   # scan segment (bounds the u64 temporaries)


def _window_hashes(buf: np.ndarray) -> np.ndarray:
    """Hashes of every complete WINDOW-byte window of `buf` (vectorized).
    Returns an array of len(buf) - WINDOW + 1 uint64 values; hashes[i]
    covers buf[i : i + WINDOW]."""
    n = buf.shape[0]
    if n < WINDOW:
        return np.empty(0, np.uint64)
    with np.errstate(over="ignore"):
        pinv = np.empty(n, np.uint64)
        pinv[0] = 1
        if n > 1:
            pinv[1:] = _PRIME_INV
        np.multiply.accumulate(pinv, out=pinv)          # P^-k
        p = np.empty(n, np.uint64)
        p[0] = np.uint64(pow(int(_PRIME), WINDOW - 1, 1 << 64))
        if n > 1:
            p[1:] = _PRIME
        np.multiply.accumulate(p, out=p)                # P^(W-1+k)
        terms = buf.astype(np.uint64) * pinv
        acc = np.zeros(n + 1, np.uint64)
        np.cumsum(terms, out=acc[1:])                   # wraps mod 2^64
        span = acc[WINDOW:] - acc[: n - WINDOW + 1]
        return p[: n - WINDOW + 1] * span


def sync_points(data: bytes | bytearray | memoryview | np.ndarray,
                avg_log: int = 20,
                min_block: int = MIN_BLOCK) -> list[int]:
    """Content-defined cut offsets for `data`.

    avg_log: log2 of the mean chunk size (the reference's rsyncBits =
    highbit(jobSizeKB) + 10, i.e. the target section size). A cut is also
    forced at 2*2^avg_log without a hash hit, mirroring the reference's
    job-buffer bound; forced cuts self-heal at the next content hit.
    Returns strictly increasing offsets in (0, len(data)); the final
    partial chunk has no trailing cut.
    """
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    n = buf.shape[0]
    max_block = 2 << avg_log
    if n <= min_block:
        return []
    mask = np.uint64((1 << avg_log) - 1)

    hits: list[np.ndarray] = []
    for s in range(0, n, _SEG):
        seg = buf[s : s + _SEG + WINDOW - 1]
        h = _window_hashes(seg)
        idx = np.nonzero((h & mask) == mask)[0]
        if idx.size:
            # hash(i) covers bytes [i, i+W): the cut lands after the window
            hits.append(idx.astype(np.int64) + (s + WINDOW))
    cand = np.concatenate(hits) if hits else np.empty(0, np.int64)

    cuts: list[int] = []
    last = 0
    for c in map(int, cand):
        while c - last > max_block:           # forced cut: section full
            last += max_block
            if last < n:
                cuts.append(last)
        if c - last >= min_block and c < n:
            cuts.append(c)
            last = c
    while n - last > max_block:
        last += max_block
        cuts.append(last)
    return cuts


def split_rsyncable(data: bytes, avg_log: int = 20,
                    min_block: int = MIN_BLOCK) -> list[bytes]:
    """Split `data` at content-defined sync points."""
    pts = sync_points(data, avg_log=avg_log, min_block=min_block)
    bounds = [0] + pts + [len(data)]
    return [data[a:b] for a, b in zip(bounds, bounds[1:])]
