"""A numpy model of csrc/lazy_resolve.cu: candidate scoring and the chunked
greedy resolve of the lazy and v3 engines, one tile of 8 chunks at a time.

Per tile (4,096 positions of a row) the model follows the kernel's phases:
stage the tile's bytes and 32 more (zeros at and past n), score each
position against its candidates with the kernel's byte compares (the
p-side window funnel-shifted from the staged 8-byte words, the c-side one
from aligned 8-byte words of the batch, the run in closed form from the
first differing byte; a byte-by-byte path with the clamped window where
c > n - 32), the two halo gains of the next tile, the deferral, each
chunk's next-matchable as the warp computes it (16 positions a lane, then a
suffix minimum over the lanes), and the walk. tests/test_torch_lazy_fused.py
holds it to ops/fastmatch.py::select_resolve_plain. Test code only:
zstd_tpu_torch does not use it.
"""

import numpy as np

CHUNK, STEPS, MIN_EMIT = 512, 160, 4
CHUNKS = 8
TILE = CHUNKS * CHUNK
HALO = 2
STAGE = TILE + 32
LANES = 32
PASSES = {"lazy": 6, "v3": 3}
NO_GAIN = np.float32(-1e9)


def _funnel(lo, hi, s):
    """Bytes [s / 8, s / 8 + 8) of the 16-byte value hi:lo (u64 arrays)."""
    t = np.where(s == 0, 8, s).astype(np.uint64)
    return np.where(s == 0, lo, (lo >> t) | (hi << (np.uint64(64) - t)))


def _first_byte(x):
    """Index of the lowest nonzero byte of each nonzero u64."""
    low = x & (~x + np.uint64(1))
    return np.log2(np.where(x == 0, 1, low).astype(np.float64)).astype(
        np.int64) // 8


def _fast_runs(words, x, pw, passes):
    """The runs of the word path: x the candidates' byte offsets in the
    batch, pw the positions' three p-side words."""
    q = x >> 3
    s = ((x & 7) * 8).astype(np.uint64)
    g = [words[q + j] for j in range(4)]
    x0 = _funnel(g[0], g[1], s) ^ pw[0]
    x1 = _funnel(g[1], g[2], s) ^ pw[1]
    x2 = _funnel(g[2], g[3], s) ^ pw[2]
    m2 = 16 if 4 + 3 * passes <= 16 else \
        np.where(x2 != 0, 16 + _first_byte(x2), 24)
    m = np.where(x0 != 0, _first_byte(x0),
                 np.where(x1 != 0, 8 + _first_byte(x1), m2))
    ok = (x0 & np.uint64(0xFFFFFFFF)) == 0
    return np.where(ok, 4 + 3 * np.minimum(passes, (m - 4) // 3), 0)


def _slow_run(row, n, c, pb, passes, counts):
    """Byte by byte; a window at c + k > n - 1 is the window at n - 1."""
    def cb(j):
        return int(row[c + j]) if c + j < n else 0

    if any(cb(j) != pb[j] for j in range(4)):
        return 0
    run = 4
    for k in range(4, 4 + 3 * passes, 3):
        if c + k <= n - 1:
            eq = all(cb(j) == pb[j] for j in range(k, k + 3))
        else:
            eq = (row[n - 1], 0, 0) == tuple(pb[k:k + 3])
            counts["clamped"] += eq
        if not eq:
            break
        run += 3
    return run


def _chunk_nxt(m):
    """Chunk-local next matchable (offsets, 512 = none) of one chunk's
    mlen, as the kernel's warp computes it, with the entry at 512."""
    seg = CHUNK // LANES
    idx = np.where(m >= MIN_EMIT, np.arange(CHUNK), CHUNK).reshape(LANES, seg)
    firsts = idx.min(axis=1)
    after = np.append(np.minimum.accumulate(firsts[::-1])[::-1][1:], CHUNK)
    x = np.empty(CHUNK + 1, np.int64)
    for lane in range(LANES):
        cur = after[lane]
        for j in range(seg - 1, -1, -1):
            cur = min(cur, idx[lane, j])
            x[lane * seg + j] = cur
    x[CHUNK] = CHUNK
    return x


def _walk(m, x, base):
    """One chunk's greedy walk: (slots ip, slots l, active steps)."""
    op = np.full(STEPS, -1, np.int32)
    ol = np.zeros(STEPS, np.int32)
    r, t = int(x[0]), 0
    while t < STEPS and r < CHUNK:
        l = min(int(m[r]), CHUNK - r)
        take = l >= MIN_EMIT
        if take:
            op[t], ol[t] = base + r, l
        r = int(x[r + (l if take else 1)])
        t += 1
    return op, ol, t


def select_resolve(blocks, rows, lens, mode):
    """blocks u8[B, n], rows i32[R, B, n], lens i32[B] -> (yp, yl, cand,
    steps, counts), the first four as select_resolve_plain gives them
    (steps its active-step counts a chunk), counts a dict: positions scored,
    candidates on the word path, on the byte path, byte-path runs > 0, and
    clamped windows that agreed."""
    B, n = blocks.shape
    passes = PASSES[mode]
    L = n // CHUNK
    # the kernel's word loads stay inside the batch; the pad only keeps the
    # model's vectorized loads of lanes it then drops in range
    flat = np.concatenate([blocks.reshape(-1),
                           np.zeros(32 + (-B * n) % 8, np.uint8)])
    words = flat.view("<u8")
    yp = np.full((B, L * STEPS), -1, np.int32)
    yl = np.zeros((B, L * STEPS), np.int32)
    cand_out = np.full((B, n), -1, np.int32)
    steps = np.zeros((B, L), np.int32)
    counts = dict(scored=0, word=0, byte=0, byte_matched=0, clamped=0)
    for b in range(B):
        vl = int(lens[b])
        for t in range(-(-n // TILE)):
            base0 = t * TILE
            stage = np.zeros(STAGE, np.uint8)
            part = blocks[b, base0:base0 + STAGE]
            stage[:len(part)] = part
            sw = stage.view("<u8")
            width = TILE + (HALO if mode == "lazy" else 0)
            r = np.arange(width)
            p = base0 + r
            live = (p < n) & (p < vl - 16)
            counts["scored"] += int(live.sum())
            q = r >> 3
            s = ((r & 7) * 8).astype(np.uint64)
            pw = [_funnel(sw[q + j], sw[q + j + 1], s) for j in range(3)]
            best_gain = np.full(width, NO_GAIN, np.float32)
            best_len = np.zeros(width, np.int64)
            best_cand = np.full(width, -1, np.int64)
            mlen = np.zeros(width, np.int64)
            for k in range(rows.shape[0]):
                c = np.full(width, -1, np.int64)
                c[p < n] = rows[k, b, p[p < n]]
                active = live & (c >= 0)
                fast = active & (c <= n - 32)
                run = np.zeros(width, np.int64)
                x = b * n + np.where(fast, c, 0)
                assert ((x[fast] >> 3) * 8 + 32 <= (b + 1) * n).all()
                run[fast] = _fast_runs(words, x, pw, passes)[fast]
                counts["word"] += int(fast.sum())
                for i in np.flatnonzero(active & ~fast):
                    run[i] = _slow_run(blocks[b], n, int(c[i]),
                                       stage[r[i]:r[i] + 22], passes, counts)
                    counts["byte"] += 1
                    counts["byte_matched"] += run[i] > 0
                if mode == "v3":
                    dist = p - c
                    weak = ((run < 6) & (dist > 1024)) | ((run < 5)
                                                          & (dist > 64))
                    mlen = np.where(active & ~weak,
                                    np.minimum(run, vl - p), 0)
                    continue
                ml = np.where(active, np.minimum(run, vl - p), 0)
                bits = np.frexp(np.maximum(p - c, 1).astype(np.float32))[1]
                g = np.where(ml >= MIN_EMIT,
                             np.float32(7.5) * ml.astype(np.float32)
                             - (np.float32(8.0) + bits.astype(np.float32)),
                             NO_GAIN).astype(np.float32)
                take = g > best_gain
                best_gain = np.where(take, g, best_gain)
                best_len = np.where(take, ml, best_len)
                best_cand = np.where(take, c, best_cand)
            if mode == "lazy":
                own = p[:TILE] < n
                cand_out[b, p[:TILE][own]] = best_cand[:TILE][own]
                g = best_gain
                mlen = np.where(g[:TILE] > 0, best_len[:TILE], 0)
                defer = (g[1:TILE + 1] > g[:TILE] + np.float32(7.5)) \
                    | (g[2:TILE + 2] > g[:TILE] + np.float32(15.0))
                mlen = np.where(defer, 0, mlen)
            for j in range(t * CHUNKS, min(t * CHUNKS + CHUNKS, L)):
                m = mlen[(j - t * CHUNKS) * CHUNK:][:CHUNK]
                op, ol, st = _walk(m, _chunk_nxt(m), j * CHUNK)
                yp[b, j * STEPS:(j + 1) * STEPS] = op
                yl[b, j * STEPS:(j + 1) * STEPS] = ol
                steps[b, j] = st
    if mode == "v3":             # the wrapper returns the row itself
        cand_out = rows[0].copy()
    return yp, yl, cand_out, steps, counts
