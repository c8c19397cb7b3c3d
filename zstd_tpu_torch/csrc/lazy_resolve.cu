// Candidate scoring and chunked greedy resolve of the lazy and v3 match
// engines, in one launch: from the block bytes and the candidate rows to the
// committed slots.
//
// Replaces, in zstd_tpu/ops/fastmatch.py: `_resolve` (:179, its lax.scan of
// RESOLVE_STEPS = 160 steps over the L = n / 512 chunks of a row) and the
// XLA ops that feed it: the lengths against each candidate row
// (`_capped_mlen_at` :429 for the lazy engine, `_capped_mlen` :131 for v3),
// the lazy engine's gains, best candidate and deferral (`gain_of`,
// `consider` and the deferral, :493-529) and `_next_matchable` (:172).
//
// Contract: ops/fastmatch.py::select_resolve_plain, bit for bit. Inputs
// blocks u8[B, n], rows i32[R, B, n] (candidate positions, -1 = none; R = 10
// in lazy mode: LAZY_DEPTH rows on the mls hash, then 2 on the 4-byte hash;
// R = 1 in v3 mode), valid_lens i32[B] (<= n). Outputs yp, yl i32[B, L * 160]
// (chunk c's slots at [c * 160, (c + 1) * 160), slot t written by step t:
// (ip, l) where step t took a match of l >= 4 bytes at ip, else (-1, 0)),
// in lazy mode cand i32[B, n] (the best candidate of every position, -1 =
// none), and optionally steps i32[B, L] (the steps each chunk ran with
// ip < end).
//
// Per position p and candidate c (the plain chain's arithmetic):
// - run = 4 if bytes [c, c + 4) equal [p, p + 4), then + 3 for each pass
//   k = 4, 7, ... (6 passes lazy, 3 v3) while the 3-byte windows at c + k
//   and p + k agree; bytes past n read 0, and a window at c + k > n - 1
//   reads the window at n - 1 (the plain version clamps the gather).
// - v3: a short match at a far candidate counts as none (mlen < 6 beyond
//   1024, mlen < 5 beyond 64).
// - tail clip: 0 unless p < valid_len - 16, then min(run, valid_len - p).
// - lazy: gain = 7.5 ml - (8 + bitlen(max(p - c, 1))) in f32 where ml >= 4
//   and c >= 0, else -1e9; the best gain over the rows, strictly greater
//   (the nearer row wins ties); mlen = its length where the gain is > 0,
//   then 0 where gain(p + 1) > gain(p) + 7.5 or gain(p + 2) > gain(p) + 15
//   (-1e9 past the row's end).
// Then nxt = the first position >= i with mlen >= 4, and each chunk
// [base, end = base + 512) walks from ip = min(nxt[base], end): a step with
// ip < end takes l = min(mlen[ip], end - ip) if l >= 4 and moves to
// min(nxt[ip + (l or 1)], end). The walk reads only min(nxt, end) at
// positions in [base, end], so nxt here is chunk-local with "none" = end.
//
// Bound on an H100: the bytes the call must move, for the main path's batch
// of 32 rows of 131,072 B in lazy mode: the blocks (4,194,304 B), 10
// candidate rows (167,772,160 B), cand (16,777,216 B) and yp, yl
// (10,485,760 B), 199,229,568 B with valid_lens: 0.0595 ms at 3.35 TB/s;
// v3 mode reads one row and writes no cand, 31,457,280 B, 0.0094 ms. The
// candidate side's bytes are gathers at data-dependent c < p, served by L2
// (the batch's 4 MiB of blocks stays in the 50 MB L2).
//
// Design: one CTA of 256 threads a tile of 8 chunks (4,096 positions) of a
// row, grid (ceil(n / 4096), B):
// 1. stage the tile's bytes [base0, base0 + 4096 + 32) in shared memory,
//    zeros at and past n: every p-side read (bytes p .. p + 21 of the tile's
//    positions and of the two halo positions) falls there;
// 2. score: thread t takes positions t + 256 k (coalesced candidate rows),
//    each against all its candidates in registers: the p-side window is
//    three 8-byte words funnel-shifted from the stage, the c-side one the
//    same from aligned 8-byte loads of the block in global memory (through
//    L1/L2), and the first mismatching byte of their XOR (__ffsll) gives the
//    run in closed form, run = 4 + 3 min(passes, (m - 4) / 3). A candidate
//    with c > n - 32 takes a byte-by-byte path with the clamp, which also
//    keeps the word loads inside the row. Gains (exact in f32: multiples of
//    0.5 below 2^8; the __f*_rn intrinsics keep nvcc from contracting them)
//    and lengths go to shared memory, the best candidate to cand; threads 0
//    and 1 also score the next tile's first two positions (the halo gains);
// 3. the deferral, from the gains in shared memory (lazy mode);
// 4. nxt: warp w takes chunk w, a suffix minimum over its 512 mlen >= 4
//    flags (16 a lane, then across the warp by shuffles), as u16 offsets;
// 5. the walk: one thread a chunk in shared memory. Every step takes >= 4
//    bytes or is one of at most 3 steps with end - ip < 4, so a chunk runs
//    at most 131 of the 160 steps; the walk stops at ip >= end and pads its
//    slots with (-1, 0) in shared memory (reusing the gains' space);
// 6. the tile's slots, contiguous in yp and yl, are written coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;               // RESOLVE_CHUNK
constexpr int kSteps = 160;               // RESOLVE_STEPS
constexpr int kMinEmit = 4;               // MIN_EMIT
constexpr int kChunks = 8;                // chunks a CTA
constexpr int kTile = kChunks * kChunk;   // positions a CTA
constexpr int kHalo = 2;                  // the deferral reads p + 1, p + 2
constexpr int kStage = kTile + 32;        // staged bytes (516 words)
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;
constexpr int kLazyRows = 10;             // LAZY_DEPTH + 2
constexpr int kLazyPasses = 6;            // LAZY_PASSES = (4, 7, ..., 19)
constexpr int kV3Passes = 3;              // MLEN_PASSES = (4, 7, 10)
constexpr int kLazy = 0, kV3 = 1;
constexpr float kNoGain = -1e9f;

struct Window {          // bytes [0, 24) from a position, little-endian
  uint64_t w0, w1, w2;
};

__device__ __forceinline__ uint64_t funnel(uint64_t lo, uint64_t hi, int s) {
  return s ? (lo >> s) | (hi << (64 - s)) : lo;
}

__device__ __forceinline__ int first_byte(uint64_t x) {
  return (__ffsll(static_cast<long long>(x)) - 1) >> 3;
}

// The p-side window at tile offset r, from the staged words.
__device__ __forceinline__ Window stage_window(const uint64_t* st, int r) {
  const int q = r >> 3, s = (r & 7) * 8;
  const uint64_t a = st[q], b = st[q + 1], c = st[q + 2], d = st[q + 3];
  return {funnel(a, b, s), funnel(b, c, s), funnel(c, d, s)};
}

// The quantized run of a position against candidate c >= 0: pw is the
// position's window, pb its staged bytes.
template <int kPasses>
__device__ __forceinline__ int run_length(const uint8_t* __restrict__ blocks,
                                          size_t row, int n, int c,
                                          const Window& pw,
                                          const uint8_t* pb) {
  constexpr int kBytes = 4 + 3 * kPasses;       // bytes compared: 22 or 13
  if (c <= n - 32) {
    // aligned words covering [row + c, row + c + 24), inside the row
    const size_t x = row + c;
    const uint64_t* g = reinterpret_cast<const uint64_t*>(blocks) + (x >> 3);
    const int s = int(x & 7) * 8;
    const uint64_t g0 = __ldg(g), g1 = __ldg(g + 1);
    const uint64_t x0 = funnel(g0, g1, s) ^ pw.w0;
    if (x0 & 0xFFFFFFFFull) return 0;
    int m;                       // the first byte >= 4 that differs
    if (x0) {
      m = first_byte(x0);
    } else {
      const uint64_t g2 = __ldg(g + 2);
      const uint64_t x1 = funnel(g1, g2, s) ^ pw.w1;
      if (x1) {
        m = 8 + first_byte(x1);
      } else if (kBytes <= 16) {
        m = 16;
      } else {
        const uint64_t x2 = funnel(g2, __ldg(g + 3), s) ^ pw.w2;
        m = x2 ? 16 + first_byte(x2) : 24;
      }
    }
    return 4 + 3 * min(kPasses, (m - 4) / 3);
  }
  // near the row's end: byte by byte, the windows past n - 1 clamped
  const uint8_t* cb = blocks + row;
  for (int j = 0; j < 4; ++j)
    if ((c + j < n ? cb[c + j] : 0) != pb[j]) return 0;
  int run = 4;
  for (int k = 4; k < kBytes; k += 3) {
    bool eq;
    if (c + k <= n - 1) {
      eq = true;
      for (int j = k; j < k + 3; ++j)
        eq = eq && (c + j < n ? cb[c + j] : 0) == pb[j];
    } else {
      eq = cb[n - 1] == pb[k] && pb[k + 1] == 0 && pb[k + 2] == 0;
    }
    if (!eq) break;
    run += 3;
  }
  return run;
}

struct Best {
  float gain;
  int len, cand;
};

// Lazy mode: the best of the position's kLazyRows candidates.
__device__ __forceinline__ Best score_lazy(
    const uint8_t* __restrict__ blocks, const int32_t* __restrict__ rows,
    size_t row, size_t plane, int n, int p, int vl, const uint64_t* st,
    const uint8_t* sb, int r) {
  Best best = {kNoGain, 0, -1};
  if (p >= vl - 16) return best;     // every length clips to 0
  int cand[kLazyRows];
#pragma unroll
  for (int k = 0; k < kLazyRows; ++k)
    cand[k] = __ldg(rows + k * plane + row + p);
  const Window pw = stage_window(st, r);
#pragma unroll
  for (int k = 0; k < kLazyRows; ++k) {
    const int c = cand[k];
    if (c < 0) continue;
    const int ml = min(run_length<kLazyPasses>(blocks, row, n, c, pw, sb + r),
                       vl - p);
    if (ml < kMinEmit) continue;
    const int d = max(p - c, 1);
    const float g = __fsub_rn(__fmul_rn(7.5f, float(ml)),
                              __fadd_rn(8.0f, float(32 - __clz(d))));
    if (g > best.gain) best = {g, ml, c};
  }
  return best;
}

// v3 mode: the length against the position's one candidate.
__device__ __forceinline__ int score_v3(const uint8_t* __restrict__ blocks,
                                        const int32_t* __restrict__ rows,
                                        size_t row, int n, int p, int vl,
                                        const uint64_t* st, const uint8_t* sb,
                                        int r) {
  const int c = __ldg(rows + row + p);
  if (c < 0 || p >= vl - 16) return 0;
  int ml = run_length<kV3Passes>(blocks, row, n, c, stage_window(st, r),
                                 sb + r);
  const int dist = p - c;
  if ((ml < 6 && dist > 1024) || (ml < 5 && dist > 64)) ml = 0;
  return min(ml, vl - p);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 4)
lazy_resolve_kernel(const uint8_t* __restrict__ blocks,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ valid_lens,
                    int32_t* __restrict__ yp, int32_t* __restrict__ yl,
                    int32_t* __restrict__ cand_out,
                    int32_t* __restrict__ steps, int B, int n, int L) {
  __shared__ uint64_t s_stage[kStage / 8];
  __shared__ float s_gain[kTile + kHalo];     // then the slots
  __shared__ uint8_t s_mlen[kTile];
  __shared__ uint16_t s_nxt[kChunks][kChunk + 2];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int base0 = blockIdx.x * kTile;
  const size_t row = size_t(b) * n;
  const size_t plane = size_t(B) * n;
  const int vl = valid_lens[b];
  uint8_t* sb = reinterpret_cast<uint8_t*>(s_stage);

  // 1. stage the tile's bytes, zeros at and past n
  for (int i = tid; i < kStage; i += kThreads) {
    const int p = base0 + i;
    sb[i] = p < n ? blocks[row + p] : 0;
  }
  __syncthreads();

  // 2. score every position of the tile (and, lazy, the two halo gains)
  for (int k = 0; k < kPerThread; ++k) {
    const int r = tid + k * kThreads;
    const int p = base0 + r;
    if (kMode == kLazy) {
      Best best = {kNoGain, 0, -1};
      if (p < n) {
        best = score_lazy(blocks, rows, row, plane, n, p, vl, s_stage, sb, r);
        cand_out[row + p] = best.cand;
      }
      s_gain[r] = best.gain;
      s_mlen[r] = best.gain > 0.0f ? best.len : 0;
    } else {
      s_mlen[r] = p < n ? score_v3(blocks, rows, row, n, p, vl, s_stage, sb,
                                   r) : 0;
    }
  }
  if (kMode == kLazy && tid < kHalo) {
    const int r = kTile + tid, p = base0 + r;
    s_gain[r] = p < n ? score_lazy(blocks, rows, row, plane, n, p, vl,
                                   s_stage, sb, r).gain : kNoGain;
  }
  __syncthreads();

  // 3. the deferral: a match 1 or 2 bytes later gains more
  if (kMode == kLazy) {
    for (int k = 0; k < kPerThread; ++k) {
      const int r = tid + k * kThreads;
      const float g = s_gain[r];
      if (s_gain[r + 1] > __fadd_rn(g, 7.5f) ||
          s_gain[r + 2] > __fadd_rn(g, 15.0f))
        s_mlen[r] = 0;
    }
    __syncthreads();
  }

  // 4. chunk-local next matchable: warp w takes chunk w
  const int first = blockIdx.x * kChunks;     // the tile's first chunk
  const int count = max(0, min(kChunks, L - first));
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < count) {
    constexpr int kSeg = kChunk / 32;
    const uint8_t* m = s_mlen + warp * kChunk;
    uint16_t* x = s_nxt[warp];
    int v = kChunk;                            // the lane's first flag
    for (int j = kSeg - 1; j >= 0; --j)
      if (m[lane * kSeg + j] >= kMinEmit) v = lane * kSeg + j;
    for (int o = 1; o < 32; o <<= 1) {         // minimum over lanes >= lane
      const int u = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v = min(v, u);
    }
    int cur = __shfl_down_sync(0xffffffffu, v, 1);
    if (lane == 31) cur = kChunk;
    for (int j = kSeg - 1; j >= 0; --j) {
      const int q = lane * kSeg + j;
      if (m[q] >= kMinEmit) cur = q;
      x[q] = static_cast<uint16_t>(cur);
    }
    if (lane == 0) x[kChunk] = kChunk;
  }
  __syncthreads();

  // 5. the walk: one thread a chunk, offsets from the chunk's base
  int32_t* s_yp = reinterpret_cast<int32_t*>(s_gain);
  int32_t* s_yl = s_yp + kChunks * kSteps;
  if (tid < count) {
    const int base = (first + tid) * kChunk;
    const uint8_t* m = s_mlen + tid * kChunk;
    const uint16_t* x = s_nxt[tid];
    int32_t* op = s_yp + tid * kSteps;
    int32_t* ol = s_yl + tid * kSteps;
    int r = x[0];
    int t = 0;
    for (; t < kSteps && r < kChunk; ++t) {
      const int l = min(int(m[r]), kChunk - r);
      const bool take = l >= kMinEmit;
      op[t] = take ? base + r : -1;
      ol[t] = take ? l : 0;
      r = x[r + (take ? l : 1)];
    }
    if (steps != nullptr) steps[size_t(b) * L + first + tid] = t;
    for (int u = t; u < kSteps; ++u) {
      op[u] = -1;
      ol[u] = 0;
    }
  }
  __syncthreads();

  // 6. the tile's slots are contiguous in yp and yl
  const size_t out = (size_t(b) * L + first) * kSteps;
  for (int f = tid; f < count * kSteps; f += kThreads) {
    yp[out + f] = s_yp[f];
    yl[out + f] = s_yl[f];
  }
}

}  // namespace

// mode 0 = lazy (n_rows 10, cand written), 1 = v3 (n_rows 1, cand unused).
// blocks must be 8-byte aligned.
extern "C" int lazy_resolve_launch(const void* blocks, const void* rows,
                                   const void* valid_lens, void* yp, void* yl,
                                   void* cand, void* steps, int B, int n,
                                   int n_rows, int mode, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(blocks) % 8 != 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  const int L = n / kChunk;
  const dim3 grid((n + kTile - 1) / kTile, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bl = static_cast<const uint8_t*>(blocks);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* vl = static_cast<const int32_t*>(valid_lens);
  auto* p = static_cast<int32_t*>(yp);
  auto* l = static_cast<int32_t*>(yl);
  auto* st = static_cast<int32_t*>(steps);
  if (mode == kLazy && n_rows == kLazyRows) {
    lazy_resolve_kernel<kLazy><<<grid, kThreads, 0, s>>>(
        bl, rw, vl, p, l, static_cast<int32_t*>(cand), st, B, n, L);
  } else if (mode == kV3 && n_rows == 1) {
    lazy_resolve_kernel<kV3><<<grid, kThreads, 0, s>>>(
        bl, rw, vl, p, l, nullptr, st, B, n, L);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
