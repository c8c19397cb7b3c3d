// Chunked greedy resolve of the lazy and v3 match engines: the lockstep
// greedy commit over 512-byte chunks of each row.
//
// Replaces: zstd_tpu/ops/fastmatch.py:179, `_resolve` (its lax.scan of
// RESOLVE_STEPS = 160 steps over the L = n / 512 chunks of a row). Same
// contract as ops/fastmatch.py::resolve_plain: inputs mlen, nxt i32[B, n]
// (nxt = the first position >= i with mlen >= 4, else 2n); outputs yp, yl
// i32[B, L * 160], chunk c's slots at [c * 160, (c + 1) * 160), slot t
// written by step t: (ip, l) where step t took a match of l >= 4 bytes at
// ip, else (-1, 0). Per chunk [base, end = base + 512), from
// ip = min(nxt[base], end), a step with ip < end takes l = min(mlen[ip],
// end - ip) if l >= 4 and moves to min(nxt[min(ip + adv, n - 1)], end),
// adv = l or 1. Optional steps i32[B, L]: the steps each chunk ran with
// ip < end.
//
// Bound on an H100: the bytes the call must move, mlen and nxt read once
// (8 B a position) and yp, yl written (8 B a slot): 44,040,192 B, 0.0131
// ms, for the main path's batch of 32 rows of 131,072 B at 3.35 TB/s. The
// walk itself is a chain of dependent steps per chunk, each two loads that
// need the previous step's position.
//
// Design: every read of a chunk's walk lies in [base, end]: ip < end and
// ip + adv <= end. So a CTA stages the mlen (512 words) and nxt (513 words,
// the last clamped to n - 1) of kChunks chunks in shared memory with all its
// threads, coalesced; one thread a chunk then walks the chain there, its
// loads shared-memory loads. Every step either takes a match of >= 4 bytes
// or is one of at most 3 steps with end - ip < 4 (steps start at nxt
// positions or at end), so a chunk runs at most 128 + 3 = 131 steps: the
// walk stops at ip >= end and pads the rest of its 160 slots with (-1, 0).
// The slots go to shared memory and the CTA writes its chunks' slots, which
// are contiguous in yp and yl, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;      // RESOLVE_CHUNK
constexpr int kSteps = 160;      // RESOLVE_STEPS
constexpr int kMinEmit = 4;      // MIN_EMIT
constexpr int kChunks = 8;       // chunks a CTA
constexpr int kThreads = 256;
constexpr int kNxtPad = kChunk + 4;

__global__ void __launch_bounds__(kThreads)
lazy_resolve_kernel(const int32_t* __restrict__ mlen,
                    const int32_t* __restrict__ nxt, int32_t* __restrict__ yp,
                    int32_t* __restrict__ yl, int32_t* __restrict__ steps,
                    int n, int L, int total) {
  __shared__ int32_t s_mlen[kChunks][kChunk];
  __shared__ int32_t s_nxt[kChunks][kNxtPad];
  __shared__ int32_t s_yp[kChunks * kSteps];
  __shared__ int32_t s_yl[kChunks * kSteps];

  const int first = blockIdx.x * kChunks;         // global chunk index
  const int count = min(kChunks, total - first);
  const int tid = threadIdx.x;

  // 1. stage: chunk g = first + c is chunk j = g % L of row b = g / L
  for (int f = tid; f < count * (kChunk + 1); f += kThreads) {
    const int c = f / (kChunk + 1), i = f - c * (kChunk + 1);
    const int g = first + c;
    const int b = g / L, base = (g - b * L) * kChunk;
    const size_t row = size_t(b) * n;
    s_nxt[c][i] = nxt[row + min(base + i, n - 1)];
    if (i < kChunk) s_mlen[c][i] = mlen[row + base + i];
  }
  __syncthreads();

  // 2. walk: one thread a chunk, positions relative to the chunk's base
  if (tid < count) {
    const int g = first + tid;
    const int base = (g % L) * kChunk;
    const int32_t* m = s_mlen[tid];
    const int32_t* x = s_nxt[tid];
    int32_t* op = s_yp + tid * kSteps;
    int32_t* ol = s_yl + tid * kSteps;
    int r = min(x[0] - base, kChunk);
    int t = 0;
    for (; t < kSteps && r < kChunk; ++t) {
      const int l = min(m[r], kChunk - r);
      const bool take = l >= kMinEmit;
      op[t] = take ? base + r : -1;
      ol[t] = take ? l : 0;
      r = min(x[r + (take ? l : 1)] - base, kChunk);
    }
    if (steps != nullptr) steps[g] = t;
    for (int u = t; u < kSteps; ++u) {
      op[u] = -1;
      ol[u] = 0;
    }
  }
  __syncthreads();

  // 3. write: the CTA's chunks' slots are contiguous in yp and yl
  const size_t out = size_t(first) * kSteps;
  for (int f = tid; f < count * kSteps; f += kThreads) {
    yp[out + f] = s_yp[f];
    yl[out + f] = s_yl[f];
  }
}

}  // namespace

extern "C" int lazy_resolve_launch(const void* mlen, const void* nxt,
                                   void* yp, void* yl, void* steps, int B,
                                   int n, void* stream) {
  const int L = n / kChunk;
  const int total = B * L;
  if (total == 0) return 0;
  const int grid = (total + kChunks - 1) / kChunks;
  lazy_resolve_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mlen), static_cast<const int32_t*>(nxt),
      static_cast<int32_t*>(yp), static_cast<int32_t*>(yl),
      static_cast<int32_t*>(steps), n, L, total);
  return int(cudaGetLastError());
}
