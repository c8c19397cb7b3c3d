// Greedy match commit + seqstore/literal compaction, one block row per CTA.
//
// Replaces: zstd_tpu/ops/resolve_pallas.py::_extract_kernel (reached through
// extract_compact from ops/seqextract.py::extract_batch_pallas). The Pallas
// kernel's 128-lane roll/realign and scalar blends have no counterpart here;
// this computes the same scan (see zstd_tpu_torch/ops/resolve.py for the
// contract and extract_plain for the same scan in Python).
//
// Bound on an H100: the scan is a serial chain. Each step needs cand[ip] and
// nxt[ip + 1] before it can choose the next ip, so a step costs one dependent
// global-memory round trip (~0.5-1 us), and a row costs its number of steps
// (about two per emitted sequence). The bytes it must move (the row, the
// candidate and jump tables, the outputs) would take microseconds at
// 3.35 TB/s; the latency chain, not bandwidth, is the limit.
//
// Design: one CTA of one warp per row. The row (N bytes + 256 zero bytes) sits
// in dynamic shared memory, so every byte compare of the match-length and
// backward-extension loops is a shared-memory read. All lanes run the same
// control flow. lcp compares 128 bytes per round (4 bytes per lane,
// __ballot_sync/__ffs find the first mismatch); backward extension tests 32
// positions per round; literal runs are copied by the whole warp. cand and
// nxt for a step are issued together, so a step pays one memory latency, not
// two. Rows run in parallel on separate SMs (B CTAs in flight).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t load4(const uint8_t* s, int i) {
  return uint32_t(s[i]) | (uint32_t(s[i + 1]) << 8) |
         (uint32_t(s[i + 2]) << 16) | (uint32_t(s[i + 3]) << 24);
}

__global__ void __launch_bounds__(32)
extract_kernel(const uint8_t* __restrict__ bytes,
               const int32_t* __restrict__ cand,
               const int32_t* __restrict__ nxt,
               const int32_t* __restrict__ vlens,
               int32_t* __restrict__ ll_out, int32_t* __restrict__ off_out,
               int32_t* __restrict__ ml_out, uint8_t* __restrict__ lits,
               int32_t* __restrict__ nb_seq_out,
               int32_t* __restrict__ nb_lit_out, int N, int cap) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = bytes + size_t(b) * N;
  const int32_t* cb = cand + size_t(b) * N;
  const int32_t* xb = nxt + size_t(b) * N;
  uint8_t* lrow = lits + size_t(b) * N;
  int32_t* llr = ll_out + size_t(b) * cap;
  int32_t* offr = off_out + size_t(b) * cap;
  int32_t* mlr = ml_out + size_t(b) * cap;

  if ((N & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(sm);
    for (int i = lane; i < N / 16; i += 32) d4[i] = s4[i];
  } else {
    for (int i = lane; i < N; i += 32) sm[i] = src[i];
  }
  for (int i = lane; i < kPad; i += 32) sm[N + i] = 0;
  __syncwarp();

  const int vl = vlens[b];
  const int limit_pos = vl - 8;
  int ip = 0, anchor = 0, k = 0, r = 0;
  while (ip < limit_pos && k < cap) {
    const int c = cb[ip];
    const int nx = xb[min(ip + 1, limit_pos)];
    int l = 0;
    if (c >= 0) {
      const int limit = vl - ip;
      // ip + l < vl <= N, so a round reads at most sm[N + 126]
      while (true) {
        const int o = l + 4 * lane;
        const uint32_t x = load4(sm, ip + o) ^ load4(sm, c + o);
        const unsigned m = __ballot_sync(kFull, x != 0);
        if (m) {
          const int fl = __ffs(m) - 1;
          const uint32_t xf = __shfl_sync(kFull, x, fl);
          l += 4 * fl + ((__ffs(xf) - 1) >> 3);
          break;
        }
        l += 128;
        if (l >= limit) break;
      }
      l = min(l, limit);
    }
    if (l >= 4) {
      const int d = ip - c;
      int s = ip;
      while (true) {   // backward extension, 32 positions per round
        const int t = s - 1 - lane;
        const bool ok = t >= anchor && t >= d && sm[t] == sm[t - d];
        const unsigned m = __ballot_sync(kFull, !ok);
        if (m) {
          s -= __ffs(m) - 1;
          break;
        }
        s -= 32;
      }
      const int lit_len = s - anchor;
      for (int i = lane; i < lit_len; i += 32) lrow[r + i] = sm[anchor + i];
      if (lane == 0) {
        llr[k] = lit_len;
        offr[k] = d;
        mlr[k] = l + (ip - s);
      }
      ++k;
      r += lit_len;
      ip += l;
      anchor = ip;
    } else {
      ip = max(nx, ip + 1);
    }
  }
  const int tail = max(vl - anchor, 0);
  for (int i = lane; i < tail; i += 32) lrow[r + i] = sm[anchor + i];
  r += tail;
  for (int i = k + lane; i < cap; i += 32) {
    llr[i] = 0;
    offr[i] = 0;
    mlr[i] = 0;
  }
  for (int i = r + lane; i < N; i += 32) lrow[i] = 0;
  if (lane == 0) {
    nb_seq_out[b] = k;
    nb_lit_out[b] = r;
  }
}

}  // namespace

extern "C" int extract_launch(const void* bytes, const void* cand,
                              const void* nxt, const void* vlens, void* ll,
                              void* off, void* ml, void* lits, void* nb_seq,
                              void* nb_lit, int B, int N, int cap,
                              void* stream) {
  const size_t smem = size_t(N) + kPad;
  cudaError_t err = cudaFuncSetAttribute(
      extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  extract_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(vlens),
      static_cast<int32_t*>(ll), static_cast<int32_t*>(off),
      static_cast<int32_t*>(ml), static_cast<uint8_t*>(lits),
      static_cast<int32_t*>(nb_seq), static_cast<int32_t*>(nb_lit), N, cap);
  return int(cudaGetLastError());
}
