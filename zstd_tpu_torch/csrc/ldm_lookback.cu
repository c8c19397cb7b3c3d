// Bounded look-back of the sharded long-distance matcher's owner: from its
// entries sorted by (bucket key, position) to each anchor's candidates.
//
// Replaces, in zstd_tpu/parallel/ldm_sharded.py `_discover`, the look-back
// over the owner's lexicographic (key, pos) sort (:156-170): 12 shifted
// compares, each a pass over the entries, that fill LDM_BUCKET = 4 slots.
//
// Contract: ops/ldm.py::lookback_plain, bit for bit. Input sorted i64[n_e],
// ascending: entry i is (key << 32) | pos for a real anchor (key < 2^20,
// 0 <= pos < 2^31), or (2^20 << 32) | 0x7FFFFFFF for an empty slot (the
// sentinel, which sorts last). block_size, window: the discovery's. For each
// entry i with key k and position p, k = 1..12 back, entry j = i - k is a
// hit when j >= 0, it has the same key, and its position q satisfies
// q < (p / block_size) * block_size and p - q <= window (candidates inserted
// before the anchor's block, inside the window). The first 4 hits, nearest
// first, fill cand[i, 0..3]; the other slots are -1. pos_out[i] = p, or -1
// for the sentinel (whose slots stay -1).
//
// Bound on this card: bytes (8 read, 4 + 16 written an entry; the compares
// are a few integer operations each). One thread an entry; a block stages
// its 256 entries and the 12 before them in shared memory, so each entry is
// read from device memory about once, and writes its 4 slots as one 16-byte
// store.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kLookback = 12;
constexpr int kBucket = 4;
constexpr int64_t kSentKey = int64_t(1) << 20;

__global__ void __launch_bounds__(kTile)
ldm_lookback_kernel(const int64_t* __restrict__ sorted, int n, int block_size,
                    int window, int32_t* __restrict__ pos_out,
                    int4* __restrict__ cand) {
  __shared__ int64_t s[kTile + kLookback];
  const int base = blockIdx.x * kTile;
  const int64_t sent = (kSentKey << 32) | 0x7FFFFFFF;
  for (int j = threadIdx.x; j < kTile + kLookback; j += kTile) {
    const int g = base - kLookback + j;
    s[j] = (g >= 0 && g < n) ? sorted[g] : sent;
  }
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i >= n) return;
  const int64_t e = s[threadIdx.x + kLookback];
  const int64_t key = e >> 32;
  const int pos = static_cast<int>(e & 0xFFFFFFFF);
  int slot[kBucket] = {-1, -1, -1, -1};
  if (key != kSentKey) {
    const int cutoff = (pos / block_size) * block_size;
    int rank = 0;
#pragma unroll
    for (int k = 1; k <= kLookback; ++k) {
      const int64_t c = s[threadIdx.x + kLookback - k];
      const int q = static_cast<int>(c & 0xFFFFFFFF);
      if ((c >> 32) == key && q < cutoff && pos - q <= window) {
#pragma unroll
        for (int b = 0; b < kBucket; ++b)
          if (rank == b) slot[b] = q;
        ++rank;
      }
    }
  }
  pos_out[i] = key == kSentKey ? -1 : pos;
  cand[i] = make_int4(slot[0], slot[1], slot[2], slot[3]);
}

}  // namespace

extern "C" int ldm_lookback_launch(const void* sorted, int n, int block_size,
                                   int window, void* pos_out, void* cand,
                                   void* stream) {
  if (n == 0) return 0;
  if (n < 0 || block_size <= 0 || reinterpret_cast<uintptr_t>(cand) % 16)
    return int(cudaErrorInvalidValue);
  const int grid = (n + kTile - 1) / kTile;
  ldm_lookback_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sorted), n, block_size, window,
      static_cast<int32_t*>(pos_out), static_cast<int4*>(cand));
  return int(cudaGetLastError());
}
