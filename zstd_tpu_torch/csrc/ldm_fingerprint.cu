// Gear fingerprint, anchor predicate and bucket key of the sharded
// long-distance matcher, for every position of one rank's chunk.
//
// Replaces, in zstd_tpu/parallel/ldm_sharded.py: `_mulp_hi32` (:51, the high
// 32 bits of v * PRIME64 mod 2^64 in 16-bit limbs, because the TPU has no
// u64), `_pack32` (:72), `_fingerprint_hi` (:81) and the anchor predicate
// and bucket key of `_discover` (:116-123).
//
// Contract: ops/ldm.py::anchor_keys_plain, bit for bit. Input ext u8[m + 64]
// (the chunk's m positions and the 64-byte halo after them), valid (the
// positions that are fingerprinted: p < valid <= m). Outputs, for each
// p < m: flag u8[m] (1 where the position is an anchor) and key i32[m]:
//   h    = XOR over (off, sh) in (0, 0), (16, 3), (32, 7), (48, 13) of
//          (uint32)((LE u64 at ext[p + off] * PRIME64) >> 32) >> sh
//   flag = (h >> 25) == 0 && p < valid          (hash_rate_log 7)
//   key  = (h >> 5) & (2^20 - 1)                (hash_log 20)
// The card has native u64 products, so this is the exact arithmetic the
// limbs emulate.
//
// Bound on this card: bytes. Each position reads its byte once (the halo
// 64 more) and writes 5 bytes, about 6 bytes a position against 4 64-bit
// multiplies: at 3.35 TB/s that is 0.12 ms for 2^26 positions, far above
// the multiplies' time. The design keeps the loads wide and the words out
// of device memory: a block of 256 threads takes a tile of 1,024 positions
// (4 a thread, so a block's load latency and its halo are paid once for
// 1,024) and loads it with its 64 halo bytes into shared memory as 32-bit
// words (a byte at a time only at the ragged end); each thread assembles
// each position's four unaligned 64-bit words from three shared words with
// funnel shifts (neighbouring lanes read neighbouring words), and stores
// its 4 flags as one 32-bit word and its 4 keys as one 16-byte vector.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                  // consecutive positions a thread
constexpr int kTile = kThreads * kItems;   // positions a block
constexpr int kSpan = 64;                  // fingerprint window bytes
constexpr int kWords = (kTile + kSpan) / 4 + 2;
constexpr uint64_t kPrime64 = 0xCF1BBCDCB7A56463ULL;

__device__ __forceinline__ uint64_t word_at(const uint32_t* w, int byte) {
  // little-endian u64 at byte offset `byte` of the tile
  const int i = byte >> 2;
  const int r = (byte & 3) * 8;
  const uint32_t lo = __funnelshift_r(w[i], w[i + 1], r);
  const uint32_t hi = __funnelshift_r(w[i + 1], w[i + 2], r);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ uint32_t fingerprint_hi(const uint32_t* w,
                                                   int byte) {
  uint32_t h = 0;
  const int offs[4] = {0, 16, 32, 48};
  const int shifts[4] = {0, 3, 7, 13};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t v = word_at(w, byte + offs[k]);
    h ^= static_cast<uint32_t>((v * kPrime64) >> 32) >> shifts[k];
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
ldm_fingerprint_kernel(const uint8_t* __restrict__ ext, int m, int valid,
                       uint8_t* __restrict__ flag, int32_t* __restrict__ key) {
  __shared__ uint32_t w[kWords];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t total = static_cast<int64_t>(m) + kSpan;   // bytes of ext
  for (int j = threadIdx.x; j < kWords; j += kThreads) {
    const int64_t g = base + 4 * j;
    uint32_t v = 0;
    if (g + 4 <= total) {
      v = *reinterpret_cast<const uint32_t*>(ext + g);
    } else {
      for (int b = 0; b < 4; ++b)
        if (g + b < total) v |= static_cast<uint32_t>(ext[g + b]) << (8 * b);
    }
    w[j] = v;
  }
  __syncthreads();
  const int t0 = threadIdx.x * kItems;
  const int64_t p0 = base + t0;
  if (p0 >= m) return;
  uint32_t flags = 0;
  int32_t keys[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t h = fingerprint_hi(w, t0 + j);
    const bool anchor = (h >> 25) == 0 && p0 + j < valid;
    flags |= static_cast<uint32_t>(anchor) << (8 * j);
    keys[j] = static_cast<int32_t>((h >> 5) & ((1u << 20) - 1));
  }
  if (p0 + kItems <= m) {
    *reinterpret_cast<uint32_t*>(flag + p0) = flags;
    *reinterpret_cast<int4*>(key + p0) =
        make_int4(keys[0], keys[1], keys[2], keys[3]);
  } else {
    for (int j = 0; j < kItems && p0 + j < m; ++j) {
      flag[p0 + j] = static_cast<uint8_t>(flags >> (8 * j));
      key[p0 + j] = keys[j];
    }
  }
}

}  // namespace

extern "C" int ldm_fingerprint_launch(const void* ext, int m, int valid,
                                      void* flag, void* key, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || reinterpret_cast<uintptr_t>(ext) % 4 != 0
      || reinterpret_cast<uintptr_t>(flag) % 4 != 0
      || reinterpret_cast<uintptr_t>(key) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const int grid = (m + kTile - 1) / kTile;
  ldm_fingerprint_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ext), m, valid,
      static_cast<uint8_t*>(flag), static_cast<int32_t*>(key));
  return int(cudaGetLastError());
}
