// The xla engine's capped match lengths and greedy walk, in one launch: from
// the block bytes and the candidates to the committed positions and their
// lengths.
//
// Replaces, in zstd_tpu/ops/match.py as find_matches_block composes them
// (:207-233): `match_lengths` (:100, its lax.while_loop :141 of up to 255
// rounds of 8 word compares) and `greedy_resolve` (:174, its fori_loop :202
// of n_log2 + 1 pointer-doubling rounds).
//
// Contract: ops/match.py::xla_walk_plain, bit for bit. Inputs blocks u8[B, n]
// (4-byte aligned), cands i32[B, n] (-1 or a position below p, as
// prev_same_bucket gives them, after the halo ban), valid_lens and emit_from
// i32[B] (valid_len <= n). Outputs committed u8[B, n] and take_len i32[B, n]
// (the match length where committed, else 0).
//
// What it computes. Pointer doubling's reachable set from 0 is the serial
// greedy walk from 0, so the kernel walks: from p, if emit_from <= p <
// valid_len - 8, cand[p] >= 0 and the 4-byte words at p and cand[p] are
// equal, commit p with length min(lcp, 8164, valid_len - p) (8164 = 4 + 4 *
// 8 * 255, where the JAX loop stops) and go on at p + length; else go on at
// p + 1. A length is computed only where the walk may stand.
//
// Bound on an H100: the bytes the call must move, for the main path's batch
// of 32 rows of 131,072 B: the rows (4,194,304 B), cands (16,777,216 B),
// committed (4,194,304 B) and take_len (16,777,216 B), 41,943,296 B with the
// two i32[B] inputs: 0.0125 ms at 3.35 TB/s. What bounds this kernel is the
// walk: a chain of dependent steps a row (about 5,300 commits in a 128 KiB
// row of the corpus, up to about 17,000), on one warp a row, with 32 of the
// 132 SMs busy for a batch of 32 rows. On an H100 a step costs about 200
// SM cycles (two shared-memory reads and the commit's stores, one warp
// alone on its SM), and the walks take about 80% of a text row's cycles,
// the tile passes the rest (chip_smoke.py prints the counts).
//
// Design: one CTA of 1,024 threads per row; the row stays in device memory
// (rows of compress_sharded are halo + block_size bytes, up to 262,144, more
// than a CTA's shared memory), read through L1/L2. The row is walked in tiles
// of kTile positions:
// 1. all threads write zeros to the row's outputs (once);
// 2. tile pass, all threads (kPer consecutive positions each): for every
//    position of the tile at or past both the walk's position and emit_from
//    and below valid_len - 8, the length byte sl[q]: 0 where the position
//    cannot commit (no candidate, or the words differ), else min(lcp, cap)
//    computed up to kShort bytes, or kLong where the match is longer than
//    kShort and the cap allows more; then nx[q], the first position >= q of
//    the tile whose sl is nonzero (kTile if none): each thread's own, then
//    a suffix minimum over the lanes (shuffles) and over the warps;
// 3. walk, warp 0: q = nx[p], commit q with sl[q] and jump by that length;
//    a kLong length is finished by the warp from device memory, 128 bytes a
//    round. A step is two shared-memory reads; the walk leaves the tile at
//    its end, and the next tile starts where it stands (a tile it jumps
//    over is skipped).
// No state crosses CTAs; rows are independent. With a stats pointer, warp 0
// also counts per row: commits, commits finished from device memory (kLong),
// their 128-byte rounds, the walk's steps, and the SM cycles of the tile
// passes and of the walks (kStats ints a row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 8192;             // positions a tile
constexpr int kPer = kTile / kThreads;  // positions a thread of the pass
constexpr int kShort = 64;              // lengths the tile pass finishes
constexpr uint8_t kLong = 255;          // longer: the walk finishes it
constexpr int kCap = 4 + 4 * 8 * 255;   // 8164
constexpr int kMargin = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStats = 6;

// SM clock, kept in place relative to the memory operations around it
__device__ __forceinline__ long long tick() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

// little-endian u32 at byte i of the row; bytes at and past n read 0
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int i, int n) {
  if (i + 8 <= n) {
    // two aligned loads: the first may start in the previous row (its bytes
    // are shifted out), the second ends before byte i + 8 <= n
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + i);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    return __funnelshift_r(__ldg(w), __ldg(w + 1), int(a & 3) * 8);
  }
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (i + k < n) v |= uint32_t(__ldg(row + i + k)) << (8 * k);
  return v;
}

// common prefix of row[a:] and row[b:], capped at limit; 128 bytes a round
// across the warp
__device__ int warp_lcp(const uint8_t* row, int a, int b, int limit, int n,
                        int lane, int& rounds) {
  int l = 0;
  while (l < limit) {
    ++rounds;
    const int o = l + 4 * lane;
    const uint32_t x = load4(row, a + o, n) ^ load4(row, b + o, n);
    const unsigned m = __ballot_sync(kFull, x != 0);
    if (m) {
      const int fl = __ffs(m) - 1;
      const uint32_t xf = __shfl_sync(kFull, x, fl);
      l += 4 * fl + ((__ffs(xf) - 1) >> 3);
      break;
    }
    l += 128;
  }
  return min(l, limit);
}

// the length byte of position q (see the header)
__device__ __forceinline__ uint8_t length_byte(const uint8_t* row,
                                               const int32_t* cand, int q,
                                               int vl, int n) {
  const int c = cand[q];
  if (c < 0 || load4(row, q, n) != load4(row, c, n)) return 0;
  const int lim = min(kCap, vl - q);
  const int cap = min(lim, kShort);
  int l = 4;
  while (l < cap) {
    const uint32_t x = load4(row, q + l, n) ^ load4(row, c + l, n);
    if (x) {
      l += (__ffs(x) - 1) >> 3;
      break;
    }
    l += 4;
  }
  l = min(l, cap);
  return (l == kShort && lim > kShort) ? kLong : uint8_t(l);
}

// minimum of v over lanes >= this lane
__device__ __forceinline__ int suffix_min(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
xla_walk_kernel(const uint8_t* __restrict__ blocks,
                const int32_t* __restrict__ cands,
                const int32_t* __restrict__ valid_lens,
                const int32_t* __restrict__ emit_from,
                uint8_t* __restrict__ committed,
                int32_t* __restrict__ take_len, int32_t* __restrict__ stats,
                int n) {
  __shared__ uint8_t sl[kTile];
  __shared__ uint16_t nx[kTile];
  __shared__ int warp_after[kThreads / 32];
  __shared__ int sh_p;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t off = size_t(b) * n;
  const uint8_t* row = blocks + off;
  const int32_t* cand = cands + off;
  uint8_t* com = committed + off;
  int32_t* tl = take_len + off;
  const int vl = valid_lens[b];
  const int ef = max(emit_from[b], 0);
  const int limit = vl - kMargin;            // positions below it may commit

  for (int i = t; i < n; i += kThreads) {
    com[i] = 0;
    tl[i] = 0;
  }
  if (t == 0) sh_p = ef;
  int commits = 0, longs = 0, long_rounds = 0, steps = 0;
  long long pass_cycles = 0, walk_cycles = 0, t0 = tick();

  for (int base = (ef / kTile) * kTile; base < limit; base += kTile) {
    __syncthreads();              // sh_p of the last walk; sl, nx free again
    const int p0 = sh_p;
    if (p0 >= base + kTile) continue;
    const int lo = max(p0, ef);
    // 2. the tile's length bytes: thread t owns positions [kPer t,
    // kPer (t + 1)) of the tile
    const int i0 = t * kPer;
    uint8_t s[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = base + i0 + k;
      s[k] = (q >= lo && q < limit) ? length_byte(row, cand, q, vl, n) : 0;
      sl[i0 + k] = s[k];
    }
    int first = kTile;
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k)
      if (s[k]) first = i0 + k;
    // the first nonzero position past this thread's positions: a suffix
    // minimum over the later lanes, then over the later warps
    const int v = suffix_min(first, lane);
    int after = __shfl_down_sync(kFull, v, 1);
    if (lane == 31) after = kTile;
    if (lane == 0) warp_after[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const int w = suffix_min(warp_after[lane], lane);
      int later = __shfl_down_sync(kFull, w, 1);
      if (lane == 31) later = kTile;
      __syncwarp();
      warp_after[lane] = later;
    }
    __syncthreads();
    int next = min(after, warp_after[warp]);
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k) {
      if (s[k]) next = i0 + k;
      nx[i0 + k] = uint16_t(next);
    }
    __syncthreads();
    // 3. the walk through the tile: every lane of warp 0 reads the same
    // shared words (a broadcast) and writes the same commits
    if (warp == 0) {
      const long long t1 = tick();
      pass_cycles += t1 - t0;
      const int end = min(base + kTile, limit);
      int p = p0;
      while (p < end) {
        ++steps;
        const int q = base + nx[p - base];
        if (q >= end) {
          p = end;
          break;
        }
        int len = sl[q - base];
        if (len == kLong) {
          const int lim = min(kCap, vl - q);
          len = kShort + warp_lcp(row, q + kShort, cand[q] + kShort,
                                  lim - kShort, n, lane, long_rounds);
          ++longs;
        }
        ++commits;
        com[q] = 1;               // every lane the same store: no branch
        tl[q] = len;
        p = q + len;
      }
      if (lane == 0) sh_p = max(p, end);
      t0 = tick();
      walk_cycles += t0 - t1;
    }
  }
  if (stats != nullptr && t == 0) {
    int32_t* st = stats + size_t(b) * kStats;
    st[0] = commits;
    st[1] = longs;
    st[2] = long_rounds;
    st[3] = steps;
    st[4] = int32_t(min(pass_cycles, 0x7fffffffLL));
    st[5] = int32_t(min(walk_cycles, 0x7fffffffLL));
  }
}

}  // namespace

extern "C" int xla_walk_launch(const void* blocks, const void* cands,
                               const void* valid_lens, const void* emit_from,
                               void* committed, void* take_len, void* stats,
                               int B, int n, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(blocks) % 4 != 0)
    return int(cudaErrorInvalidValue);
  xla_walk_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(cands),
      static_cast<const int32_t*>(valid_lens),
      static_cast<const int32_t*>(emit_from),
      static_cast<uint8_t*>(committed), static_cast<int32_t*>(take_len),
      static_cast<int32_t*>(stats), n);
  return int(cudaGetLastError());
}
