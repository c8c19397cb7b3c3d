// Batched backward Huffman decode of literal streams, segment-parallel: one
// CTA a lane, one thread a segment of the lane's bit positions. Writes each
// lane's symbols where they belong (a row of a [L, max_syms] buffer, or the
// lane's span of the frame's literal pool) and copies the pool's raw/RLE
// spans in a second small kernel.
//
// Replaces: zstd_tpu/ops/decode_dev.py:59 (huf_decode_streams, the lax.scan
// over huf_window_values :46) and :93 (assemble_pool). Lane l decodes n =
// clip(n_syms[l], 0, max_syms) symbols from bit position start_bits[l]
// down: the step at p reads idx = win(min(p, W - 1)), W = 8 * byte_cap + 1,
// where win(q) is the value of stream bits [q - 11, q) with bit q - 1 most
// significant and bits below 0 zero; it emits lut_sym[tab, idx] and moves to
// p - lut_len[tab, idx], tab = clip(lane_tab[l], 0, T - 1). Symbol i < n
// goes to out[out_base[l] + i] (dropped at or past out_size; nothing for a
// lane with out_base < 0), final[l] is p after step n - 1 (start_bits for
// n == 0): the contract of ops/decode_dev.py::huf_decode_plain on
// syms[l, :n] and final. Nothing else of `out` is written.
//
// Every table length must be >= 1 (the host never builds a 0: a Huffman
// weight of 0 marks an absent symbol, and every entry the host expands has
// nbits >= 1); the wrapper checks it and raises, so positions fall strictly
// and every walk below takes at most K steps.
//
// Bound on an H100: the bytes are small (the streams, the u8 tables, one
// byte per symbol: about 3 us at 16 MiB); the time is the longest chain of
// dependent steps (window, table load, subtract). The old design ran each
// lane's 32,768 steps on one thread; this one cuts the chain:
//   - head: while p > W - 1 every step reads the same window, so the count
//     of those steps and the position after them are closed form;
//   - segments: positions (0, T0] (T0 the position after the head) are cut
//     into segments of K = 512 positions, segment s holding
//     (s K, min((s + 1) K, T0)]. Thread t walks segment S - 1 - t from its
//     top (speculate: the top segment starts at T0 and is right), marking
//     each position it visits in a bitmap in shared memory. A Huffman decode
//     begun at a wrong position falls into step with the true one within a
//     few symbols, so a wrong entry mostly leads to the right exit.
//   - repair: rounds under __syncthreads re-walk each segment whose entry
//     (the exit of the segment above, as of the round before) differs from
//     the one it walked, until the walk meets a marked position (from there
//     it is the speculative path: the exit is the speculative exit and the
//     count is the steps so far plus a popcount of the bitmap) or leaves
//     the segment. The top segment is right, so round r fixes segment
//     S - 1 - r at the latest: at most S - 1 rounds change anything;
//   - place and write: a CTA-wide exclusive prefix sum of the counts gives
//     each segment's first symbol index; each thread walks its segment again
//     from its true entry and stores its symbols below n, four to a 32-bit
//     store where the four bytes are its own and aligned;
//   - tail: once p <= 0 every step reads win(0) = 0, index 0, so the
//     remaining symbols are lut_sym[tab, 0] and final = p - (n - C) *
//     lut_len[tab, 0], C the symbols above bit 0.
// The table is packed once a CTA into 2048 u16 entries (sym | len << 8) in
// shared memory, and the stream bytes (16-byte loads) sit behind 16 zero
// bytes so that a window is two shared loads and a funnel shift.
// tests/hufmodel.py models these phases step for step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTlog = 11;
constexpr int kTableSize = 1 << kTlog;
constexpr int kSeg = 512;                 // K, in bit positions
constexpr int kSegWords = kSeg / 32;      // bitmap words a segment
constexpr int kGuardWords = 4;            // zero words before the stream
constexpr int kMaxThreads = 1024;

__host__ __device__ int lane_threads(int byte_cap) {
  const int segs = (8 * byte_cap + kSeg - 1) / kSeg;
  const int nt = (segs + 31) / 32 * 32;
  return nt > 32 ? nt : 32;
}

__host__ __device__ int stream_words(int byte_cap) {
  return kGuardWords + byte_cap / 4 + 8;
}

// shared memory of a lane CTA: table, stream, bitmap, exits, scan, misc
__host__ __device__ size_t lane_smem_bytes(int byte_cap) {
  const int nt = lane_threads(byte_cap);
  return sizeof(uint16_t) * kTableSize +
         sizeof(uint32_t) * (stream_words(byte_cap) + nt * kSegWords + nt +
                             32 + 8);
}

// table index at bit position p in [1, 8 * byte_cap]: stream bit b is bit
// b + 128 of the word array
__device__ __forceinline__ int window(const uint32_t* str, int p) {
  const int a = p - kTlog + 32 * kGuardWords;
  return __funnelshift_r(str[a >> 5], str[(a >> 5) + 1], a & 31) &
         (kTableSize - 1);
}

// exclusive prefix sum over the CTA in thread order; *total gets the sum
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
    if (lane == 31) *total = w;
  }
  __syncthreads();
  const int r = x - v + (warp ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return r;
}

// symbols of one thread's consecutive indices, packed into aligned words
struct Writer {
  uint8_t* out;
  long long base, size;   // out_base of the lane (< 0: write nothing), size
  uint32_t acc = 0, have = 0;

  __device__ void flush(long long w) {
    if (have == 15u && w + 3 < size) {
      *reinterpret_cast<uint32_t*>(out + w) = acc;
    } else {
      for (int k = 0; k < 4; ++k)
        if (((have >> k) & 1u) && w + k < size) out[w + k] = uint8_t(acc >> 8 * k);
    }
    acc = 0;
    have = 0;
  }
  __device__ void put(int i, uint32_t v) {
    if (base < 0) return;
    const long long a = base + i;
    const int b = int(a & 3);
    acc |= v << (8 * b);
    have |= 1u << b;
    if (b == 3) flush(a - 3);
  }
  __device__ void finish(int i_end) {
    if (base >= 0 && have) flush((base + i_end - 1) & ~3ll);
  }
};

// indices [a, b) of the lane all get symbol v, written by the whole CTA
__device__ void fill(uint8_t* out, long long base, long long size, int a,
                     int b, uint8_t v) {
  if (base < 0) return;
  for (int i = a + threadIdx.x; i < b; i += blockDim.x)
    if (base + i < size) out[base + i] = v;
}

// stats per lane: segments, repair rounds, longest speculative walk,
// critical path (longest speculative walk + longest re-walk of each repair
// round + longest write walk), all in steps
__global__ void __launch_bounds__(kMaxThreads)
huf_lane_kernel(const uint8_t* __restrict__ sb,
                const int32_t* __restrict__ start_bits,
                const int32_t* __restrict__ n_syms,
                const uint8_t* __restrict__ lut_sym,
                const uint8_t* __restrict__ lut_len,
                const int32_t* __restrict__ lane_tab,
                const int64_t* __restrict__ out_base, uint8_t* out,
                long long out_size, int32_t* __restrict__ final_pos,
                int32_t* __restrict__ stats, int byte_cap, int max_syms,
                int T) {
  extern __shared__ uint4 smem_raw[];
  const int l = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = min(max(n_syms[l], 0), max_syms);
  const int start = start_bits[l];
  if (n == 0) {
    if (tid == 0) {
      final_pos[l] = start;
      if (stats)
        for (int k = 0; k < 4; ++k) stats[4 * l + k] = 0;
    }
    return;
  }
  const long long ob = out_base[l];
  const int w1 = 8 * byte_cap;  // W - 1

  uint16_t* tab = reinterpret_cast<uint16_t*>(smem_raw);
  uint32_t* str = reinterpret_cast<uint32_t*>(tab + kTableSize);
  uint32_t* bits = str + stream_words(byte_cap);
  int* exit_s = reinterpret_cast<int*>(bits + nt * kSegWords);
  int* warp_sums = exit_s + nt;
  int* misc = warp_sums + 32;  // [0] longest, [1] round's re-walk, [2] write
                               // walk, [3] total

  // ---- stage: the lane's table, its stream bytes, zero guards ----------
  const int t = min(max(lane_tab[l], 0), T - 1);
  const uint32_t* ts =
      reinterpret_cast<const uint32_t*>(lut_sym + size_t(t) * kTableSize);
  const uint32_t* tl =
      reinterpret_cast<const uint32_t*>(lut_len + size_t(t) * kTableSize);
  for (int i = tid; i < kTableSize / 4; i += nt) {
    const uint32_t s4 = __ldg(ts + i), l4 = __ldg(tl + i);
    for (int k = 0; k < 4; ++k)
      tab[4 * i + k] = uint16_t(((s4 >> 8 * k) & 0xffu) |
                                (((l4 >> 8 * k) & 0xffu) << 8));
  }
  const int top_bits = max(min(start, w1), 0);
  const int nb16 = min(byte_cap, ((top_bits + 7) / 8 + 15) & ~15);
  const uint4* src = reinterpret_cast<const uint4*>(sb + size_t(l) * byte_cap);
  uint4* dst = reinterpret_cast<uint4*>(str + kGuardWords);
  for (int i = tid; i < nb16 / 16; i += nt) dst[i] = __ldg(src + i);
  if (tid < kGuardWords) {
    str[tid] = 0;
    str[kGuardWords + nb16 / 4 + tid] = 0;
  }
  if (tid < 8) misc[tid] = 0;
  __syncthreads();

  // ---- head: positions above W - 1 all read win(W - 1) ----------------
  long long c = 0;
  int t0 = start;
  if (start > w1) {
    const int e = tab[window(str, w1)];
    const int lc = e >> 8;
    c = (start - (long long)w1 + lc - 1) / lc;
    t0 = int(start - c * lc);
    if (c >= n) {
      fill(out, ob, out_size, 0, n, uint8_t(e & 0xff));
      if (tid == 0) {
        final_pos[l] = int(start - (long long)n * lc);
        if (stats)
          for (int k = 0; k < 4; ++k) stats[4 * l + k] = 0;
      }
      return;
    }
    fill(out, ob, out_size, 0, int(c), uint8_t(e & 0xff));
  }

  // ---- speculate: thread tid walks segment S - 1 - tid from its top ----
  // S <= nt: t0 <= 8 * byte_cap and nt >= ceil(8 * byte_cap / K)
  const int S = t0 > 0 ? (t0 + kSeg - 1) / kSeg : 0;
  const bool act = tid < S;
  const int s = S - 1 - tid;
  const int bottom = s * kSeg;
  int entry = min(bottom + kSeg, t0), cnt = 0, spec_exit = 0;
  if (act) {
    for (int w = 0; w < kSegWords; ++w) bits[s * kSegWords + w] = 0;
    int p = entry, wi = (p - 1) >> 5;
    uint32_t word = 0;
    while (p > bottom) {
      const int b = p - 1;
      if ((b >> 5) != wi) {
        bits[wi] = word;
        word = 0;
        wi = b >> 5;
      }
      word |= 1u << (b & 31);
      p -= tab[window(str, p)] >> 8;
      ++cnt;
    }
    bits[wi] = word;
    exit_s[s] = p;
    spec_exit = p;
    atomicMax(&misc[0], cnt);
  }
  __syncthreads();

  // ---- repair: rounds read the exits of the round before ---------------
  int rounds = 0, crit = misc[0];
  for (;;) {
    int e = 0;
    const bool need = act && s < S - 1 && (e = exit_s[s + 1]) != entry;
    __syncthreads();
    if (need) {
      int q = e, steps = 0;
      while (q > bottom && !((bits[(q - 1) >> 5] >> ((q - 1) & 31)) & 1u)) {
        q -= tab[window(str, q)] >> 8;
        ++steps;
      }
      if (q > bottom) {  // met the speculative path at q
        int k = steps;
        const int last = (q - 1) >> 5;
        for (int w = bottom >> 5; w < last; ++w) k += __popc(bits[w]);
        k += __popc(bits[last] & ((2u << ((q - 1) & 31)) - 1u));
        cnt = k;
        exit_s[s] = spec_exit;
      } else {
        cnt = steps;
        exit_s[s] = q;
      }
      entry = e;
      atomicMax(&misc[1], steps);
    }
    if (!__syncthreads_or(need)) break;
    ++rounds;
    crit += misc[1];
    __syncthreads();
    if (tid == 0) misc[1] = 0;
  }

  // ---- place: first symbol index of each segment, top segment first ----
  const int first = int(c) + block_scan(act ? cnt : 0, warp_sums, &misc[3]);
  const int C = int(c) + misc[3];

  // ---- write: walk again from the true entry ----------------------------
  if (act && first < n) {
    Writer wr{out, ob, out_size};
    int q = entry, i = first;
    while (q > bottom && i < n) {
      const int e = tab[window(str, q)];
      wr.put(i, e & 0xffu);
      q -= e >> 8;
      if (++i == n) final_pos[l] = q;
    }
    wr.finish(i);
    atomicMax(&misc[2], i - first);
  }

  // ---- tail: below bit 0 every step reads index 0 -----------------------
  if (C < n) {
    fill(out, ob, out_size, C, n, uint8_t(tab[0] & 0xff));
    if (tid == 0) {
      const int p = S ? exit_s[0] : t0;
      final_pos[l] = int(p - (long long)(n - C) * (tab[0] >> 8));
    }
  }
  __syncthreads();
  if (tid == 0 && stats) {
    stats[4 * l + 0] = S;
    stats[4 * l + 1] = rounds;
    stats[4 * l + 2] = misc[0];
    stats[4 * l + 3] = crit + misc[2];
  }
}

// the pool's raw/RLE spans: segment i covers [seg_start[i], next start) cut
// at `lim` (the pool's literal count) and reads host[clip(seg_src[i] +
// within, 0, H - 1)]; one CTA a segment, dev segments skip
__global__ void pool_host_kernel(const int32_t* __restrict__ seg_start,
                                 const int32_t* __restrict__ seg_src,
                                 const uint8_t* __restrict__ seg_is_dev,
                                 const uint8_t* __restrict__ host, int H,
                                 int S, long long lim, uint8_t* out) {
  const int i = blockIdx.x;
  if (seg_is_dev[i]) return;
  const long long st = seg_start[i];
  const long long en = min(i + 1 < S ? (long long)seg_start[i + 1] : lim, lim);
  const long long from = seg_src[i];
  for (long long j = max(st, 0ll) + threadIdx.x; j < en; j += blockDim.x)
    out[j] = host[min(max(from + (j - st), 0ll), (long long)H - 1)];
}

}  // namespace

extern "C" int huf_decode_smem_bytes(int byte_cap) {
  return int(lane_smem_bytes(byte_cap));
}

extern "C" int huf_decode_threads(int byte_cap) {
  return lane_threads(byte_cap);
}

// one launch of the lane kernel over L lanes; with S > 0 also the pool's
// host spans (seg_* and host may be null when S == 0)
extern "C" int huf_decode_launch(const void* sb, const void* start_bits,
                                 const void* n_syms, const void* lut_sym,
                                 const void* lut_len, const void* lane_tab,
                                 const void* out_base, void* out,
                                 long long out_size, void* final_pos,
                                 void* stats, int L, int byte_cap,
                                 int max_syms, int T, const void* seg_start,
                                 const void* seg_src, const void* seg_is_dev,
                                 const void* host, int H, int S,
                                 long long lim, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (S > 0) {
    pool_host_kernel<<<S, 256, 0, st>>>(
        static_cast<const int32_t*>(seg_start),
        static_cast<const int32_t*>(seg_src),
        static_cast<const uint8_t*>(seg_is_dev),
        static_cast<const uint8_t*>(host), H, S, lim,
        static_cast<uint8_t*>(out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (L == 0) return 0;
  const size_t smem = lane_smem_bytes(byte_cap);
  cudaError_t err = cudaFuncSetAttribute(
      huf_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  huf_lane_kernel<<<L, lane_threads(byte_cap), smem, st>>>(
      static_cast<const uint8_t*>(sb), static_cast<const int32_t*>(start_bits),
      static_cast<const int32_t*>(n_syms),
      static_cast<const uint8_t*>(lut_sym),
      static_cast<const uint8_t*>(lut_len),
      static_cast<const int32_t*>(lane_tab),
      static_cast<const int64_t*>(out_base), static_cast<uint8_t*>(out),
      out_size, static_cast<int32_t*>(final_pos),
      static_cast<int32_t*>(stats), byte_cap, max_syms, T);
  return int(cudaGetLastError());
}
