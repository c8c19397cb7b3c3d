// The lazy and v3 engines' last seqstore step, in one launch: the exact
// forward and backward extension of the merged sequences, their literal,
// match and offset fields, and the literal index.
//
// Replaces, in zstd_tpu/ops/fastmatch.py: `_finish_sequences` (:320), its
// four while_loops (forward in 3-byte steps :344 and 1-byte steps :357,
// backward in 3-byte steps :377 and 1-byte steps :392) and its scans over
// the coverage and the literal ranks (:410, :413).
//
// Contract: ops/fastmatch.py::finish_sequences_plain, bit for bit, on the
// rows the merge writes (nb_seq <= cap; the first nb_seq sequences in
// position order, none overlapping the next, none ending past valid_len).
// Inputs blocks u8[B, n], seq_pos, seq_len, seq_off i32[B, cap], nb_seq and
// valid_lens i32[B]. Outputs ll, off, ml i32[B, cap] (0 past nb_seq),
// lit_idx i32[B, n] (the literal positions in order, n - 1 past nb_lit),
// nb_lit i32[B], overflow u8[B] (nb_seq >= cap).
//
// Per sequence k < nb_seq (the plain's arithmetic; indices clamped to
// [0, n - 1], bytes past n read 0):
// - forward, with room = max(next start - end, 0) (the next sequence's
//   original start, or min(valid_len, n) after the last) and limit = len +
//   room: up to 7 steps of 3 while the 3-byte words at pos + ln and
//   pos - off + ln agree and ln + 3 <= limit, then up to 2 steps of 1 while
//   the bytes agree and ln < limit;
// - backward, from the previous sequence's end after its forward steps (a
//   backward step keeps start + length, so that end is fixed once every
//   forward extension is done): up to 5 steps of 3 while sp - 3 >= that end,
//   sp - off - 3 >= 0 and the words at sp - 3 and sp - off - 3 agree, then
//   up to 2 steps of 1 while sp > that end, sp - off > 0 and the bytes agree;
// - ll = sp - previous end, ml = end - sp, off.
// So every sequence extends on its own: one thread a sequence, all steps in
// registers. The literals are the gaps between the extended sequences,
// [previous end, sp) for each k and [last end, min(valid_len, n)) after the
// last: where the sequences are in order and do not overlap, this is the
// plain's difference array of starts and ends, and gap k's first rank is the
// sum of the gaps before it.
//
// Bound on an H100: the bytes the call must move, for the main path's batch
// of 32 rows of 131,072 B (cap 16,384): blocks (4,194,304 B), seq_pos,
// seq_len and seq_off (6,291,456 B), nb_seq and valid_lens read; ll, off, ml
// (6,291,456 B), lit_idx (16,777,216 B), nb_lit and overflow written:
// 33,554,848 B, 0.0100 ms at 3.35 TB/s.
//
// Design: one CTA of 1024 threads a row (grid B); shared memory holds the
// row's bytes (131,072 B, then the gaps' ranks in the same space) and the
// forward ends (4 * cap: 65,536 B); global scratch takes both where they do
// not fit.
// 1. stage the row's bytes (16-byte loads);
// 2. forward: one thread a sequence (strided, coalesced), the compares on
//    the staged bytes; each sequence's end goes to shared memory;
// 3. backward and the fields: one thread a sequence; ll, ml and off written
//    (zeros past nb_seq);
// 4. the gaps' ranks: each thread sums a contiguous run of gap lengths (ll
//    read back), a block scan gives each run its first rank;
// 5. lit_idx in 16-byte stores, four ranks a thread: a binary search of the
//    ranks gives the first rank's gap, the next three follow it; n - 1 from
//    nb_lit on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kExt3 = 7, kExt1 = 2, kBack3 = 5, kBack1 = 2;   // step caps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;       // shared memory an H100 block may use
constexpr int kStatic = 1024;            // room kept for the static arrays

// Bytes of the shared region that holds the row's bytes, then the ranks.
__host__ __device__ int region_a(int n, int cap) {
  const long long a = n > 4LL * (cap + 1) ? n : 4LL * (cap + 1);
  return int((a + 15) / 16 * 16);
}

bool row_in_smem(int n, int cap) {
  return static_cast<long long>(region_a(n, cap)) + 4LL * cap <=
         kSmemLimit - kStatic;
}

// Exclusive prefix sum over the block's threads; `total` receives the sum.
__device__ int block_sum(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  total = s_warp[kWarps - 1];
  __syncthreads();
  return before + inc - x;
}

struct Row {
  const uint8_t* bytes;
  int n;
  __device__ __forceinline__ uint32_t byte(int x) const {
    return x < n ? bytes[x] : 0u;
  }
  // the 3-byte word at x >= 0
  __device__ __forceinline__ uint32_t tri(int x) const {
    return byte(x) | byte(x + 1) << 8 | byte(x + 2) << 16;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
seq_finish_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ seq_pos,
                  const int32_t* __restrict__ seq_len,
                  const int32_t* __restrict__ seq_off,
                  const int32_t* __restrict__ nb_seq,
                  const int32_t* __restrict__ valid_lens,
                  int32_t* __restrict__ ll, int32_t* __restrict__ off,
                  int32_t* __restrict__ ml, int32_t* __restrict__ lit_idx,
                  int32_t* __restrict__ nb_lit, uint8_t* __restrict__ overflow,
                  int32_t* __restrict__ scratch, int n, int cap,
                  bool in_smem) {
  extern __shared__ __align__(16) uint8_t s_row[];
  __shared__ int s_sum[kWarps];

  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t brow = size_t(b) * n, crow = size_t(b) * cap;
  const int nb_in = nb_seq[b];
  const int nb = min(max(nb_in, 0), cap);
  const int vn = min(valid_lens[b], n);
  const int32_t* sp_in = seq_pos + crow;
  const int32_t* sl_in = seq_len + crow;
  const int32_t* so_in = seq_off + crow;

  Row row;
  int32_t* rank;                         // nb + 1 gaps' first ranks
  int32_t* efwd;                         // each sequence's forward end
  row.n = n;
  if (in_smem) {
    row.bytes = s_row;
    rank = reinterpret_cast<int32_t*>(s_row);
    efwd = reinterpret_cast<int32_t*>(s_row + region_a(n, cap));
    // 1. stage the row's bytes
    const uint8_t* src = blocks + brow;
    if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(s_row);
      for (int i = tid; i < n / 16; i += kThreads) d4[i] = __ldg(s4 + i);
    } else {
      for (int i = tid; i < n; i += kThreads) s_row[i] = __ldg(src + i);
    }
    __syncthreads();
  } else {
    row.bytes = blocks + brow;
    rank = scratch + size_t(b) * (2 * cap + 1);
    efwd = rank + cap + 1;
  }

  // 2. forward
  for (int k = tid; k < nb; k += kThreads) {
    const int p = sp_in[k], l = sl_in[k], o = so_in[k];
    const int next = k + 1 < nb ? sp_in[k + 1] : vn;
    const int room = max(next - (p + l), 0);
    int ln = l;
    if (room > 0) {
      const int limit = l + room, src = p - o;
      for (int i = 0; i < kExt3; ++i) {
        if (ln + 3 > limit ||
            row.tri(min(p + ln, n - 1)) != row.tri(max(min(src + ln, n - 1), 0)))
          break;
        ln += 3;
      }
      for (int i = 0; i < kExt1; ++i) {
        if (ln >= limit ||
            row.byte(min(p + ln, n - 1)) != row.byte(max(min(src + ln, n - 1), 0)))
          break;
        ln += 1;
      }
    }
    efwd[k] = p + ln;
  }
  __syncthreads();

  // 3. backward and the fields
  for (int k = tid; k < cap; k += kThreads) {
    int lv = 0, mv = 0, ov = 0;
    if (k < nb) {
      const int o = so_in[k];
      const int pe = k ? efwd[k - 1] : 0;
      int sp = sp_in[k];
      for (int i = 0; i < kBack3; ++i) {
        if (sp - 3 < pe || sp - o - 3 < 0 ||
            row.tri(max(sp - 3, 0)) != row.tri(max(sp - o - 3, 0)))
          break;
        sp -= 3;
      }
      for (int i = 0; i < kBack1; ++i) {
        if (sp <= pe || sp - o <= 0 ||
            row.byte(max(sp - 1, 0)) != row.byte(max(sp - o - 1, 0)))
          break;
        sp -= 1;
      }
      lv = sp - pe;
      mv = efwd[k] - sp;
      ov = o;
    }
    ll[crow + k] = lv;
    ml[crow + k] = mv;
    off[crow + k] = ov;
  }
  __syncthreads();                       // ll visible; the bytes are done

  // 4. the gaps' first ranks: gap g < nb is ll[g], gap nb the tail
  const int tail_start = nb ? efwd[nb - 1] : 0;
  const int gaps = nb + 1;
  const int run = (gaps + kThreads - 1) / kThreads;
  const int g0 = min(tid * run, gaps), g1 = min(g0 + run, gaps);
  auto gap_len = [&](int g) {
    return g < nb ? max(ll[crow + g], 0) : max(vn - tail_start, 0);
  };
  int mine = 0;
  for (int g = g0; g < g1; ++g) mine += gap_len(g);
  int total;
  int r = block_sum(mine, s_sum, total);
  for (int g = g0; g < g1; ++g) {
    rank[g] = r;
    r += gap_len(g);
  }
  __syncthreads();

  // 5. lit_idx: rank r of gap g (rank[g] <= r < rank[g + 1]) is position
  // start(g) + r - rank[g], start(g) the previous sequence's end
  auto first_gap = [&](int r0) {
    int lo = 0, hi = nb;                 // rank[lo] <= r0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rank[mid] <= r0) lo = mid; else hi = mid - 1;
    }
    return lo;
  };
  auto value = [&](int& g, int r) {
    if (r >= total) return n - 1;
    while (g < nb && rank[g + 1] <= r) ++g;
    return (g ? efwd[g - 1] : 0) + r - rank[g];
  };
  int32_t* out = lit_idx + brow;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int c = tid; c < n / 4; c += kThreads) {
      const int r0 = 4 * c;
      int4 v = make_int4(n - 1, n - 1, n - 1, n - 1);
      if (r0 < total) {
        int g = first_gap(r0);
        v.x = value(g, r0);
        v.y = value(g, r0 + 1);
        v.z = value(g, r0 + 2);
        v.w = value(g, r0 + 3);
      }
      out4[c] = v;
    }
  } else {
    for (int r0 = tid; r0 < n; r0 += kThreads) {
      int g = r0 < total ? first_gap(r0) : 0;
      out[r0] = value(g, r0);
    }
  }
  if (tid == 0) {
    nb_lit[b] = total;
    overflow[b] = nb_in >= cap;
  }
}

}  // namespace

// Ints of global scratch the kernel needs a row: 0 where the row's bytes
// and the forward ends fit in shared memory, else 2 * cap + 1.
extern "C" int seq_finish_scratch_ints(int n, int cap) {
  return row_in_smem(n, cap) ? 0 : 2 * cap + 1;
}

// One launch over B rows; scratch holds B * seq_finish_scratch_ints(n, cap)
// ints (may be null when that is 0).
extern "C" int seq_finish_launch(const void* blocks, const void* seq_pos,
                                 const void* seq_len, const void* seq_off,
                                 const void* nb_seq, const void* valid_lens,
                                 void* ll, void* off, void* ml, void* lit_idx,
                                 void* nb_lit, void* overflow, void* scratch,
                                 int B, int n, int cap, void* stream) {
  if (B == 0) return 0;
  if (n < 1 || cap < 1) return int(cudaErrorInvalidValue);
  const bool in_smem = row_in_smem(n, cap);
  if (!in_smem && scratch == nullptr) return int(cudaErrorInvalidValue);
  const int smem = in_smem ? region_a(n, cap) + 4 * cap : 0;
  // set once per size, outside any graph capture that replays the launch
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        seq_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    smem_set = smem;
  }
  seq_finish_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(seq_pos),
      static_cast<const int32_t*>(seq_len), static_cast<const int32_t*>(seq_off),
      static_cast<const int32_t*>(nb_seq),
      static_cast<const int32_t*>(valid_lens), static_cast<int32_t*>(ll),
      static_cast<int32_t*>(off), static_cast<int32_t*>(ml),
      static_cast<int32_t*>(lit_idx), static_cast<int32_t*>(nb_lit),
      static_cast<uint8_t*>(overflow), static_cast<int32_t*>(scratch), n, cap,
      in_smem);
  return int(cudaGetLastError());
}
