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
// of 32 rows of 131,072 B (cap 16,384): seq_pos, seq_len and seq_off read
// below nb_seq, the bytes only where an extension compares (both sides), at
// 32-byte sectors, nb_seq and valid_lens read; ll, off, ml (6,291,456 B),
// lit_idx (16,777,216 B), nb_lit and overflow written: 31,047,328 B on
// level-5 batch 0, 0.00927 ms at 3.35 TB/s (chip_smoke.py's finish_bytes).
// lit_idx is over half of it: a row's 512 KiB of stores is more than one
// SM pushes in that time.
//
// Design: C CTAs of 1024 threads a row (2-4, launched as clusters of C and
// chosen by the wrapper from the card's occupancy: 3 for a batch of 32
// rows on an H100, which holds 39 clusters of 3 at once but 30 of 4), CTA
// c taking sequences [c * P, (c + 1) * P) (P = ceil(nb_seq / C)) and the
// gaps before them (the last CTA also the tail gap), so a row's extensions
// and stores go through C SMs.
// 1. every CTA stages the row's bytes (a compare at pos - off can reach
//    anywhere in the row; cp.async of 16 bytes, the other CTAs of the
//    cluster reading the same lines from L2);
// 2. forward: one thread a sequence, for its sequences and the one before
//    them (its first backward bound); the ends go to shared memory. No
//    index is clamped below the next start, so the steps are a count of
//    the bytes that agree, up to 24 (six 4-byte words a side from the
//    staged row, the first difference by __ffs);
// 3. backward and the fields: one thread a sequence, the steps again a
//    count (from the top, by __clz) where both sides lie 24 bytes clear of
//    the row's start; ll, ml and off written, the zeros past nb_seq split
//    across the cluster; each gap's length kept;
// 4. the gaps' first ranks: a block scan over contiguous runs of gaps, then
//    an exchange (cluster barrier, distributed shared memory) of each CTA's
//    literals and of the tail gap's rank and start;
// 5. lit_idx in 16-byte stores (scalar at a range's ragged ends), four
//    ranks a thread: each CTA writes the ranks of its own gaps, a binary
//    search of its gaps' ranks giving each rank's gap (the next three
//    search only where they pass the first's gap: stepping gap by gap
//    would cross runs of empty gaps, hundreds long in rows with few
//    literals); the tail gap's ranks and the n - 1 after nb_lit
//    are one closed form, split evenly across the cluster. No CTA waits for
//    another's search, and no gap's rank leaves the CTA that owns it.
// Shared memory a CTA, the main path's shape at C = 3: the row's bytes and
// 32 more for the word loads (131,104 B), its forward ends and gap ranks
// (2 * 5,463 ints: 43,704 B), 174,808 B. Rows of up to 173,056 B are held
// at C = 3 (154,112 B at C = 2, 184,832 B at C = 4; cap = n / 8); past that
// the bytes are read from device memory, the extensions step by step, and
// the two arrays live in global scratch.
// Why the step loops stay beside the counts: the counts are word loads of
// the staged row, with 32 bytes of room past its end. So the steps (the
// plain's own compares through Row, byte by byte) run wherever that does
// not hold: an index the plain clamps (off < 0 or pos - off < 0, which the
// merge never writes but the contract takes), a backward compare with sp -
// off < 24 (the six words would read below the row's start), and the
// global route (rows past 173,056 B, which no engine's batch makes), whose
// row in device memory has no room past its end and no alignment. On the
// main path only the second case reaches them, for sequences whose source
// lies in the row's first 24 bytes. tests/seqtailmodel.py takes the same
// forms on the shared-memory route.
//
// Time on the main path's shape (level-5 batch 0; NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 7): 0.0261 ms at C = 3 (0.0329 at C = 2,
// 0.0366 at C = 4, two waves), 2.8x the 0.00927-ms bound; one CTA of 1024
// threads a row took 0.0590 ms. At 64 and 128 rows the wrapper takes C =
// 2 (0.0375 and 0.0674 ms, its fastest there).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kExt3 = 7, kExt1 = 2, kBack3 = 5, kBack1 = 2;   // step caps
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;       // shared memory an H100 block may use
constexpr int kStatic = 1024;            // room kept for the static arrays
constexpr int kStamps = 6;               // phase ends a CTA may report

// Ints a CTA keeps of its own: forward ends from the one before its first
// sequence, then its gaps (the tail too in the last CTA).
__host__ __device__ int local_ints(int cap, int C) {
  return 2 * ((cap + C - 1) / C + 1);
}

// Bytes of shared memory the row takes: its bytes, and room for the
// extensions' word loads past its end.
__host__ __device__ int row_bytes(int n) { return (n + 32 + 15) / 16 * 16; }

long long smem_bytes(int n, int cap, int C) {
  return row_bytes(n) + 4LL * local_ints(cap, C);
}

bool row_in_smem(int n, int cap, int C) {
  return smem_bytes(n, cap, C) <= kSmemLimit - kStatic;
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

// 4 bytes of the staged row at byte x (aligned loads, funnel-shifted).
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int x) {
  return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], 8 * (x & 3));
}

// How many bytes agree at x + i and y + i, i = 0, 1, ..., counted up to 24,
// in the staged row (x, y >= 0; reads up to 28 bytes past each).
__device__ __forceinline__ int equal_ahead(const uint8_t* s, int x, int y) {
  const auto* w = reinterpret_cast<const uint32_t*>(s);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint32_t d = word_at(w, x + 4 * i) ^ word_at(w, y + 4 * i);
    if (d) return 4 * i + (__ffs(d) - 1) / 8;
  }
  return 24;
}

// How many bytes agree at x - 1 - i and y - 1 - i, i = 0, 1, ..., counted up
// to 24, in the staged row (x, y >= 24).
__device__ __forceinline__ int equal_behind(const uint8_t* s, int x, int y) {
  const auto* w = reinterpret_cast<const uint32_t*>(s);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint32_t d = word_at(w, x - 4 - 4 * i) ^ word_at(w, y - 4 - 4 * i);
    if (d) return 4 * i + __clz(d) / 8;
  }
  return 24;
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

// What a CTA shows the rest of its cluster.
struct Pub {
  int total;          // its literals
  int tail_rank;      // the tail gap's first rank among them (last CTA)
  int tail_start;     // the tail gap's first position (last CTA)
};

// Writes lit_idx[r] for r in [lo, hi): 16-byte stores of four ranks a
// thread where `vec`, scalar stores at the ragged ends. `first(r)` gives the
// search state of rank r, `value(state, r)` its position (the state moves
// forward as r grows).
template <typename First, typename Value>
__device__ void emit(int32_t* out, int lo, int hi, bool vec, First first,
                     Value value) {
  const int tid = threadIdx.x;
  int a = hi, z = hi;                    // the 16-byte body [a, z)
  if (vec) {
    a = min((lo + 3) & ~3, hi);
    z = max(hi & ~3, a);
  }
  for (int r = lo + tid; r < a; r += kThreads) {
    int g = first(r);
    out[r] = value(g, r);
  }
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int c = a / 4 + tid; c < z / 4; c += kThreads) {
    const int r0 = 4 * c;
    int g = first(r0);
    int4 v;
    v.x = value(g, r0);
    v.y = value(g, r0 + 1);
    v.z = value(g, r0 + 2);
    v.w = value(g, r0 + 3);
    out4[c] = v;
  }
  for (int r = z + tid; r < hi; r += kThreads) {
    int g = first(r);
    out[r] = value(g, r);
  }
}

// The row's kernel: C CTAs a row (launched as clusters of C), the row's
// bytes and each CTA's arrays in shared memory (kSmem) or device memory.
template <bool kSmem>
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
                  int32_t* __restrict__ scratch,
                  long long* __restrict__ cycles, int n, int cap) {
  extern __shared__ __align__(16) uint8_t s_row[];
  __shared__ int s_sum[kWarps];
  __shared__ Pub s_pub, s_pubs[4];       // this CTA's, and all C of them
  __shared__ int s_base, s_all, s_tail_rank, s_tail_start;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x, b = blockIdx.x / C;
  const long long t0 = clock64();
  // SM cycles from the start to the end of phase i, as thread 0 sees them
  auto stamp = [&](int i) {
    if (cycles && tid == 0) cycles[blockIdx.x * kStamps + i] = clock64() - t0;
  };
  const size_t brow = size_t(b) * n, crow = size_t(b) * cap;
  const int nb_in = nb_seq[b];
  const int nb = min(max(nb_in, 0), cap);
  const int vn = min(valid_lens[b], n);
  const int32_t* sp_in = seq_pos + crow;
  const int32_t* sl_in = seq_len + crow;
  const int32_t* so_in = seq_off + crow;
  const int per = (nb + C - 1) / C;
  const int k0 = min(rank * per, nb), k1 = min(k0 + per, nb);
  const bool last = rank == C - 1;

  Row row;
  int32_t* efwd;       // efwd[i]: the end of sequence k0 + i - 1 after its
                       // forward steps, the start of the CTA's gap i
  int32_t* out = lit_idx + brow;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  row.n = n;
  if constexpr (kSmem) {
    row.bytes = s_row;
    efwd = reinterpret_cast<int32_t*>(s_row + row_bytes(n));
    // 1. stage the row's bytes
    const uint8_t* src = blocks + brow;
    if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int i = tid; i < n / 16; i += kThreads)
        __pipeline_memcpy_async(s_row + 16 * i, src + 16 * i, 16);
      __pipeline_commit();
    } else {
      for (int i = tid; i < n; i += kThreads) s_row[i] = __ldg(src + i);
    }
  } else {
    row.bytes = blocks + brow;
    efwd = scratch + (size_t(b) * C + rank) * local_ints(cap, C);
  }
  int32_t* gaps = efwd + local_ints(cap, C) / 2;   // lengths, then ranks
  if (tid == 0 && k0 == 0) efwd[0] = 0;
  __pipeline_wait_prior(0);
  __syncthreads();
  stamp(0);

  // 2. forward
  for (int k = max(k0 - 1, 0) + tid; k < k1; k += kThreads) {
    const int p = sp_in[k], l = sl_in[k], o = so_in[k];
    const int next = k + 1 < nb ? sp_in[k + 1] : vn;
    const int room = max(next - (p + l), 0);
    int ln = l;
    if (kSmem && room > 0 && o >= 0 && p - o >= 0) {
      // no index is clamped below p + l + room <= n: the steps are the
      // bytes that agree from p + l and p - o + l, up to room
      const int m = min(equal_ahead(s_row, p + l, p - o + l), room);
      const int s3 = min(kExt3, m / 3);
      ln = l + 3 * s3 + min(kExt1, m - 3 * s3);
    } else if (room > 0) {
      const int limit = l + room, src = p - o;
      for (int i = 0; i < kExt3; ++i) {
        if (ln + 3 > limit || row.tri(min(p + ln, n - 1)) !=
                                  row.tri(max(min(src + ln, n - 1), 0)))
          break;
        ln += 3;
      }
      for (int i = 0; i < kExt1; ++i) {
        if (ln >= limit || row.byte(min(p + ln, n - 1)) !=
                               row.byte(max(min(src + ln, n - 1), 0)))
          break;
        ln += 1;
      }
    }
    efwd[k - k0 + 1] = p + ln;
  }
  __syncthreads();
  stamp(1);

  // 3. backward and the fields
  for (int k = k0 + tid; k < k1; k += kThreads) {
    const int o = so_in[k];
    const int pe = efwd[k - k0];
    int sp = sp_in[k];
    if (kSmem && o >= 0 && sp - o >= 24) {
      // no index is clamped above pe >= 0 and 0: the steps are the bytes
      // that agree below sp and sp - o, down to pe on one side and 0 on
      // the other
      const int m = max(min(min(equal_behind(s_row, sp, sp - o), sp - pe),
                            sp - o), 0);
      const int s3 = min(kBack3, m / 3);
      sp -= 3 * s3 + min(kBack1, m - 3 * s3);
    } else {
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
    }
    ll[crow + k] = sp - pe;
    ml[crow + k] = efwd[k - k0 + 1] - sp;
    off[crow + k] = o;
    gaps[k - k0] = max(sp - pe, 0);
  }
  const long long zeros = cap - nb;
  for (long long k = nb + rank * zeros / C + tid;
       k < nb + (rank + 1) * zeros / C; k += kThreads) {
    ll[crow + k] = 0;
    ml[crow + k] = 0;
    off[crow + k] = 0;
  }
  const int nl = k1 - k0;                // the CTA's gaps before sequences
  int tail_len = 0, tail_start = 0;
  if (last && tid == 0) {                // the tail gap
    tail_start = nb ? efwd[nb - k0] : 0;
    tail_len = max(vn - tail_start, 0);
    gaps[nl] = tail_len;
  }
  __syncthreads();
  stamp(2);

  // 4. the gaps' first ranks: local, then across the cluster
  const int ng = nl + last;
  const int run = (ng + kThreads - 1) / kThreads;
  const int g0 = min(tid * run, ng), g1 = min(g0 + run, ng);
  int mine = 0;
  for (int g = g0; g < g1; ++g) mine += gaps[g];
  int total;
  int r = block_sum(mine, s_sum, total);
  for (int g = g0; g < g1; ++g) {
    const int len = gaps[g];
    gaps[g] = r;
    r += len;
  }
  if (tid == 0) {
    s_pub.total = total;
    s_pub.tail_rank = total - tail_len;
    s_pub.tail_start = tail_start;
  }
  stamp(3);
  cluster.sync();
  if (tid < C) s_pubs[tid] = *cluster.map_shared_rank(&s_pub, tid);
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int c = 0; c < C; ++c) {
      if (c == rank) s_base = sum;
      if (c == C - 1) {
        s_tail_rank = sum + s_pubs[c].tail_rank;
        s_tail_start = s_pubs[c].tail_start;
      }
      sum += s_pubs[c].total;
    }
    s_all = sum;
  }
  __syncthreads();
  // the cluster's shared memory is read no more: arrive now, wait at the end
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  stamp(4);

  // 5. lit_idx
  const int base = s_base, all = s_all;
  const int tail_rank = s_tail_rank, tail_from = s_tail_start;
  // the CTA's own gaps (the tail aside): rank r is position efwd[g] + r -
  // base - gaps[g] of its gap g, the last with gaps[g] <= r - base (a run
  // of empty gaps shares its rank with the gap after it)
  auto gap_of = [&](int rl, int lo) {    // the last g >= lo, gaps[g] <= rl
    int hi = nl - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (gaps[mid] <= rl) lo = mid; else hi = mid - 1;
    }
    return lo;
  };
  emit(out, base, base + s_pub.tail_rank, vec,
       [&](int r0) { return gap_of(r0 - base, 0); },
       [&](int& g, int r) {
         // the next rank may pass a long run of empty gaps: search again
         if (g < nl - 1 && gaps[g + 1] <= r - base)
           g = gap_of(r - base, g + 1);
         return efwd[g] + r - base - gaps[g];
       });
  // the tail gap, then n - 1 from nb_lit on: split evenly across the cluster
  const long long rest = n - tail_rank;
  emit(out, int(tail_rank + rank * rest / C),
       int(tail_rank + (rank + 1) * rest / C), vec, [](int) { return 0; },
       [&](int&, int r) {
         return r < all ? tail_from + r - tail_rank : n - 1;
       });
  if (rank == 0 && tid == 0) {
    nb_lit[b] = all;
    overflow[b] = nb_in >= cap;
  }
  stamp(5);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

using Kernel = decltype(&seq_finish_kernel<true>);

// f(kernel, cfg): the instantiation for rows of n bytes and cap sequences
// at C CTAs a row (2-4), and a launch configuration of B clusters of C on
// the stream, its shared memory allowed; a cudaError_t where that fails.
template <typename F>
int with_config(int C, int B, int n, int cap, cudaStream_t stream, F f) {
  if (C < 2 || C > 4) return int(cudaErrorInvalidValue);
  const bool smem_route = row_in_smem(n, cap, C);
  const Kernel kernel =
      smem_route ? seq_finish_kernel<true> : seq_finish_kernel<false>;
  const int smem = smem_route ? int(smem_bytes(n, cap, C)) : 0;
  // set once per size, outside any graph capture that replays the launch
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return f(kernel, cfg);
}

}  // namespace

// Ints of global scratch the kernel needs a row with C CTAs a row: 0 where
// the row's bytes and the CTAs' arrays fit in shared memory, else the C
// CTAs' arrays.
extern "C" int seq_finish_scratch_ints(int n, int cap, int C) {
  return row_in_smem(n, cap, C) ? 0 : C * local_ints(cap, C);
}

// Clusters of C CTAs (2-4) the current card can hold at once for rows of n
// bytes and cap sequences, or a negative cudaError_t.
extern "C" int seq_finish_max_clusters(int n, int cap, int C) {
  int num = 0;
  const int err = with_config(
      C, 64, n, cap, nullptr,
      [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaOccupancyMaxActiveClusters(&num, kernel, &cfg));
      });
  return err == 0 ? num : -err;
}

// One launch over B rows with C CTAs a row (2-4); scratch holds B *
// seq_finish_scratch_ints(n, cap, C) ints (may be null when that is 0).
// cycles (may be null): i64[B, C, 6], each CTA's SM cycles from its start
// to the end of each phase (FINISH_STAMPS in ops/fastmatch.py names them).
extern "C" int seq_finish_launch(const void* blocks, const void* seq_pos,
                                 const void* seq_len, const void* seq_off,
                                 const void* nb_seq, const void* valid_lens,
                                 void* ll, void* off, void* ml, void* lit_idx,
                                 void* nb_lit, void* overflow, void* scratch,
                                 void* cycles, int B, int n, int cap, int C,
                                 void* stream) {
  if (B == 0) return 0;
  if (n < 1 || cap < 1 || cap > (1 << 27) || B > 2147483647 / 4)
    return int(cudaErrorInvalidValue);
  if (!row_in_smem(n, cap, C) && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  const int err = with_config(
      C, B, n, cap, static_cast<cudaStream_t>(stream),
      [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaLaunchKernelEx(
            &cfg, kernel, static_cast<const uint8_t*>(blocks),
            static_cast<const int32_t*>(seq_pos),
            static_cast<const int32_t*>(seq_len),
            static_cast<const int32_t*>(seq_off),
            static_cast<const int32_t*>(nb_seq),
            static_cast<const int32_t*>(valid_lens), static_cast<int32_t*>(ll),
            static_cast<int32_t*>(off), static_cast<int32_t*>(ml),
            static_cast<int32_t*>(lit_idx), static_cast<int32_t*>(nb_lit),
            static_cast<uint8_t*>(overflow), static_cast<int32_t*>(scratch),
            static_cast<long long*>(cycles), n, cap));
      });
  if (err != 0) return err;
  return int(cudaGetLastError());
}
