// The sequence executor in one cooperative launch: every output byte is
// placed from the sequences (its first source, or its literal), each match
// byte's final source and hop count are found by in-place pointer jumping
// over a worklist that shrinks each pass, and the rounds, `ok` and values of
// the JAX loop's out-of-place doubling follow in closed form from the hop
// counts.
//
// Replaces: zstd_tpu/ops/decode_dev.py:150 (exec_sequences: the positional
// half :161-218, the doubling while_loop :227 and the gather :230-240).
// Same contract as ops/decode_dev.py::exec_prepare followed by
// exec_resolve_plain on (out, ok, rounds run), for literal and match lengths
// >= 0 (the wrapper checks them and raises).
//
// Inputs, from O(seq_cap) torch prefix sums over the nb valid sequences
// (each clamped to n, which leaves every value a position below n reads
// unchanged): seq_end[k] (inclusive prefix of ll + ml), mstart[k] = seq_end
// - ml (where the match begins), lit_start[k] (exclusive prefix of ll,
// lit_start[nb] the total). Byte j < n lies in the first sequence k with
// seq_end[k] > j; it is a literal if j < mstart[k] (rank lit_start[k] + j -
// seq_start[k]), else a match byte with source m - off + (j - m) % off
// (m = mstart[k], off = max(off[k], 1): the periodic rewrite, always before
// m); past the last sequence it is a literal of rank lit_start[nb] + j -
// seq_end[nb - 1]. A literal below out_len takes lits[min(rank, min(n,
// nlits) - 1)], every other non-match byte 0: exec_prepare's `placed`.
//
// Why closed form. Let hop(j) be a match byte's source and hop(j) = j for
// every other byte (a fixed point; a match byte's source lies before it, so
// it is never one), and d_j the hops from j to a fixed point or a negative
// (history) source, D the largest d_j. Out-of-place doubling holds
// hop^(2^t) after round t, so round t changes a pointer iff D > 2^t: the
// loop runs r = 1 + min(rounds, ceil(log2 D)) rounds (0 without a match
// byte), byte j has reached its source iff d_j <= 2^r, and an unresolved
// byte reads `placed` of a match byte, 0. So (F_j, d_j), F_j the final
// source, give (out, ok, r) exactly, and any order of composing pointers
// finds them. Doubling in place over a worklist finds them in fewer passes
// than out of place (a pass in increasing position order meets mostly
// sources that are already final), and the worklist per out-of-place round
// is the count of bytes with d_j > 2^t, a histogram of ceil(log2 d_j).
//
// Phases, separated by grid.sync():
//   1. place: each warp takes 256 consecutive bytes, finds the sequence of
//      its first byte by a 32-way search over seq_end (one probe a lane a
//      step), and each lane walks forward over every 32nd byte. It writes
//      P[j] = (pointer, hops) as one 64-bit word, (j, 0) for a non-match
//      byte (and its value to `out`), (source, 1) for a match byte, which
//      also goes to worklist 0 (a block-wide prefix sum and one atomic per
//      4,096 bytes).
//   2. passes: an entry i reads (q, h) = P[i]; a negative q, or a q with
//      P[q] = (q, 0), is final; else P[i] = (q2, h + h2) from (q2, h2) =
//      P[q], final if q2 < 0 or P[q2] = (q2, 0), kept otherwise. Reads go to L2 (ld.cg), so a
//      pair written in this pass by another block may be seen or not:
//      either is a valid (target, hops) pair, at least as far along as at
//      the pass's start, so a pass at least doubles every kept entry's hops
//      and at most ceil(log2 D) + 1 passes run. D is the max of the final
//      hops (a warp max, one atomic a warp).
//   3. gather: r and 2^r from D; for each match byte, out[j] =
//      history[clip(h + F, 0, h - 1)] for F < 0, out[F] (a non-match byte's
//      value, written in phase 1 and never again) otherwise, when d_j <=
//      2^r; else 0, and a byte below out_len makes ok false.
// The diagnostics (the histogram of ceil(log2 d_j), which reproduces the
// out-of-place rounds' changed counts, the phase times and the grid) are
// kept only when `stats` is not null; the decode passes null.
//
// Bound on an H100: bytes. Once each: the literals the sequences read (the
// sum of their literal lengths), ll/ml/off (12 bytes a sequence), the
// history and the out_len bytes of output. The kernel also writes 8 bytes of
// (pointer, hops) a byte and 4 bytes a match byte of worklist in phase 1,
// and moves about 24 bytes a worklist entry a pass.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 8;                      // entries a thread per tile
constexpr int kTile = kThreads * kPer;       // bytes or entries a tile
constexpr int kMaxPasses = 40;               // > ceil(log2 2^31) + 1
constexpr int kPassBase = 4;                 // ctrl: worklist of each pass
constexpr int kCtrlLen = kPassBase + kMaxPasses + 1;
constexpr int kTimeBase = 32;                // stats: after the histogram
constexpr int kStatsLen = kTimeBase + 4;     // phase times, grid

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

typedef unsigned long long u64;

__device__ __forceinline__ u64 pair(int ptr, int hops) {
  return u64(uint32_t(ptr)) | (u64(uint32_t(hops)) << 32);
}
__device__ __forceinline__ int pair_ptr(u64 v) { return int(uint32_t(v)); }
__device__ __forceinline__ int pair_hops(u64 v) { return int(v >> 32); }

// ceil(log2 d) for d >= 1
__device__ __forceinline__ int ceil_log2(int d) { return 32 - __clz(d - 1); }

// this thread's slot in a list that the block appends `count` entries to:
// one atomicAdd on *counter per block
__device__ int block_offset(int count, int* counter, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sm[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sm[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) sm[lane] = w;
    if (lane == 31) sm[32] = w ? atomicAdd(counter, w) : 0;
  }
  __syncthreads();
  const int r = sm[32] + (warp ? sm[warp - 1] : 0) + x - count;
  __syncthreads();
  return r;
}

// first k in [0, nb) with seq_end[k] > j (nb if none), by the whole warp:
// each step probes the last index of 32 buckets, one a lane
__device__ int warp_search(const int32_t* __restrict__ seq_end, int nb,
                           int j) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = nb;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int first = lo + step * lane;
    const int last = min(first + step, hi) - 1;
    const bool gt = first < hi && seq_end[last] > j;
    const unsigned b = __ballot_sync(0xffffffffu, gt);
    if (!b) return hi;
    const int f = __ffs(b) - 1;
    lo = lo + step * f;
    hi = min(lo + step, hi);
  }
  const bool gt = lo + lane < hi && seq_end[lo + lane] > j;
  const unsigned b = __ballot_sync(0xffffffffu, gt);
  return b ? lo + __ffs(b) - 1 : hi;
}

// ctrl: [0] rounds run, [1] some match byte below out_len unresolved, [2]
// D, [3] passes, [kPassBase + t] entries of pass t's worklist. stats (null
// or kStatsLen): [c] match bytes with ceil(log2 d) == c, [kTimeBase + k] ns
// of phase k + 1, [kTimeBase + 3] grid
__global__ void __launch_bounds__(kThreads)
exec_seq_kernel(const uint8_t* __restrict__ lits, int nlits,
                const int32_t* __restrict__ seq_end,
                const int32_t* __restrict__ mstart,
                const int32_t* __restrict__ lit_start,
                const int32_t* __restrict__ off, int nb, u64* P,
                int32_t* list0, int32_t* list1, int32_t* list2,
                const uint8_t* __restrict__ history, int h, uint8_t* out,
                uint8_t* __restrict__ ok, int32_t* ctrl, int32_t* stats,
                int n, int out_len, int rounds) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int sm[33];
  __shared__ int cls[33];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  volatile int32_t* vctrl = ctrl;
  if (tid == 0) {
    for (int k = 0; k < kCtrlLen; ++k) ctrl[k] = 0;
    if (stats)
      for (int k = 0; k < kStatsLen; ++k) stats[k] = 0;
  }
  grid.sync();
  const long long t_begin = stats ? global_ns() : 0;
  long long t_placed = 0, t_passes = 0;

  // ---- 1. place ---------------------------------------------------------
  const int total = nb ? seq_end[nb - 1] : 0;
  const int total_ll = lit_start[nb];
  const int lit_cap = min(n, nlits) - 1;
  const int ntiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int w0 = tile * kTile + warp * 32 * kPer;
    int k = warp_search(seq_end, nb, w0);
    uint32_t mask = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int j = w0 + lane + 32 * m;
      if (j >= n) break;
      while (k < nb && seq_end[k] <= j) ++k;
      int p = j, rank = -1;
      if (k >= nb) {
        if (j < out_len) rank = total_ll + (j - total);
      } else {
        const int ms = mstart[k];
        if (j < ms) {
          if (j < out_len) rank = lit_start[k] + (j - (k ? seq_end[k - 1] : 0));
        } else {
          const long long d = max(off[k], 1);
          p = int(ms - d + (j - ms) % d);
          mask |= 1u << m;
        }
      }
      const bool match = (mask >> m) & 1u;
      P[j] = pair(p, match ? 1 : 0);
      if (!match) out[j] = rank >= 0 ? lits[min(rank, lit_cap)] : 0;
    }
    // worklist 0 in position order: warps in order, then m, then lanes
    unsigned ball[kPer];
    int wcount = 0;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      ball[m] = __ballot_sync(0xffffffffu, (mask >> m) & 1u);
      wcount += __popc(ball[m]);
    }
    int at = __shfl_sync(0xffffffffu,
                         block_offset(lane ? 0 : wcount, &ctrl[kPassBase], sm),
                         0);
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      if ((mask >> m) & 1u)
        list0[at + __popc(ball[m] & below)] = w0 + lane + 32 * m;
      at += __popc(ball[m]);
    }
  }
  grid.sync();
  if (stats) t_placed = global_ns();

  // ---- 2. passes over the worklist --------------------------------------
  const int32_t* lin = list0;
  int32_t* lout = list1;
  int t = 0;
  for (; t < kMaxPasses; ++t) {
    const int len = vctrl[kPassBase + t];
    if (len == 0) break;
    int dmax = 0;
    for (int base = blockIdx.x * kTile; base < len;
         base += gridDim.x * kTile) {
      // each thread takes kPer consecutive entries, so the kept ones stay
      // in position order
      const int e0 = base + threadIdx.x * kPer;
      int ent[kPer];
      if (e0 + kPer <= len) {
        const int4 a = __ldcg(reinterpret_cast<const int4*>(lin + e0));
        const int4 b = __ldcg(reinterpret_cast<const int4*>(lin + e0) + 1);
        ent[0] = a.x; ent[1] = a.y; ent[2] = a.z; ent[3] = a.w;
        ent[4] = b.x; ent[5] = b.y; ent[6] = b.z; ent[7] = b.w;
      } else {
#pragma unroll
        for (int m = 0; m < kPer; ++m)
          ent[m] = e0 + m < len ? __ldcg(lin + e0 + m) : -1;
      }
      int keep[kPer];
      int nkeep = 0;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        keep[m] = -1;
        const int i = ent[m];
        if (i < 0) continue;
        const u64 v = __ldcg(P + i);
        const int q = pair_ptr(v);
        int hops = pair_hops(v);
        if (q >= 0) {
          const u64 v2 = __ldcg(P + q);
          const int q2 = pair_ptr(v2);
          if (q2 != q) {                 // q is a match byte: compose
            hops += pair_hops(v2);
            __stcg(P + i, pair(q2, hops));
            if (q2 >= 0 && pair_ptr(__ldcg(P + q2)) != q2) {
              keep[m] = i;
              ++nkeep;
              continue;
            }
          }
        }
        dmax = max(dmax, hops);          // final: history, or a fixed q
      }
      int at = block_offset(nkeep, &ctrl[kPassBase + t + 1], sm);
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        if (keep[m] >= 0) lout[at++] = keep[m];
    }
    dmax = __reduce_max_sync(0xffffffffu, dmax);
    if (lane == 0 && dmax) atomicMax(&ctrl[2], dmax);
    grid.sync();
    lin = lout;
    lout = lout == list1 ? list2 : list1;
  }

  // ---- 3. rounds, ok and the gather ---------------------------------------
  if (stats) t_passes = global_ns();
  const int nmatch = vctrl[kPassBase];
  const int D = vctrl[2];
  const int r = nmatch ? 1 + min(rounds, ceil_log2(max(D, 1))) : 0;
  const int lim = r >= 31 ? 0x7fffffff : 1 << r;
  if (threadIdx.x < 33) cls[threadIdx.x] = 0;
  __syncthreads();
  bool bad = false;
  for (int e = tid; e < nmatch; e += gridDim.x * blockDim.x) {
    const int j = __ldcg(list0 + e);
    const u64 v = __ldcg(P + j);
    const int F = pair_ptr(v), d = pair_hops(v);
    if (stats) atomicAdd(&cls[ceil_log2(d)], 1);
    if (d <= lim) {
      out[j] = F < 0 ? history[min(max(h + F, 0), h - 1)] : __ldcg(out + F);
    } else {
      out[j] = 0;
      bad |= j < out_len;
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(&ctrl[1], 1);
  if (stats && threadIdx.x < 32 && cls[threadIdx.x])
    atomicAdd(&stats[threadIdx.x], cls[threadIdx.x]);
  grid.sync();
  if (tid == 0) {
    ok[0] = vctrl[1] == 0;
    ctrl[0] = r;
    ctrl[3] = t;
    if (stats) {
      // ns of place, passes, gather (block 0's view of the barriers)
      const long long t_end = global_ns();
      stats[kTimeBase + 0] = int(t_placed - t_begin);
      stats[kTimeBase + 1] = int(t_passes - t_placed);
      stats[kTimeBase + 2] = int(t_end - t_passes);
      stats[kTimeBase + 3] = gridDim.x;
    }
  }
}

}  // namespace

extern "C" int exec_seq_ctrl_len() { return kCtrlLen; }
extern "C" int exec_seq_stats_len() { return kStatsLen; }

extern "C" int exec_seq_launch(const void* lits, int nlits, const void* seq_end,
                               const void* mstart, const void* lit_start,
                               const void* off, int nb, void* pairs,
                               void* list0, void* list1, void* list2,
                               const void* history, int h, void* out, void* ok,
                               void* ctrl, void* stats, int n, int out_len,
                               int rounds, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      exec_seq_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return int(err);
  const int need = (n + kTile - 1) / kTile;
  const int grid = max(1, min(per_sm * sms, need));
  auto* li = static_cast<const uint8_t*>(lits);
  auto* se = static_cast<const int32_t*>(seq_end);
  auto* ms = static_cast<const int32_t*>(mstart);
  auto* ls = static_cast<const int32_t*>(lit_start);
  auto* of = static_cast<const int32_t*>(off);
  auto* pr = static_cast<u64*>(pairs);
  auto* l0 = static_cast<int32_t*>(list0);
  auto* l1 = static_cast<int32_t*>(list1);
  auto* l2 = static_cast<int32_t*>(list2);
  auto* hi = static_cast<const uint8_t*>(history);
  auto* o = static_cast<uint8_t*>(out);
  auto* k = static_cast<uint8_t*>(ok);
  auto* c = static_cast<int32_t*>(ctrl);
  auto* s = static_cast<int32_t*>(stats);
  void* args[] = {&li, &nlits, &se, &ms, &ls, &of, &nb, &pr, &l0, &l1, &l2,
                  &hi, &h, &o, &k, &c, &s, &n, &out_len, &rounds};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(exec_seq_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
