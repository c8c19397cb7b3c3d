// The lazy and v3 engines' seqstore merge, in one launch: from the resolve's
// committed slots to the merged sequences.
//
// Replaces, in zstd_tpu/ops/fastmatch.py: `_compact` (:202, its last-valid
// scan :221 and group scan :229), `_rep_rewrite` (:241, its while_loop :270)
// and `_merge_chains` (:276, its scan :284), as the engines chain them
// (:471-474, :532-535).
//
// Contract: ops/fastmatch.py::seq_merge_plain, bit for bit, on the slots the
// resolve writes (yp < n where yl > 0). Inputs yp, yl i32[B, M] (M = L * 160
// slots a row, (-1, 0) where a step took no match), cand i32[B, n] (the
// candidate of every position), blocks u8[B, n]. Outputs pos, len, dist
// i32[B, cap] ((n, 0, 0) past nb) and nb i32[B].
//
// What it computes per row:
// - compact: dist = yp - cand[yp] for a valid slot (yl > 0); a valid slot
//   merges into the group of the last valid slot before it when it starts
//   at that slot's end with the same dist; every other valid slot starts a
//   group, and groups at or past cap are dropped (nb = min(groups, cap)).
//   A group's members start where the one before ends, so its minimum yp is
//   its first slot's, its lengths sum to its last end less that yp, and its
//   dists are all the first's (the plain's max starts at 0).
// - rep_rewrite: group k > 0 takes the previous group's dist d when d > 0,
//   differs from its own, pos - d >= 0, its length is <= 18, and the 3-byte
//   words at pos + j and pos - d + j (j = 0, 3, ..., 15, j < len; indices
//   clamped to [0, n - 1], bytes past n read 0) are equal.
// - merge_chains: the same merge on the rewritten groups (entry k > 0 joins
//   k - 1 when it starts at its end with the same dist). The plain clamps a
//   merged group id to cap - 1, but an id never passes its entry's index,
//   so the clamp never acts.
//
// Bound on an H100: the bytes the call must move, for the main path's batch
// of 32 rows of 131,072 B (M = 40,960, cap = 16,384): yp and yl read
// (10,485,760 B), cand and blocks read once (16,777,216 + 4,194,304 B), pos,
// len, dist and nb written (6,291,584 B): 37,748,864 B, 0.0113 ms at
// 3.35 TB/s. The call reads cand only at the valid slots and the bytes only
// at the rewrite's candidates, so it moves far fewer.
//
// Design: one CTA of 1024 threads a row (grid B). The groups live in shared
// memory (pos, dist and end, 3 * cap ints: 196,608 B at cap 16,384; in
// global scratch when they do not fit).
// 1. the slots in tiles of 4,096, four a thread as one int4 of yp and of
//    yl: a block scan of "the last valid slot" (warp shuffles, then across
//    the warps), carried from tile to tile, gives each slot its predecessor;
//    a block scan of the group starts gives each start its group id. A
//    start writes its group's pos and dist and the previous group's end
//    (its predecessor's end); the row's last valid slot ends the last group.
// 2. the groups in rounds of 1,024, one a thread: the rewrite's byte
//    compares (the bytes through L1/L2), the rewritten dists exchanged
//    through shared memory for the merge test, a block scan of the merged
//    starts; a start writes its pos and dist and the previous merged
//    group's end into the outputs.
// 3. each merged group's length is its end less its pos; the rest of the
//    row is (n, 0, 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                  // slots a thread a tile (one int4)
constexpr int kRepMax = 18;              // longer groups are never rewritten
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;       // shared memory an H100 block may use
constexpr int kStatic = 8192;            // room kept for the static arrays

// the last valid slot so far: valid, its end and its dist
struct Last {
  int v, e, d;
};

__device__ __forceinline__ Last later(const Last& a, const Last& b) {
  return b.v ? b : a;
}

__device__ __forceinline__ Last shfl_up(const Last& x, int o) {
  return {__shfl_up_sync(kFull, x.v, o), __shfl_up_sync(kFull, x.e, o),
          __shfl_up_sync(kFull, x.d, o)};
}

// Exclusive scan of `later` over the block's threads in order; `total`
// receives the block's inclusive result.
__device__ Last block_last(const Last& x, Last* s_warp, Last& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Last inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const Last y = shfl_up(inc, o);
    if (lane >= o && !inc.v) inc = y;
  }
  Last ex = shfl_up(inc, 1);
  if (lane == 0) ex = {0, 0, 0};
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Last w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const Last y = shfl_up(w, o);
      if (lane >= o && !w.v) w = y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const Last before = warp ? s_warp[warp - 1] : Last{0, 0, 0};
  total = s_warp[kWarps - 1];
  __syncthreads();                       // s_warp is reused by the next scan
  return later(before, ex);
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

// The 3-byte word at x in [0, n - 1] of a row, bytes past n read as 0.
__device__ __forceinline__ uint32_t tri(const uint8_t* __restrict__ row,
                                        int n, int x) {
  uint32_t v = __ldg(row + x);
  if (x + 1 < n) v |= uint32_t(__ldg(row + x + 1)) << 8;
  if (x + 2 < n) v |= uint32_t(__ldg(row + x + 2)) << 16;
  return v;
}

bool groups_in_smem(int cap) { return 12LL * cap <= kSmemLimit - kStatic; }

__global__ void __launch_bounds__(kThreads, 1)
seq_merge_kernel(const int32_t* __restrict__ yp,
                 const int32_t* __restrict__ yl,
                 const int32_t* __restrict__ cand,
                 const uint8_t* __restrict__ blocks,
                 int32_t* __restrict__ out_pos, int32_t* __restrict__ out_len,
                 int32_t* __restrict__ out_dist, int32_t* __restrict__ out_nb,
                 int32_t* __restrict__ scratch, int n, int M, int cap,
                 bool in_smem) {
  extern __shared__ int32_t s_groups[];
  __shared__ Last s_last[kWarps];
  __shared__ int s_sum[kWarps];
  __shared__ int s_rd[kThreads];

  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t crow = size_t(b) * cap;
  int32_t* gpos = in_smem ? s_groups : scratch + 3 * crow;
  int32_t* gdist = gpos + cap;
  int32_t* gend = gdist + cap;
  const int32_t* crd = cand + size_t(b) * n;
  const uint8_t* row = blocks + size_t(b) * n;

  // 1. compact: the slots in tiles of kThreads * kVec
  const int4* yp4 = reinterpret_cast<const int4*>(yp + size_t(b) * M);
  const int4* yl4 = reinterpret_cast<const int4*>(yl + size_t(b) * M);
  const int M4 = M / kVec;
  Last carry = {0, 0, 0};
  int count = 0;                         // groups started so far
  for (int q0 = 0; q0 < M4; q0 += kThreads) {
    const int q = q0 + tid;
    int4 p4 = make_int4(-1, -1, -1, -1), l4 = make_int4(0, 0, 0, 0);
    if (q < M4) {
      p4 = __ldg(yp4 + q);
      l4 = __ldg(yl4 + q);
    }
    const int ps[kVec] = {p4.x, p4.y, p4.z, p4.w};
    const int ls[kVec] = {l4.x, l4.y, l4.z, l4.w};
    int ds[kVec];
    Last mine = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      ds[i] = 0;
      if (ls[i] > 0) {
        ds[i] = ps[i] - __ldg(crd + ps[i]);
        mine = {1, ps[i] + ls[i], ds[i]};
      }
    }
    Last total;
    Last cur = later(carry, block_last(mine, s_last, total));
    carry = later(carry, total);
    bool start[kVec];
    int pend[kVec], starts = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const bool valid = ls[i] > 0;
      start[i] = valid && !(cur.v && ps[i] == cur.e && ds[i] == cur.d);
      pend[i] = cur.e;
      if (valid) cur = {1, ps[i] + ls[i], ds[i]};
      starts += start[i];
    }
    int added;
    int g = count + block_sum(starts, s_sum, added);
    count += added;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (!start[i]) continue;
      if (g < cap) {
        gpos[g] = ps[i];
        gdist[g] = max(ds[i], 0);
      }
      if (g >= 1 && g - 1 < cap) gend[g - 1] = pend[i];
      ++g;
    }
  }
  if (tid == 0 && count >= 1 && count - 1 < cap) gend[count - 1] = carry.e;
  const int nb = min(count, cap);
  __syncthreads();

  // 2. rep_rewrite and merge_chains: the groups in rounds of kThreads
  int rd_carry = 0, merged = 0;
  for (int k0 = 0; k0 < nb; k0 += kThreads) {
    const int k = k0 + tid;
    const bool live = k < nb;
    int pos = 0, rd = 0, prev_end = 0;
    if (live) {
      pos = gpos[k];
      rd = gdist[k];
      if (k > 0) {
        const int d = gdist[k - 1], len = gend[k] - pos;
        prev_end = gend[k - 1];
        if (d > 0 && rd != d && pos - d >= 0 && len <= kRepMax) {
          bool ok = true;
          for (int j = 0; j < len; j += 3)
            ok = ok && tri(row, n, min(pos + j, n - 1)) ==
                           tri(row, n, max(min(pos - d + j, n - 1), 0));
          if (ok) rd = d;
        }
      }
    }
    s_rd[tid] = rd;
    __syncthreads();
    const int prd = tid ? s_rd[tid - 1] : rd_carry;
    const bool start = live && !(k > 0 && pos == prev_end && rd == prd);
    int added;
    const int g = merged + block_sum(start, s_sum, added);
    if (start) {
      out_pos[crow + g] = pos;
      out_dist[crow + g] = max(rd, 0);
      if (g > 0) out_len[crow + g - 1] = prev_end;   // its end, for now
    }
    merged += added;
    rd_carry = s_rd[kThreads - 1];
    __syncthreads();                     // before s_rd is rewritten
  }
  if (tid == 0 && merged > 0) out_len[crow + merged - 1] = gend[nb - 1];
  __syncthreads();

  // 3. lengths from the ends; the rest of the row empty
  for (int g = tid; g < cap; g += kThreads) {
    if (g < merged) {
      out_len[crow + g] -= out_pos[crow + g];
    } else {
      out_pos[crow + g] = n;
      out_len[crow + g] = 0;
      out_dist[crow + g] = 0;
    }
  }
  if (tid == 0) out_nb[b] = merged;
}

}  // namespace

// Ints of global scratch the kernel needs a row: 0 where the groups fit in
// shared memory, else 3 * cap.
extern "C" int seq_merge_scratch_ints(int cap) {
  return groups_in_smem(cap) ? 0 : 3 * cap;
}

// One launch over B rows. yp and yl must be 16-byte aligned and M a multiple
// of 4; scratch holds B * seq_merge_scratch_ints(cap) ints (may be null when
// that is 0).
extern "C" int seq_merge_launch(const void* yp, const void* yl,
                                const void* cand, const void* blocks,
                                void* pos, void* len, void* dist, void* nb,
                                void* scratch, int B, int n, int M, int cap,
                                void* stream) {
  if (B == 0) return 0;
  if (reinterpret_cast<uintptr_t>(yp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(yl) % 16 != 0 || M % kVec != 0 ||
      cap < 1 || B > 2147483647 / cap)
    return int(cudaErrorInvalidValue);
  const bool in_smem = groups_in_smem(cap);
  if (!in_smem && scratch == nullptr) return int(cudaErrorInvalidValue);
  const int smem = in_smem ? 12 * cap : 0;
  // set once per size, outside any graph capture that replays the launch
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        seq_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    smem_set = smem;
  }
  seq_merge_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(yp), static_cast<const int32_t*>(yl),
      static_cast<const int32_t*>(cand), static_cast<const uint8_t*>(blocks),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(len),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(nb),
      static_cast<int32_t*>(scratch), n, M, cap, in_smem);
  return int(cudaGetLastError());
}
