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
// of 32 rows of 131,072 B (M = 40,960, cap = 16,384): yp and yl read whole
// (10,485,760 B), cand only at the valid slots' positions and the bytes
// only at the rewrite's candidate groups (length <= 18, both sides), at
// 32-byte sectors (15,839,072 B on level-5 batch 0), pos, len, dist and nb
// written (6,291,584 B): 32,616,416 B, 0.00974 ms at 3.35 TB/s
// (chip_smoke.py's merge_bytes). What bounds the kernel is the chain of
// dependent steps a row takes (loads, gathers, scans, barriers), not the
// bytes.
//
// Design: C CTAs of 1024 threads a row (2-4, launched as clusters of C and
// chosen by the wrapper from the card's occupancy: 3 for a batch of 32
// rows on an H100, which holds 39 clusters of 3 at once but 30 of 4), so a
// row's steps are cut by C and 32 rows fill 96 SMs. CTA c takes slots
// [c * S, (c + 1) * S) (S = ceil(M / C) rounded up to 4), each thread a
// contiguous run of them, and groups [c * P, (c + 1) * P) (P = ceil(nb /
// C)). Each cross-CTA step is one cluster barrier and reads of a few ints
// of the other CTAs' shared memory.
// 1. The CTA's yp and yl go to shared memory in one go (cp.async, 16 bytes
//    a copy), so no scan waits on device memory.
// 2. The dists: cand[yp] gathered with a warp on consecutive slots, 8 loads
//    a thread in flight (a few lines of cand a load; a warp whose threads
//    each took a run touched 32, and its gathers were the kernel's largest
//    phase). Pass 1: each
//    thread walks its run: the last valid slot, the first valid slot, and
//    the group starts after the first, each marked in place of its yl
//    with the end before it. A block scan of the last valid slot gives
//    each run its predecessor, a block sum the starts; the CTA's first
//    valid slot counts as a start for now.
// 3. Exchange: a CTA's carry-in is the last valid slot of the CTAs before
//    it, its first slot is no start where it chains to that, and its first
//    group id is the sum of the corrected counts before it.
// 4. Pass 2: each run's marked starts (and its first valid slot, against
//    its carry-in) write their group's pos and dist and the previous
//    group's end into the CTA that owns the group id, through distributed
//    shared memory; the row's last valid slot ends the last group. Then the
//    row's bytes are copied over the slots while the cluster waits.
// 5. The CTA's groups, a contiguous run a thread: the rewrite (the previous
//    group's dist and end from the CTA before it for its first), its
//    compares of up to 18 bytes as 8-byte words of the copied row; the
//    merge starts, its first group counted for now.
// 6. Exchange: each CTA's merge starts, first and last rewritten dist, last
//    group's end and the end before its second start correct its first
//    group and give each CTA its first merged id and the end of its last
//    merged group (where the next real start of a later CTA begins).
// 7. The merged groups are compacted by merged index in shared memory and
//    written 4 bytes a thread, coalesced; the cluster fills (n, 0, 0) past
//    nb. No CTA leaves while another may read its shared memory (a cluster
//    barrier's arrive after the last such read, its wait at the end).
// Shared memory a CTA, the main path's shape at C = 3: the slots (yp, yl
// and dists: 3 * 13,656 ints; the rewritten dists, the row's copy and the
// merged groups later in the same space) and its groups (pos, dist, end:
// 3 * 5,462 ints), 229,416 B. Rows of up to 132,096 B are held at C = 3
// (154,112 B at C = 4, 88,064 B at C = 2; cap = n / 8); past that (C = 2
// at the main path's shape) the slots are read from device memory and the
// groups and marks live in global scratch.
//
// Time on the main path's shape (level-5 batch 0; NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py phase 7): 0.0404 ms at C = 3 (0.0526 at C = 4,
// 0.1431 at C = 2 on the global route), 4.2x the 0.00974-ms bound; one CTA
// of 1024 threads a row took 0.0823 ms. It misses its aim of 3x the bound:
// the phases' SM cycles (seq_merge_cycles) put a quarter of a CTA's time
// in the gathers and pass 1, and the rest in thousands of cycles each of
// staging, the row's copy, pass 2, the rewrite and the writes, at 32 warps
// an SM. At 64 and 128 rows the wrapper takes C = 3 and 4 (0.0829 and
// 0.1572 ms; C = 2, on the global route, 0.1907 and 0.3360).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                // slots a thread loads at once
constexpr int kRepMax = 18;              // longer groups are never rewritten
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;       // shared memory an H100 block may use
constexpr int kStatic = 1024;            // room kept for the static arrays
constexpr int kStamps = 9;               // phase ends a CTA may report

// the last valid slot so far: valid, its end and its dist
struct Last {
  int v, e, d;
};

__device__ __forceinline__ Last later(const Last& a, const Last& b) {
  return b.v ? b : a;
}

__device__ __forceinline__ bool chains(const Last& a, int p, int d) {
  return a.v && p == a.e && d == a.d;
}

__device__ __forceinline__ Last shfl_up(const Last& x, int o) {
  return {__shfl_up_sync(kFull, x.v, o), __shfl_up_sync(kFull, x.e, o),
          __shfl_up_sync(kFull, x.d, o)};
}

// What a CTA shows the rest of its cluster.
struct Pub {
  Last last;          // its last valid slot
  int fv, fp, fd;     // its first valid slot
  int starts;         // its group starts, the first valid slot counted
  int m;              // its merged starts, its first group counted
  int eq;             // its first group starts at the previous group's end
  int rd_first, rd_last;
  int end_last;       // its last group's end
  int end2;           // the end of the group before its second merge start
};

// This CTA's share of the exchanges.
struct Mine {
  Last carry;         // the last valid slot before its slots
  int base, corr;     // its first group id, its first slot chains
  int count;          // the row's groups
  int end;            // the row's last valid slot's end
  int mbase, mcorr;   // its first merged id, its first group merges
  int merged;         // the row's merged groups
  int mend;           // the end of its last merged group
};

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
  uint32_t v = row[x];
  if (x + 1 < n) v |= uint32_t(row[x + 1]) << 8;
  if (x + 2 < n) v |= uint32_t(row[x + 2]) << 16;
  return v;
}

// The aligned 8-byte words w[i] at (x & ~7) + 8 i (i < 4) of a row whose
// length n is a multiple of 8, where they hold bytes of [x, x + span); 0
// for the others and at or past n.
__device__ __forceinline__ void window(const uint8_t* __restrict__ row, int n,
                                       int x, int span,
                                       unsigned long long* w) {
  const int a = x & ~7;
  const auto* p = reinterpret_cast<const unsigned long long*>(row + a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = a + 8 * i < n && a + 8 * i < x + span ? p[i] : 0ull;
}

// Bytes [o + 8 k, o + 8 k + 8) of a window, little-endian.
__device__ __forceinline__ unsigned long long bytes8(
    const unsigned long long* w, int o, int k) {
  return o ? w[k] >> (8 * o) | w[k + 1] << (64 - 8 * o) : w[k];
}

// The rewrite's test: the 3-byte words at pos + j and pos - d + j agree for
// j = 0, 3, ... < len (pos - d >= 0, d > 0). Where the row's words are
// 8-byte aligned (`wide`) and pos + len <= n, no index is clamped, so this
// is the byte ranges [pos, pos + span) and [pos - d, pos - d + span) (span
// = 3 ceil(len / 3) <= 18, bytes past n read 0), compared 8 bytes at a time
// from at most four 8-byte loads a side; else word by word.
__device__ __forceinline__ bool same_words(const uint8_t* __restrict__ row,
                                           int n, bool wide, int pos, int d,
                                           int len) {
  bool ok = true;
  if (wide && pos + len <= n) {
    const int span = (len + 2) / 3 * 3;
    unsigned long long a[4], b[4];
    window(row, n, pos, span, a);
    window(row, n, pos - d, span, b);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int keep = min(span - 8 * k, 8);
      if (keep <= 0) break;
      const unsigned long long diff =
          bytes8(a, pos & 7, k) ^ bytes8(b, (pos - d) & 7, k);
      ok &= (keep == 8 ? diff : diff & ((1ull << (8 * keep)) - 1)) == 0;
    }
    return ok;
  }
#pragma unroll
  for (int j = 0; j < kRepMax; j += 3)
    if (j < len)
      ok &= tri(row, n, min(pos + j, n - 1)) ==
            tri(row, n, max(min(pos - d + j, n - 1), 0));
  return ok;
}

// Slots a CTA: ceil(M / C) rounded up to 4 (16-byte copies).
__host__ __device__ int seg_slots(int M, int C) {
  return ((M + C - 1) / C + 3) / 4 * 4;
}

// Whether the rewrite reads a copy of the row in shared memory (16-byte
// copies of a row of n bytes).
__host__ __device__ bool row_copied(int n) { return n % 16 == 0; }

// Ints of the rewritten dists at the start of the shared region, rounded
// up to 4 (the row's copy after them takes 16-byte copies).
__host__ __device__ int rd_ints(int cap, int C) {
  return ((cap + C - 1) / C + 3) / 4 * 4;
}

// Ints of the shared region: first the slots (yp, yl and the dists); then
// the rewritten dists and after them the row's bytes (where copied), then
// the merged groups' pos, dist and end in the same space.
__host__ __device__ int region_ints(int n, int M, int cap, int C) {
  const int per_max = (cap + C - 1) / C;
  return max(3 * seg_slots(M, C),
             rd_ints(cap, C) + max(row_copied(n) ? n / 4 : 0, 3 * per_max));
}

long long smem_bytes(int n, int M, int cap, int C) {
  return 4LL * (region_ints(n, M, cap, C) + 3LL * ((cap + C - 1) / C));
}

bool held(int n, int M, int cap, int C) {
  return smem_bytes(n, M, cap, C) <= kSmemLimit - kStatic;
}

// The groups of a row: pos, dist and end arrays, ids in runs of `per` a CTA
// in shared memory (each CTA's arrays `stride` ints apart), or the row's
// global scratch.
template <bool kSmem>
struct Groups {
  int32_t* base;
  int stride, per, rank;
  __device__ int32_t* at(cg::cluster_group& cluster, int arr, int k) const {
    if constexpr (!kSmem) return base + arr * stride + k;
    const int o = (k >= per) + (k >= 2 * per) + (k >= 3 * per);   // C <= 4
    int32_t* p = base + arr * stride + (k - o * per);
    return o == rank ? p : cluster.map_shared_rank(p, o);
  }
  // a[arr][k] = v, by a shared-memory store where this CTA owns id k
  __device__ void put(cg::cluster_group& cluster, int arr, int k,
                      int v) const {
    if constexpr (kSmem) {
      const int o = (k >= per) + (k >= 2 * per) + (k >= 3 * per);
      if (o == rank) {
        base[arr * stride + k - o * per] = v;
        return;
      }
    }
    *at(cluster, arr, k) = v;
  }
};

// yp and yl of the slots [c0, c0 + kChunk) of a run ending at r1.
__device__ __forceinline__ void slots(const int32_t* P, const int32_t* L,
                                      int c0, int r1, int* ps, int* ls) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = c0 + i < r1;
    ps[i] = in ? P[c0 + i] : -1;
    ls[i] = in ? L[c0 + i] : 0;
  }
}

// The row's kernel: C CTAs a row (launched as clusters of C), the slots and
// groups in shared memory (kSmem) or read from and kept in device memory.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
seq_merge_kernel(const int32_t* __restrict__ yp,
                 const int32_t* __restrict__ yl,
                 const int32_t* __restrict__ cand,
                 const uint8_t* __restrict__ blocks,
                 int32_t* __restrict__ out_pos, int32_t* __restrict__ out_len,
                 int32_t* __restrict__ out_dist, int32_t* __restrict__ out_nb,
                 int32_t* __restrict__ scratch,
                 long long* __restrict__ cycles, int n, int M, int cap) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ Last s_last[kWarps];
  __shared__ int s_sum[kWarps];
  __shared__ Pub s_pub, s_pubs[4];       // this CTA's, and all C of them
  __shared__ Mine s_mine;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x, b = blockIdx.x / C;
  const long long t0 = clock64();
  // SM cycles from the start to the end of phase i, as thread 0 sees them
  auto stamp = [&](int i) {
    if (cycles && tid == 0) cycles[blockIdx.x * kStamps + i] = clock64() - t0;
  };
  const size_t crow = size_t(b) * cap;
  const int32_t* crd = cand + size_t(b) * n;
  const uint8_t* row = blocks + size_t(b) * n;
  const bool wide =                     // the row's 8-byte words aligned
      (n & 7) == 0 && (reinterpret_cast<uintptr_t>(blocks) & 7) == 0;
  const int seg = seg_slots(M, C);
  const int lo = min(rank * seg, M), hi = min(lo + seg, M);
  const int per_max = (cap + C - 1) / C;
  int32_t* region = smem;
  int32_t* s_groups = smem + region_ints(n, M, cap, C);
  // the global route: pos, dist, end, rewritten dist (cap each), the slots'
  // dists (M), the merged groups' pos, dist and end (cap each), the slots'
  // marks (M)
  int32_t* grow = scratch + size_t(b) * (7 * cap + 2 * M);

  // 1. the slots: yp, yl and (from pass 1) each start's dist and mark
  const int32_t* gp = yp + size_t(b) * M + lo;
  const int32_t* gl = yl + size_t(b) * M + lo;
  const int32_t* P;
  const int32_t* L;
  int32_t* D;
  int32_t* E;                            // over yl where it is copied
  const int cnt = hi - lo;
  if (tid == 0) s_pub.fv = 0;
  if constexpr (kSmem) {
    for (int q = tid; q < cnt / 4; q += kThreads) {
      __pipeline_memcpy_async(region + 4 * q, gp + 4 * q, 16);
      __pipeline_memcpy_async(region + seg + 4 * q, gl + 4 * q, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    P = region;
    L = region + seg;
    D = region + 2 * seg;
    E = region + seg;
  } else {
    P = gp;
    L = gl;
    D = grow + 4 * cap + lo;
    E = grow + 7 * cap + M + lo;
  }
  stamp(0);
  const int K = (cnt + kThreads - 1) / kThreads;
  const int r0 = min(tid * K, cnt), r1 = min(r0 + K, cnt);

  // 2. the slots' dists, a warp on consecutive slots: its cand gathers
  // then touch a few lines of cand, where runs a thread would touch 32
  for (int i0 = tid; i0 < cnt; i0 += kChunk * kThreads) {
    int ps[kChunk];                      // yp where valid, else -1
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j * kThreads;
      ps[j] = i < cnt && L[i] > 0 ? P[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {   // all kChunk gathers in flight
      const int i = i0 + j * kThreads;
      if (i < cnt) D[i] = ps[j] >= 0 ? ps[j] - __ldg(crd + ps[j]) : 0;
    }
  }
  __syncthreads();
  // pass 1: the run alone. Past its first valid slot, whether a slot starts
  // a group is known here: mark each start with the end before it (E > 0;
  // 0 elsewhere), so pass 2 reads only marks
  Last cur = {0, 0, 0};
  int fv = 0, fp = 0, fd = 0, inner = 0;  // first valid slot, later starts
  for (int c0 = r0; c0 < r1; c0 += kChunk) {
    int ps[kChunk], ls[kChunk];
    slots(P, L, c0, r1, ps, ls);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (c0 + i >= r1) continue;
      int mark = 0;
      if (ls[i] > 0) {
        const int d = D[c0 + i];
        if (!fv) {
          fv = 1;
          fp = ps[i];
          fd = d;
        } else if (!chains(cur, ps[i], d)) {
          ++inner;
          mark = cur.e;                  // >= 1: a valid slot ends past 0
        }
        cur = {1, ps[i] + ls[i], d};
      }
      E[c0 + i] = mark;
    }
  }
  Last total;
  const Last pred = block_last(cur, s_last, total);
  const int starts = inner + (fv && !chains(pred, fp, fd));
  int cta_starts;
  const int ex = block_sum(starts, s_sum, cta_starts);
  if (fv && !pred.v) {                   // the CTA's first valid slot
    s_pub.fv = 1;
    s_pub.fp = fp;
    s_pub.fd = fd;
  }
  if (tid == 0) {
    s_pub.last = total;
    s_pub.starts = cta_starts;
  }
  stamp(1);

  // 3. exchange
  cluster.sync();
  if (tid < C) s_pubs[tid] = *cluster.map_shared_rank(&s_pub, tid);
  __syncthreads();
  if (tid == 0) {
    Last run = {0, 0, 0};
    int count = 0;
    for (int c = 0; c < C; ++c) {
      const Pub* q = &s_pubs[c];
      const int corr = q->fv && chains(run, q->fp, q->fd);
      if (c == rank) {
        s_mine.carry = run;
        s_mine.base = count;
        s_mine.corr = corr;
      }
      count += q->starts - corr;
      run = later(run, q->last);
    }
    s_mine.count = count;
    s_mine.end = run.e;
  }
  __syncthreads();
  stamp(2);
  const int count = s_mine.count;
  const int nb = min(count, cap);
  const int per = max((nb + C - 1) / C, 1);
  const Groups<kSmem> G{kSmem ? s_groups : grow, kSmem ? per_max : cap, per,
                        rank};

  // 4. pass 2: the run's starts, the groups to their owners (the first
  // valid slot against the run's carry-in)
  int g = s_mine.base + ex - (s_mine.corr && pred.v);
  auto place = [&](int p, int d, int end_before) {
    if (g < cap) {
      G.put(cluster, 0, g, p);
      G.put(cluster, 1, g, max(d, 0));
    }
    if (g >= 1 && g - 1 < cap) G.put(cluster, 2, g - 1, end_before);
    ++g;
  };
  const Last cin = later(s_mine.carry, pred);
  if (fv && !chains(cin, fp, fd)) place(fp, fd, cin.e);
  for (int c0 = r0; c0 < r1; c0 += kChunk) {
    int es[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) es[i] = c0 + i < r1 ? E[c0 + i] : 0;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (es[i] > 0) place(P[c0 + i], D[c0 + i], es[i]);
  }
  if (rank == C - 1 && tid == 0 && count >= 1 && count - 1 < cap)
    *G.at(cluster, 2, count - 1) = s_mine.end;
  // the rewrite's bytes: the row, copied over the slots while the cluster
  // places its groups
  const bool copy = kSmem && row_copied(n) &&
                    (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  stamp(3);
  if (copy) {
    __syncthreads();                     // every run's slots are read
    for (int i = tid; i < n / 16; i += kThreads)
      __pipeline_memcpy_async(region + rd_ints(cap, C) + 4 * i, row + 16 * i,
                              16);
    __pipeline_commit();
  }
  cluster.sync();
  if (copy) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  stamp(4);

  // 5. the CTA's groups k0 + q, q < gc: rewrite, then the merge starts
  const int k0 = min(rank * per, nb), k1 = min(k0 + per, nb);
  const int gc = k1 - k0;
  const int R = (gc + kThreads - 1) / kThreads;
  const int q0 = min(tid * R, gc), q1 = min(q0 + R, gc);
  const int32_t* gpos = kSmem ? s_groups : grow + k0;
  const int32_t* gdist = gpos + G.stride;
  const int32_t* gend = gdist + G.stride;
  const auto* copied = reinterpret_cast<uint8_t*>(region + rd_ints(cap, C));
  int32_t* rdv = kSmem ? region : grow + 3 * cap + k0;
  // the merged groups' pos, dist and end, by the CTA's merged index: over
  // the row's copy once the rewrite is done
  int32_t* opos = kSmem ? region + rd_ints(cap, C) : grow + 4 * cap + M + k0;
  int32_t* odist = opos + (kSmem ? per_max : cap);
  int32_t* oend = odist + (kSmem ? per_max : cap);
  for (int q = q0; q < q1; ++q) {
    const int pos = gpos[q];
    int rd = gdist[q];
    if (k0 + q > 0) {
      const int d = q ? gdist[q - 1] : *G.at(cluster, 1, k0 - 1);
      const int len = gend[q] - pos;
      // (the two calls let the copy's loads be shared-memory loads)
      if (d > 0 && rd != d && pos - d >= 0 && len <= kRepMax &&
          (copy ? same_words(copied, n, true, pos, d, len)
                : same_words(row, n, wide, pos, d, len)))
        rd = d;
    }
    rdv[q] = rd;
  }
  __syncthreads();
  stamp(5);
  // group k0 + q starts a merged group (q = 0 for now); bit q - q0 of
  // `mbits` keeps it for the first 32 of the run
  auto begins = [&](int q) {
    return q == 0 || !(gpos[q] == gend[q - 1] && rdv[q] == rdv[q - 1]);
  };
  uint32_t mbits = 0;
  int mstarts = 0;
  for (int q = q0; q < q1; ++q) {
    const bool st = begins(q);
    if (st && q - q0 < 32) mbits |= 1u << (q - q0);
    mstarts += st;
  }
  auto starts_at = [&](int q) {
    return q - q0 < 32 ? (mbits >> (q - q0) & 1u) != 0 : begins(q);
  };
  int cta_m;
  const int mex = block_sum(mstarts, s_sum, cta_m);
  const int prev_end =                   // thread 0's first group's
      tid == 0 && gc > 0 && k0 > 0 ? *G.at(cluster, 2, k0 - 1) : 0;
  if (tid == 0) {
    s_pub.m = cta_m;
    s_pub.eq = gc > 0 && k0 > 0 && gpos[0] == prev_end;
    s_pub.rd_first = gc > 0 ? rdv[0] : 0;
    s_pub.rd_last = gc > 0 ? rdv[gc - 1] : 0;
    s_pub.end_last = gc > 0 ? gend[gc - 1] : 0;
  }
  for (int q = q0, i = mex; q < q1; ++q)   // the second merge start
    if (starts_at(q) && i++ == 1) s_pub.end2 = gend[q - 1];
  stamp(6);
  cluster.sync();
  if (tid < C) s_pubs[tid] = *cluster.map_shared_rank(&s_pub, tid);
  __syncthreads();
  // the cluster's shared memory is read no more: arrive now, wait at the end
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid == 0) {
    int merged = 0, rd_last = 0, corr[4];
    for (int c = 0; c < C; ++c) {
      const Pub* q = &s_pubs[c];
      corr[c] = c > 0 && q->eq && q->rd_first == rd_last;
      if (c == rank) {
        s_mine.mbase = merged;
        s_mine.mcorr = corr[c];
      }
      merged += q->m - corr[c];
      rd_last = q->rd_last;
    }
    s_mine.merged = merged;
    // the end of this CTA's last merged group: where the next real start
    // of a later CTA begins, else the row's last group's end
    int mend = nb > 0 ? s_pubs[min((nb - 1) / per, C - 1)].end_last : 0;
    for (int c = rank + 1; c < C && min(c * per, nb) < nb; ++c) {
      if (!corr[c]) {
        mend = s_pubs[c - 1].end_last;
        break;
      }
      if (s_pubs[c].m > 1) {
        mend = s_pubs[c].end2;
        break;
      }
    }
    s_mine.mend = mend;
  }
  __syncthreads();
  stamp(7);

  // 6. the merged groups by the CTA's merged index j: pos, dist, and the
  // end of the group before the next start; then written out coalesced
  const int merged = s_mine.merged, mcorr = s_mine.mcorr;
  const int mc = cta_m - mcorr;          // the CTA's merged groups
  for (int q = q0, j = mex - (mcorr && tid > 0); q < q1; ++q) {
    if (!starts_at(q) || (q == 0 && mcorr)) continue;
    opos[j] = gpos[q];
    odist[j] = max(rdv[q], 0);
    if (j > 0) oend[j - 1] = gend[q - 1];
    ++j;
  }
  if (tid == 0 && mc > 0) oend[mc - 1] = s_mine.mend;
  __syncthreads();
  const size_t o0 = crow + s_mine.mbase;
  for (int j = tid; j < mc; j += kThreads) {
    out_pos[o0 + j] = opos[j];
    out_dist[o0 + j] = odist[j];
    out_len[o0 + j] = oend[j] - opos[j];
  }
  const long long fill = cap - merged;
  for (long long f = merged + rank * fill / C + tid;
       f < merged + (rank + 1) * fill / C; f += kThreads) {
    out_pos[crow + f] = n;
    out_len[crow + f] = 0;
    out_dist[crow + f] = 0;
  }
  if (rank == 0 && tid == 0) out_nb[b] = merged;
  stamp(8);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

using Kernel = decltype(&seq_merge_kernel<true>);

// f(kernel, cfg): the instantiation for rows of n bytes, M slots and cap
// groups at C CTAs a row (2-4), and a launch configuration of B clusters of
// C on the stream, its shared memory allowed; a cudaError_t where that
// fails.
template <typename F>
int with_config(int C, int B, int n, int M, int cap, cudaStream_t stream,
                F f) {
  if (C < 2 || C > 4) return int(cudaErrorInvalidValue);
  const bool smem_route = held(n, M, cap, C);
  const Kernel kernel =
      smem_route ? seq_merge_kernel<true> : seq_merge_kernel<false>;
  const int smem = smem_route ? int(smem_bytes(n, M, cap, C)) : 0;
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
// the slots and the groups fit in shared memory, else 7 * cap + 2 * M (the
// groups' pos, dist, end and rewritten dist, the merged groups' pos, dist
// and end, and each slot's dist and mark).
extern "C" int seq_merge_scratch_ints(int n, int M, int cap, int C) {
  return held(n, M, cap, C) ? 0 : 7 * cap + 2 * M;
}

// Clusters of C CTAs (2-4) the current card can hold at once for rows of M
// slots and cap groups (a batch of more rows runs in waves), or a negative
// cudaError_t.
extern "C" int seq_merge_max_clusters(int n, int M, int cap, int C) {
  int num = 0;
  const int err = with_config(
      C, 64, n, M, cap, nullptr,
      [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaOccupancyMaxActiveClusters(&num, kernel, &cfg));
      });
  return err == 0 ? num : -err;
}

// One launch over B rows with C CTAs a row (2-4). yp and yl must be 16-byte
// aligned and M a multiple of 4; scratch holds B * seq_merge_scratch_ints(n,
// M, cap, C) ints (may be null when that is 0). cycles (may be null):
// i64[B, C, 9], each CTA's SM cycles from its start to the end of each
// phase (MERGE_STAMPS in ops/fastmatch.py
// names them).
extern "C" int seq_merge_launch(const void* yp, const void* yl,
                                const void* cand, const void* blocks,
                                void* pos, void* len, void* dist, void* nb,
                                void* scratch, void* cycles, int B, int n,
                                int M, int cap, int C, void* stream) {
  if (B == 0) return 0;
  if (reinterpret_cast<uintptr_t>(yp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(yl) % 16 != 0 || M % 4 != 0 || cap < 1 ||
      B > 2147483647 / (7 * cap + 2 * M) || B > 2147483647 / (4 * C))
    return int(cudaErrorInvalidValue);
  if (!held(n, M, cap, C) && scratch == nullptr)
    return int(cudaErrorInvalidValue);
  const int err = with_config(
      C, B, n, M, cap, static_cast<cudaStream_t>(stream),
      [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaLaunchKernelEx(
            &cfg, kernel, static_cast<const int32_t*>(yp),
            static_cast<const int32_t*>(yl), static_cast<const int32_t*>(cand),
            static_cast<const uint8_t*>(blocks), static_cast<int32_t*>(pos),
            static_cast<int32_t*>(len), static_cast<int32_t*>(dist),
            static_cast<int32_t*>(nb), static_cast<int32_t*>(scratch),
            static_cast<long long*>(cycles), n, M, cap));
      });
  if (err != 0) return err;
  return int(cudaGetLastError());
}
