// Greedy match commit + seqstore/literal compaction: one block row per CTA,
// the row's greedy chain cut into 32 segments walked by 32 warps at once.
//
// Replaces: zstd_tpu/ops/resolve_pallas.py::_extract_kernel (reached through
// extract_compact from ops/seqextract.py::extract_batch_pallas). It computes
// the serial scan that zstd_tpu_torch/ops/resolve.py::extract_plain writes
// out in Python (the contract is in that module).
//
// The walk. With nxt = next_possible(cands) (nxt[p] is the first position
// >= p whose candidate matches 4 bytes), the serial scan reduces to one step
// per match: from p, the next match starts at m = nxt[p] (none if
// m >= vl - 8), has candidate c = cand[m] and length l = lcp(m, c, vl - m)
// >= 4, and the walk goes on from m + l. Where the walk goes depends on p
// alone, not on the literal anchor, so the chain can be started anywhere.
//
// Bound on an H100: the bytes the call must move (the row, cand and nxt, the
// outputs) take 0.0144 ms for a batch of 32 rows of 128 KiB at 3.35 TB/s.
// What bounds this kernel is the longest segment's chain of dependent steps
// (about 400 matches in a 128 KiB text row), plus the repair steps and the
// emit (two passes over the segment's matches and its literal bytes). Each
// step is a shared-memory read of nxt and cand and a 128-byte compare, about
// a hundred instructions; with 32 warps on one SM, issuing those
// instructions, more than waiting on memory, sets the pace. On an H100 the
// speculate phase takes about 70% of a text row's cycles, the emit about
// 27%, the repair 1-2% (chip_smoke.py prints the counts).
//
// Phases (S = kWarps segments of [0, vl - 8), one warp each):
//  1. Load: the row (N bytes + kPad zero bytes) goes to dynamic shared
//     memory. Every lcp and backward-extension compare reads it there.
//  2. Speculate: warp w walks the chain from its segment's start and records
//     the matches that start in its segment, (m, l, c), in global scratch,
//     and its exit: the first match start past the segment. nxt and cand
//     come through a per-warp ring in shared memory: two windows of kWin
//     positions filled by cp.async, the next window in flight while the
//     current one is walked (the walk only moves forward). A step thus waits
//     on shared memory, and device memory is waited on once a window.
//  3. Repair: the true chain enters segment w at segment w-1's exit. Where
//     that differs from the speculative entry, warp w walks the true chain
//     until a match start equals one it recorded (from there its list is
//     right) or the chain leaves the segment. The repaired prefix goes to a
//     second list. Rounds repeat, all warps in parallel, until no entry
//     moves: after round r segments 0..r are exact, so this ends, and it
//     equals the serial scan even when chains never meet.
//  4. Emit: CTA-wide prefix sums of the per-segment counts and last match
//     ends give each match its index k (k >= cap is dropped) and anchor.
//     Pass A: a lane per match extends it backward (16 steps, then the warp
//     finishes long extensions 32 positions a round) and writes ll/off/ml.
//     Pass B: the literal runs are copied at offsets from a prefix sum of
//     ll; then all warps copy the tail and zero what lies past nb_seq and
//     nb_lit. One launch does all four phases.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 256;
constexpr int kWarps = 32;              // segments per row, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kWin = 128;               // ring window, positions
constexpr int kExt = 16;                // backward steps a lane takes alone
constexpr int kEnd = 0x7fffffff;        // exit of a chain with no more match
constexpr int kMerged = -1;             // a repair met the speculative chain
constexpr int kFar = -(1 << 30);        // a ring base no position is near
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStats = 8;               // counts per row, see extract_launch

__host__ __device__ constexpr int row_bytes(int N) {
  return (N + kPad + 15) & ~15;
}
__host__ __device__ constexpr int seg_cap(int N) {   // matches per segment
  return ((N + kWarps - 1) / kWarps + 3) / 4 + 2;
}
constexpr int kRingBytes = kWarps * 2 * 2 * kWin * 4;

// little-endian u32 at byte i of a 4-byte aligned buffer: two aligned loads
__device__ __forceinline__ uint32_t load4(const uint8_t* s, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (i >> 2);
  return __funnelshift_r(w[0], w[1], (i & 3) * 8);
}

// SM clock, kept in place relative to the memory operations around it
__device__ __forceinline__ long long tick() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

// Common prefix of sm[p:] and sm[c:], capped at limit; 128 bytes a round.
// p + l < vl <= N, so a round reads at most sm[N + 134].
__device__ int lcp(const uint8_t* sm, int p, int c, int limit, int lane) {
  int l = 0;
  while (true) {
    const int o = l + 4 * lane;
    const uint32_t x = load4(sm, p + o) ^ load4(sm, c + o);
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
  return min(l, limit);
}

// One warp's walk over the chain: nxt and cand through a two-window ring in
// shared memory. Every lane holds the same state; positions only grow
// between resets.
struct Walker {
  int32_t* rn;             // ring of nxt: [2][kWin]
  int32_t* rc;             // ring of cand: [2][kWin]
  const int32_t* gx;       // the row's nxt and cand in device memory
  const int32_t* gc;
  const uint8_t* sm;       // the row in shared memory
  int N, vl, limit, lane;
  bool vec;                // 16-byte copies allowed
  int cur, bcur, bnext;    // buffer in use, its base, the other's base

  __device__ void fill(int buf, int base) {
    int32_t* dn = rn + buf * kWin;
    int32_t* dc = rc + buf * kWin;
    for (int i = 4 * lane; i < kWin; i += 128) {
      const int q = base + i;
      if (vec && q + 4 <= N) {
        __pipeline_memcpy_async(dn + i, gx + q, 16);
        __pipeline_memcpy_async(dc + i, gc + q, 16);
      } else {
        for (int e = 0; e < 4 && q + e < N; ++e) {
          __pipeline_memcpy_async(dn + i + e, gx + q + e, 4);
          __pipeline_memcpy_async(dc + i + e, gc + q + e, 4);
        }
      }
    }
    __pipeline_commit();
  }

  // make q's window current; q is never below the current base
  __device__ void ensure(int q) {
    if (unsigned(q - bcur) < unsigned(kWin)) return;
    __pipeline_wait_prior(0);
    __syncwarp();
    const bool ahead = unsigned(q - bnext) < unsigned(kWin);
    if (ahead) {
      cur ^= 1;
      bcur = bnext;
    } else {
      bcur = q & ~(kWin - 1);
      fill(cur, bcur);
    }
    bnext = bcur + kWin;
    fill(cur ^ 1, bnext);
    if (!ahead) __pipeline_wait_prior(1);
    __syncwarp();
  }

  __device__ void reset(int q) {
    bcur = bnext = kFar;
    ensure(q);
  }

  // first match start at or after p, or kEnd
  __device__ int first(int p) {
    if (p >= limit) return kEnd;
    ensure(p);
    const int m = max(rn[cur * kWin + p - bcur], p);
    return m < limit ? m : kEnd;
  }

  // Matches from start m while m < end, into out (count of them); the ring
  // was reset at or before m. With a speculative list, stops where m meets one
  // of its starts and returns kMerged with j at that start; otherwise
  // returns the exit (the first start >= end, or kEnd) with j = n_spec.
  __device__ int walk(int m, int end, const int4* spec, int n_spec,
                      int4* out, int& count, int& j, int& steps) {
    count = 0;
    j = 0;
    while (m < end) {
      if (spec != nullptr) {
        while (j < n_spec && spec[j].x < m) ++j;
        if (j < n_spec && spec[j].x == m) return kMerged;
      }
      ensure(m);
      const int c = rc[cur * kWin + m - bcur];
      // c < m for candidates from prev_same_bucket; a jump table that is not
      // next_possible's may point at a miss, which only moves the walk on
      const int l = (c >= 0 && c < m) ? lcp(sm, m, c, vl - m, lane) : 0;
      ++steps;
      int p = m + 1;
      if (l >= 4) {
        if (lane == 0) out[count] = make_int4(m, l, c, 0);
        ++count;
        p = m + l;
      }
      m = first(p);
    }
    j = n_spec;
    return m;
  }
};

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads, 1)
extract_kernel(const uint8_t* __restrict__ bytes,
               const int32_t* __restrict__ cand,
               const int32_t* __restrict__ nxt,
               const int32_t* __restrict__ vlens,
               int32_t* __restrict__ ll_out, int32_t* __restrict__ off_out,
               int32_t* __restrict__ ml_out, uint8_t* __restrict__ lits,
               int32_t* __restrict__ nb_seq_out,
               int32_t* __restrict__ nb_lit_out, int4* scratch,
               int32_t* __restrict__ stats, int N, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_exit[kWarps], s_cnt[kWarps], s_end[kWarps], s_lit[kWarps];
  // counts for stats: steps, the longest warp's cycles in each phase
  __shared__ int s_tail, s_steps, s_repair, s_wspec, s_wrep, s_wemit;
  const long long t_start = tick();
  uint8_t* sm = smem;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + row_bytes(N));

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const uint8_t* src = bytes + size_t(b) * N;
  uint8_t* lrow = lits + size_t(b) * N;
  int32_t* llr = ll_out + size_t(b) * cap;
  int32_t* offr = off_out + size_t(b) * cap;
  int32_t* mlr = ml_out + size_t(b) * cap;
  const int scap = seg_cap(N);
  int4* spec = scratch + (size_t(b) * kWarps + w) * 2 * scap;
  int4* pre = spec + scap;

  // ---- 1. load the row -------------------------------------------------
  if ((N & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(sm);
    for (int i = tid; i < N / 16; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = tid; i < N; i += kThreads) sm[i] = src[i];
  }
  for (int i = N + tid; i < row_bytes(N); i += kThreads) sm[i] = 0;
  if (tid == 0) {
    s_tail = 0;
    s_steps = 0;
    s_repair = 0;
    s_wspec = 0;
    s_wrep = 0;
    s_wemit = 0;
  }
  __syncthreads();

  const int vl = vlens[b];
  const int limit = vl - 8;
  const int seg = limit > 0 ? (limit + kWarps - 1) / kWarps : 1;
  const int lo = min(w * seg, max(limit, 0));
  const int hi = min((w + 1) * seg, max(limit, 0));
  const int32_t* gx = nxt + size_t(b) * N;
  const int32_t* gc = cand + size_t(b) * N;
  Walker wk{ring + w * 2 * kWin, ring + (kWarps + w) * 2 * kWin, gx, gc, sm,
            N, vl, limit, lane,
            (N & 3) == 0 && (reinterpret_cast<uintptr_t>(gx) & 15) == 0 &&
                (reinterpret_cast<uintptr_t>(gc) & 15) == 0,
            0, kFar, kFar};

  // ---- 2. speculate ----------------------------------------------------
  int steps = 0, n = 0, h = 0, j = 0, jj = 0;
  if (lo < limit) wk.reset(lo);
  long long t0 = tick();
  int entry = wk.first(lo);
  const int spec_exit = wk.walk(entry, hi, nullptr, 0, spec, n, jj, steps);
  if (lane == 0) {
    s_exit[w] = spec_exit;
    atomicMax(&s_steps, steps);
    atomicMax(&s_wspec, int(tick() - t0));
  }
  __syncthreads();

  // ---- 3. repair, in rounds --------------------------------------------
  int rounds = 0;
  long long wrep = 0;
  while (true) {
    const int e = w == 0 ? entry : s_exit[w - 1];
    __syncthreads();
    const bool todo = e != entry;
    if (todo) {
      int rsteps = 0;
      t0 = tick();
      if (e < hi) wk.reset(e);
      const int ex = wk.walk(e, hi, spec, n, pre, h, j, rsteps);
      entry = e;
      if (lane == 0) {
        s_exit[w] = ex == kMerged ? spec_exit : ex;
        atomicAdd(&s_repair, h);
      }
      wrep += tick() - t0;
    }
    if (!__syncthreads_or(todo)) break;
    ++rounds;
  }
  __pipeline_wait_prior(0);
  if (lane == 0) atomicMax(&s_wrep, int(wrep));

  // this warp's matches: pre[0, h) then spec[j, n)
  const int count = h + n - j;
  auto rec = [&](int i) { return i < h ? pre[i] : spec[j + i - h]; };
  if (lane == 0) {
    s_cnt[w] = count;
    int4 last = count > 0 ? rec(count - 1) : make_int4(0, 0, 0, 0);
    s_end[w] = last.x + last.y;
  }
  __syncthreads();

  // ---- 4. emit -----------------------------------------------------------
  const long long t_emit = tick();
  const int k0 = __reduce_add_sync(kFull, lane < w ? s_cnt[lane] : 0);
  const int total = __reduce_add_sync(kFull, s_cnt[lane]);
  const int anchor0 = __reduce_max_sync(kFull, lane < w ? s_end[lane] : 0);
  const int nb = min(total, cap);
  const int n_emit = max(min(count, cap - k0), 0);

  // pass A: backward extension, ll / off / ml
  int lit = 0, carry = anchor0;
  for (int i0 = 0; i0 < n_emit; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < n_emit;
    const int4 r = valid ? rec(i) : make_int4(0, 0, 0, 0);
    const int end = r.x + r.y;
    const int prev = __shfl_up_sync(kFull, end, 1);
    const int anchor = lane == 0 ? carry : prev;
    carry = __shfl_sync(kFull, end, 31);
    const int d = r.x - r.z;
    int s = r.x;
    bool done = !valid;
    for (int t = 0; t < kExt && !done; ++t) {
      if (s > anchor && s > d && sm[s - 1] == sm[s - 1 - d]) --s;
      else done = true;
    }
    for (unsigned pend = __ballot_sync(kFull, !done); pend;
         pend &= pend - 1) {
      const int q = __ffs(pend) - 1;
      const int qa = __shfl_sync(kFull, anchor, q);
      const int qd = __shfl_sync(kFull, d, q);
      int qs = __shfl_sync(kFull, s, q);
      while (true) {   // 32 positions a round
        const int t = qs - 1 - lane;
        const bool ok = t >= qa && t >= qd && sm[t] == sm[t - qd];
        const unsigned miss = __ballot_sync(kFull, !ok);
        if (miss) {
          qs -= __ffs(miss) - 1;
          break;
        }
        qs -= 32;
      }
      if (lane == q) s = qs;
    }
    if (valid) {
      const int k = k0 + i;
      llr[k] = s - anchor;
      offr[k] = d;
      mlr[k] = r.y + r.x - s;
      if (k == nb - 1) s_tail = end;
    }
    lit += __reduce_add_sync(kFull, valid ? s - anchor : 0);
  }
  if (lane == 0) s_lit[w] = lit;
  __syncthreads();

  // pass B: literal runs, then the tail and the zero fill
  int r0 = __reduce_add_sync(kFull, lane < w ? s_lit[lane] : 0);
  const int body = __reduce_add_sync(kFull, s_lit[lane]);
  carry = anchor0;
  for (int i0 = 0; i0 < n_emit; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < n_emit;
    const int4 r = valid ? rec(i) : make_int4(0, 0, 0, 0);
    const int ll = valid ? llr[k0 + i] : 0;
    const int end = r.x + r.y;
    const int prev = __shfl_up_sync(kFull, end, 1);
    const int anchor = lane == 0 ? carry : prev;
    carry = __shfl_sync(kFull, end, 31);
    const int incl = warp_incl_sum(ll, lane);
    const int dst = r0 + incl - ll;
    r0 += __shfl_sync(kFull, incl, 31);
    const int nv = min(32, n_emit - i0);
    for (int q = 0; q < nv; ++q) {
      const int qa = __shfl_sync(kFull, anchor, q);
      const int ql = __shfl_sync(kFull, ll, q);
      const int qd = __shfl_sync(kFull, dst, q);
      for (int x = lane; x < ql; x += 32) lrow[qd + x] = sm[qa + x];
    }
  }
  const int tail_at = s_tail;
  const int tail = max(vl - tail_at, 0);
  for (int i = tid; i < tail; i += kThreads) lrow[body + i] = sm[tail_at + i];
  for (int i = nb + tid; i < cap; i += kThreads) {
    llr[i] = 0;
    offr[i] = 0;
    mlr[i] = 0;
  }
  for (int i = body + tail + tid; i < N; i += kThreads) lrow[i] = 0;
  if (tid == 0) {
    nb_seq_out[b] = nb;
    nb_lit_out[b] = body + tail;
  }
  if (stats != nullptr) {
    if (lane == 0) atomicMax(&s_wemit, int(tick() - t_emit));
    __syncthreads();
    if (tid == 0) {
      int32_t* st = stats + kStats * b;
      st[0] = s_steps;
      st[1] = s_repair;
      st[2] = rounds;
      st[3] = total;
      st[4] = int(tick() - t_start);
      st[5] = s_wspec;
      st[6] = s_wrep;
      st[7] = s_wemit;
    }
  }
}

}  // namespace

// Bytes of global scratch the kernel needs per row (two match lists of
// seg_cap int4 records per segment).
extern "C" int extract_scratch_bytes(int N) {
  return kWarps * 2 * seg_cap(N) * int(sizeof(int4));
}

// Dynamic shared memory of one CTA: the padded row and the warps' rings.
extern "C" int extract_smem_bytes(int N) { return row_bytes(N) + kRingBytes; }

// stats (may be null): i32[B, 8] per row: the longest segment's speculative
// steps, the repair steps, the repair rounds, the matches found before the
// cap, the CTA's SM cycles, and the longest warp's cycles in the speculate,
// repair and emit phases. (Each warp times its own phases: a clock read
// right after a barrier may be scheduled ahead of it.)
extern "C" int extract_launch(const void* bytes, const void* cand,
                              const void* nxt, const void* vlens, void* ll,
                              void* off, void* ml, void* lits, void* nb_seq,
                              void* nb_lit, void* scratch, void* stats, int B,
                              int N, int cap, void* stream) {
  const int smem = extract_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  extract_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(vlens),
      static_cast<int32_t*>(ll), static_cast<int32_t*>(off),
      static_cast<int32_t*>(ml), static_cast<uint8_t*>(lits),
      static_cast<int32_t*>(nb_seq), static_cast<int32_t*>(nb_lit),
      static_cast<int4*>(scratch), static_cast<int32_t*>(stats), N, cap);
  return int(cudaGetLastError());
}
