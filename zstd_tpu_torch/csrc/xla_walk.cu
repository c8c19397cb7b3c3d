// The xla engine from the candidates to the seqstore, in one launch: the
// greedy walk of capped matches, their backward extension, the sequences and
// the literal index.
//
// Replaces, in zstd_tpu: `match_lengths` (ops/match.py:100, its
// lax.while_loop :141 of up to 255 rounds of 8 word compares) and
// `greedy_resolve` (:174, its fori_loop :202 of n_log2 + 1 pointer-doubling
// rounds), as find_matches_block composes them (:207-233), and what
// extract_block computes after them in XLA (ops/seqextract.py:45-97: the
// backward extension, the running maximum of the committed ends, the
// compaction and the covered-delta literal index).
//
// Contract: ops/seqextract.py::xla_extract_plain, bit for bit. Inputs blocks
// u8[B, n] (4-byte aligned), cands i32[B, n] (-1 or a position below p, as
// prev_same_bucket gives them, after the halo ban), valid_lens and emit_from
// i32[B] (valid_len <= n), halo_ok u8[B] (a torch bool). Outputs nb_seq
// i32[B] (every commit), ll/off/ml i32[B, cap] (zero past nb_seq), lit_idx
// i32[B, n] (n - 1 past nb_lit), nb_lit i32[B] and overflow u8[B]
// (nb_seq > cap).
//
// What it computes. Pointer doubling's reachable set from 0 is the serial
// greedy walk: from p, if emit_from <= p < valid_len - 8, cand[p] >= 0 and
// the 4-byte words at p and cand[p] are equal, commit p with length
// min(lcp, 8164, valid_len - p) (8164 = 4 + 4 * 8 * 255, where the JAX loop
// stops) and go on at p + length; else go on at p + 1. Each commit extends
// backward as zstd_tpu's backward_extension does (four steps over the words
// ending 4, 8, 12 and 16 bytes back: equal high bytes, a step only while
// both sides stay >= 0 and the step before was whole), cut to p - max(end of
// the previous commit, emit_from) and, where halo_ok is False, to
// cand - emit_from. The literals are the gaps between the extended matches
// in [emit_from, valid_len).
//
// Bound on an H100: the bytes the call must move, for the main path's batch
// of 32 rows of 131,072 B at seq_cap 16,384: blocks 4,194,304 + cands
// 16,777,216 + ll/off/ml 6,291,456 + lit_idx 16,777,216 = 44,040,192 B and
// the per-row scalars, 0.0131 ms at 3.35 TB/s (32 sharded rows of 196,608 B
// at seq_cap 32,768: 69,206,016 B, 0.0207 ms). What bounds this kernel is
// the walk: a chain of dependent steps a row (about 11,900 commits in a
// 128 KiB row of the corpus), each a ballot over 32 positions and a length
// round, over a hundred warp instructions a commit; with 32 warps on an
// SM, issuing them sets the pace (chip_smoke.py prints the counts and
// cycles).
//
// Design: C CTAs of 32 warps a row, launched as clusters of C (2-4, chosen
// by the wrapper from the card's occupancy: 3 for a batch of 32 rows on an
// H100, which holds 39 such clusters at once but only 30 of 4), so the row
// has S = 32 C segments of [emit_from, valid_len - 8), one a warp. Where it
// fits beside the rings (up to about 198,000 B), every CTA holds the whole
// row in shared memory, zero-padded; longer rows are read through L1/L2.
//  1. Speculate: each warp walks the chain from its segment's start. A step
//     is a ballot over 32 aligned positions (a candidate >= 0 and equal
//     words at q and cand[q]); a commit's length takes a round of 128 bytes
//     (4 a lane), then rounds of 512 (16 a lane). The candidates come
//     through a per-warp ring in shared memory, two windows of kWin
//     positions filled by cp.async, the next one in flight and kAhead
//     windows on prefetched into L2. The warp records (q, length) in global
//     scratch, a sentinel after them, and its exit, the first position >=
//     its segment's end that the walk stands on. No position inside a match
//     is ever looked at.
//  2. Repair, in rounds: after a cluster barrier every warp reads every
//     segment's (entry, exit) through distributed shared memory, C a lane,
//     and follows the true chain over the lanes in order: an entry at or
//     past a segment's end passes through it, an entry inside it takes its
//     exit. A segment whose entry moved walks again from it until it stands
//     on a position its speculative walk stood on (from there that list is
//     right); where its walk jumps past its end into a commit of a later
//     segment's speculative walk, it follows the chain on through those
//     segments, so a run of long matches is walked by one warp in one round
//     (its exit is then where it met a speculative walk, the row's end, or
//     where its list filled). Rounds repeat until no entry moves: after
//     round r segments 0..r are exact, so this ends, and it equals the
//     serial walk even where chains never meet.
//  3. Emit: cluster-wide prefix sums of the per-segment commit counts and a
//     prefix maximum of their last ends give each commit its rank and the
//     previous end. Pass A: a lane a commit extends it backward and writes
//     ll/off/ml below cap (every commit counts in nb_seq). Pass B: from a
//     cluster-wide prefix sum of the literal counts, each lane writes its
//     commit's literal run (the warp writes runs longer than 32) into
//     lit_idx; the cluster's threads write the tail run, n - 1 past nb_lit,
//     and zeros past nb_seq.
// Nothing of [B, n] but lit_idx goes to device memory. With a stats
// pointer (zeroed by the caller) it also counts per row (kStats ints, see
// xla_walk_launch).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;                  // warps a CTA, a segment each
constexpr int kThreads = kWarps * 32;
constexpr int kWin = 128;                   // ring window, positions
constexpr int kRingBytes = kWarps * 2 * kWin * 4;
constexpr int kAhead = 4;                   // windows of candidates prefetched
constexpr int kFirst = 128;                 // bytes of a first length round
constexpr int kRound = 512;                 // bytes of a later one
constexpr int kPad = 528;                   // zeros past a held row (>= 516)
constexpr int kCap = 4 + 4 * 8 * 255;       // 8164
constexpr int kMargin = 8;
constexpr int kMerged = -1;                 // a repair met the spec walk
constexpr int kFar = -(1 << 30);            // a ring base no position is near
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStats = 10;

// commits a segment may hold: its positions are at most ceil(n / segs),
// and commits are at least 4 long
__host__ __device__ constexpr int seg_cap(int n, int segs) {
  return ((n + segs - 1) / segs + 3) / 4 + 2;
}

// the row in shared memory, zero-padded past n: a length round reads up to
// 516 bytes past its last position below n
__host__ __device__ constexpr int row_bytes(int n) {
  return ((n + 15) & ~15) + kPad;
}

// SM clock, kept in place relative to the memory operations around it
__device__ __forceinline__ long long tick() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ int clamp_int(long long v) {
  return int(v < 0x7fffffffLL ? v : 0x7fffffffLL);
}

// little-endian u32 at byte i >= 0 of the row; bytes at and past n read 0.
// A held row (in shared memory, 16-byte aligned) is zero-padded by kPad, so
// a position past n + kPad - 8 reads as that one.
template <bool kSmem>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int i, int n) {
  if (kSmem) {
    i = min(i, n + kPad - 8);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (i >> 2);
    return __funnelshift_r(w[0], w[1], (i & 3) * 8);
  }
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

// the 16 bytes at byte i >= 0 of the row as four little-endian words;
// bytes at and past n read 0 (a held row as in load4)
template <bool kSmem>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int i, int n) {
  const uint32_t* w;
  int sh;
  if (kSmem) {
    i = min(i, n + kPad - 20);
    w = reinterpret_cast<const uint32_t*>(row) + (i >> 2);
    sh = (i & 3) * 8;
  } else if (i + 20 <= n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + i);
    w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    sh = int(a & 3) * 8;
  } else {
    return make_uint4(load4<false>(row, i, n), load4<false>(row, i + 4, n),
                      load4<false>(row, i + 8, n),
                      load4<false>(row, i + 12, n));
  }
  uint32_t v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = kSmem ? w[k] : __ldg(w + k);
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

// index of the first nonzero byte of a nonzero little-endian word
__device__ __forceinline__ int first_byte(uint32_t x) {
  return (__ffs(int(x)) - 1) >> 3;
}

// common prefix of row[a:] and row[b:], capped at limit, across the warp:
// a first round of kFirst bytes (4 a lane; most matches end there), then
// rounds of kRound bytes (16 a lane); each round counts a step
template <bool kSmem>
__device__ int warp_lcp(const uint8_t* row, int a, int b, int limit, int n,
                        int lane, int& steps) {
  if (limit <= 0) return min(0, limit);
  ++steps;
  const uint32_t x0 = load4<kSmem>(row, a + 4 * lane, n) ^
                      load4<kSmem>(row, b + 4 * lane, n);
  const unsigned m0 = __ballot_sync(kFull, x0 != 0);
  if (m0) {
    const int fl = __ffs(m0) - 1;
    return min(4 * fl + first_byte(__shfl_sync(kFull, x0, fl)), limit);
  }
  int l = kFirst;
  while (l < limit) {
    ++steps;
    const int o = l + 16 * lane;
    const uint4 x = load16<kSmem>(row, a + o, n);
    const uint4 y = load16<kSmem>(row, b + o, n);
    int f = 16;              // the first differing byte of this lane's 16
    if (x.w != y.w) f = 12 + first_byte(x.w ^ y.w);
    if (x.z != y.z) f = 8 + first_byte(x.z ^ y.z);
    if (x.y != y.y) f = 4 + first_byte(x.y ^ y.y);
    if (x.x != y.x) f = first_byte(x.x ^ y.x);
    const unsigned m = __ballot_sync(kFull, f < 16);
    if (m) {
      const int fl = __ffs(m) - 1;
      l += 16 * fl + __shfl_sync(kFull, f, fl);
      break;
    }
    l += kRound;
  }
  return min(l, limit);
}

// zstd_tpu's backward_extension of the match (p, c): equal high bytes of the
// words ending 4, 8, 12 and 16 bytes back
template <bool kSmem>
__device__ __forceinline__ int back_ext(const uint8_t* row, int p, int c,
                                        int n) {
  int ext = 0;
  bool still = true;
#pragma unroll
  for (int k = 1; k <= 4; ++k) {
    const int ia = p - 4 * k, ib = c - 4 * k;
    const bool ok = still && ia >= 0 && ib >= 0;
    const uint32_t x = load4<kSmem>(row, max(ia, 0), n) ^
                       load4<kSmem>(row, max(ib, 0), n);
    if (ok) ext += x == 0 ? 4 : (__clz(int(x)) >> 3);
    still = ok && x == 0;
  }
  return ext;
}

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// One warp's walk over the chain: the candidates through a two-window ring
// in shared memory. Every lane holds the same state; positions only grow
// between resets.
template <bool kSmem>
struct Walker {
  int32_t* rc;             // ring of candidates: [2][kWin]
  const int32_t* gc;       // the row's candidates in device memory
  const uint8_t* row;      // the row's bytes (shared or device memory)
  int n, vl, lane;
  bool vec;                // 16-byte copies allowed
  int cur, bcur, bnext;    // buffer in use, its base, the other's base

  __device__ void fill(int buf, int base) {
    int32_t* d = rc + buf * kWin;
    for (int i = 4 * lane; i < kWin; i += 128) {
      const int q = base + i;
      if (vec && q + 4 <= n) {
        __pipeline_memcpy_async(d + i, gc + q, 16);
      } else {
        for (int e = 0; e < 4 && q + e < n; ++e)
          __pipeline_memcpy_async(d + i + e, gc + q + e, 4);
      }
    }
    __pipeline_commit();
    // the candidates kAhead windows on into L2 (a line a lane), and in
    // device memory the window's own bytes into L1
    const int ahead = base + kAhead * kWin + 32 * lane;
    if (lane < kWin / 32 && ahead < n)
      asm volatile("prefetch.global.L2 [%0];" : : "l"(gc + ahead));
    if (!kSmem && lane < 2 && base + 128 * lane < n)
      asm volatile("prefetch.global.L1 [%0];"
                   :
                   : "l"(row + base + 128 * lane));
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

  // the first position of [p, end) that can commit (a candidate whose word
  // is equal), or end; a ballot over 32 aligned positions a step. The
  // returned position's window is current.
  __device__ int next_commit(int p, int end, int& steps) {
    while (p < end) {
      ensure(p);
      const int base = p & ~31;
      const int q = base + lane;
      // q lies in the current window; the loads need no branch (a held
      // row's loads are clamped, a row in device memory checks its own)
      const int c = rc[cur * kWin + q - bcur];
      const bool ok = (q >= p) & (q < end) & (c >= 0) &
                      (load4<kSmem>(row, q, n) ==
                       load4<kSmem>(row, max(c, 0), n));
      ++steps;
      const unsigned m = __ballot_sync(kFull, ok);
      if (m) return base + __ffs(m) - 1;
      p = base + 32;
    }
    return end;
  }

  // (q, length) of a commit at q, whose window is current
  __device__ int2 commit_at(int q, int& steps) {
    const int c = rc[cur * kWin + q - bcur];
    const int lim = min(kCap, vl - q);
    return make_int2(
        q, 4 + warp_lcp<kSmem>(row, q + 4, c + 4, lim - 4, n, lane, steps));
  }

  // The speculative walk from p while p < hi: its commits into out (count
  // of them) and a sentinel after them. Returns the exit, the first
  // position >= hi the walk stands on.
  __device__ int spec_walk(int p, int hi, int2* out, int& count,
                           int& steps) {
    count = 0;
    while (p < hi) {
      const int q = next_commit(p, hi, steps);
      if (q >= hi) {
        p = hi;
        break;
      }
      const int2 r = commit_at(q, steps);
      if (lane == 0) out[count] = r;
      ++count;
      p = r.x + r.y;
    }
    if (lane == 0) out[count] = make_int2(INT_MAX, 0);
    return p;
  }

  // A repair's walk of segment t from p (inside t): its commits into out
  // (count of them). It follows the chain into later segments while it
  // stands inside a commit of their speculative walks. Returns kMerged with
  // j at t's first speculative commit at or after p where it stands on a
  // position t's speculative walk stood on (that list is right from there);
  // otherwise its exit: where it stands on a position a later segment's
  // speculative walk stood on, or passed top, or filled out (scap records).
  // lists: the row's per-segment list pairs (speculative first, scap each).
  __device__ int rewalk(int p, int t, const int2* lists, int scap, int efc,
                        int seg, int top, int2* out, int& count, int& j,
                        int& steps) {
    count = 0;
    j = 0;
    int u = t;
    int hu = min(efc + (t + 1) * seg, top);
    const int2* sp = lists + size_t(t) * 2 * scap;
    while (p < top) {
      while (p >= hu) {
        ++u;
        hu = min(efc + (u + 1) * seg, top);
        sp = lists + size_t(u) * 2 * scap;
        j = 0;
      }
      int2 r = sp[j];
      while (r.x + r.y <= p) r = sp[++j];    // a sentinel ends the list
      if (r.x >= p) return u == t ? kMerged : p;
      if (u != t && count >= scap) return p;
      const int end = min(r.x + r.y, hu);
      const int q = next_commit(p, end, steps);
      if (q >= end) {
        p = end;
        continue;
      }
      const int2 c = commit_at(q, steps);
      if (lane == 0) out[count] = c;
      ++count;
      p = c.x + c.y;
    }
    return p;
  }
};

// The row's kernel: C CTAs a row (launched as clusters of C), the row in
// shared memory (kSmem) or read from device memory.
template <int C, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
xla_walk_kernel(const uint8_t* __restrict__ blocks,
                const int32_t* __restrict__ cands,
                const int32_t* __restrict__ valid_lens,
                const int32_t* __restrict__ emit_from,
                const uint8_t* __restrict__ halo_ok,
                int32_t* __restrict__ nb_seq_out,
                int32_t* __restrict__ ll_out, int32_t* __restrict__ off_out,
                int32_t* __restrict__ ml_out, int32_t* __restrict__ lit_idx,
                int32_t* __restrict__ nb_lit_out,
                uint8_t* __restrict__ overflow_out, int2* __restrict__ scratch,
                int32_t* __restrict__ stats, int n, int cap) {
  constexpr int kSegs = C * kWarps;         // segments a row
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int2 s_ex[2][kWarps];    // (entry, exit) a segment, by round
  __shared__ int s_cnt[kWarps], s_end[kWarps], s_lit[kWarps];
  const long long t_start = tick();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int s = rank * kWarps + w;          // this warp's segment
  const size_t off = size_t(b) * n;
  const int32_t* cand = cands + off;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + (kSmem ? row_bytes(n) : 0));
  const uint8_t* row = blocks + off;
  if (kSmem) {      // every CTA of the cluster holds the whole row
    const uint8_t* src = row;
    if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(smem);
      for (int i = tid; i < n / 16; i += kThreads) d4[i] = __ldg(s4 + i);
    } else {
      for (int i = tid; i < n; i += kThreads) smem[i] = src[i];
    }
    for (int i = n + tid; i < row_bytes(n); i += kThreads) smem[i] = 0;
    __syncthreads();
    row = smem;
  }
  const int vl = valid_lens[b];
  const int ef = emit_from[b];
  const int efc = max(ef, 0);
  const bool hok = halo_ok[b] != 0;
  const int top = max(vl - kMargin, efc);   // commits start below it
  const int seg = max((top - efc + kSegs - 1) / kSegs, 1);
  auto lo_of = [&](int t) { return min(efc + t * seg, top); };
  const int lo = lo_of(s), hi = lo_of(s + 1);
  const int scap = seg_cap(n, kSegs);
  int2* spec = scratch + (size_t(b) * kSegs + s) * 2 * scap;
  int2* pre = spec + scap;
  Walker<kSmem> wk{ring + w * 2 * kWin, cand, row, n, vl, lane,
                   (reinterpret_cast<uintptr_t>(cand) & 15) == 0, 0, kFar,
                   kFar};

  // ---- 1. speculate ------------------------------------------------------
  long long t0 = tick();
  int steps = 0, rsteps = 0, ns = 0, h = 0, j = 0;
  if (lo < hi) wk.reset(lo);
  const int spec_exit = wk.spec_walk(lo, hi, spec, ns, steps);
  const long long c_spec = tick() - t0;

  // ---- 2. repair, in rounds ----------------------------------------------
  int entry = lo, exit = spec_exit, rounds = 0;
  long long c_rep = 0;
  for (int round = 0;; ++round) {
    const int buf = round & 1;
    if (lane == 0) s_ex[buf][w] = make_int2(entry, exit);
    cluster.sync();
    // lane l holds segments l * C + k (k < C): their entries and exits, and
    // out[k], the exit of segments l * C + k .. l * C + C - 1 for an entry
    // inside segment l * C + k (those after it pass a far exit through)
    int ent[C], ex[C], out[C], e[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int t = lane * C + k;
      const int2 v =
          cluster.map_shared_rank(&s_ex[buf][0], t / kWarps)[t % kWarps];
      ent[k] = v.x;
      ex[k] = v.y;
    }
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      int o = ex[k];
#pragma unroll
      for (int m = C - 1; m > k; --m)
        if (ex[k] < lo_of(lane * C + m + 1)) o = out[m];
      out[k] = o;
    }
    // the true chain over the lanes in order: an entry passes through every
    // segment it lies past and takes the exit of the one it lies in
    int in = efc, cur_e = efc;
    for (int l = 0; l < 32; ++l) {
      int o = cur_e;
#pragma unroll
      for (int k = C - 1; k >= 0; --k)
        if (cur_e < lo_of(lane * C + k + 1)) o = out[k];
      if (lane == l) in = cur_e;
      cur_e = __shfl_sync(kFull, o, l);
    }
    bool moved = false;
    int v = in;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      e[k] = v;
      if (v < lo_of(lane * C + k + 1)) v = ex[k];
      moved |= e[k] != ent[k];
    }
    if (!__any_sync(kFull, moved)) break;
    ++rounds;
    int mine = 0;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (k == s % C) mine = e[k];
    const int en = __shfl_sync(kFull, mine, s / C);
    if (en != entry) {
      const long long t1 = tick();
      entry = en;
      h = 0;
      j = ns;
      exit = en;
      if (en < hi) {
        wk.reset(en);
        const int xt = wk.rewalk(en, s, scratch + size_t(b) * kSegs * 2 * scap,
                                 scap, efc, seg, top, pre, h, j, rsteps);
        if (xt == kMerged) {
          exit = spec_exit;
        } else {
          exit = xt;
          j = ns;
        }
      }
      c_rep += tick() - t1;
    }
  }
  __pipeline_wait_prior(0);

  // this warp's commits: pre[0, h) then spec[j, ns)
  const int count = h + ns - j;
  auto slot = [&](int i) { return i < h ? pre + i : spec + (j + i - h); };
  if (lane == 0) {
    s_cnt[w] = count;
    if (count > 0) {
      const int2 r = *slot(count - 1);
      s_end[w] = r.x + r.y;
    } else {
      s_end[w] = -1;
    }
  }
  cluster.sync();

  // ---- 3. emit -----------------------------------------------------------
  const long long t2 = tick();
  int k0 = 0, total = 0, pe0 = -1, last_end = -1;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int cn = cluster.map_shared_rank(s_cnt, k)[lane];
    const int en = cluster.map_shared_rank(s_end, k)[lane];
    total += cn;
    last_end = max(last_end, en);
    if (k * 32 + lane < s) {
      k0 += cn;
      pe0 = max(pe0, en);
    }
  }
  k0 = __reduce_add_sync(kFull, k0);
  total = __reduce_add_sync(kFull, total);
  pe0 = __reduce_max_sync(kFull, pe0);       // -1: no commit before
  last_end = __reduce_max_sync(kFull, last_end);
  int32_t* llr = ll_out + size_t(b) * cap;
  int32_t* offr = off_out + size_t(b) * cap;
  int32_t* mlr = ml_out + size_t(b) * cap;
  int32_t* lrow = lit_idx + off;

  // pass A: backward extension, ll / off / ml; each record becomes
  // (start, end) of its extended match
  int lit = 0, carry = pe0;
  for (int i0 = 0; i0 < count; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < count;
    const int2 r = valid ? *slot(i) : make_int2(0, 0);
    const int end = r.x + r.y;
    const int prev = __shfl_up_sync(kFull, end, 1);
    const int pe = lane == 0 ? carry : prev;
    carry = __shfl_sync(kFull, end, min(31, count - 1 - i0));
    if (valid) {
      const int q = r.x;
      const int c = cand[q];
      const int a_ext = pe >= 0 ? pe : efc;
      int ext = min(back_ext<kSmem>(row, q, c, n), max(q - a_ext, 0));
      if (!hok) ext = min(ext, max(c - ef, 0));
      const int st = q - ext;
      const int k = k0 + i;
      if (k < cap) {
        llr[k] = st - (pe >= 0 ? pe : ef);
        offr[k] = q - c;
        mlr[k] = r.y + ext;
      }
      *slot(i) = make_int2(st, end);
      lit += st - a_ext;
    }
  }
  lit = __reduce_add_sync(kFull, lit);
  if (lane == 0) s_lit[w] = lit;
  cluster.sync();

  // pass B: the literal runs before this warp's commits
  int r0 = 0, body = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int v = cluster.map_shared_rank(s_lit, k)[lane];
    body += v;
    if (k * 32 + lane < s) r0 += v;
  }
  r0 = __reduce_add_sync(kFull, r0);
  body = __reduce_add_sync(kFull, body);
  carry = pe0;
  for (int i0 = 0; i0 < count; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < count;
    const int2 r = valid ? *slot(i) : make_int2(0, 0);
    const int prev = __shfl_up_sync(kFull, r.y, 1);
    const int pe = lane == 0 ? carry : prev;
    carry = __shfl_sync(kFull, r.y, min(31, count - 1 - i0));
    const int a = pe >= 0 ? pe : efc;
    const int ln = valid ? r.x - a : 0;
    const int incl = warp_incl_sum(ln, lane);
    const int dst = r0 + incl - ln;
    r0 += __shfl_sync(kFull, incl, 31);
    // runs of up to 32 positions: each lane its own; longer ones: the warp
    const bool alone = ln <= 32;
    for (int x = 0; x < 32; ++x) {
      if (!__any_sync(kFull, alone && x < ln)) break;
      if (alone && x < ln) lrow[dst + x] = a + x;
    }
    for (unsigned big = __ballot_sync(kFull, !alone); big; big &= big - 1) {
      const int q = __ffs(big) - 1;
      const int qa = __shfl_sync(kFull, a, q);
      const int ql = __shfl_sync(kFull, ln, q);
      const int qd = __shfl_sync(kFull, dst, q);
      for (int x = lane; x < ql; x += 32) lrow[qd + x] = qa + x;
    }
  }
  // the tail run, the fill past nb_lit and past nb_seq: the whole cluster
  const int g = rank * kThreads + tid;
  constexpr int kStride = C * kThreads;
  const int tail_at = last_end >= 0 ? last_end : efc;
  const int tail = max(vl - tail_at, 0);
  for (int i = g; i < tail; i += kStride) lrow[body + i] = tail_at + i;
  const int nb_lit = body + tail;
  for (int i = nb_lit + g; i < n; i += kStride) lrow[i] = n - 1;
  for (int i = min(total, cap) + g; i < cap; i += kStride) {
    llr[i] = 0;
    offr[i] = 0;
    mlr[i] = 0;
  }
  if (g == 0) {
    nb_seq_out[b] = total;
    nb_lit_out[b] = nb_lit;
    overflow_out[b] = total > cap ? 1 : 0;
  }
  if (stats != nullptr && lane == 0) {
    int32_t* st = stats + size_t(b) * kStats;
    if (g == 0) {
      st[0] = total;
      st[3] = rounds;
      st[8] = C;
    }
    if (lo < hi) atomicAdd(st + 1, 1);
    atomicMax(st + 2, steps);
    atomicAdd(st + 4, rsteps);
    atomicMax(st + 5, clamp_int(c_spec));
    atomicMax(st + 6, clamp_int(c_rep));
    atomicMax(st + 7, clamp_int(tick() - t2));
    atomicMax(st + 9, clamp_int(tick() - t_start));
  }
  cluster.sync();   // no CTA leaves while another may read its shared memory
}

// Dynamic shared memory of one CTA: the row (if it is held) and the rings.
int smem_bytes(bool held, int n) {
  return (held ? row_bytes(n) : 0) + kRingBytes;
}

// Whether a row of n bytes fits in a CTA's shared memory beside the rings.
bool row_held(int n) {
  return smem_bytes(true, n) <= 232448 - 1024;   // the static arrays aside
}

using Kernel = decltype(&xla_walk_kernel<2, true>);

// f(kernel, cfg): the instantiation for C CTAs a row (2-4) and rows of n
// bytes, and a launch configuration of B clusters of C on the stream, its
// shared memory allowed; a cudaError_t where that fails.
template <typename F>
int with_kernel(int C, int B, int n, cudaStream_t stream, F f) {
  const bool held = row_held(n);
  Kernel kernel;
  switch (C) {
    case 2: kernel = held ? xla_walk_kernel<2, true> : xla_walk_kernel<2, false>;
      break;
    case 3: kernel = held ? xla_walk_kernel<3, true> : xla_walk_kernel<3, false>;
      break;
    case 4: kernel = held ? xla_walk_kernel<4, true> : xla_walk_kernel<4, false>;
      break;
    default: return int(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(held, n);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
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

// Bytes of global scratch the kernel needs per row with C CTAs a row: two
// commit lists (the speculative walk's and a repair's) of seg_cap int2
// records a segment.
extern "C" int xla_walk_scratch_bytes(int n, int C) {
  return C * kWarps * 2 * seg_cap(n, C * kWarps) * int(sizeof(int2));
}

// Clusters of C CTAs (2-4) the current card can hold at once for rows of n
// bytes (a batch of more rows runs in waves), or a negative cudaError_t.
extern "C" int xla_walk_max_clusters(int n, int C) {
  int num = 0;
  const int err = with_kernel(
      C, 64, n, nullptr, [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaOccupancyMaxActiveClusters(&num, kernel, &cfg));
      });
  return err == 0 ? num : -err;
}

// One launch over B rows with C CTAs a row (2-4). stats (may be null;
// zeroed by the caller): i32[B, 10] per row: commits, segments with
// positions, the slowest warp's speculative steps (ballots and length
// rounds), repair rounds, repair steps of all warps, the longest warp's SM
// cycles in the speculate, repair and emit phases, C, and the longest CTA's
// SM cycles. (Each warp times its own phases: a clock read right after a
// barrier may be scheduled ahead of it.)
extern "C" int xla_walk_launch(const void* blocks, const void* cands,
                               const void* valid_lens, const void* emit_from,
                               const void* halo_ok, void* nb_seq, void* ll,
                               void* off, void* ml, void* lit_idx,
                               void* nb_lit, void* overflow, void* scratch,
                               void* stats, int B, int n, int cap, int C,
                               void* stream) {
  if (B == 0 || n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(blocks) % 4 != 0 || cap < 1)
    return int(cudaErrorInvalidValue);
  const int err = with_kernel(
      C, B, n, static_cast<cudaStream_t>(stream),
      [&](Kernel kernel, const cudaLaunchConfig_t& cfg) {
        return int(cudaLaunchKernelEx(
            &cfg, kernel, static_cast<const uint8_t*>(blocks),
            static_cast<const int32_t*>(cands),
            static_cast<const int32_t*>(valid_lens),
            static_cast<const int32_t*>(emit_from),
            static_cast<const uint8_t*>(halo_ok),
            static_cast<int32_t*>(nb_seq), static_cast<int32_t*>(ll),
            static_cast<int32_t*>(off), static_cast<int32_t*>(ml),
            static_cast<int32_t*>(lit_idx), static_cast<int32_t*>(nb_lit),
            static_cast<uint8_t*>(overflow), static_cast<int2*>(scratch),
            static_cast<int32_t*>(stats), n, cap));
      });
  if (err != 0) return err;
  return int(cudaGetLastError());
}
