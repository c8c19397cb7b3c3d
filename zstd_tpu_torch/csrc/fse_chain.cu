// Interleaved 3-state FSE sequence encoding: the (value, nbits) field list of
// each block's sequences bitstream, as a cut-and-resolve chain.
//
// Replaces: zstd_tpu/ops/fse_enc.py:111, the lax.scan of fse_pack_block (the
// state chain; its pack_bits half stays torch ops in
// zstd_tpu_torch/ops/bitpack.py). Field order (per block, M = 6 * cap + 4
// fields): step k = 0..cap-1 handles sequence i = cap-1-k and writes
// [OF state, ML state, LL state, LL extra, ML extra, OF extra]; steps with
// i >= nb_seq are padding (nbits 0); the step i == nb_seq-1 sets the init
// states and writes only its extras. Then the ML, OF and LL state flushes and
// the (1, 1) sentinel. Same contract as ops/fse_enc.py::fse_fields_plain, for
// tables built by format/fse.py (build_ctable, build_ctable_rle).
//
// Bound on an H100: the bytes the call must move (six i32 code/extra arrays
// and the tables in, two i32 field arrays out; 0.0113 ms for the main path's
// batch of 32 blocks at 3.35 TB/s), and the chain of dependent steps. Each
// step maps the state x to st[(x >> nb(x)) + df[s]], nb(x) = (x + dn[s]) >>
// 16, a shared-memory load that needs the previous state; walked serially, a
// block of 11,872 sequences is 11,871 dependent steps per stream.
//
// Design: x >> nb(x) covers exactly [p, 2p) for a symbol of normalized count
// p (1 for -1), so after a step the state is one of p candidates
// st[df + p + j], j < p; p follows from dn alone: m = (dn >> 16) + 1,
// p = ((m << 16) - dn) >> m. Each stream's chain (walk order q = 0..nb-2,
// sequence nb-2-q) is cut into windows of kW = 64 steps, each window right
// after its step with the fewest candidates (the first on ties). One CTA per
// (block, stream), clusters of the three streams of a block:
//   1. stage: the stream's state table, its symbol table (df + p and
//      max(p, 1) for the cuts), its codes in walk order (bytes) and, for the
//      walks, each step's (dn, df) packed in one word, in shared memory;
//   2. cut: a warp per window picks its cut; warp 0 sums the candidate
//      counts into the task offsets of the segments;
//   3. candidate walk: a thread per (segment, entry candidate) walks to the
//      segment's cut and records the exit as a candidate index there (u16
//      maps in shared memory, or in the wrapper's global scratch when they
//      do not fit);
//   4. resolve: one thread follows the maps, one lookup per segment;
//   5. replay: a thread per segment walks again from its true entry and
//      stores (state | nbits << 10) per step as u16 in shared memory;
//   6. write: after a cluster barrier each CTA writes a third of the block's
//      field list: a thread builds one step's six fields in shared memory,
//      reading the other streams' states through distributed shared memory,
//      and the CTA copies each chunk of steps out coalesced.
// The critical path of a block is then about 2 x the longest segment (at
// most 2 kW - 1 steps) + the segments: about 430 dependent steps on the
// corpus's first block instead of 11,871 (tools/torch_chain_counts.py).
// tests/chainmodel.py models the phases in Python.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatePad = 512;   // STATE_TABLE_PAD of zstd_tpu/ops/fse_enc.py
constexpr int kSymPad = 64;      // SYM_PAD of zstd_tpu/ops/fse_enc.py
constexpr int kLL = 0, kOF = 1, kML = 2;
constexpr int kThreads = 1024;
constexpr int kW = 64;           // steps per window: one cut per window
constexpr int kMapSmem = 16384;  // candidate map entries kept in shared memory
constexpr int kCodePad = 8;      // zero words past the walk (read ahead)
constexpr int kStats = 10;

__constant__ int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

__host__ __device__ inline int max_windows(int cap) { return cap / kW + 1; }
__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// byte offsets of the dynamic shared memory of one CTA
struct Layout {
  int st, symw, symc, bits, cut, ent, off, jt, out16, cw, maps, words, misc;
  int total;
  __host__ __device__ explicit Layout(int cap) {
    const int nw = max_windows(cap);
    st = 0;
    symw = st + align16(4 * kStatePad);
    symc = symw + align16(4 * kSymPad);
    bits = symc + align16(8 * kSymPad);
    cut = bits + align16(4 * (36 + 53));
    ent = cut + align16(4 * nw);
    off = ent + align16(4 * nw);
    jt = off + align16(4 * (nw + 2));
    out16 = jt + align16(4 * (nw + 1));
    cw = out16 + align16(2 * cap);
    maps = cw + align16(cap + kCodePad);
    // the steps' packed symbols during the chain; the write phase's staging
    // of 6 values and 6 nbits a thread after it
    words = maps + align16(2 * kMapSmem);
    const int steps = 4 * (cap + kCodePad), stage = 2 * 6 * 4 * kThreads;
    misc = words + align16(steps > stage ? steps : stage);
    total = misc + align16(4 * 8);
  }
};

// A symbol's (dn, df) packed in one word: dn < 2^20, -1024 <= df < 1024.
__device__ __forceinline__ uint32_t pack_sym(int dn, int df) {
  return uint32_t(dn) << 11 | uint32_t(df + 1024);
}
__device__ __forceinline__ int sym_dn(uint32_t w) { return int(w >> 11); }
__device__ __forceinline__ int sym_df(uint32_t w) {
  return int(w & 2047u) - 1024;
}

// Walks steps [a, e) from state x and returns the state after them. With
// kEmit, stores (x | nbits << 10) of each step at out[q]. The packed symbol
// of the next step is loaded one step ahead, so a step makes two shared
// loads, and only the state table's depends on the state.
template <bool kEmit>
__device__ __forceinline__ int walk_steps(int x, int a, int e,
                                          const uint32_t* words,
                                          const int32_t* st, uint16_t* out) {
  if (a >= e) return x;
  uint32_t cur = words[a];
  for (int q = a; q < e; ++q) {
    const uint32_t next = words[q + 1];
    const int nbits = (x + sym_dn(cur)) >> 16;
    const int idx = (x >> nbits) + sym_df(cur);
    if (kEmit) out[q] = uint16_t(x | (nbits << 10));
    x = st[idx];
    cur = next;
  }
  return x;
}

// jt[k]: the true entry candidate of segment k, one map lookup a segment
__device__ __forceinline__ void resolve(const uint16_t* __restrict__ maps,
                                        const int32_t* __restrict__ off,
                                        int32_t* __restrict__ jt, int n) {
  int j = 0, o = off[0];
  jt[0] = 0;
  for (int k = 0; k < n; ++k) {
    const int o_next = off[k + 1];
    j = maps[o + j];
    jt[k + 1] = j;
    o = o_next;
  }
}

__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads)
fse_chain_kernel(const int32_t* __restrict__ llc,
                 const int32_t* __restrict__ mlc,
                 const int32_t* __restrict__ ofc,
                 const int32_t* __restrict__ llx,
                 const int32_t* __restrict__ mlb,
                 const int32_t* __restrict__ ob,
                 const int32_t* __restrict__ nbs,
                 const int32_t* __restrict__ g_st,
                 const int32_t* __restrict__ g_dn,
                 const int32_t* __restrict__ g_df,
                 const int32_t* __restrict__ g_tl,
                 int32_t* __restrict__ vals, int32_t* __restrict__ nbits,
                 uint16_t* __restrict__ scratch, int32_t* __restrict__ stats,
                 int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay(cap);
  int32_t* st = reinterpret_cast<int32_t*>(smem + lay.st);
  uint32_t* symw = reinterpret_cast<uint32_t*>(smem + lay.symw);  // dn, df
  int2* symc = reinterpret_cast<int2*>(smem + lay.symc);  // df + p, max(p, 1)
  int32_t* llbits = reinterpret_cast<int32_t*>(smem + lay.bits);
  int32_t* mlbits = llbits + 36;
  int32_t* cut = reinterpret_cast<int32_t*>(smem + lay.cut);
  int32_t* ent = reinterpret_cast<int32_t*>(smem + lay.ent);  // cut's cands
  int32_t* off = reinterpret_cast<int32_t*>(smem + lay.off);
  int32_t* jt = reinterpret_cast<int32_t*>(smem + lay.jt);
  uint16_t* out16 = reinterpret_cast<uint16_t*>(smem + lay.out16);
  uint8_t* cw = smem + lay.cw;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + lay.words);
  int32_t* misc = reinterpret_cast<int32_t*>(smem + lay.misc);  // x0, flush

  const int t = int(cluster.block_rank());   // stream: kLL, kOF or kML
  const int b = blockIdx.x / 3;
  const int tid = threadIdx.x;
  const int nb = min(max(nbs[b], 0), cap);
  const int L = max(nb - 1, 0);              // steps of the walk
  const size_t row = size_t(b) * cap;
  const int32_t* codes = (t == kLL ? llc : t == kOF ? ofc : mlc) + row;
  const bool walk = nb > 0 && g_tl[b * 3 + t] > 0;   // tableLog 0: RLE
  const int n = (L + kW - 1) / kW;           // windows; segments n + 1
  long long clk[7];
  clk[0] = clock64();

  // ---- 1. stage ----------------------------------------------------------
  // every global load first, behind one barrier; then the packed words
  for (int q0 = 0; q0 < L; q0 += 8 * kThreads) {   // 8 loads in flight
    int c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * kThreads + tid;
      c[u] = q < L ? codes[nb - 2 - q] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * kThreads + tid;
      if (q < L) cw[q] = uint8_t(min(max(c[u], 0), kSymPad - 1));
    }
  }
  const size_t tab = size_t(b) * 3 + t;
  for (int i = tid; i < kStatePad; i += kThreads)
    st[i] = g_st[tab * kStatePad + i];
  for (int s = tid; s < kSymPad; s += kThreads) {
    const int dn = g_dn[tab * kSymPad + s];
    const int df = g_df[tab * kSymPad + s];
    const int m = min(max((dn >> 16) + 1, 1), 31);
    const int p = ((m << 16) - dn) >> m;     // normalized count, 0 if absent
    symw[s] = pack_sym(dn, df);
    symc[s] = make_int2(df + p, min(max(p, 1), kStatePad));
  }
  for (int i = tid; i < 36 + 53; i += kThreads)
    llbits[i] = i < 36 ? kLLBits[i] : kMLBits[i - 36];
  __syncthreads();
  for (int q = tid; q < L + kCodePad; q += kThreads)  // read after a barrier
    words[q] = q < L ? symw[cw[q]] : 0;
  clk[1] = clock64();

  // ---- 2. cut ------------------------------------------------------------
  if (walk) {
    const int lane = tid & 31;
    for (int w = tid >> 5; w < n; w += kThreads / 32) {
      const int lo = w * kW, hi = min(lo + kW, L);
      unsigned key = ~0u;      // (candidates, step): fewest, then first
      for (int q = lo + lane; q < hi; q += 32)
        key = min(key, unsigned(symc[cw[q]].y) << 16 | unsigned(q - lo));
      key = __reduce_min_sync(0xffffffffu, key);
      if (lane == 0) {
        cut[w] = lo + int(key & 0xffffu);
        ent[w] = int(key >> 16);
      }
    }
    if (tid == 0) {     // FSE_initCState2 with the last sequence's symbol
      const uint32_t w = symw[min(max(codes[nb - 1], 0), kSymPad - 1)];
      const int d = sym_dn(w);
      const int nb_out = (d + (1 << 15)) >> 16;
      misc[0] = st[(((nb_out << 16) - d) >> nb_out) + sym_df(w)];
    }
  }
  __syncthreads();
  if (walk && tid < 32) {   // off[k]: first task of segment k (k < n walk)
    int carry = 0;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + tid;
      int v = k < n ? (k == 0 ? 1 : ent[k - 1]) : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, d);
        if (tid >= d) v += y;
      }
      if (k < n) off[k + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (tid == 0) off[0] = 0;
  }
  __syncthreads();
  clk[2] = clock64();
  const int x0 = misc[0];
  const int tasks = walk ? off[n] : 0;
  const bool maps_smem = tasks <= kMapSmem;
  uint16_t* maps = maps_smem
      ? reinterpret_cast<uint16_t*>(smem + lay.maps)
      : scratch + size_t(blockIdx.x) * max_windows(cap) * kStatePad;

  // ---- 3. candidate walk -------------------------------------------------
  for (int task = tid; task < tasks; task += kThreads) {
    int lo = 0, hi = n - 1;                  // segment: last off[k] <= task
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= task) lo = mid; else hi = mid - 1;
    }
    const int k = lo, j = task - off[k];
    const int x = k == 0 ? x0 : st[symc[cw[cut[k - 1]]].x + j];
    const int e = cut[k];
    const int y = walk_steps<false>(x, k == 0 ? 0 : cut[k - 1] + 1, e, words,
                                    st, nullptr);
    const uint32_t w = words[e];
    const int2 c = symc[cw[e]];
    const int idx = (y >> ((y + sym_dn(w)) >> 16)) + sym_df(w);
    maps[task] = uint16_t(min(max(idx - c.x, 0), c.y - 1));
  }
  __syncthreads();
  clk[3] = clock64();

  // ---- 4. resolve --------------------------------------------------------
  if (walk && tid == 0) {
    if (maps_smem)
      resolve(reinterpret_cast<uint16_t*>(smem + lay.maps), off, jt, n);
    else
      resolve(maps, off, jt, n);
  }
  __syncthreads();
  clk[4] = clock64();

  // ---- 5. replay ---------------------------------------------------------
  if (walk) {
    for (int k = tid; k <= n; k += kThreads) {
      const int x = k == 0 ? x0 : st[symc[cw[cut[k - 1]]].x + jt[k]];
      const int y = walk_steps<true>(x, k == 0 ? 0 : cut[k - 1] + 1,
                                     k < n ? cut[k] + 1 : L, words, st,
                                     out16);
      if (k == n) misc[1] = y;
    }
  } else {
    for (int q = tid; q < L; q += kThreads) out16[q] = 0;
    if (tid == 0) misc[1] = 0;
  }
  cluster.sync();      // every stream's states of this block are in place
  clk[5] = clock64();

  // ---- 6. write: a third of the block's steps per CTA ------------------
  // A thread builds the 6 fields of one step in shared memory (the packed
  // words are dead by now); the CTA copies each chunk out coalesced while
  // the next chunk's loads are in flight.
  const uint16_t* o_ll = cluster.map_shared_rank(out16, kLL);
  const uint16_t* o_of = cluster.map_shared_rank(out16, kOF);
  const uint16_t* o_ml = cluster.map_shared_rank(out16, kML);
  const int M = 6 * cap + 4;
  const int per = (cap + 2) / 3;
  const int k_lo = min(t * per, cap), k_hi = min((t + 1) * per, cap);
  int32_t* v = vals + size_t(b) * M;
  int32_t* nv = nbits + size_t(b) * M;
  int32_t* sv = reinterpret_cast<int32_t*>(words);
  int32_t* sn = sv + 6 * kThreads;
  struct Raw { int lx, mb, o, lc, mc, oc, wo, wm, wl; };
  auto fetch = [&](int k) {   // zero past nb_seq and at the init step
    Raw r = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    const int i = cap - 1 - k;
    if (k < k_hi && i < nb) {
      const size_t g = row + i;
      r.lx = llx[g]; r.mb = mlb[g]; r.o = ob[g];
      r.lc = llc[g]; r.mc = mlc[g]; r.oc = ofc[g];
      if (i < nb - 1) {
        const int q = nb - 2 - i;
        r.wo = o_of[q]; r.wm = o_ml[q]; r.wl = o_ll[q];
      }
    }
    return r;
  };
  Raw raw = fetch(k_lo + tid);
  for (int c0 = k_lo; c0 < k_hi; c0 += kThreads) {
    if (c0 + tid < k_hi) {      // LL_BITS[0] = ML_BITS[0] = 0 past nb_seq
      int32_t* a = sv + 6 * tid;
      int32_t* z = sn + 6 * tid;
      a[0] = raw.wo & 1023; z[0] = raw.wo >> 10;
      a[1] = raw.wm & 1023; z[1] = raw.wm >> 10;
      a[2] = raw.wl & 1023; z[2] = raw.wl >> 10;
      a[3] = raw.lx; z[3] = llbits[min(max(raw.lc, 0), 35)];
      a[4] = raw.mb; z[4] = mlbits[min(max(raw.mc, 0), 52)];
      a[5] = raw.o; z[5] = raw.oc;
    }
    __syncthreads();
    raw = fetch(c0 + kThreads + tid);
    const int m = 6 * min(kThreads, k_hi - c0);
    for (int x = tid; x < m; x += kThreads) {
      v[6 * size_t(c0) + x] = sv[x];
      nv[6 * size_t(c0) + x] = sn[x];
    }
    __syncthreads();
  }
  if (t == kML && tid < 4) {   // ML, OF, LL flushes and the (1, 1) sentinel
    int val = 1, nbv = 1;
    if (tid < 3) {
      const int u = tid == 0 ? kML : tid == 1 ? kOF : kLL;
      val = nb > 0 ? *cluster.map_shared_rank(misc + 1, u) : 0;
      nbv = nb > 0 ? g_tl[b * 3 + u] : 0;
    }
    v[6 * cap + tid] = val;
    nv[6 * cap + tid] = nbv;
  }
  if (stats != nullptr) __syncthreads();
  clk[6] = clock64();

  if (stats != nullptr && tid == 0) {
    // counts as tests/chainmodel.py gives them: segments, longest segment,
    // most candidates, candidate walk steps; then the phases' cycles
    int longest = 0, most = 0, walked = 0;
    for (int k = 0; walk && k <= n; ++k) {
      const int a = k == 0 ? 0 : cut[k - 1] + 1;
      const int len = (k < n ? cut[k] + 1 : L) - a;
      const int c = k == 0 ? 1 : ent[k - 1];
      longest = max(longest, len);
      most = max(most, c);
      if (k < n) walked += c * len;
    }
    int32_t* o = stats + (size_t(b) * 3 + t) * kStats;
    o[0] = walk ? n + 1 : 0;
    o[1] = longest;
    o[2] = most;
    o[3] = walked;
    for (int p = 0; p < 6; ++p) o[4 + p] = int(clk[p + 1] - clk[p]);
  }
  cluster.sync();      // the other CTAs have finished reading this one's
}

}  // namespace

extern "C" int fse_chain_smem_bytes(int cap) { return Layout(cap).total; }

// global scratch for one CTA's candidate maps when they exceed kMapSmem
extern "C" int fse_chain_scratch_bytes(int cap) {
  return max_windows(cap) * kStatePad * int(sizeof(uint16_t));
}

extern "C" int fse_chain_launch(const void* llc, const void* mlc,
                                const void* ofc, const void* llx,
                                const void* mlb, const void* ob,
                                const void* nbs, const void* st,
                                const void* dn, const void* df,
                                const void* tl, void* vals, void* nbits,
                                void* scratch, void* stats, int B, int cap,
                                void* stream) {
  const int smem = Layout(cap).total;
  cudaError_t err = cudaFuncSetAttribute(
      fse_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (B == 0) return 0;
  fse_chain_kernel<<<3 * B, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(llc), static_cast<const int32_t*>(mlc),
      static_cast<const int32_t*>(ofc), static_cast<const int32_t*>(llx),
      static_cast<const int32_t*>(mlb), static_cast<const int32_t*>(ob),
      static_cast<const int32_t*>(nbs), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(dn), static_cast<const int32_t*>(df),
      static_cast<const int32_t*>(tl), static_cast<int32_t*>(vals),
      static_cast<int32_t*>(nbits), static_cast<uint16_t*>(scratch),
      static_cast<int32_t*>(stats), cap);
  return int(cudaGetLastError());
}
