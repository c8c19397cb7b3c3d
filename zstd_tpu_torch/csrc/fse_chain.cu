// Interleaved 3-state FSE sequence encoding: the (value, nbits) field list of
// one block's sequences bitstream, one block per CTA.
//
// Replaces: zstd_tpu/ops/fse_enc.py::fse_pack_block's lax.scan (the state
// chain; its pack_bits half stays torch ops in zstd_tpu_torch/ops/bitpack.py).
// Field order (per block, M = 6 * cap + 4 fields): step k = 0..cap-1 handles
// sequence i = cap-1-k and writes [OF state, ML state, LL state, LL extra,
// ML extra, OF extra]; steps with i >= nb_seq are padding (nbits 0); the step
// i == nb_seq-1 sets the init states and writes only its extras. Then the
// ML, OF and LL state flushes and the (1, 1) sentinel.
//
// Bound on an H100: the three state chains are serial over the sequences
// (each new state is a table lookup indexed by the previous state), so a
// block costs nb_seq dependent shared-memory lookups; the bytes it must move
// (six i32 code/extra arrays in, two i32 field arrays out) would take
// microseconds at 3.35 TB/s.
//
// Design: the whole CTA first stages the block's three tables and its codes
// (as bytes) in shared memory and writes every field that does not depend on
// the states (extras, padding, zeroed state slots) in parallel; then one
// thread walks the chain over shared memory and writes the state fields.
// Blocks run in parallel on separate SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStatePad = 512;   // STATE_TABLE_PAD of zstd_tpu/ops/fse_enc.py
constexpr int kSymPad = 64;      // SYM_PAD of zstd_tpu/ops/fse_enc.py
constexpr int kLL = 0, kOF = 1, kML = 2;
constexpr int kThreads = 256;

__constant__ int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

__global__ void __launch_bounds__(kThreads)
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
                 int cap) {
  extern __shared__ __align__(16) int32_t sm[];
  int32_t* st = sm;                        // [3][kStatePad]
  int32_t* dn = st + 3 * kStatePad;        // [3][kSymPad]
  int32_t* df = dn + 3 * kSymPad;          // [3][kSymPad]
  uint8_t* codes = reinterpret_cast<uint8_t*>(df + 3 * kSymPad);  // ll|of|ml

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nb = nbs[b];
  const size_t row = size_t(b) * cap;
  const int M = 6 * cap + 4;
  int32_t* v = vals + size_t(b) * M;
  int32_t* n = nbits + size_t(b) * M;

  for (int i = tid; i < 3 * kStatePad; i += kThreads)
    st[i] = g_st[size_t(b) * 3 * kStatePad + i];
  for (int i = tid; i < 3 * kSymPad; i += kThreads) {
    dn[i] = g_dn[size_t(b) * 3 * kSymPad + i];
    df[i] = g_df[size_t(b) * 3 * kSymPad + i];
  }
  for (int i = tid; i < nb; i += kThreads) {
    codes[i] = uint8_t(llc[row + i]);
    codes[cap + i] = uint8_t(ofc[row + i]);
    codes[2 * cap + i] = uint8_t(mlc[row + i]);
  }
  // state-independent fields of every step
  for (int k = tid; k < cap; k += kThreads) {
    const int i = cap - 1 - k;
    const int f = 6 * k;
    const bool valid = i < nb;
    if (!valid || i == nb - 1) {
      v[f] = 0; n[f] = 0;
      v[f + 1] = 0; n[f + 1] = 0;
      v[f + 2] = 0; n[f + 2] = 0;
    }
    if (valid) {
      const int lc = min(max(llc[row + i], 0), 35);
      const int mc = min(max(mlc[row + i], 0), 52);
      v[f + 3] = llx[row + i]; n[f + 3] = kLLBits[lc];
      v[f + 4] = mlb[row + i]; n[f + 4] = kMLBits[mc];
      v[f + 5] = ob[row + i]; n[f + 5] = ofc[row + i];
    } else {
      v[f + 3] = 0; n[f + 3] = 0;
      v[f + 4] = 0; n[f + 4] = 0;
      v[f + 5] = 0; n[f + 5] = 0;
    }
  }
  __syncthreads();
  if (tid != 0) return;

  auto init_state = [&](int t, int sym) {
    const int d = dn[t * kSymPad + sym];
    const int nb_out = (d + (1 << 15)) >> 16;
    const int val = (nb_out << 16) - d;
    return st[t * kStatePad + (val >> nb_out) + df[t * kSymPad + sym]];
  };
  int s_ll = 0, s_of = 0, s_ml = 0;
  if (nb > 0) {
    s_ll = init_state(kLL, codes[nb - 1]);
    s_of = init_state(kOF, codes[cap + nb - 1]);
    s_ml = init_state(kML, codes[2 * cap + nb - 1]);
    for (int i = nb - 2; i >= 0; --i) {
      const int f = 6 * (cap - 1 - i);
      const int oc = codes[cap + i];
      const int mc = codes[2 * cap + i];
      const int lc = codes[i];
      const int no = (s_of + dn[kOF * kSymPad + oc]) >> 16;
      const int nm = (s_ml + dn[kML * kSymPad + mc]) >> 16;
      const int nl = (s_ll + dn[kLL * kSymPad + lc]) >> 16;
      v[f] = s_of; n[f] = no;
      v[f + 1] = s_ml; n[f + 1] = nm;
      v[f + 2] = s_ll; n[f + 2] = nl;
      s_of = st[kOF * kStatePad + (s_of >> no) + df[kOF * kSymPad + oc]];
      s_ml = st[kML * kStatePad + (s_ml >> nm) + df[kML * kSymPad + mc]];
      s_ll = st[kLL * kStatePad + (s_ll >> nl) + df[kLL * kSymPad + lc]];
    }
  }
  const bool has = nb > 0;
  const int32_t* tl = g_tl + size_t(b) * 3;
  const int f = 6 * cap;
  v[f] = has ? s_ml : 0; n[f] = has ? tl[kML] : 0;
  v[f + 1] = has ? s_of : 0; n[f + 1] = has ? tl[kOF] : 0;
  v[f + 2] = has ? s_ll : 0; n[f + 2] = has ? tl[kLL] : 0;
  v[f + 3] = 1; n[f + 3] = 1;
}

}  // namespace

extern "C" int fse_chain_launch(const void* llc, const void* mlc,
                                const void* ofc, const void* llx,
                                const void* mlb, const void* ob,
                                const void* nbs, const void* st,
                                const void* dn, const void* df,
                                const void* tl, void* vals, void* nbits,
                                int B, int cap, void* stream) {
  const size_t smem =
      (3 * kStatePad + 6 * kSymPad) * sizeof(int32_t) + 3 * size_t(cap);
  cudaError_t err = cudaFuncSetAttribute(
      fse_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  fse_chain_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(llc), static_cast<const int32_t*>(mlc),
      static_cast<const int32_t*>(ofc), static_cast<const int32_t*>(llx),
      static_cast<const int32_t*>(mlb), static_cast<const int32_t*>(ob),
      static_cast<const int32_t*>(nbs), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(dn), static_cast<const int32_t*>(df),
      static_cast<const int32_t*>(tl), static_cast<int32_t*>(vals),
      static_cast<int32_t*>(nbits), cap);
  return int(cudaGetLastError());
}
