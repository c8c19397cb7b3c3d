// Batched backward Huffman decode of literal streams: one lane per stream.
//
// Replaces: zstd_tpu/ops/decode_dev.py:46-90, huf_window_values followed by
// the lax.scan of huf_decode_streams. Lane l decodes n_syms[l] symbols (at
// most max_syms) from the bit position start_bits[l] down: each step reads
// idx = win(clip(pos, 0, W - 1)), W = 8 * byte_cap + 1, where win(p) is the
// value of stream bits [p - 11, p) with bit p - 1 most significant and bits
// below 0 zero; it emits lut_sym[tab, idx] and sets pos -= lut_len[tab, idx]
// with tab = lane_tab[l]. final[l] is the last pos: 0 for a well-formed
// stream, negative when it under-ran (the clip keeps reading index 0 there,
// as the JAX scan does). Same contract as ops/decode_dev.py::huf_decode_plain
// on syms[l, :n_syms[l]] (nothing past n_syms is written) and final.
//
// Bound on an H100: a chain of dependent steps per lane, not bytes. A full
// 4-stream block of 128 KiB gives lanes of about 32k symbols; each step is a
// shift, a table load (L1) and a subtract that the next step needs, so a
// lane costs its symbol count times the load latency, however few bytes
// the whole call moves (the streams, the u8 tables, one byte per symbol).
//
// Design (the simple first version): one thread per lane, 32 lanes a block
// so the lanes spread over the SMs. The thread never builds the window
// array (the JAX one is f32[L, 8 * byte_cap + 1], about 1.2 GB at 16 MiB):
// it keeps 64 stream bits in a register, bits [base, base + 64) with base
// a multiple of 8, refilled from two aligned 8-byte loads whenever the
// window [q - 11, q) leaves it; after a refill base = floor8(q) - 56, so a
// refill serves at least 45 bits. The tables stay u8[T, 2048] and are read
// through the read-only cache with the lane's table index; symbols go out
// four to a 32-bit store. Interleaving the 4 streams of a block in one
// thread, and tables in shared memory, are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTlog = 11;
constexpr int kTableSize = 1 << kTlog;
constexpr int kLanesPerBlock = 32;

__global__ void __launch_bounds__(kLanesPerBlock)
huf_decode_kernel(const uint8_t* __restrict__ sb,
                  const int32_t* __restrict__ start_bits,
                  const int32_t* __restrict__ n_syms,
                  const uint8_t* __restrict__ lut_sym,
                  const uint8_t* __restrict__ lut_len,
                  const int32_t* __restrict__ lane_tab,
                  uint8_t* __restrict__ syms, int32_t* __restrict__ final_pos,
                  int L, int byte_cap, int max_syms, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int W = 8 * byte_cap + 1;
  const int nwords = byte_cap / 8;
  const uint64_t* words =
      reinterpret_cast<const uint64_t*>(sb + size_t(l) * byte_cap);
  const int tab = min(max(__ldg(lane_tab + l), 0), T - 1);
  const uint8_t* tsym = lut_sym + size_t(tab) * kTableSize;
  const uint8_t* tlen = lut_len + size_t(tab) * kTableSize;
  uint8_t* out = syms + size_t(l) * max_syms;
  const int n = min(max(__ldg(n_syms + l), 0), max_syms);
  int pos = __ldg(start_bits + l);

  int base = 0x7fffffff;  // stream bit of the container's bit 0
  uint64_t cont = 0;
  uint32_t acc = 0;
  for (int i = 0; i < n; ++i) {
    const int q = min(max(pos, 0), W - 1);
    if (q - kTlog < base) {
      base = (q & ~7) - 56;
      const int b = base >> 3;  // first byte (may be negative: zeros)
      const int w = b >> 3, s = b & 7;
      const uint64_t lo = (w >= 0 && w < nwords) ? __ldg(words + w) : 0ull;
      const uint64_t hi =
          (w + 1 >= 0 && w + 1 < nwords) ? __ldg(words + w + 1) : 0ull;
      cont = s ? (lo >> (8 * s)) | (hi << (64 - 8 * s)) : lo;
    }
    const int idx = int(cont >> (q - kTlog - base)) & (kTableSize - 1);
    const uint32_t sym = __ldg(tsym + idx);
    pos -= __ldg(tlen + idx);
    acc |= sym << (8 * (i & 3));
    if ((i & 3) == 3) {
      *reinterpret_cast<uint32_t*>(out + i - 3) = acc;
      acc = 0;
    }
  }
  for (int k = n & ~3; k < n; ++k) {
    out[k] = uint8_t(acc);
    acc >>= 8;
  }
  final_pos[l] = pos;
}

}  // namespace

extern "C" int huf_decode_launch(const void* sb, const void* start_bits,
                                 const void* n_syms, const void* lut_sym,
                                 const void* lut_len, const void* lane_tab,
                                 void* syms, void* final_pos, int L,
                                 int byte_cap, int max_syms, int T,
                                 void* stream) {
  if (L == 0) return 0;
  const int grid = (L + kLanesPerBlock - 1) / kLanesPerBlock;
  huf_decode_kernel<<<grid, kLanesPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sb), static_cast<const int32_t*>(start_bits),
      static_cast<const int32_t*>(n_syms),
      static_cast<const uint8_t*>(lut_sym),
      static_cast<const uint8_t*>(lut_len),
      static_cast<const int32_t*>(lane_tab), static_cast<uint8_t*>(syms),
      static_cast<int32_t*>(final_pos), L, byte_cap, max_syms, T);
  return int(cudaGetLastError());
}
