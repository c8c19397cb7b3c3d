// Pointer-doubling resolve of every output byte to its literal or history
// source, then the ok check and the value gather, in one cooperative launch.
//
// Replaces: zstd_tpu/ops/decode_dev.py:214-240, the lax.while_loop of
// exec_sequences (dbl_body) and its final gather. Rounds read one buffer and
// write the other: nxt[i] = p < 0 ? p : p[min(p, n - 1)] with p = ptr[i]. No
// round runs if no byte is in a match; otherwise rounds run until one
// changes nothing or the round with index r == rounds has run (at most
// rounds + 1 of them). Reading and writing one buffer in place would
// converge in fewer rounds and so move where ok turns false. Then
//   ok  = all(ptr[i] == (p < 0 ? p : ptr[min(p, n - 1)]) || i >= out_len)
//   out = p < 0 ? history[clamp(h + p, 0, h - 1)]
//       : in_match[i] ? placed[min(p, n - 1)] : placed[i].
// Same contract as ops/decode_dev.py::exec_resolve_plain.
//
// Bound on an H100: bytes. A round reads the i32 pointers, gathers the
// pointers they point at (mostly nearby) and writes i32 pointers: about
// 12 bytes a byte of output, 0.06 ms a round at 16 MiB and 3.35 TB/s. The
// rounds needed grow with the log of the match-to-match dependency depth.
//
// Design: one grid that stays resident for every round (a cooperative
// launch sized by the occupancy calculator), each thread striding over the
// bytes, cooperative_groups' grid.sync() between rounds instead of a launch
// per round and a copy of the `changed` flag to the host. A block ORs its
// threads' `changed` (__syncthreads_or) and adds one to the round's counter;
// the counters rotate over three slots, and a round resets the slot of the
// round after it: that slot was last read before the previous barrier, so
// the reset never races a read. rounds is an argument so that a caller can
// drive the ok == false case at a small depth.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

// ctrl: [0..2] changed counters of rounds r % 3, [3] any byte in a match,
// [4] some byte below out_len not at its fixed point
__global__ void __launch_bounds__(kThreads)
exec_seq_kernel(int32_t* ptr_a, int32_t* ptr_b,
                const uint8_t* __restrict__ in_match,
                const uint8_t* __restrict__ placed,
                const uint8_t* __restrict__ history, uint8_t* __restrict__ out,
                uint8_t* __restrict__ ok, int32_t* ctrl,
                int32_t* __restrict__ stats, int n, int h, int out_len,
                int rounds) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  volatile int32_t* vctrl = ctrl;
  if (tid == 0) {
    for (int k = 0; k < 5; ++k) ctrl[k] = 0;
  }
  grid.sync();

  bool any = false;
  for (int i = tid; i < n; i += stride) any |= in_match[i] != 0;
  if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(&ctrl[3], 1);
  grid.sync();

  int32_t* src = ptr_a;
  int32_t* dst = ptr_b;
  bool cont = vctrl[3] != 0;
  int r = 0;
  while (cont) {
    if (tid == 0) ctrl[(r + 1) % 3] = 0;
    bool changed = false;
    for (int i = tid; i < n; i += stride) {
      const int p = src[i];
      const int nx = p < 0 ? p : src[min(p, n - 1)];
      dst[i] = nx;
      changed |= nx != p;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicAdd(&ctrl[r % 3], 1);
    grid.sync();
    cont = vctrl[r % 3] != 0 && r < rounds;
    ++r;
    int32_t* t = src;
    src = dst;
    dst = t;
  }

  bool bad = false;
  for (int i = tid; i < n; i += stride) {
    const int p = src[i];
    uint8_t v;
    if (p < 0) {
      v = history[min(max(h + p, 0), h - 1)];
    } else {
      const int q = min(p, n - 1);
      bad |= src[q] != p && i < out_len;
      v = in_match[i] ? placed[q] : placed[i];
    }
    out[i] = v;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(&ctrl[4], 1);
  grid.sync();
  if (tid == 0) {
    ok[0] = vctrl[4] == 0;
    stats[0] = r;
    stats[1] = gridDim.x;
  }
}

}  // namespace

extern "C" int exec_seq_launch(void* ptr_a, void* ptr_b, const void* in_match,
                               const void* placed, const void* history,
                               void* out, void* ok, void* ctrl, void* stats,
                               int n, int h, int out_len, int rounds,
                               void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      exec_seq_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return int(err);
  const int need = (n + kThreads - 1) / kThreads;
  const int grid = max(1, min(per_sm * sms, need));
  auto* a = static_cast<int32_t*>(ptr_a);
  auto* b = static_cast<int32_t*>(ptr_b);
  auto* im = static_cast<const uint8_t*>(in_match);
  auto* pl = static_cast<const uint8_t*>(placed);
  auto* hi = static_cast<const uint8_t*>(history);
  auto* o = static_cast<uint8_t*>(out);
  auto* k = static_cast<uint8_t*>(ok);
  auto* c = static_cast<int32_t*>(ctrl);
  auto* s = static_cast<int32_t*>(stats);
  void* args[] = {&a, &b, &im, &pl, &hi, &o, &k, &c, &s,
                  &n, &h, &out_len, &rounds};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(exec_seq_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
