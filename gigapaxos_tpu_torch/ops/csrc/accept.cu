// The acceptor phase-2 transition for a batch of lanes (HOT LOOP #1),
// written by hand for Hopper (sm_90a).
//
// Replaces gigapaxos_tpu/ops/pallas_accept.py:_accept_blocks/_kernel
// (the repo's one pl.pallas_call, :165).  It computes what that kernel
// and kernels.py:accept_batch compute, not the TPU kernel's blocks: the
// octile grid, one-hot lane masks, scalar prefetch and the overflow
// re-call loop exist only for Mosaic's (8, 128) tiling and VMEM staging.
//
// Semantics (per lane i, row r = g[i], W = window width):
//   live      = valid[i] && active[r]
//   bal[r]    = max(bal[r], max over live lanes of r)       (phase 1)
//   cur       = bal[r] after the WHOLE batch                (phase 2)
//   promised  = live && lane_bal >= cur
//   stale     = live && slot < exec_cursor[r]
//   in_win    = exec_cursor[r] <= slot < exec_cursor[r] + W
//   store     = promised && in_win -> acc[r, slot mod W] = {slot, bal, rlo, rhi}
//   out       = [acked = store | (promised & stale), stale,
//                out_window = promised & !in_win & !stale, cur]
// Invalid lanes read row 0 (kernels.py:_gi) and write nothing.
//
// Two launches, because every lane must see the ballot max over the whole
// batch: one pass with atomics would let an early lane read a partial max.
//
// Bound: device-memory bytes, ~66 B a lane (21 B of lane inputs, 9 B of
// gathers of active/bal/exec_cursor, at most 4 B of ballot write, one
// 16 B acc store, 16 B of outputs) and no arithmetic to speak of.  So the
// design is one thread a lane, coalesced lane loads and output stores, the
// acc pvalue written as ONE 16-byte int4 store (a [G, W, 4] int32 row is
// 16-byte aligned), and a read before the atomic so lanes that cannot
// raise the ballot (the steady state) issue no atomic at all.
//
// Precondition (as in kernels.py): at most one lane writes a given
// (row, slot) per batch; valid lanes name rows in [0, G).  A valid lane
// outside [0, G) is treated as invalid so the kernel never touches memory
// outside the state.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool lane_live_row(const int32_t* g,
                                              const uint8_t* valid, int i,
                                              int G, int* row) {
  int r = g[i];
  bool v = valid[i] != 0 && r >= 0 && r < G;
  *row = v ? r : 0;
  return v;
}

__global__ void accept_ballot_kernel(const int32_t* __restrict__ g,
                                     const int32_t* __restrict__ lane_bal,
                                     const uint8_t* __restrict__ valid,
                                     const uint8_t* __restrict__ active,
                                     int32_t* __restrict__ bal, int B,
                                     int G) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int r;
  if (!lane_live_row(g, valid, i, G, &r) || !active[r]) return;
  int b = lane_bal[i];
  // bal only grows during this launch: a lane at or below what it reads
  // cannot change the max
  if (b > bal[r]) atomicMax(&bal[r], b);
}

__global__ void accept_store_kernel(const int32_t* __restrict__ g,
                                    const int32_t* __restrict__ slot,
                                    const int32_t* __restrict__ lane_bal,
                                    const int32_t* __restrict__ rlo,
                                    const int32_t* __restrict__ rhi,
                                    const uint8_t* __restrict__ valid,
                                    const uint8_t* __restrict__ active,
                                    const int32_t* __restrict__ bal,
                                    const int32_t* __restrict__ cursor,
                                    int4* __restrict__ acc,
                                    int32_t* __restrict__ out, int B,
                                    int G, int W) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int r;
  bool v = lane_live_row(g, valid, i, G, &r);
  bool live = v && active[r] != 0;
  int cur_bal = bal[r];
  int cur = cursor[r];
  int s = slot[i];
  int b = lane_bal[i];
  // int32 wrap-around as in torch/XLA (no signed-overflow UB)
  int hi = (int)((unsigned)cur + (unsigned)W);
  bool promised = live && b >= cur_bal;
  bool stale = live && s < cur;
  bool in_win = s >= cur && s < hi;
  bool store = promised && in_win;
  if (store) {
    int w = s % W;  // floor mod: C++ % truncates toward zero
    if (w < 0) w += W;
    acc[(size_t)r * W + w] = make_int4(s, b, rlo[i], rhi[i]);
  }
  out[i] = store || (promised && stale);
  out[(size_t)B + i] = stale;
  out[2 * (size_t)B + i] = promised && !in_win && !stale;
  out[3 * (size_t)B + i] = cur_bal;
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int gp_accept_ballot(const void* g, const void* lane_bal,
                                const void* valid, const void* active,
                                void* bal, int B, int G, void* stream) {
  accept_ballot_kernel<<<blocks_for(B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(g), static_cast<const int32_t*>(lane_bal),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(bal), B, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gp_accept_store(const void* g, const void* slot,
                               const void* lane_bal, const void* rlo,
                               const void* rhi, const void* valid,
                               const void* active, const void* bal,
                               const void* cursor, void* acc, void* out,
                               int B, int G, int W, void* stream) {
  accept_store_kernel<<<blocks_for(B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(g), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(lane_bal), static_cast<const int32_t*>(rlo),
      static_cast<const int32_t*>(rhi), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(active), static_cast<const int32_t*>(bal),
      static_cast<const int32_t*>(cursor), static_cast<int4*>(acc),
      static_cast<int32_t*>(out), B, G, W);
  return static_cast<int>(cudaGetLastError());
}
