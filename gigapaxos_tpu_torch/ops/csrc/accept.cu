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
//   bal[r]    = max(bal[r], max over live lanes of r)       (phase A)
//   cur       = bal[r] after the WHOLE batch                (phase B)
//   promised  = live && lane_bal >= cur
//   stale     = live && slot < exec_cursor[r]
//   in_win    = exec_cursor[r] <= slot < exec_cursor[r] + W
//   store     = promised && in_win -> acc[r, slot mod W] = {slot, bal, rlo, rhi}
//   out       = [acked = store | (promised & stale), stale,
//                out_window = promised & !in_win & !stale, cur]
// Invalid lanes read row 0 (kernels.py:_gi) and write nothing.
//
// Bound: device-memory bytes, ~66 B a lane (21 B of lane inputs, 9 B of
// gathers of active/bal/exec_cursor, at most 4 B of ballot write, one
// 16 B acc store, 16 B of outputs) and no arithmetic to speak of.  What
// the byte count hides is the access pattern: every row gather and every
// acc store lands on its own 32-byte sector of a state far larger than
// L2, so at large B the kernel is bound by random sector traffic (on the
// storm's lanes about half its time is the acc stores, PERF.md), and at
// small B by the launch and the chain of dependent round trips each
// lane waits on (lane load, row gathers, atomic, barrier, bal, store).
//
// Design:
// - ONE cooperative launch (cudaLaunchCooperativeKernel) with a grid-wide
//   barrier between phase A (raise bal[r] by atomicMax, read first so a
//   lane that cannot raise the promise, the steady state, issues no
//   atomic) and phase B (read the post-batch bal[r], decide, store).
//   Every lane must see the max over the whole batch, so a barrier is
//   needed; one launch pays one launch latency instead of two.
// - The grid never exceeds the co-resident block count (the barrier
//   needs every block resident; gp_accept_limits reports it), and lanes
//   beyond threads x kLanes x grid take a grid-stride loop.
// - A thread owns kLanes = 4 consecutive lanes, loaded with 16-byte
//   vector loads where the lane arrays are 16-byte aligned, and issues
//   the 12 row gathers (active, exec_cursor, bal of 4 lanes) before it
//   uses any.  Its first quad of lanes and the read-only gathers stay in
//   registers across the barrier: phase B gathers only bal[r], which
//   phase A just touched (an L2 hit).  Three row gathers a lane, not
//   five, and one pass over the lane inputs, not two.
// - Cache hints: lane inputs, outputs and the int4 acc store are touched
//   once (evict-first: __ldcs/__stcs), active and exec_cursor go by the
//   read-only path, bal by L2 only (__ldcg: it is written by atomics of
//   other SMs during the launch, and L1 is not coherent), so the [G]
//   planes rather than the 256 MB acc plane stay in L2.
//
// Precondition (as in kernels.py): at most one lane writes a given
// (row, slot) per batch; valid lanes name rows in [0, G).  A valid lane
// outside [0, G) is treated as invalid so the kernel never touches memory
// outside the state.
//
// The raise, the decision and the store are accept_dev.cuh's, which the
// runtime's wave kernels (wave.cu) share.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;
constexpr int64_t kBlockLanes = kThreads * kLanes;

struct Args {
  const int32_t* g;
  const int32_t* slot;
  const int32_t* lane_bal;
  const int32_t* rlo;
  const int32_t* rhi;
  const uint8_t* valid;
  const uint8_t* active;
  int32_t* bal;
  const int32_t* cursor;
  int4* acc;
  int32_t* out;
  int B, G, W;
  int vec_in;  // lane inputs 16-byte (valid 4-byte) aligned
};

// A thread's quad of lanes: the inputs and the read-only row gathers.
struct Quad {
  int n;  // lanes of the quad below B (4, or fewer at the tail)
  int row[kLanes], slot[kLanes], bal[kLanes], rlo[kLanes], rhi[kLanes];
  int cur[kLanes];
  bool live[kLanes];
};

__device__ __forceinline__ void unpack(int4 v, int* d) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// Loads the quad at lane `base` and issues its row gathers; `pb` gets
// bal[row] as it stands now (phase A's read-before-atomic).
__device__ __forceinline__ void load_quad(const Args& a, int64_t base,
                                          Quad& q, int* pb) {
  int g[kLanes];
  bool v[kLanes];
  const int64_t rest = a.B - base;
  q.n = rest < kLanes ? (int)rest : kLanes;
  if (q.n == kLanes && a.vec_in) {
    unpack(__ldcs(reinterpret_cast<const int4*>(a.g + base)), g);
    unpack(__ldcs(reinterpret_cast<const int4*>(a.slot + base)), q.slot);
    unpack(__ldcs(reinterpret_cast<const int4*>(a.lane_bal + base)), q.bal);
    unpack(__ldcs(reinterpret_cast<const int4*>(a.rlo + base)), q.rlo);
    unpack(__ldcs(reinterpret_cast<const int4*>(a.rhi + base)), q.rhi);
    unsigned vv = __ldcs(reinterpret_cast<const unsigned*>(a.valid + base));
#pragma unroll
    for (int k = 0; k < kLanes; ++k) v[k] = (vv >> (8 * k)) & 0xffu;
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      bool in = k < q.n;
      int64_t i = base + k;
      g[k] = in ? __ldcs(a.g + i) : 0;
      q.slot[k] = in ? __ldcs(a.slot + i) : 0;
      q.bal[k] = in ? __ldcs(a.lane_bal + i) : 0;
      q.rlo[k] = in ? __ldcs(a.rlo + i) : 0;
      q.rhi[k] = in ? __ldcs(a.rhi + i) : 0;
      v[k] = in && __ldcs(a.valid + i) != 0;
    }
  }
  uint8_t act[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    v[k] = v[k] && g[k] >= 0 && g[k] < a.G;
    q.row[k] = v[k] ? g[k] : 0;
  }
  // all twelve gathers before any use: they are in flight together
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    act[k] = __ldg(a.active + q.row[k]);
    q.cur[k] = __ldg(a.cursor + q.row[k]);
    pb[k] = __ldcg(a.bal + q.row[k]);
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) q.live[k] = v[k] && act[k] != 0;
}

// Phase A: bal only grows during the launch, so a lane at or below what
// it read cannot change the max.
__device__ __forceinline__ void raise_quad(const Args& a, const Quad& q,
                                           const int* pb) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    gp::accept_raise(a.bal, q.row[k], q.live[k], q.bal[k], pb[k]);
}

// Phase B: decide against the post-batch promise, store, write out.
__device__ __forceinline__ void decide_quad(const Args& a, int64_t base,
                                            const Quad& q) {
  int cb[kLanes], o_ack[kLanes], o_stale[kLanes], o_ow[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) cb[k] = __ldcg(a.bal + q.row[k]);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    gp::AcceptDecision d = gp::accept_decide(q.live[k], q.bal[k], q.slot[k],
                                             q.cur[k], cb[k], a.W);
    if (d.store)
      gp::accept_store(a.acc, q.row[k], a.W, q.slot[k], q.bal[k], q.rlo[k],
                       q.rhi[k]);
    o_ack[k] = d.acked;
    o_stale[k] = d.stale;
    o_ow[k] = d.out_window;
  }
  const size_t B = (size_t)a.B;
  if (q.n == kLanes && (a.B % kLanes) == 0) {  // out rows 16-byte aligned
    __stcs(reinterpret_cast<int4*>(a.out + base),
           make_int4(o_ack[0], o_ack[1], o_ack[2], o_ack[3]));
    __stcs(reinterpret_cast<int4*>(a.out + B + base),
           make_int4(o_stale[0], o_stale[1], o_stale[2], o_stale[3]));
    __stcs(reinterpret_cast<int4*>(a.out + 2 * B + base),
           make_int4(o_ow[0], o_ow[1], o_ow[2], o_ow[3]));
    __stcs(reinterpret_cast<int4*>(a.out + 3 * B + base),
           make_int4(cb[0], cb[1], cb[2], cb[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (k >= q.n) continue;
      size_t i = (size_t)base + k;
      __stcs(a.out + i, o_ack[k]);
      __stcs(a.out + B + i, o_stale[k]);
      __stcs(a.out + 2 * B + i, o_ow[k]);
      __stcs(a.out + 3 * B + i, cb[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) accept_coop_kernel(Args a) {
  const int64_t stride = (int64_t)gridDim.x * kBlockLanes;
  const int64_t first =
      (int64_t)blockIdx.x * kBlockLanes + (int64_t)threadIdx.x * kLanes;
  const bool have = first < a.B;
  Quad q;
  int pb[kLanes];
  if (have) {
    load_quad(a, first, q, pb);
    raise_quad(a, q, pb);
  }
  for (int64_t base = first + stride; base < a.B; base += stride) {
    Quad t;
    load_quad(a, base, t, pb);
    raise_quad(a, t, pb);
  }
  cg::this_grid().sync();  // every atomicMax of the batch is visible past it
  if (have) decide_quad(a, first, q);
  for (int64_t base = first + stride; base < a.B; base += stride) {
    Quad t;
    load_quad(a, base, t, pb);
    decide_quad(a, base, t);
  }
}

}  // namespace

// The launch geometry and the co-resident block count of the current
// device (SMs x blocks an SM holds), and whether it takes cooperative
// launches at all.
extern "C" int gp_accept_limits(int* threads, int* lanes, int* blocks,
                                int* cooperative) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, accept_coop_kernel, kThreads, 0);
  *threads = kThreads;
  *lanes = kLanes;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int gp_accept(const void* g, const void* slot,
                         const void* lane_bal, const void* rlo,
                         const void* rhi, const void* valid,
                         const void* active, void* bal, const void* cursor,
                         void* acc, void* out, int B, int G, int W,
                         int blocks, int vec_in, void* stream) {
  Args a{static_cast<const int32_t*>(g),    static_cast<const int32_t*>(slot),
         static_cast<const int32_t*>(lane_bal),
         static_cast<const int32_t*>(rlo),  static_cast<const int32_t*>(rhi),
         static_cast<const uint8_t*>(valid),
         static_cast<const uint8_t*>(active), static_cast<int32_t*>(bal),
         static_cast<const int32_t*>(cursor), static_cast<int4*>(acc),
         static_cast<int32_t*>(out),         B, G, W, vec_in};
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(accept_coop_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();  // clear the launch's error state; `e` reports it
  return static_cast<int>(e);
}
