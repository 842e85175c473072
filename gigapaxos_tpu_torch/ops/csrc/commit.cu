// The commit (decision) transition for a batch of lanes at any width, written
// by hand for Hopper (sm_90a): the decide storm's commit, one launch a call.
//
// Replaces the XLA-jit body gigapaxos_tpu/ops/kernels.py:commit_batch
// (:301-337; packed commit_packed, :619-626; jit commit, :680), which the
// storm step (gigapaxos_tpu/ops/storm.py) runs once a replica.  It computes
// what that body computes, row for row of its packed output.
//
// Semantics (per lane i, row r = g[i] if valid, else 0 as kernels.py:_gi
// gathers; W = window width; cur = exec_cursor[r] BEFORE the batch):
//   live       = valid[i] && 0 <= g[i] < G && active[r]
//   stale      = live && slot < cur
//   out_window = live && slot >= cur + W
//   store      = live && cur <= slot < cur + W
//                -> dec[r, slot mod W] = {slot, rlo, rhi}      (phase A)
//   adv        = leading k < W with dec[r, (cur + k) mod W].slot == cur + k
//                in dec AFTER the whole batch's stores; on store lanes
//                exec_cursor[r] = max(exec_cursor[r], cur + adv)  (phase B)
//   out        = [applied = store, stale, out_window,
//                 new_cursor = exec_cursor[r] after the batch]  (phase C)
// cur + W and cur + k wrap as int32; slot mod W is the floor mod.  The lane
// decision, the store and the advance are commit_dev.cuh's, which the
// runtime's wave kernels (wave.cu) share.
//
// Bound: device-memory bytes, ~62 B a storing lane (21 B of lane inputs,
// 5 B of row gathers of active and exec_cursor, a 12 B dec store, the dec
// slot words its scan reads (4 B each: the advance and the word that ends
// it), a 4 B cursor write and 16 B of outputs) and no arithmetic to speak
// of: at the storm's 2^18 lanes about 16 MB, some 5 us at 3.35 TB/s.  As in
// the accept kernel, every row gather and dec store lands on its own
// sector of a state far larger than L2, so at large B the kernel is bound
// by random sector traffic, and at small B by the launch, the two grid
// barriers and the chain of dependent round trips each lane waits on (lane
// load, row gathers, store, barrier, scan, atomic, barrier, cursor).
//
// Design:
// - ONE cooperative launch (cudaLaunchCooperativeKernel) with two grid-wide
//   barriers (cg::this_grid().sync()): phase A (decide, store, write the
//   first three output rows) | phase B (scan and advance) | phase C (read
//   the new cursor).  The scan must see every store of the batch and the
//   new cursor every advance, from lanes on any SM.
// - One lane a thread.  The grid never exceeds the co-resident block count
//   (the barrier needs every block resident; gp_commit_limits reports it),
//   and lanes beyond threads x grid take a grid-stride loop.
// - The pre-batch cursor must survive both barriers, and phase B cannot
//   re-read it: other SMs' atomicMaxes race it.  A thread keeps its first
//   lane's row, cursor and store flag in registers; each later lane of its
//   grid-stride loop stashes its cursor in its own new_cursor output word,
//   which phase C overwrites, and re-reads its store flag from its applied
//   word and its row from the lane input.
// - Every store lane scans its own row (a row with several store lanes is
//   scanned by each; all find the same advance), kScan words a round trip.
//   A lane that advances nothing issues no atomic: exec_cursor[r] starts
//   the phase at cur and only grows.
// - 32 registers a thread (__launch_bounds__(256, 8)): 8 blocks an SM, so
//   the storm's 2^18 lanes take one round of the grid.
// - Cache hints: lane inputs and active by the read-only path; dec and
//   exec_cursor through L2 only (__ldcg): other SMs write them during the
//   launch, and L1 is not coherent.
//
// Precondition (as in kernels.py): at most one lane writes a given
// (row, slot) per batch; valid lanes name rows in [0, G).  A valid lane
// outside [0, G) is treated as invalid so the kernel never touches memory
// outside the state.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "commit_dev.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// 32 registers a thread, so 8 blocks fit an SM: the co-resident grid (1056
// blocks on 132 SMs) holds the storm's 2^18 lanes in one round
constexpr int kBlocksPerSm = 8;
// dec slot words a scan loads at once: 4 words (48 B, two or three sectors)
// rather than the row's 16 (192 B, six sectors) -- most storing lanes
// advance their row by a slot or two, and a longer advance pays a round
// trip a group
constexpr int kScan = 4;

struct Args {
  const int32_t* g;
  const int32_t* slot;
  const int32_t* rlo;
  const int32_t* rhi;
  const uint8_t* valid;
  const uint8_t* active;
  int32_t* cursor;  // exec_cursor
  int32_t* dec;     // [G, W, 3] of {slot, rlo, rhi}
  int32_t* out;     // [4, B]: applied, stale, out_window, new_cursor
  int B, G, W;
};

// What a lane carries from phase A to phases B and C.
struct Lane {
  int row, cur;
  bool store;
};

// A lane's row: g if valid and in [0, G), else 0.
__device__ __forceinline__ int lane_row(const Args& a, int64_t i) {
  const int g = __ldg(a.g + i);
  return __ldg(a.valid + i) != 0 && g >= 0 && g < a.G ? g : 0;
}

// Phase A of lane i: decide against the pre-batch cursor, store the
// decision, write applied, stale and out_window.
__device__ __forceinline__ Lane decide_lane(const Args& a, int64_t i) {
  const int g = __ldg(a.g + i);
  const bool v = __ldg(a.valid + i) != 0 && g >= 0 && g < a.G;
  Lane l;
  l.row = v ? g : 0;
  const int slot = __ldg(a.slot + i);
  const bool live = v && __ldg(a.active + l.row) != 0;
  l.cur = __ldcg(a.cursor + l.row);
  const gp::CommitDecision d = gp::commit_decide(live, slot, l.cur, a.W);
  l.store = d.store;
  if (d.store)
    gp::commit_store(a.dec, l.row, a.W, slot, __ldg(a.rlo + i),
                     __ldg(a.rhi + i));
  const size_t B = (size_t)a.B;
  a.out[i] = d.store;
  a.out[B + i] = d.stale;
  a.out[2 * B + i] = d.out_window;
  return l;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    commit_coop_kernel(Args a) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool have = first < a.B;
  const size_t B = (size_t)a.B;
  int32_t* stash = a.out + 3 * B;  // the new_cursor row
  Lane l{0, 0, false};
  if (have) l = decide_lane(a, first);
  for (int64_t i = first + stride; i < a.B; i += stride)
    stash[i] = decide_lane(a, i).cur;
  cg::this_grid().sync();  // every store of the batch before any scan
  if (l.store)
    gp::commit_advance<kScan>(a.cursor, a.dec, l.row, l.cur, a.W);
  for (int64_t i = first + stride; i < a.B; i += stride)
    if (__ldcg(a.out + i))  // applied: a store lane, so its row is g
      gp::commit_advance<kScan>(a.cursor, a.dec, __ldg(a.g + i),
                                __ldcg(stash + i), a.W);
  cg::this_grid().sync();  // every advance before any read of a cursor
  if (have) stash[first] = __ldcg(a.cursor + l.row);
  for (int64_t i = first + stride; i < a.B; i += stride)
    stash[i] = __ldcg(a.cursor + lane_row(a, i));
}

// the launch floor: an empty kernel at the commit kernel's geometry
__global__ void commit_floor_kernel(int) {}

}  // namespace

// The launch geometry and the co-resident block count of the current
// device (SMs x blocks an SM holds), and whether it takes cooperative
// launches at all.
extern "C" int gp_commit_limits(int* threads, int* blocks, int* cooperative) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, commit_coop_kernel, kThreads, 0);
  *threads = kThreads;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int gp_commit(const void* g, const void* slot, const void* rlo,
                         const void* rhi, const void* valid,
                         const void* active, void* cursor, void* dec,
                         void* out, int B, int G, int W, int blocks,
                         void* stream) {
  Args a{static_cast<const int32_t*>(g),   static_cast<const int32_t*>(slot),
         static_cast<const int32_t*>(rlo), static_cast<const int32_t*>(rhi),
         static_cast<const uint8_t*>(valid),
         static_cast<const uint8_t*>(active), static_cast<int32_t*>(cursor),
         static_cast<int32_t*>(dec),       static_cast<int32_t*>(out),
         B, G, W};
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(commit_coop_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();  // clear the launch's error state; `e` reports it
  return static_cast<int>(e);
}

// An empty kernel launched as the commit kernel is, on `blocks` blocks.
extern "C" int gp_commit_floor(int blocks, void* stream) {
  int unused = 0;
  void* args[] = {&unused};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(commit_floor_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();
  return static_cast<int>(e);
}
