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
// by random sector traffic and by the chain of dependent round trips each
// lane waits on, and at small B by the launch and its grid barriers.
//
// Design:
// - ONE cooperative launch (cudaLaunchCooperativeKernel): phase A (decide,
//   store, write the first three output rows) | grid barrier | phase B
//   (scan and advance; a store lane's new cursor) | a second grid barrier
//   only where a lane needs it | phase C (a non-store lane reads the new
//   cursor).  The scan must see every store of the batch, from lanes on
//   any SM.
// - No read-back for a store lane: every store lane of a row starts from
//   the same pre-batch cursor and scans the same post-batch dec, so all
//   find the same advance, and the row's cursor after the batch is
//   cur + adv (a store lane's window cur + W does not wrap, so neither
//   does cur + adv).  Only a lane that does not store reads a cursor that
//   another lane may raise, after every advance.  Phase A counts such
//   lanes (one atomicAdd a block that has any) into a device word; every
//   block reads it after the first barrier, so all agree whether the
//   second barrier runs, and block 0 clears it after that barrier.  On the
//   storm's lanes every lane stores and the second barrier never runs.
// - kLanes lanes a thread (lane block*kBlockLanes + k*kThreads + thread, so
//   each load instruction of a warp is coalesced), every lane input and
//   row gather of a thread's lanes issued before any is used; each lane's
//   row, pre-batch cursor and store flag stay in registers across the
//   barriers.  Lanes beyond the co-resident grid take further rounds; such
//   a lane stashes its pre-batch cursor in its own new_cursor word (which
//   it overwrites later) and re-reads its store flag from its applied word
//   and its row from the lane input.
// - Every store lane scans its own row, kScan words a round trip, the
//   first round of all a thread's lanes loaded together.  Phase A
//   prefetches those words into L2 beside the lane's store, so the scan
//   after the barrier finds them there and not in device memory.  A lane
//   that advances writes its row's cursor with a plain store (all the
//   row's store lanes write the same cur + adv), one that advances
//   nothing writes nothing.
// - Cache hints: lane inputs and active by the read-only path; dec and
//   exec_cursor through L2 only (__ldcg): other SMs write them during the
//   launch, and L1 is not coherent.
// - 64 registers a thread (-Xptxas -v, sm_90a; two lanes a thread, eight
//   blocks an SM: the storm's 2^18 lanes take one round of the grid), no
//   spills.
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

constexpr int kThreads = 128;
constexpr int kLanes = 2;
constexpr int kBlockLanes = kThreads * kLanes;
// dec slot words a scan loads at once: 2 words (24 B, one or two sectors)
// -- most storing lanes of the storm advance their row by one slot, which
// the first two words settle, and a longer advance pays a round trip a
// group
constexpr int kScan = 2;

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
  unsigned* readers;  // nonzero: a lane reads the post-batch cursor (0
                      // between calls)
  int B, G, W;
};

// What a lane carries from phase A to phases B and C.
struct Lane {
  int row, cur;
  bool store;
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A lane's row: g if valid and in [0, G), else 0.
__device__ __forceinline__ int lane_row(const Args& a, int64_t i) {
  const int g = __ldg(a.g + i);
  return __ldg(a.valid + i) != 0 && g >= 0 && g < a.G ? g : 0;
}

// Phase A of the lanes base + k * kThreads, k < kLanes: decide against the
// pre-batch cursor, store the decision, write applied, stale and
// out_window.  Returns how many of them (below B) do not store.
__device__ __forceinline__ int decide_lanes(const Args& a, int64_t base,
                                            Lane* l) {
  int slot[kLanes], rlo[kLanes], rhi[kLanes];
  bool v[kLanes], live[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // the lane inputs, all at once
    const int64_t i = base + (int64_t)k * kThreads;
    const bool on = i < a.B;
    const int g = on ? __ldg(a.g + i) : 0;
    slot[k] = on ? __ldg(a.slot + i) : 0;
    rlo[k] = on ? __ldg(a.rlo + i) : 0;
    rhi[k] = on ? __ldg(a.rhi + i) : 0;
    v[k] = on && __ldg(a.valid + i) != 0 && g >= 0 && g < a.G;
    l[k].row = v[k] ? g : 0;
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // the row gathers, all at once
    live[k] = v[k] && __ldg(a.active + l[k].row) != 0;
    l[k].cur = __ldcg(a.cursor + l[k].row);
  }
  const size_t B = (size_t)a.B;
  int readers = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    const gp::CommitDecision d =
        gp::commit_decide(live[k], slot[k], l[k].cur, a.W);
    l[k].store = d.store;
    if (d.store) {
      const int* drow = a.dec + (size_t)l[k].row * a.W * 3;
#pragma unroll
      for (int j = 0; j < kScan; ++j)  // the scan's words, into L2 now
        prefetch_l2(drow +
                    gp::floor_mod(gp::add_wrap(l[k].cur, j), a.W) * 3);
      gp::commit_store(a.dec, l[k].row, a.W, slot[k], rlo[k], rhi[k]);
    }
    if (i < a.B) {
      a.out[i] = d.store;
      a.out[B + i] = d.stale;
      a.out[2 * B + i] = d.out_window;
      readers += !d.store;
    }
  }
  return readers;
}

// Phase B of the store lanes among base + k * kThreads: the first kScan
// slot words of every lane's scan loaded before any is used (a store or
// the cursor write after one lane's scan would hold the next lane's loads
// back: they may alias), then each lane's advance, its row's new cursor and
// its own.  Every store lane of a row writes the same cur + adv, the
// row's cursor after the batch, so a plain store does.
__device__ __forceinline__ void advance_lanes(const Args& a, int64_t base,
                                              const Lane* l) {
  int got[kLanes][kScan];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int* drow = a.dec + (size_t)l[k].row * a.W * 3;
#pragma unroll
    for (int j = 0; j < kScan; ++j)
      got[k][j] = l[k].store && j < a.W
                      ? __ldcg(drow + gp::floor_mod(gp::add_wrap(l[k].cur, j),
                                                    a.W) * 3)
                      : 0;
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (!l[k].store) continue;
    int adv = 0;
    while (adv < kScan && adv < a.W &&
           got[k][adv] == gp::add_wrap(l[k].cur, adv))
      ++adv;
    if (adv == kScan && kScan < a.W)  // a longer run: scan on
      adv += min(gp::commit_scan<kScan>(a.dec, l[k].row,
                                        gp::add_wrap(l[k].cur, kScan), a.W),
                 a.W - kScan);
    const int now = gp::add_wrap(l[k].cur, adv);
    if (adv) a.cursor[l[k].row] = now;
    a.out[3 * (size_t)a.B + base + (int64_t)k * kThreads] = now;
  }
}

__global__ void __launch_bounds__(kThreads, 4) commit_coop_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t)gridDim.x * kBlockLanes;
  const int64_t base0 = (int64_t)blockIdx.x * kBlockLanes + threadIdx.x;
  int32_t* stash = a.out + 3 * (size_t)a.B;  // the new_cursor row
  Lane first[kLanes];
  int readers = decide_lanes(a, base0, first);
  for (int64_t base = base0 + stride; base < a.B; base += stride) {
    Lane l[kLanes];
    readers += decide_lanes(a, base, l);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + (int64_t)k * kThreads;
      if (i < a.B) stash[i] = l[k].cur;
    }
  }
  readers = __syncthreads_count(readers != 0);
  if (threadIdx.x == 0 && readers) *a.readers = 1u;  // the same word from
                                                     // every such block
  grid.sync();  // every store of the batch before any scan
  const bool second = __ldcg(a.readers) != 0;
  advance_lanes(a, base0, first);
  for (int64_t base = base0 + stride; base < a.B; base += stride) {
    Lane l[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + (int64_t)k * kThreads;
      l[k] = Lane{0, 0, false};
      if (i < a.B && __ldcg(a.out + i)) {  // applied: a store lane, row g
        l[k].store = true;
        l[k].row = __ldg(a.g + i);
        l[k].cur = __ldcg(stash + i);
      }
    }
    advance_lanes(a, base, l);
  }
  if (!second) return;  // every lane stored: every new cursor is written
  grid.sync();  // every advance before any read of a cursor
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.readers = 0u;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int64_t i = base0 + (int64_t)k * kThreads;
    if (i < a.B && !first[k].store)
      stash[i] = __ldcg(a.cursor + first[k].row);
  }
  for (int64_t base = base0 + stride; base < a.B; base += stride) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + (int64_t)k * kThreads;
      if (i < a.B && !__ldcg(a.out + i))
        stash[i] = __ldcg(a.cursor + lane_row(a, i));
    }
  }
}

// the launch floor: an empty kernel at the commit kernel's geometry
__global__ void commit_floor_kernel(int) {}

}  // namespace

// The launch geometry and the co-resident block count of the current
// device (SMs x blocks an SM holds), and whether it takes cooperative
// launches at all.
extern "C" int gp_commit_limits(int* threads, int* lanes, int* blocks,
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
        &per_sm, commit_coop_kernel, kThreads, 0);
  *threads = kThreads;
  *lanes = kLanes;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int gp_commit(const void* g, const void* slot, const void* rlo,
                         const void* rhi, const void* valid,
                         const void* active, void* cursor, void* dec,
                         void* out, void* readers, int B, int G, int W,
                         int blocks, void* stream) {
  Args a{static_cast<const int32_t*>(g),   static_cast<const int32_t*>(slot),
         static_cast<const int32_t*>(rlo), static_cast<const int32_t*>(rhi),
         static_cast<const uint8_t*>(valid),
         static_cast<const uint8_t*>(active), static_cast<int32_t*>(cursor),
         static_cast<int32_t*>(dec),       static_cast<int32_t*>(out),
         static_cast<unsigned*>(readers), B, G, W};
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
