// The commit step's device code, shared by the commit kernel (commit.cu)
// and the runtime's wave kernels (wave.cu).
//
// The commit step of one lane, row r, W = window width, cur = exec_cursor[r]
// as it stood before the batch:
//   decide:  stale = live && slot < cur; out_window = live && slot >= cur + W;
//            store = live && cur <= slot < cur + W
//   store:   dec[r, slot mod W] = {slot, rlo, rhi}          (then a barrier)
//   advance: adv = the leading k < W with dec[r, (cur + k) mod W].slot ==
//            cur + k, read after the WHOLE batch's stores (the torch body's
//            cumprod); exec_cursor[r] = max(exec_cursor[r], cur + adv)
//                                                             (then a barrier)
//   then every lane reads exec_cursor[r] as the batch left it.
// cur + W and cur + k wrap as int32 (add_wrap), as torch and XLA add.  A
// caller gathers active and the pre-batch exec_cursor itself, and reads the
// row's dec words through L2: other lanes of the batch stored them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"

namespace gp {

struct CommitDecision {
  bool store;       // the decision goes to dec[row, slot mod W]
  bool stale;       // slot < exec_cursor
  bool out_window;  // slot >= exec_cursor + W
};

__device__ __forceinline__ CommitDecision commit_decide(bool live, int slot,
                                                        int cur, int W) {
  const int hi = add_wrap(cur, W);
  CommitDecision d;
  d.store = live && slot >= cur && slot < hi;
  d.stale = live && slot < cur;
  d.out_window = live && slot >= hi;
  return d;
}

// The store of a decided lane: {slot, rlo, rhi} into its window column.
__device__ __forceinline__ void commit_store(int* dec, int row, int W,
                                             int slot, int rlo, int rhi) {
  int* d = dec + ((size_t)row * W + floor_mod(slot, W)) * 3;
  d[0] = slot;
  d[1] = rlo;
  d[2] = rhi;
}

// adv: the row's slot words loaded kGroup at a time, each group at once
// (one round trip a group), through L2.  A wider group pays fewer round
// trips on a long advance and more sectors on a short one.
template <int kGroup>
__device__ __forceinline__ int commit_scan(const int* dec, int row, int cur,
                                           int W) {
  const int* drow = dec + (size_t)row * W * 3;
  for (int k0 = 0; k0 < W; k0 += kGroup) {
    int got[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 + j;
      got[j] = k < W ? __ldcg(drow + floor_mod(add_wrap(cur, k), W) * 3) : 0;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 + j;
      if (k >= W || got[j] != add_wrap(cur, k)) return k;
    }
  }
  return W;
}

// The advance of a storing lane.  exec_cursor[row] is `cur` until the
// batch's first advance and only grows, so a lane that advances nothing
// cannot raise it and issues no atomic.
template <int kGroup>
__device__ __forceinline__ void commit_advance(int* cursor, const int* dec,
                                               int row, int cur, int W) {
  const int adv = commit_scan<kGroup>(dec, row, cur, W);
  if (adv) atomicMax(cursor + row, add_wrap(cur, adv));
}

}  // namespace gp
