// The accept step's device code, shared by the accept kernel (accept.cu)
// and the runtime's wave kernels (wave.cu), and the int32 arithmetic both
// follow (torch's and XLA's, not C++'s).
//
// The accept step of one lane, row r = g, W = window width (the header of
// accept.cu has the whole transition):
//   raise:  bal[r] = max(bal[r], lane_bal) over live lanes   (then a barrier)
//   decide: cur = bal[r] after the WHOLE batch; promised = live && lane_bal
//           >= cur; stale = live && slot < exec_cursor[r]; in window =
//           exec_cursor[r] <= slot < exec_cursor[r] + W; store = promised
//           && in window -> acc[r, slot mod W] = {slot, lane_bal, rlo, rhi}
// A caller gathers active, exec_cursor and bal itself (its cache hints
// differ: the accept kernel reads exec_cursor by the read-only path, a wave
// kernel writes it later in the same launch).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gp {

// a + b with int32 wrap-around, as torch and XLA add (no signed-overflow UB)
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// a mod W with the sign of W (torch's and jnp's %); C++ % truncates
__device__ __forceinline__ int floor_mod(int a, int W) {
  int m = a % W;
  return m < 0 ? m + W : m;
}

// a // 2 rounded toward minus infinity (torch's and jnp's //)
__device__ __forceinline__ int floor_half(int a) { return a >> 1; }

// The raise: `seen` is bal[row] as the lane read it before any raise of
// this batch.  bal only grows during a batch, so a lane at or below what
// it read cannot change the max and issues no atomic.
__device__ __forceinline__ void accept_raise(int* bal, int row, bool live,
                                             int lane_bal, int seen) {
  if (live && lane_bal > seen) atomicMax(bal + row, lane_bal);
}

struct AcceptDecision {
  bool store;   // the pvalue goes to acc[row, slot mod W]
  bool acked;   // stored, or promised and already decided (stale)
  bool stale;   // slot < exec_cursor
  bool out_window;  // promised, not stale, beyond the window
};

// The decision against `cb`, bal[row] after the whole batch's raises.
__device__ __forceinline__ AcceptDecision accept_decide(bool live,
                                                        int lane_bal,
                                                        int slot, int cur,
                                                        int cb, int W) {
  AcceptDecision d;
  bool promised = live && lane_bal >= cb;
  d.stale = live && slot < cur;
  bool in_win = slot >= cur && slot < add_wrap(cur, W);
  d.store = promised && in_win;
  d.acked = d.store || (promised && d.stale);
  d.out_window = promised && !in_win && !d.stale;
  return d;
}

// The store of a decided lane: one 16-byte pvalue, touched once
// (evict-first).
__device__ __forceinline__ void accept_store(int4* acc, int row, int W,
                                             int slot, int lane_bal, int rlo,
                                             int rhi) {
  __stcs(acc + (size_t)row * W + floor_mod(slot, W),
         make_int4(slot, lane_bal, rlo, rhi));
}

}  // namespace gp
