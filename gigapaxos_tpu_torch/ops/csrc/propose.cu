// The propose (slot assignment) transition for a batch of lanes at any
// width, written by hand for Hopper (sm_90a), with a run rank written by
// hand (rank_dev.cuh): one launch a call, no sort.
//
// Replaces the XLA-jit body gigapaxos_tpu/ops/kernels.py:propose_batch
// (:243-286, with _run_rank :71-90; packed propose_packed, :528-536; jits
// propose :679 and propose_p :681), which the storm step runs once and the
// SPI's ColumnarBackend.propose once a <=4096-lane chunk.  It computes what
// that body computes, row for row of its packed output.
//
// Semantics (per lane i, row r = g[i] if valid, else 0 as kernels.py:_gi
// gathers; W = window width; next_slot, exec_cursor and cbal as they stood
// BEFORE the batch):
//   v        = valid[i] && 0 <= g[i] < G
//   coord    = is_coord[r] && coord_active[r]
//   can      = v && active[r] && coord
//   rank     = the can lanes before i (in lane order) on row r; 0 if !can
//   slot     = next_slot[r] + rank
//   in_win   = slot < exec_cursor[r] + W
//   granted  = can && in_win -> next_slot[r] += 1,
//                               prop[r, slot mod W] = {slot, rlo, rhi, 0}
//   out      = [granted, rejected = v && active[r] && !coord,
//               throttled = can && !in_win, slot, cbal[r]]
// on every lane, padding lanes included.  Adds wrap as int32 (add_wrap),
// the compare is signed, slot mod W is the floor mod (C++'s % truncates).
//
// Bound: device-memory bytes, ~48 B a lane and 20 B more a granted one: 13 B
// of lane inputs, 15 B of row gathers (active, is_coord, coord_active,
// next_slot, exec_cursor, cbal), 20 B of outputs, a 16 B prop store and a
// 4 B next_slot add.  At the storm's 2^18 lanes about 17 MB, some 5 us at
// 3.35 TB/s.  The run rank's workspace adds a list entry a (tile, row): an
// 8 B head exchange, a 16 B entry, its walk (8 B of head and 16 B an entry
// read) and a 4 B sum written and read by each lane of the key.  As in the
// accept and commit kernels, every row gather and store lands on its own
// sector of a state far larger than L2, so the kernel is bound by random
// sector traffic and, at small B, by the launch, its barriers and the chain
// of round trips each lane waits on (lane load, row gathers, append, grid
// barrier, list walk, sum, store).
//
// Design:
// - ONE cooperative launch (cudaLaunchCooperativeKernel) with one grid-wide
//   barrier (cg::this_grid().sync()): phase A (gather; the rank in the
//   tile; append the tile's entries) | phase B (walk; decide; add; store).
//   The barrier orders every read of next_slot before any add, and every
//   list entry before any walk.
// - 256-lane tiles, one lane a thread.  The grid never exceeds the
//   co-resident block count (gp_propose_limits); block b takes tiles b,
//   b + grid, ... in turn, and every thread of a block walks the same tiles
//   (the tile rank holds block barriers).  A thread keeps its first tile's
//   lane in registers across the grid barrier; a lane of a later tile
//   stashes what phase B needs in its own output words (granted: its
//   tile's first lane of its row, plus 1; throttled: exec_cursor + W;
//   slot: next_slot + its rank in the tile), which phase B overwrites.
// - The run rank (rank_dev.cuh): the rank in the tile by warp match and a
//   shared-memory table; across tiles a list a row of {tile, count}
//   entries, one a (tile, row), walked once a (tile, row) by the tile's
//   first lane of the row, whose sum its row's other lanes of the tile read
//   after a block barrier.  The list heads are tagged with a call's epoch:
//   the kernel reads the epoch of the last call (a device word), uses the
//   next and stores it after the grid barrier; when it wraps to 0, every
//   head is cleared first (behind one more grid barrier), so no call
//   needs a reset and a walk never reads another call's entry.
// - Cache hints: lane inputs, active, the coordinator flags, exec_cursor
//   and cbal by the read-only path; next_slot and the workspace through L2
//   only (__ldcg): other SMs write them during the launch, and L1 is not
//   coherent.
//
// Precondition (as in kernels.py): at most one lane writes a given
// (row, slot) per batch (so next_slot <= exec_cursor + W before it); valid
// lanes name rows in [0, G).  A valid lane outside [0, G) is treated as
// invalid so the kernel never touches memory outside the state.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"
#include "rank_dev.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 2 * kThreads;  // slots of a block's rank table
constexpr int kBlocksPerSm = 8;

struct Args {
  const int32_t* g;
  const int32_t* rlo;
  const int32_t* rhi;
  const uint8_t* valid;
  const uint8_t* active;
  const uint8_t* is_coord;
  const uint8_t* coord_active;
  const int32_t* cbal;
  const int32_t* cursor;  // exec_cursor
  int32_t* next_slot;
  int4* prop;   // [G, W] of {slot, rlo, rhi, votes}
  int32_t* out;  // [5, B]: granted, rejected, throttled, slot, cbal
  unsigned long long* head;  // [G]: epoch << 32 | first entry
  gp::RankEntry* pool;       // [B]: list entries, by lane
  int32_t* base;             // [B]: a walk's sum, by the walking lane
  unsigned* epoch;           // the last call's epoch
  int B, G, W;
};

// What a lane that can be granted carries from phase A to phase B.
struct Lane {
  bool can;
  int row;
  int partial;  // next_slot + the rank in the tile (wraps)
  int hi;       // exec_cursor + W (wraps)
  int first;    // the tile's first lane of the row: its walk's sum
};

// Phase A of lane i (every thread calls it, i >= B included): gather,
// rank in the tile, append the tile's entry, write rejected and cbal, and
// every output of a lane that cannot be granted.
__device__ Lane propose_a(const Args& a, gp::TileSlot<kWarps>* tab,
                          int64_t i, int tile, unsigned epoch) {
  const bool on = i < a.B;
  Lane l{false, 0, 0, 0, -1};
  bool v = false, act = false, coord = false;
  int ns = 0, cur = 0, cb = 0;
  if (on) {
    const int g = __ldg(a.g + i);
    v = __ldg(a.valid + i) != 0 && g >= 0 && g < a.G;
    l.row = v ? g : 0;
    act = __ldg(a.active + l.row) != 0;
    coord = __ldg(a.is_coord + l.row) != 0 &&
            __ldg(a.coord_active + l.row) != 0;
    ns = __ldcg(a.next_slot + l.row);
    cur = __ldg(a.cursor + l.row);
    cb = __ldg(a.cbal + l.row);
  }
  l.can = v && act && coord;
  const gp::TileRank r = gp::tile_rank<kThreads>(tab, l.can, l.row, 0,
                                                 (int)i);
  if (l.can && r.first == i)
    gp::rank_append(a.head, a.pool, epoch, l.row, 0, tile, r.count, (int)i);
  if (!on) return l;
  const size_t B = (size_t)a.B;
  a.out[B + i] = v && act && !coord;
  a.out[4 * B + i] = cb;
  if (!l.can) {
    a.out[i] = 0;
    a.out[2 * B + i] = 0;
    a.out[3 * B + i] = ns;
  }
  l.partial = gp::add_wrap(ns, r.rank);
  l.hi = gp::add_wrap(cur, a.W);
  l.first = r.first;
  return l;
}

// A later tile's lane: its phase-A carry into its own output words.
__device__ __forceinline__ void stash(const Args& a, const Lane& l,
                                      int64_t i) {
  if (!l.can) return;  // its outputs are written
  const size_t B = (size_t)a.B;
  a.out[i] = l.first + 1;
  a.out[2 * B + i] = l.hi;
  a.out[3 * B + i] = l.partial;
}

__device__ __forceinline__ Lane unstash(const Args& a, int64_t i) {
  Lane l{false, 0, 0, 0, -1};
  if (i >= a.B) return l;
  const size_t B = (size_t)a.B;
  const int f = __ldcg(a.out + i);
  if (f == 0) return l;
  l.can = true;
  l.first = f - 1;
  l.row = __ldg(a.g + i);  // a lane that can be granted is valid
  l.hi = __ldcg(a.out + 2 * B + i);
  l.partial = __ldcg(a.out + 3 * B + i);
  return l;
}

// Phase B of lane i (every thread calls it): the tile's first lane of a
// row walks the row's list; after a block barrier every lane of the row
// adds that sum, decides, and a granted lane adds to next_slot and stores
// its prop column.
__device__ void propose_b(const Args& a, const Lane& l, int64_t i, int tile,
                          unsigned epoch) {
  if (l.can && l.first == i)
    a.base[i] = tile ? gp::rank_earlier(a.head, a.pool, epoch, l.row, 0,
                                        tile)
                     : 0;
  __syncthreads();  // every walk of the tile before its lanes read the sums
  if (!l.can) return;
  const int slot = gp::add_wrap(l.partial, __ldcg(a.base + l.first));
  const bool in_win = slot < l.hi;
  const size_t B = (size_t)a.B;
  a.out[i] = in_win;
  a.out[2 * B + i] = !in_win;
  a.out[3 * B + i] = slot;
  if (in_win) {
    atomicAdd(a.next_slot + l.row, 1);
    a.prop[(size_t)l.row * a.W + gp::floor_mod(slot, a.W)] =
        make_int4(slot, __ldg(a.rlo + i), __ldg(a.rhi + i), 0);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    propose_coop_kernel(Args a) {
  __shared__ gp::TileSlot<kWarps> tab[kCap];
  gp::tile_table_clear(tab, kCap);
  cg::grid_group grid = cg::this_grid();
  unsigned epoch = __ldcg(a.epoch) + 1u;
  if (epoch == 0) {  // wrapped: every head from the last 2^32 - 1 calls
    for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < a.G;
         r += (int64_t)gridDim.x * kThreads)
      a.head[r] = 0;
    grid.sync();
    epoch = 1;
  }
  const int tiles = (int)(((int64_t)a.B + kThreads - 1) / kThreads);
  const int t0 = blockIdx.x;
  Lane first{false, 0, 0, 0, -1};
  for (int t = t0; t < tiles; t += gridDim.x) {
    const int64_t i = (int64_t)t * kThreads + threadIdx.x;
    const Lane l = propose_a(a, tab, i, t, epoch);
    if (t == t0)
      first = l;
    else
      stash(a, l, i);
  }
  grid.sync();  // every next_slot read and list entry before phase B
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.epoch = epoch;
  for (int t = t0; t < tiles; t += gridDim.x) {
    const int64_t i = (int64_t)t * kThreads + threadIdx.x;
    propose_b(a, t == t0 ? first : unstash(a, i), i, t, epoch);
  }
}

// the launch floor: an empty kernel at the propose kernel's geometry
__global__ void propose_floor_kernel(int) {}

}  // namespace

// The launch geometry and the co-resident block count of the current
// device (SMs x blocks an SM holds), and whether it takes cooperative
// launches at all.
extern "C" int gp_propose_limits(int* threads, int* blocks,
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
        &per_sm, propose_coop_kernel, kThreads, 0);
  *threads = kThreads;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int gp_propose(const void* g, const void* rlo, const void* rhi,
                          const void* valid, const void* active,
                          const void* is_coord, const void* coord_active,
                          const void* cbal, const void* cursor,
                          void* next_slot, void* prop, void* out, void* head,
                          void* pool, void* base, void* epoch, int B, int G,
                          int W, int blocks, void* stream) {
  Args a{static_cast<const int32_t*>(g),
         static_cast<const int32_t*>(rlo),
         static_cast<const int32_t*>(rhi),
         static_cast<const uint8_t*>(valid),
         static_cast<const uint8_t*>(active),
         static_cast<const uint8_t*>(is_coord),
         static_cast<const uint8_t*>(coord_active),
         static_cast<const int32_t*>(cbal),
         static_cast<const int32_t*>(cursor),
         static_cast<int32_t*>(next_slot),
         static_cast<int4*>(prop),
         static_cast<int32_t*>(out),
         static_cast<unsigned long long*>(head),
         static_cast<gp::RankEntry*>(pool),
         static_cast<int32_t*>(base),
         static_cast<unsigned*>(epoch),
         B, G, W};
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(propose_coop_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();  // clear the launch's error state; `e` reports it
  return static_cast<int>(e);
}

// An empty kernel launched as the propose kernel is, on `blocks` blocks.
extern "C" int gp_propose_floor(int blocks, void* stream) {
  int unused = 0;
  void* args[] = {&unused};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(propose_floor_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();
  return static_cast<int>(e);
}
