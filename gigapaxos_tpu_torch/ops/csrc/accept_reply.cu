// The accept-reply (vote counting) transition for a batch of lanes at any
// width, written by hand for Hopper (sm_90a), with the run rank of
// rank_dev.cuh: one launch a call, one grid barrier, no sort.
//
// Replaces the XLA-jit body gigapaxos_tpu/ops/kernels.py:accept_reply_batch
// (:152-227, with _run_rank :71-90; packed accept_reply_packed, :549-557;
// jits accept_reply :678 and accept_reply_p :687), which the storm step
// runs R times and the SPI's ColumnarBackend.accept_reply once a <=4096-lane
// chunk.  It computes what that body computes, row for row of its packed
// output.
//
// Semantics (per lane i, row r = g[i] if valid, else 0 as kernels.py:_gi
// gathers; W = window width; col = prop[r, w] as it stood BEFORE the batch):
//   v       = valid[i] && 0 <= g[i] < G
//   w       = v ? slot mod W : 0
//   match   = v && is_coord[r] && coord_active[r] && bal == cbal[r] && acked
//             && slot >= 0 && col.slot == slot
//   fresh   = match && bit `sender` of col.votes clear
//             -> prop[r, w].votes += 1 << sender
//   quorum  = match && popcount(prop[r, w].votes & VOTE_MASK) after EVERY
//             fresh add of the batch >= members[r] / 2 + 1
//   newly   = quorum && !(col.votes & EMITTED_BIT) && no earlier quorum
//             lane (in lane order) has the same (row, slot)
//             -> prop[r, w].votes += EMITTED_BIT
//   pre     = v && is_coord[r] && !acked && bal > cbal[r]
//             -> is_coord[r] = coord_active[r] = 0, after every lane read
//   out     = [newly, pre, cbal[r], col.rlo, col.rhi, slot]
// on every lane, padding lanes included.  Shifts follow torch and XLA (a
// count outside [0, 32) gives 0 to the left and the sign to the right).
//
// The rank needs no second barrier.  Every lane of one (row, slot) reads
// the same column, so it sees the same re-gathered count and members: a
// key's quorum lanes are exactly its match lanes when the column crosses
// quorum, and there are none when it does not.  A quorum lane's rank among
// quorum lanes is therefore its rank among its key's match lanes, which
// phase A can rank before any vote is counted.
//
// Bound: device-memory bytes, ~42 B a lane (18-24 B of lane inputs, 24 B
// of outputs), ~10 B a touched row (is_coord, coord_active, cbal, members),
// 16 B a touched column, 4 B a changed vote word and 2 B a preempted row.
// At the storm's 2^18 lanes on distinct rows about 19 MB, some 6 us at
// 3.35 TB/s.  The run rank adds a list entry a (tile, key) of the match
// lanes: an 8 B head exchange, a 16 B entry, and a walk (8 B of head and
// 16 B an entry) by a key's first lane of a tile whose column crossed
// quorum.  As in the other kernels every row gather and store lands on its
// own sector of a state far larger than L2, so the kernel is bound by
// random sector traffic and, at small B, by the launch, its barriers and
// the chain of round trips each lane waits on.
//
// Design:
// - ONE cooperative launch with one grid-wide barrier: phase A (gather;
//   match; the fresh vote's atomicAdd; the rank in the tile; append the
//   tile's entries) | phase B (re-gather the vote word; a key's first lane
//   of its tile walks its row's list only to learn whether an earlier tile
//   holds the key; EMITTED_BIT by atomicAdd; the resignations).  The
//   barrier orders every vote before any re-gather, every list entry
//   before any walk, and every flag read before any resignation.
// - 256-lane tiles, one lane a thread, the grid never past the
//   co-resident block count; block b takes tiles b, b + grid, ...  A
//   thread keeps its first tile's lane in registers across the barrier; a
//   lane of a later tile stashes its flags (match, first of its key in the
//   tile, EMITTED_BIT before the batch) in its own newly_decided word,
//   which phase B overwrites, and re-reads its row and slot.
// - The workspace (head[G], the epoch, the lane-indexed entries) is the
//   propose kernel's, one a device, stream and G: a call's epoch tags its
//   lists, so calls of either kernel on one stream may share it.
// - Cache hints: lane inputs, cbal and members by the read-only path; the
//   coordinator flags, the prop column and the workspace through L2 only
//   (__ldcg): this launch writes them, and L1 is not coherent.
//
// Precondition (as in kernels.py): at most one lane a (row, slot, sender)
// per batch, so no vote bit is added twice and a lane's view of its own
// sender's bit is the pre-batch one, whatever other lanes added first;
// valid lanes name rows in [0, G).  A valid lane outside [0, G) is treated
// as invalid so the kernel never touches memory outside the state.
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
constexpr int kEmitted = 1 << 30;  // types.EMITTED_BIT
constexpr int kVoteMask = kEmitted - 1;

struct Args {
  const int32_t* g;
  const int32_t* slot;
  const int32_t* bal;
  const int32_t* sender;
  const void* acked;  // uint8 or int32 lanes (flag_bytes)
  const void* valid;
  uint8_t* is_coord;
  uint8_t* coord_active;
  const int32_t* cbal;
  const int32_t* members;
  int4* prop;    // [G, W] of {slot, rlo, rhi, votes}
  int32_t* out;  // [6, B]: newly, preempted, dec_bal, req_lo, req_hi, slot
  unsigned long long* head;  // [G]: epoch << 32 | first entry
  gp::RankEntry* pool;       // [B]: list entries, by lane
  unsigned* epoch;           // the last call's epoch
  int B, G, W;
  int flag_bytes;  // 1: acked and valid are bool lanes; 4: int32 lanes
};

// What a lane carries from phase A to phase B.
struct Lane {
  bool match;    // votes in its column: a candidate for the decision
  bool lead;     // its key's first match lane in its tile
  bool emitted;  // the column held EMITTED_BIT before the batch
  bool pre;      // preempts its row's coordinator
  int row, w, slot;
  int need;  // members / 2 + 1 (match lanes only)
};

// flag bits of a later tile's lane, stashed in its newly_decided word
constexpr int kMatch = 1, kLead = 2, kWasEmitted = 4;

__device__ __forceinline__ bool flag(const void* p, int bytes, int64_t i) {
  return bytes == 4 ? __ldg(static_cast<const int32_t*>(p) + i) != 0
                    : __ldg(static_cast<const uint8_t*>(p) + i) != 0;
}

// 1 << s and x >> s as torch and XLA shift int32
__device__ __forceinline__ int bit_of(int s) {
  return s >= 0 && s < 32 ? (int)(1u << s) : 0;
}
__device__ __forceinline__ int shift_right(int x, int s) {
  return x >> (s >= 0 && s < 31 ? s : 31);
}

__device__ __forceinline__ int* vote_word(const Args& a, int row, int w) {
  return reinterpret_cast<int*>(a.prop + (size_t)row * a.W + w) + 3;
}

__device__ __forceinline__ int need_of(const Args& a, int row) {
  return gp::floor_half(__ldg(a.members + row)) + 1;
}

// Phase A of lane i (every thread calls it, i >= B included): gather,
// match, the fresh vote, rank in the tile, append the tile's entry, and
// every output but newly_decided.
__device__ Lane reply_a(const Args& a, gp::TileSlot<kWarps>* tab, int64_t i,
                        int tile, unsigned epoch) {
  const bool on = i < a.B;
  Lane l{false, false, false, false, 0, 0, 0, 0};
  int sender = 0, cb = 0;
  int4 col = make_int4(0, 0, 0, 0);
  if (on) {
    const int g = __ldg(a.g + i);
    l.slot = __ldg(a.slot + i);
    const int bal = __ldg(a.bal + i);
    sender = __ldg(a.sender + i);
    const bool acked = flag(a.acked, a.flag_bytes, i);
    const bool v = flag(a.valid, a.flag_bytes, i) && g >= 0 && g < a.G;
    l.row = v ? g : 0;
    l.w = v ? gp::floor_mod(l.slot, a.W) : 0;
    const bool ic = __ldcg(a.is_coord + l.row) != 0;
    const bool ca = __ldcg(a.coord_active + l.row) != 0;
    cb = __ldg(a.cbal + l.row);
    col = __ldcg(a.prop + (size_t)l.row * a.W + l.w);
    l.match = v && ic && ca && bal == cb && acked && l.slot >= 0 &&
              col.x == l.slot;
    l.pre = v && ic && !acked && bal > cb;
  }
  const gp::TileRank r =
      gp::tile_rank<kThreads>(tab, l.match, l.row, l.slot, (int)i);
  if (l.match && r.first == i)
    gp::rank_append(a.head, a.pool, epoch, l.row, l.slot, tile, r.count,
                    (int)i);
  if (!on) return l;
  if (l.match) {
    if ((shift_right(col.w, sender) & 1) == 0)
      atomicAdd(vote_word(a, l.row, l.w), bit_of(sender));
    l.need = need_of(a, l.row);
  }
  l.lead = l.match && r.rank == 0;
  l.emitted = (col.w & kEmitted) != 0;
  const size_t B = (size_t)a.B;
  a.out[B + i] = l.pre;
  a.out[2 * B + i] = cb;
  a.out[3 * B + i] = col.y;
  a.out[4 * B + i] = col.z;
  a.out[5 * B + i] = l.slot;
  return l;
}

// A later tile's lane: its flags into its own newly_decided word.
__device__ __forceinline__ void stash(const Args& a, const Lane& l,
                                      int64_t i) {
  if (i < a.B)
    a.out[i] = (l.match ? kMatch : 0) | (l.lead ? kLead : 0) |
               (l.emitted ? kWasEmitted : 0);
}

__device__ __forceinline__ Lane unstash(const Args& a, int64_t i) {
  Lane l{false, false, false, false, 0, 0, 0, 0};
  if (i >= a.B) return l;
  const size_t B = (size_t)a.B;
  const int f = __ldcg(a.out + i);
  l.pre = __ldcg(a.out + B + i) != 0;
  if (!f && !l.pre) return l;
  l.row = __ldg(a.g + i);  // a matching or preempting lane is valid
  l.slot = __ldg(a.slot + i);
  l.w = gp::floor_mod(l.slot, a.W);
  l.match = (f & kMatch) != 0;
  l.lead = (f & kLead) != 0;
  l.emitted = (f & kWasEmitted) != 0;
  if (l.match) l.need = need_of(a, l.row);
  return l;
}

// Phase B of lane i (every thread calls it): a key's first match lane of
// its tile, on a column with no EMITTED_BIT before the batch, counts the
// votes; past quorum it is newly decided unless an earlier tile holds its
// key.  A preempting lane resigns its row.
__device__ void reply_b(const Args& a, const Lane& l, int64_t i, int tile,
                        unsigned epoch) {
  if (i >= a.B) return;
  bool newly = false;
  if (l.lead && !l.emitted) {
    int* vote = vote_word(a, l.row, l.w);
    newly = __popc(__ldcg(vote) & kVoteMask) >= l.need &&
            !(tile && gp::rank_seen(a.head, a.pool, epoch, l.row, l.slot,
                                    tile));
    if (newly) atomicAdd(vote, kEmitted);
  }
  a.out[i] = newly;
  if (l.pre) {
    a.is_coord[l.row] = 0;
    a.coord_active[l.row] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    accept_reply_coop_kernel(Args a) {
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
  Lane first{false, false, false, false, 0, 0, 0, 0};
  for (int t = t0; t < tiles; t += gridDim.x) {
    const int64_t i = (int64_t)t * kThreads + threadIdx.x;
    const Lane l = reply_a(a, tab, i, t, epoch);
    if (t == t0)
      first = l;
    else
      stash(a, l, i);
  }
  grid.sync();  // every vote, list entry and flag read before phase B
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.epoch = epoch;
  for (int t = t0; t < tiles; t += gridDim.x) {
    const int64_t i = (int64_t)t * kThreads + threadIdx.x;
    reply_b(a, t == t0 ? first : unstash(a, i), i, t, epoch);
  }
}

// the launch floor: an empty kernel at the accept-reply kernel's geometry
__global__ void accept_reply_floor_kernel(int) {}

}  // namespace

// The launch geometry and the co-resident block count of the current
// device (SMs x blocks an SM holds), and whether it takes cooperative
// launches at all.
extern "C" int gp_accept_reply_limits(int* threads, int* blocks,
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
        &per_sm, accept_reply_coop_kernel, kThreads, 0);
  *threads = kThreads;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

extern "C" int gp_accept_reply(const void* g, const void* slot,
                               const void* bal, const void* sender,
                               const void* acked, const void* valid,
                               void* is_coord, void* coord_active,
                               const void* cbal, const void* members,
                               void* prop, void* out, void* head, void* pool,
                               void* epoch, int B, int G, int W,
                               int flag_bytes, int blocks, void* stream) {
  Args a{static_cast<const int32_t*>(g),
         static_cast<const int32_t*>(slot),
         static_cast<const int32_t*>(bal),
         static_cast<const int32_t*>(sender),
         acked,
         valid,
         static_cast<uint8_t*>(is_coord),
         static_cast<uint8_t*>(coord_active),
         static_cast<const int32_t*>(cbal),
         static_cast<const int32_t*>(members),
         static_cast<int4*>(prop),
         static_cast<int32_t*>(out),
         static_cast<unsigned long long*>(head),
         static_cast<gp::RankEntry*>(pool),
         static_cast<unsigned*>(epoch),
         B, G, W, flag_bytes};
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(accept_reply_coop_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();  // clear the launch's error state; `e` reports it
  return static_cast<int>(e);
}

// An empty kernel launched as the accept-reply kernel is, on `blocks`
// blocks.
extern "C" int gp_accept_reply_floor(int blocks, void* stream) {
  int unused = 0;
  void* args[] = {&unused};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(accept_reply_floor_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaGetLastError();
  return static_cast<int>(e);
}
