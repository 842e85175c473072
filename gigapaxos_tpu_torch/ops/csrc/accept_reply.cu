// The accept-reply (vote counting) transition for a batch of lanes at any
// width, written by hand for Hopper (sm_90a): one launch a call, no sort,
// in one of two geometries chosen by the width B.
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
// Bound: device-memory bytes, ~42 B a lane (18-24 B of lane inputs, 24 B
// of outputs), ~10 B a touched row (is_coord, coord_active, cbal, members),
// 16 B a touched column, 4 B a changed vote word and 2 B a preempted row.
// At the storm's 2^18 lanes on distinct rows about 19 MB, some 6 us at
// 3.35 TB/s.  Every row gather and store lands on its own sector of a state
// far larger than L2, so the kernel is bound by random sector traffic and
// by the chain of dependent round trips each lane waits on, and at small B
// by the launch and its barriers.
//
// Design: the wrapper picks the path from B alone (accept_reply_cuda.plan).
//
// - Small path, B <= 4096 (the SPI's chunks): one CTA of B threads
//   rounded up to a warp up to 512 lanes, one 8 x 512 thread-block cluster
//   above (cudaLaunchKernelEx's cluster attribute; the geometry and the
//   run rank of vote_dev.cuh, which the runtime's coordinator wave shares);
//   one lane a thread.  A candidate (a matching lane on a column not yet
//   emitted) adds its vote and claims its column as on the wide path
//   (below), and enters the run rank by (row, slot) in its CTA's
//   shared-memory table | __syncthreads or the hardware cluster barrier |
//   the re-gathered count; only the candidates of a contested column look
//   the rank up (across the cluster's CTAs in distributed shared memory),
//   the lone candidate of any other column decides alone | one more
//   barrier, after which the column's deciding candidate stores its vote
//   word (no lane re-gathers it after that, and no CTA leaves while
//   another reads its table).  No grid barrier, no workspace.
// - Wide path, B > 4096 (the storm's 2^18): ONE cooperative launch with
//   one grid barrier, and a second only where two candidates share a
//   column.  kLanes lanes a thread (lane block*kBlockLanes + k*kThreads +
//   thread, so each load instruction of a warp is coalesced), every lane
//   input and row gather of a thread's lanes issued before any is used.
//   A candidate is a matching lane on a column not yet emitted; every
//   lane of a (row, slot) reads one column, so a key's quorum lanes are
//   all its candidates or none, and the newly decided lane is the key's
//   first candidate in lane order.  The candidates of a column all carry
//   its slot, so the column is the key.
//   Phase A: a candidate adds its fresh vote and claims the column in one
//   atomicOr of bit 31 of the vote word (0 in every state: votes are bits
//   0..29, of at most 30 replicas, and EMITTED_BIT is bit 30).  The one
//   that finds bit 31 clear is the column's first claimer; a later one
//   sets bit 30 (a contest: EMITTED_BIT is clear on a candidate's column)
//   and raises the column's word of a table to epoch << 32 | ~i by
//   atomicMax, and sets a device word.
//   Phase B (after the grid barrier): a candidate loads the vote word and
//   members (one round trip).  On an uncontested column it is the only
//   candidate, newly decided iff past quorum, and it stores the vote
//   word as the launch leaves it (bits 30 and 31 cleared, EMITTED_BIT set
//   if decided).  On a contested one the first claimer raises the table
//   word with its own tag, and, after a second grid barrier, run only
//   when the device word is set (every block reads it after the first),
//   the candidate whose tag the word holds is the key's first: newly
//   decided iff past quorum, it stores the vote word.  A candidate of the
//   storm waits on its lane loads, one round of row gathers (the flags,
//   cbal, the column), the grid barrier and one round (vote word,
//   members), and issues one atomic and one store; no table word is
//   touched.
//   The table (one 8-byte word a window column, zero at allocation) is a
//   workspace the wrapper keeps per device, stream, G and W; its epoch (a
//   device word the kernel advances) tags each call's entries, so no call
//   clears it, and a call that wraps the epoch clears the table first.
//   A thread keeps its first round of lanes in registers across the
//   barrier; a lane of a later round (beyond the co-resident grid)
//   stashes its flags in its own newly_decided word, which phase B
//   overwrites, and re-reads its row and slot.
// - Cache hints: lane inputs, cbal and members by the read-only path; the
//   coordinator flags, the prop column and the table through L2 only
//   (__ldcg): the launch writes them, and L1 is not coherent.
//
// Registers (-Xptxas -v, sm_90a): the small path 32 in one CTA and 60 in a
// cluster, the wide path 128 (four lanes a thread, four blocks an SM: the
// storm's 2^18 lanes take one round of the grid); no spills, no stack.
//
// Precondition (as in kernels.py): at most one lane a (row, slot, sender)
// per batch, so no vote bit is added twice and a lane's view of its own
// sender's bit is the pre-batch one, whatever other lanes added first;
// valid lanes name rows in [0, G); a matching lane's sender is a member
// index in [0, 30) and bit 31 of every vote word is 0 (types.py: votes are
// bits 0..29, EMITTED_BIT bit 30).  A valid lane outside [0, G) is treated
// as invalid so the kernel never touches memory outside the state.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"
#include "vote_dev.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // wide path: threads a block
constexpr int kLanes = 4;      // wide path: lanes a thread
constexpr int kBlockLanes = kThreads * kLanes;
constexpr int kEmitted = gp::kEmittedBit;
constexpr int kVoteMask = gp::kVoteBits;

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
  unsigned long long* first;  // wide path: [G * W] of epoch << 32 | ~lane
  unsigned* epoch;            // wide path: the last call's epoch
  unsigned* contested;  // wide path: nonzero when a column has two
                        // candidates (0 between calls)
  int B, G, W;
  int flag_bytes;  // 1: acked and valid are bool lanes; 4: int32 lanes
};

__device__ __forceinline__ bool flag(const void* p, int bytes, int64_t i) {
  return bytes == 4 ? __ldg(static_cast<const int32_t*>(p) + i) != 0
                    : __ldg(static_cast<const uint8_t*>(p) + i) != 0;
}

// ---- a candidate's claim on its column (both paths) -------------------------

// Bits 30 and 31 of a candidate column's vote word during a launch: 31 set
// by its first candidate to claim it, 30 (EMITTED_BIT before and after the
// launch) by any later one.  Both are cleared, and EMITTED_BIT set where
// the column is decided, before the launch ends.
constexpr int kClaim = (int)(1u << 31);
constexpr int kContested = kEmitted;

// Whether a column was emitted before the launch, from its vote word as a
// lane gathered it: a column a candidate of this launch claimed was not,
// and its bit 30 then marks a contest.
__device__ __forceinline__ bool emitted_before(int votes) {
  return (votes & kClaim) == 0 && (votes & kEmitted) != 0;
}

// The vote word the deciding candidate of a column leaves: the votes, and
// EMITTED_BIT where the column reached quorum.
__device__ __forceinline__ int settled(int votes, bool quorum) {
  return (votes & kVoteMask) | (quorum ? kEmitted : 0);
}

// ---- the small path: one CTA or one cluster ---------------------------------

template <bool kCl>
__global__ void __launch_bounds__(gp::kCtaLanes, 1)
    accept_reply_chunk_kernel(Args a) {
  extern __shared__ gp::RankSlot tab[];
  const int cap = gp::table_cap(blockDim.x);
  if (gp::needs_tables(kCl ? gp::kClusterCtas : 1, blockDim.x))
    gp::clear_tables(tab, cap);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < a.B;
  int row = 0, w = 0, slot = 0, cb = 0, members = 0;
  bool pre = false, cand = false, later = false;
  int4 col = make_int4(0, 0, 0, 0);
  if (on) {
    const int g = __ldg(a.g + i);
    slot = __ldg(a.slot + i);
    const int bal = __ldg(a.bal + i);
    const int sender = __ldg(a.sender + i);
    const bool acked = flag(a.acked, a.flag_bytes, i);
    const bool v = flag(a.valid, a.flag_bytes, i) && g >= 0 && g < a.G;
    row = v ? g : 0;
    w = v ? gp::floor_mod(slot, a.W) : 0;
    const bool ic = __ldcg(a.is_coord + row) != 0;
    const bool ca = __ldcg(a.coord_active + row) != 0;
    cb = __ldg(a.cbal + row);
    members = __ldg(a.members + row);
    col = __ldcg(a.prop + (size_t)row * a.W + w);
    const bool match = v && ic && ca && bal == cb && acked && slot >= 0 &&
                       col.x == slot;
    pre = v && ic && !acked && bal > cb;
    cand = match && !emitted_before(col.w);
    const int fresh = match && (gp::shift_right(col.w, sender) & 1) == 0
                          ? gp::bit_of(sender)
                          : 0;
    int* vote = gp::vote_word(a.prop, a.W, row, w);
    if (cand) {
      later = (atomicOr(vote, fresh | kClaim) & kClaim) != 0;
      if (later) atomicOr(vote, kContested);
    } else if (fresh) {
      atomicAdd(vote, fresh);
    }
  }
  const unsigned long long key =
      ((unsigned long long)(unsigned)row << 32) | (unsigned)slot;
  __syncthreads();  // the table cleared before any entry
  const gp::RankTicket t = gp::rank_enter<kCl>(tab, cap, cand, key);
  gp::chunk_barrier<kCl>();  // every vote, claim and table entry before any
                             // re-gather or lookup, every flag read before
                             // any resign
  const int votes = cand ? __ldcg(gp::vote_word(a.prop, a.W, row, w)) : 0;
  const bool contested = cand && (later || (votes & kContested) != 0);
  const bool quorum = cand && __popc(votes & kVoteMask) >=
                                  gp::floor_half(members) + 1;
  // the key's first candidate in lane order decides: an uncontested
  // column's lone one, a contested one's by the run rank (every lane calls
  // it: a warp shuffle)
  const int rank = gp::rank_read<kCl>(tab, cap, contested, key, t);
  const bool decides = cand && rank == 0;
  if (on) {
    if (pre) {
      a.is_coord[row] = 0;
      a.coord_active[row] = 0;
    }
    const int B = a.B;
    a.out[i] = decides && quorum;
    a.out[B + i] = pre;
    a.out[2 * B + i] = cb;
    a.out[3 * B + i] = col.y;
    a.out[4 * B + i] = col.z;
    a.out[5 * B + i] = slot;
  }
  gp::chunk_barrier<kCl>();  // every re-gather and lookup before a vote
                             // word is rewritten; no CTA leaves while
                             // another reads its table
  if (decides)
    *gp::vote_word(a.prop, a.W, row, w) = settled(votes, quorum);
}

// ---- the wide path: one cooperative grid, kLanes lanes a thread ------------

// What a lane carries from phase A to phase B.
struct Lane {
  int row, w;
  bool cand;   // matches a column not yet emitted: may be newly decided
  bool first;  // the first candidate of its column to claim it
  bool pre;    // preempts its row's coordinator
};

// the flags a later round's lane stashes in its newly_decided word
constexpr int kStashCand = 1, kStashFirst = 2;
// a contested candidate's newly_decided word across the second barrier
constexpr int kDeferred = 2, kDeferredQuorum = 3;

__device__ __forceinline__ unsigned long long tag_of(unsigned epoch,
                                                     int64_t i) {
  return ((unsigned long long)epoch << 32) | (unsigned)~(unsigned)i;
}

__device__ __forceinline__ unsigned long long* first_of(const Args& a,
                                                        int row, int w) {
  return a.first + (size_t)row * a.W + w;
}

// Phase A of the lanes base + k * kThreads, k < kLanes (each below B):
// gather, match, the fresh vote with the claim, a contest's tag, and every
// output but newly_decided.
__device__ __forceinline__ void reply_a(const Args& a, int64_t base,
                                        unsigned epoch, Lane* l) {
  int g[kLanes], slot[kLanes], bal[kLanes], sender[kLanes];
  bool acked[kLanes], v[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // the lane inputs, all at once
    const int64_t i = base + (int64_t)k * kThreads;
    const bool on = i < a.B;
    g[k] = on ? __ldg(a.g + i) : 0;
    slot[k] = on ? __ldg(a.slot + i) : 0;
    bal[k] = on ? __ldg(a.bal + i) : 0;
    sender[k] = on ? __ldg(a.sender + i) : 0;
    acked[k] = on && flag(a.acked, a.flag_bytes, i);
    v[k] = on && flag(a.valid, a.flag_bytes, i);
  }
  bool ic[kLanes], ca[kLanes];
  int cb[kLanes];
  int4 col[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // the row gathers, all at once
    v[k] = v[k] && g[k] >= 0 && g[k] < a.G;
    l[k].row = v[k] ? g[k] : 0;
    l[k].w = v[k] ? gp::floor_mod(slot[k], a.W) : 0;
    ic[k] = __ldcg(a.is_coord + l[k].row) != 0;
    ca[k] = __ldcg(a.coord_active + l[k].row) != 0;
    cb[k] = __ldg(a.cbal + l[k].row);
    col[k] = __ldcg(a.prop + (size_t)l[k].row * a.W + l[k].w);
  }
  const size_t B = (size_t)a.B;
  int was[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // the votes and claims, all at once
    const int64_t i = base + (int64_t)k * kThreads;
    const bool match = v[k] && ic[k] && ca[k] && bal[k] == cb[k] &&
                       acked[k] && slot[k] >= 0 && col[k].x == slot[k];
    const int fresh = match && (gp::shift_right(col[k].w, sender[k]) & 1) == 0
                          ? gp::bit_of(sender[k])
                          : 0;
    int* vote = gp::vote_word(a.prop, a.W, l[k].row, l[k].w);
    l[k].pre = v[k] && ic[k] && !acked[k] && bal[k] > cb[k];
    l[k].cand = match && !emitted_before(col[k].w);
    was[k] = 0;
    if (l[k].cand)
      was[k] = atomicOr(vote, fresh | kClaim);
    else if (fresh)
      atomicAdd(vote, fresh);
    if (i < a.B) {
      a.out[B + i] = l[k].pre;
      a.out[2 * B + i] = cb[k];
      a.out[3 * B + i] = col[k].y;
      a.out[4 * B + i] = col[k].z;
      a.out[5 * B + i] = slot[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // a later candidate: a contest
    l[k].first = l[k].cand && (was[k] & kClaim) == 0;
    if (l[k].cand && !l[k].first) {
      atomicOr(gp::vote_word(a.prop, a.W, l[k].row, l[k].w), kContested);
      atomicMax(first_of(a, l[k].row, l[k].w),
                tag_of(epoch, base + (int64_t)k * kThreads));
      *a.contested = 1u;  // the same word from every such lane
    }
  }
}

// A later round's lanes: each one's flags into its own newly_decided word
// (its preempted word holds the other flag).
__device__ __forceinline__ void stash(const Args& a, int64_t base,
                                      const Lane* l) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    if (i < a.B)
      a.out[i] = (l[k].cand ? kStashCand : 0) |
                 (l[k].first ? kStashFirst : 0);
  }
}

__device__ __forceinline__ void unstash(const Args& a, int64_t base,
                                        Lane* l) {
  const size_t B = (size_t)a.B;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    l[k] = Lane{0, 0, false, false, false};
    if (i >= a.B) continue;
    const int f = __ldcg(a.out + i);
    l[k].cand = (f & kStashCand) != 0;
    l[k].first = (f & kStashFirst) != 0;
    l[k].pre = __ldcg(a.out + B + i) != 0;
    if (l[k].cand || l[k].pre) {  // a valid lane: its row is g
      l[k].row = __ldg(a.g + i);
      l[k].w = gp::floor_mod(__ldg(a.slot + i), a.W);
    }
  }
}

// Phase B of the lanes: a candidate counts its column's votes.  On a
// column no other candidate claimed it is newly decided iff past quorum,
// and it stores the column's vote word as the launch leaves it; on a
// contested one its first claimer enters its tag and each candidate
// defers to the second barrier.  A preempting lane resigns its row.
__device__ __forceinline__ void reply_b(const Args& a, int64_t base,
                                        unsigned epoch, const Lane* l) {
  int votes[kLanes], members[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {  // one round trip for every lane
    votes[k] = members[k] = 0;
    if (l[k].cand) {
      votes[k] = __ldcg(gp::vote_word(a.prop, a.W, l[k].row, l[k].w));
      members[k] = __ldg(a.members + l[k].row);
    }
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    if (i >= a.B) continue;
    const bool quorum = l[k].cand && __popc(votes[k] & kVoteMask) >=
                                         gp::floor_half(members[k]) + 1;
    int newly = 0;
    if (l[k].cand && (votes[k] & kContested) == 0) {  // the lone candidate
      newly = quorum;
      *gp::vote_word(a.prop, a.W, l[k].row, l[k].w) =
          settled(votes[k], quorum);
    } else if (l[k].cand) {
      if (l[k].first)
        atomicMax(first_of(a, l[k].row, l[k].w), tag_of(epoch, i));
      newly = quorum ? kDeferredQuorum : kDeferred;
    }
    a.out[i] = newly;
    if (l[k].pre) {
      a.is_coord[l[k].row] = 0;
      a.coord_active[l[k].row] = 0;
    }
  }
}

// After the second barrier, a contested candidate of lane i: newly
// decided iff it holds its column's largest tag (the first candidate in
// lane order) and the column reached quorum; that lane stores the
// column's vote word as the launch leaves it.
__device__ __forceinline__ void settle(const Args& a, int64_t i,
                                       unsigned epoch) {
  const int f = __ldcg(a.out + i);
  if (f < kDeferred) return;
  const int row = __ldg(a.g + i), w = gp::floor_mod(__ldg(a.slot + i), a.W);
  const bool first = __ldcg(first_of(a, row, w)) == tag_of(epoch, i);
  const bool quorum = f == kDeferredQuorum;
  if (first) {
    int* vote = gp::vote_word(a.prop, a.W, row, w);
    *vote = settled(__ldcg(vote), quorum);
  }
  a.out[i] = first && quorum;
}

__global__ void __launch_bounds__(kThreads, 4)
    accept_reply_grid_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  unsigned epoch = __ldcg(a.epoch) + 1u;
  if (epoch == 0) {  // wrapped: every tag from the last 2^32 - 1 calls
    const int64_t n = (int64_t)a.G * a.W;
    for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < n;
         k += (int64_t)gridDim.x * kThreads)
      a.first[k] = 0;
    grid.sync();
    epoch = 1;
  }
  const int64_t stride = (int64_t)gridDim.x * kBlockLanes;
  const int64_t base0 = (int64_t)blockIdx.x * kBlockLanes + threadIdx.x;
  Lane first[kLanes];
  reply_a(a, base0, epoch, first);
  for (int64_t base = base0 + stride; base < a.B; base += stride) {
    Lane l[kLanes];
    reply_a(a, base, epoch, l);
    stash(a, base, l);
  }
  grid.sync();  // every vote, claim, tag and flag read before phase B
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.epoch = epoch;
  const bool contest = __ldcg(a.contested) != 0;
  reply_b(a, base0, epoch, first);
  for (int64_t base = base0 + stride; base < a.B; base += stride) {
    Lane l[kLanes];
    unstash(a, base, l);
    reply_b(a, base, epoch, l);
  }
  if (!contest) return;  // no column had two candidates
  grid.sync();  // every tag before any contested candidate settles
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.contested = 0u;
  for (int64_t base = base0; base < a.B; base += stride)
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (base + (int64_t)k * kThreads < a.B)
        settle(a, base + (int64_t)k * kThreads, epoch);
}

// the launch floors: empty kernels at the two paths' geometries (one
// argument, as the launch helpers pass at least one)
__global__ void accept_reply_floor_kernel(int) {}

size_t chunk_smem(int B) { return gp::chunk_table_bytes(B, 1); }

}  // namespace

// The wide path's geometry (threads a block, lanes a thread), its
// co-resident block count on the current device (SMs x blocks an SM
// holds), and whether the device takes cooperative launches at all.
extern "C" int gp_accept_reply_limits(int* threads, int* lanes, int* blocks,
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
        &per_sm, accept_reply_grid_kernel, kThreads, 0);
  *threads = kThreads;
  *lanes = kLanes;
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

// The small path's geometry of a B-lane call (1 <= B <= 4096): CTAs (1, or
// one cluster) and threads a CTA.
extern "C" int gp_accept_reply_geometry(int B, int* ctas, int* threads) {
  if (B < 1 || B > gp::kChunkLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const gp::ChunkGeometry g = gp::chunk_geometry(B);
  *ctas = g.ctas;
  *threads = g.threads;
  return static_cast<int>(cudaSuccess);
}

// One call over B >= 1 lanes: the small path up to 4096 lanes (`first`,
// `epoch`, `contested` and `blocks` unused), else the wide path on `blocks`
// blocks.
extern "C" int gp_accept_reply(const void* g, const void* slot,
                               const void* bal, const void* sender,
                               const void* acked, const void* valid,
                               void* is_coord, void* coord_active,
                               const void* cbal, const void* members,
                               void* prop, void* out, void* first,
                               void* epoch, void* contested, int B, int G,
                               int W, int flag_bytes, int blocks,
                               void* stream) {
  if (B < 1 || G < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
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
         static_cast<unsigned long long*>(first),
         static_cast<unsigned*>(epoch),
         static_cast<unsigned*>(contested),
         B, G, W, flag_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (B <= gp::kChunkLanes) {
    e = gp::chunk_geometry(B).ctas > 1
            ? gp::launch_chunk(accept_reply_chunk_kernel<true>, B,
                               chunk_smem(B), st, a)
            : gp::launch_chunk(accept_reply_chunk_kernel<false>, B,
                               chunk_smem(B), st, a);
  } else {
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(accept_reply_grid_kernel), dim3(blocks),
        dim3(kThreads), args, 0, st);
  }
  const cudaError_t last = cudaGetLastError();  // clear the error state
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// An empty kernel launched as a B-lane call is: as the small path's CTA or
// cluster with its shared memory, or cooperative on `blocks` blocks.
extern "C" int gp_accept_reply_floor(int B, int blocks, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (B <= gp::kChunkLanes) {
    e = gp::launch_chunk(accept_reply_floor_kernel, B, chunk_smem(B), st, 0);
  } else {
    int unused = 0;
    void* args[] = {&unused};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(accept_reply_floor_kernel),
        dim3(blocks), dim3(kThreads), args, 0, st);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
