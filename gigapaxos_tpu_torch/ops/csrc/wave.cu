// The node runtime's two fused engine waves, written by hand for Hopper
// (sm_90a): one launch computes one <=4096-lane chunk of a wave.
//
// Replaces the XLA-jit bodies (outside Pallas) of gigapaxos_tpu/ops/kernels.py
// that ColumnarBackend drives once a worker batch:
// - acceptor_wave_kernel: accept_commit_packed (:644-656, jit accept_commit_p)
//   -- an accept batch, then a commit batch, on one state.  With no accept
//   lanes it is commit_packed (jit commit_p).
// - coordinator_wave_kernel: request_reply_packed (:629-641, jit
//   request_reply_p) -- propose_accept_self_packed (:560-593: propose, the
//   node's own accept on the granted lanes, its own vote), then
//   accept_reply_commit_self_packed (:596-616: the replies' votes, the own
//   commit of what they decided).  Either half alone is the jit of that half.
// The port's plain versions are the torch bodies of ops/kernels.py; the
// outputs are their packed [4|9, B] int32 rows, row for row, on every lane
// (padding lanes read row 0, as kernels.py:_gi gathers).
//
// Semantics.  A batch is one linearization, so each step is a scatter phase
// and a gather phase with a barrier between them; a one-pass kernel with
// atomics would let a lane read a row before another lane of the batch
// wrote it.  In order:
// - accept (accept_dev.cuh, shared with accept.cu): gather active,
//   exec_cursor and bal; raise bal[g] by atomicMax | barrier | read the
//   post-batch bal[g], decide, store acc[g, slot%W].
// - commit (commit_dev.cuh, shared with commit.cu): gather active and the
//   pre-batch exec_cursor, store dec[g, slot%W] = {slot, rlo, rhi} on
//   in-window lanes | barrier | the contiguity scan (adv = leading k < W
//   with dec[g,(cur+k)%W].slot == cur+k; the torch body's cumprod),
//   atomicMax exec_cursor[g] with cur+adv | barrier | read the new cursor.
// - propose: gather active, the coordinator flags, next_slot and
//   exec_cursor; the run rank of each lane among the earlier lanes of its
//   group (the stable lexsort of kernels.py:_run_rank) | barrier | slot =
//   next_slot + rank, throttled at exec_cursor + W; atomicAdd next_slot per
//   granted lane, store prop[g, slot%W] = {slot, rlo, rhi, 0}.
// - vote (accept_reply): gather the flags, cbal and the pre-batch prop
//   column; match on slot and ballot; atomicAdd the sender bit once per
//   fresh vote | barrier | re-gather the vote word, popcount against
//   members/2+1; dedup quorum lanes of one (g, slot) by run rank; atomicAdd
//   EMITTED_BIT once per column; a nack above cbal clears is_coord and
//   coord_active (vote_dev.cuh, whose geometry, barriers and run rank the
//   accept-reply kernel's small path shares).
// The coordinator wave runs propose, the own accept (granted lanes, ballot
// cbal), the own vote (reply ballot cbal if acked, else the promise), then
// the replies' vote and the commit of their newly decided lanes.  Each
// step's gather waits on its own scatter through a barrier; between two
// steps a barrier stands where a lane of the later step may touch a word
// another lane of the earlier one wrote: between the two halves (the second
// half's vote sees the first half's preemption), and between propose and
// the own vote (the prop columns), which the own accept's barrier is.  The
// other steps touch disjoint planes (accept: bal, acc; commit: dec,
// exec_cursor; vote: prop votes, flags), and each lane hands its outputs to
// the next step in registers.
//
// Bound.  Bytes: a live lane moves at most ~100-200 B (its packed inputs
// and outputs, its row's [G] words, one window column, and for a storing
// commit the dec slots its scan reads; chip_smoke.py's wave_bound_bytes
// counts what a run's data needs), under 1 MB at 4096 lanes, a fraction of
// a microsecond at 3.35 TB/s, and no arithmetic to speak of.  What bounds a
// chunk is latency: the launch, then a chain of dependent round trips to
// L2 or device memory and of barriers.  Each half gathers its lane inputs
// in one round trip and its row words in a second; then accept 1 round
// trip (bal after the raises) and 1 barrier; commit 2 (the scan, the new
// cursor) and 2 barriers; propose 2 barriers (the tables' clear, the run
// rank); vote 2 round trips (the column, the vote word) and 2 barriers.
// Both halves of a wave gather together (what the first half writes, the
// second re-reads after the barrier between them: the flags and the prop
// column).  Acceptor wave, both halves: 5 round trips, 4 barriers.
// Coordinator wave: 9 round trips, 10 barriers (7 in a one-warp CTA, which
// ranks without tables), and in a cluster up to 3 rounds of lookups in
// the other CTAs' tables.
//
// Design:
// - One lane a thread.  A chunk of at most kCtaLanes lanes runs as ONE CTA
//   of as many threads as lanes, rounded up to a warp (buckets 8, 64, 512:
//   32, 64, 512 threads); a larger one as ONE thread-block cluster of
//   kClusterCtas CTAs on neighbouring SMs (bucket 4096: 8 x 512), launched
//   with cudaLaunchKernelEx's cluster attribute.  The launch geometry is
//   gp_wave_geometry's; the wrapper checks it against its own.
// - Barriers: inside one CTA, __syncthreads alone (bar.sync orders the
//   CTA's memory operations; no fence).  Across a cluster, the hardware
//   cluster barrier (barrier.cluster.arrive.release / wait.acquire, through
//   cooperative_groups' cluster sync), not a grid sync.  Planes a wave
//   writes are read through L2 (__ldcg), the ones it only reads by the
//   read-only path.
// - The contiguity scan issues the kScan slot words of a row at once (W
//   independent loads, one round trip) and counts the leading matches; a
//   lane that advances nothing issues no atomic.  The commit step's lane
//   decision, store and advance are commit_dev.cuh's, which the storm's
//   commit kernel (commit.cu) shares.
// - The run rank without a sort: inside a warp __match_any_sync gives each
//   lane its peers, and __popc of the earlier peers its rank there.  One
//   leader a key and warp enters the key in the CTA's shared-memory hash
//   table (linear probing, 2x as many slots as threads), with a count of
//   its lanes in each warp.  After one barrier a lane's rank is its rank in
//   the warp, plus its key's lanes in the CTA's earlier warps (one table
//   read), plus, in a cluster, its key's lanes in the earlier CTAs: one
//   lookup in each of their tables through distributed shared memory, the
//   first probes of all of them issued together.  A key found in no other
//   warp or CTA adds nothing.  Lane order breaks no tie (the lanes of a key
//   are counted, never ordered), so the rank is the stable lexsort's, with
//   any mix of repeated keys, up to 4096 lanes on one row.  A one-warp CTA
//   (bucket 8) needs no table.
// - Each step keeps in registers what no earlier step of the wave can have
//   changed (its lane inputs, row, active, members, cbal, and the flags
//   before the first vote) and re-reads what an earlier step writes
//   (bal, exec_cursor after the commit's advance, the prop column and vote
//   word, next_slot) after the barrier that orders it.
//
// Registers, shared memory and spills (-Xptxas -v, sm_90a, CUDA 12.8): the
// acceptor wave 48 registers in one CTA and in a cluster (53 before its
// commit step became commit_dev.cuh's), the coordinator wave 48 in one CTA
// and 74 in a cluster (its lookups in the other CTAs' tables), the
// launch-floor kernel 4; no spills, no stack, no static
// shared memory.  The coordinator wave's tables are dynamic shared memory,
// 32 B a slot, twice as many slots as threads, a table for propose and the
// own vote with a request half and one for the replies' vote: 96 KB a CTA
// at 512 threads with both halves, 12 KB at 64, none at 32.
//
// Preconditions (as in kernels.py): at most one lane writes a given
// (row, slot) per batch; valid lanes name rows in [0, G) (a valid lane
// outside is treated as invalid, so the kernel never touches memory outside
// the state); a chunk holds at most 4096 lanes.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"
#include "commit_dev.cuh"
#include "vote_dev.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLanes = gp::kChunkLanes;  // lanes of a chunk, at most
constexpr int kCtaLanes = gp::kCtaLanes;    // a chunk up to this many is one
                                            // CTA
constexpr int kClusterCtas = gp::kClusterCtas;  // a larger one, one cluster
constexpr int kScan = 16;  // dec slot words a scan loads at once
using gp::RankSlot;
using gp::run_rank;
using gp::table_cap;
using gp::VoteLane;
using gp::VoteOut;
using gp::vote_step;

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ bool in_range(int g, int G) {
  return g >= 0 && g < G;
}

struct Planes {
  const uint8_t* active;
  const int* members;
  int* bal;
  int4* acc;  // [G, W] of {slot, bal, rlo, rhi}
  int* dec;   // [G, W, 3] of {slot, rlo, rhi}
  int* cursor;  // exec_cursor
  uint8_t* is_coord;
  uint8_t* coord_active;
  const int* cbal;
  int* next_slot;
  int4* prop;  // [G, W] of {slot, rlo, rhi, votes}
  int G, W;
};

// One half of a wave: the packed input [k+1, B] (valid mask last) and its
// output [m, B]; B = 0 for an empty half.
struct Half {
  const int* in;
  int* out;
  int B;
};

// ---- the steps -------------------------------------------------------------

// an accept lane: its row (0 unless valid), live (valid and active), its
// slot, ballot and request id, and its row's exec_cursor and bal as read
// before any raise of the batch
struct AcceptLane {
  int row, slot, bal, rlo, rhi, cur, seen;
  bool live;
};

// a lane of a packed accept input [6, B]: g, slot, bal, rlo, rhi, valid
__device__ AcceptLane accept_lane(const Planes& s, const int* in, int B,
                                  int i) {
  AcceptLane a;
  const int g = __ldg(in + i);
  const bool v = __ldg(in + 5 * B + i) != 0 && in_range(g, s.G);
  a.row = v ? g : 0;
  a.slot = __ldg(in + B + i);
  a.bal = __ldg(in + 2 * B + i);
  a.rlo = __ldg(in + 3 * B + i);
  a.rhi = __ldg(in + 4 * B + i);
  a.live = v && __ldg(s.active + a.row) != 0;
  a.cur = __ldcg(s.cursor + a.row);
  a.seen = __ldcg(s.bal + a.row);
  return a;
}

// accept: the raise | barrier | the decision against bal[row] after the
// whole batch (*cb), and the store
template <bool kCl>
__device__ gp::AcceptDecision accept_step(const Planes& s, bool on,
                                          const AcceptLane& a, int* cb) {
  if (on) gp::accept_raise(s.bal, a.row, a.live, a.bal, a.seen);
  gp::chunk_barrier<kCl>();  // every raise of the batch before any
                             // decision
  gp::AcceptDecision d{};
  *cb = 0;
  if (on) {
    *cb = __ldcg(s.bal + a.row);
    d = gp::accept_decide(a.live, a.bal, a.slot, a.cur, *cb, s.W);
    if (d.store)
      gp::accept_store(s.acc, a.row, s.W, a.slot, a.bal, a.rlo, a.rhi);
  }
  return d;
}

// a commit lane: its row (0 unless valid), live (valid and active), slot,
// request id, and its row's exec_cursor before the batch
struct CommitLane {
  int row, slot, rlo, rhi, cur;
  bool live;
};

// a lane of a packed commit input [5, B]: g, slot, rlo, rhi, valid
__device__ CommitLane commit_lane(const Planes& s, const int* in, int B,
                                  int i) {
  CommitLane c;
  const int g = __ldg(in + i);
  const bool v = __ldg(in + 4 * B + i) != 0 && in_range(g, s.G);
  c.row = v ? g : 0;
  c.slot = __ldg(in + B + i);
  c.rlo = __ldg(in + 2 * B + i);
  c.rhi = __ldg(in + 3 * B + i);
  c.live = v && __ldg(s.active + c.row) != 0;
  c.cur = __ldcg(s.cursor + c.row);
  return c;
}

// commit: the stores | barrier | the scan and advance | barrier | the new
// cursor; outputs applied, stale, out_window (where given), new_cursor
template <bool kCl>
__device__ void commit_step(const Planes& s, bool on, const CommitLane& c,
                            int i, int* o_applied, int* o_stale, int* o_ow,
                            int* o_cursor) {
  const gp::CommitDecision d = gp::commit_decide(on && c.live, c.slot, c.cur,
                                                 s.W);
  if (on) {
    o_applied[i] = d.store;
    o_stale[i] = d.stale;
    if (o_ow) o_ow[i] = d.out_window;
    if (d.store) gp::commit_store(s.dec, c.row, s.W, c.slot, c.rlo, c.rhi);
  }
  gp::chunk_barrier<kCl>();  // every store of the batch before any scan
  if (d.store)
    gp::commit_advance<kScan>(s.cursor, s.dec, c.row, c.cur, s.W);
  gp::chunk_barrier<kCl>();  // every advance before any read of the new
                             // cursor
  if (on) o_cursor[i] = __ldcg(s.cursor + c.row);
}

// ---- the halves of the coordinator wave ------------------------------------

// a propose input [5, B] (g, rlo, rhi, self_midx, valid): propose, the own
// accept, the own vote; out [9, B]: granted, rejected, throttled, slot,
// cbal, self_acked, newly_decided, preempted, acc_cur_bal
template <bool kCl>
__device__ void request_half(const Planes& s, const Half& h, int i,
                             RankSlot* t_prop, RankSlot* t_vote, int cap) {
  const int B = h.B;
  const int* in = h.in;
  int* out = h.out;
  const bool on = i < B;
  int g = 0, rlo = 0, rhi = 0, smidx = 0, row = 0;
  int ns = 0, cur = 0, cb = 0, seen = 0, members = 0;
  bool v = false, act = false, ic = false, ca = false;
  if (on) {
    g = __ldg(in + i);
    rlo = __ldg(in + B + i);
    rhi = __ldg(in + 2 * B + i);
    smidx = __ldg(in + 3 * B + i);
    v = __ldg(in + 4 * B + i) != 0 && in_range(g, s.G);
    row = v ? g : 0;
    act = __ldg(s.active + row) != 0;
    ic = __ldcg(s.is_coord + row) != 0;
    ca = __ldcg(s.coord_active + row) != 0;
    ns = __ldcg(s.next_slot + row);
    cur = __ldcg(s.cursor + row);
    cb = __ldg(s.cbal + row);
    seen = __ldcg(s.bal + row);
    members = __ldg(s.members + row);
  }
  // propose
  const bool coord = ic && ca;
  const bool can = v && act && coord;
  __syncthreads();  // the tables cleared before any entry
  const int rank = run_rank<kCl>(t_prop, cap, can, (unsigned)g);
  // (run_rank's barrier, or in a one-warp CTA the one above: every
  // next_slot read before any add)
  const int slot = gp::add_wrap(ns, rank);
  const bool in_win = slot < gp::add_wrap(cur, s.W);
  const bool granted = can && in_win;
  if (on) {
    out[i] = granted;
    out[B + i] = v && act && !coord;
    out[2 * B + i] = can && !in_win;
    out[3 * B + i] = slot;
    out[4 * B + i] = cb;
    if (granted) {
      atomicAdd(s.next_slot + row, 1);
      s.prop[(size_t)row * s.W + gp::floor_mod(slot, s.W)] =
          make_int4(slot, rlo, rhi, 0);
    }
  }
  // the own accept of the granted lanes at cbal (a granted lane is valid
  // and active, so its row words above are its accept's)
  const AcceptLane a{granted ? row : 0, slot, cb, rlo, rhi, cur, seen,
                     granted};
  int cb_after;
  const gp::AcceptDecision d = accept_step<kCl>(s, on, a, &cb_after);
  if (on) {
    out[5 * B + i] = d.acked;
    out[8 * B + i] = cb_after;
  }
  // the own vote (its barrier above is the accept's: every propose store
  // before any column read); the flags are as propose read them, since no
  // vote has run yet
  const VoteLane l{a.row, granted ? gp::floor_mod(slot, s.W) : 0, slot,
                   d.acked ? cb : cb_after, smidx, cb, members,
                   granted, ic, ca, d.acked};
  const VoteOut o = vote_step<kCl>(s, on, l, t_vote, cap);
  if (on) {
    out[6 * B + i] = o.newly;
    out[7 * B + i] = o.pre;
  }
}

// a lane of a reply input [6, B] (g, slot, bal, sender, acked, valid):
// the vote lane without its flags, and the row words of the commit of a
// lane the vote decides (its row is then this one)
struct ReplyLane {
  VoteLane l;
  bool act;
  int cur;
};

// the words a reply lane reads that the request half cannot change: its
// inputs, cbal and members, and for the commit active and exec_cursor
// (only the commit writes exec_cursor)
__device__ ReplyLane reply_lane(const Planes& s, const int* in, int B, int i) {
  ReplyLane r{};
  VoteLane& l = r.l;
  const int g = __ldg(in + i);
  l.slot = __ldg(in + B + i);
  l.bal = __ldg(in + 2 * B + i);
  l.sender = __ldg(in + 3 * B + i);
  l.acked = __ldg(in + 4 * B + i) != 0;
  l.v = __ldg(in + 5 * B + i) != 0 && in_range(g, s.G);
  l.row = l.v ? g : 0;
  l.w = l.v ? gp::floor_mod(l.slot, s.W) : 0;
  l.cb = __ldg(s.cbal + l.row);
  l.members = __ldg(s.members + l.row);
  r.act = __ldg(s.active + l.row) != 0;
  r.cur = __ldcg(s.cursor + l.row);
  return r;
}

// the replies' vote, then the commit of what they newly decided; out
// [9, B]: newly_decided, preempted, dec_bal, req_lo, req_hi, dec_slot,
// applied, stale, new_cursor.  The flags are read here, after the barrier
// between the halves.
template <bool kCl>
__device__ void reply_half(const Planes& s, const Half& h, int i,
                           ReplyLane r, RankSlot* t_vote, int cap) {
  const int B = h.B;
  int* out = h.out;
  const bool on = i < B;
  VoteLane& l = r.l;
  if (on) {
    l.ic = __ldcg(s.is_coord + l.row) != 0;
    l.ca = __ldcg(s.coord_active + l.row) != 0;
  }
  const VoteOut o = vote_step<kCl>(s, on, l, t_vote, cap);
  if (on) {
    out[i] = o.newly;
    out[B + i] = o.pre;
    out[2 * B + i] = l.cb;
    out[3 * B + i] = o.col.y;
    out[4 * B + i] = o.col.z;
    out[5 * B + i] = l.slot;
  }
  // the newly decided lanes commit {slot, req_lo, req_hi}
  const CommitLane c{o.newly ? l.row : 0, l.slot, o.col.y, o.col.z, r.cur,
                     o.newly && r.act};
  commit_step<kCl>(s, on, c, i, out + 6 * B, out + 7 * B, nullptr,
                   out + 8 * B);
}

// ---- the kernels -------------------------------------------------------------

template <bool kCl>
__global__ void __launch_bounds__(kCtaLanes, 1)
    acceptor_wave_kernel(Planes s, Half acc, Half com) {
  const int i = lane_index();
  // both halves' lane inputs and row words first: the accept touches
  // neither dec nor exec_cursor, so the commit's pre-batch cursor is the
  // cursor at launch
  const bool a_on = i < acc.B, c_on = i < com.B;
  AcceptLane a{};
  CommitLane c{};
  if (a_on) a = accept_lane(s, acc.in, acc.B, i);
  if (c_on) c = commit_lane(s, com.in, com.B, i);
  if (acc.B > 0) {
    int cb;
    const gp::AcceptDecision d = accept_step<kCl>(s, a_on, a, &cb);
    if (a_on) {
      const int B = acc.B;
      acc.out[i] = d.acked;
      acc.out[B + i] = d.stale;
      acc.out[2 * B + i] = d.out_window;
      acc.out[3 * B + i] = cb;
    }
  }
  if (acc.B > 0 && com.B > 0)
    gp::chunk_barrier<kCl>();  // between the halves
  if (com.B > 0) {
    const int B = com.B;
    commit_step<kCl>(s, c_on, c, i, com.out, com.out + B, com.out + 2 * B,
                     com.out + 3 * B);
  }
}

template <bool kCl>
__global__ void __launch_bounds__(kCtaLanes, 1)
    coordinator_wave_kernel(Planes s, Half req, Half rep) {
  extern __shared__ RankSlot tabs[];  // propose, own vote, replies' vote
  const int cap = table_cap(blockDim.x);
  const int own = req.B > 0 ? 2 : 0;
  if (gp::needs_tables(kCl ? kClusterCtas : 1, blockDim.x))
    gp::clear_tables(tabs, (own + (rep.B > 0 ? 1 : 0)) * cap);
  const int i = lane_index();
  ReplyLane r{};  // gathered with the request half's words
  if (i < rep.B) r = reply_lane(s, rep.in, rep.B, i);
  if (req.B > 0) request_half<kCl>(s, req, i, tabs, tabs + cap, cap);
  if (req.B > 0 && rep.B > 0)
    gp::chunk_barrier<kCl>();  // between the halves: the replies' vote
                               // sees the own vote's resignations
  if (rep.B > 0) {
    reply_half<kCl>(s, rep, i, r, tabs + own * cap, cap);
  } else if constexpr (kCl) {
    gp::chunk_barrier<kCl>();  // no CTA leaves while another reads its table
  }
}

// the launch floor: an empty kernel at a wave's geometry and shared memory
// (one argument, as the launch helper passes at least one)
__global__ void wave_floor_kernel(int) {}

Planes planes(const void* active, const void* members, void* bal, void* acc,
              void* dec, void* cursor, void* is_coord, void* coord_active,
              const void* cbal, void* next_slot, void* prop, int G, int W) {
  return Planes{static_cast<const uint8_t*>(active),
                static_cast<const int*>(members),
                static_cast<int*>(bal),
                static_cast<int4*>(acc),
                static_cast<int*>(dec),
                static_cast<int*>(cursor),
                static_cast<uint8_t*>(is_coord),
                static_cast<uint8_t*>(coord_active),
                static_cast<const int*>(cbal),
                static_cast<int*>(next_slot),
                static_cast<int4*>(prop),
                G,
                W};
}

bool bad_half(int B) { return B < 0 || B > kMaxLanes; }

// shared memory of a launch over B lanes with `tables` run-rank tables
size_t table_bytes(int B, int tables) {
  return gp::chunk_table_bytes(B, tables);
}

// the most shared memory a launch takes: three tables at kCtaLanes threads
constexpr size_t kMaxTableBytes =
    3 * (2 * kCtaLanes) * sizeof(RankSlot);

// Lift the 48 KB default of dynamic shared memory, once a process.
cudaError_t allow_tables() {
  static const cudaError_t e = [] {
    const void* kernels[] = {
        reinterpret_cast<const void*>(coordinator_wave_kernel<false>),
        reinterpret_cast<const void*>(coordinator_wave_kernel<true>),
        reinterpret_cast<const void*>(wave_floor_kernel)};
    for (const void* k : kernels) {
      const cudaError_t r = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kMaxTableBytes);
      if (r != cudaSuccess) return r;
    }
    return cudaSuccess;
  }();
  return e;
}

// Launch `kernel` over B lanes: one CTA, or one cluster of kClusterCtas.
template <class... Args>
cudaError_t launch(void (*kernel)(Args...), int B, size_t smem,
                   cudaStream_t stream, Args... args) {
  return gp::launch_chunk(kernel, B, smem, stream, args...);
}

}  // namespace

// The launch geometry of a B-lane chunk: CTAs (1, or one cluster) and
// threads a CTA.
extern "C" int gp_wave_geometry(int B, int* ctas, int* threads) {
  if (B < 1 || B > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  const gp::ChunkGeometry g = gp::chunk_geometry(B);
  *ctas = g.ctas;
  *threads = g.threads;
  return static_cast<int>(cudaSuccess);
}

// Planes, in this order: active, members, bal, acc, dec, exec_cursor,
// is_coord, coord_active, cbal, next_slot, prop.
extern "C" int gp_acceptor_wave(const void* acc_in, void* acc_out, int Ba,
                                const void* com_in, void* com_out, int Bc,
                                const void* active, const void* members,
                                void* bal, void* acc, void* dec, void* cursor,
                                void* is_coord, void* coord_active,
                                const void* cbal, void* next_slot, void* prop,
                                int G, int W, void* stream) {
  if (bad_half(Ba) || bad_half(Bc) || Ba + Bc == 0 || W < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes s = planes(active, members, bal, acc, dec, cursor, is_coord,
                    coord_active, cbal, next_slot, prop, G, W);
  const int B = Ba > Bc ? Ba : Bc;
  Half a{static_cast<const int*>(acc_in), static_cast<int*>(acc_out), Ba};
  Half c{static_cast<const int*>(com_in), static_cast<int*>(com_out), Bc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = gp::chunk_geometry(B).ctas > 1
                      ? launch(acceptor_wave_kernel<true>, B, 0, st, s, a, c)
                      : launch(acceptor_wave_kernel<false>, B, 0, st, s, a, c);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int gp_coordinator_wave(const void* req_in, void* req_out, int Bq,
                                   const void* rep_in, void* rep_out, int Br,
                                   const void* active, const void* members,
                                   void* bal, void* acc, void* dec,
                                   void* cursor, void* is_coord,
                                   void* coord_active, const void* cbal,
                                   void* next_slot, void* prop, int G, int W,
                                   void* stream) {
  if (bad_half(Bq) || bad_half(Br) || Bq + Br == 0 || W < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_tables();
  if (e != cudaSuccess) return static_cast<int>(e);
  Planes s = planes(active, members, bal, acc, dec, cursor, is_coord,
                    coord_active, cbal, next_slot, prop, G, W);
  const int B = Bq > Br ? Bq : Br;
  const size_t smem = table_bytes(B, (Bq > 0 ? 2 : 0) + (Br > 0 ? 1 : 0));
  Half q{static_cast<const int*>(req_in), static_cast<int*>(req_out), Bq};
  Half r{static_cast<const int*>(rep_in), static_cast<int*>(rep_out), Br};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = gp::chunk_geometry(B).ctas > 1
          ? launch(coordinator_wave_kernel<true>, B, smem, st, s, q, r)
          : launch(coordinator_wave_kernel<false>, B, smem, st, s, q, r);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// The launch floor of a B-lane chunk: an empty kernel at its geometry, with
// the shared memory of `tables` run-rank tables (0 for the acceptor wave,
// 3 for a coordinator wave with both halves).
extern "C" int gp_wave_floor(int B, int tables, void* stream) {
  if (B < 1 || B > kMaxLanes || tables < 0 || tables > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_tables();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch(wave_floor_kernel, B, table_bytes(B, tables),
             static_cast<cudaStream_t>(stream), 0);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
