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
// - commit: gather active and the pre-batch exec_cursor, store
//   dec[g, slot%W] = {slot, rlo, rhi} on in-window lanes | barrier | the
//   contiguity scan (adv = leading k < W with dec[g,(cur+k)%W].slot ==
//   cur+k; the torch body's cumprod), atomicMax exec_cursor[g] with cur+adv
//   | barrier | read the new cursor.
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
//   coord_active | barrier (the next step sees the preemption).
// The coordinator wave runs propose, the own accept (granted lanes, ballot
// cbal), the own vote (reply ballot cbal if acked, else the promise), then
// the replies' vote and the commit of their newly decided lanes.  The two
// halves touch disjoint window columns (the JAX docstring's window
// argument); the barrier between them keeps the composition exact anyway.
//
// Bound: device-memory bytes and latency.  A live lane moves at most
// ~100-200 B (its packed inputs and outputs, its row's [G] words, one
// window column, and for a storing commit the dec slots its scan reads;
// chip_smoke.py's wave_bound_bytes counts what a run's data needs), well
// under 1 MB at 4096 lanes, a fraction of a microsecond at 3.35 TB/s, and
// no arithmetic to speak of.  What bounds a runtime chunk is latency: the
// launch, and a dozen dependent round trips to L2 and device memory across
// the barriers, plus the run-rank sorts.
//
// Design: ONE CTA per chunk (1024 threads, each owning lanes tid, tid+1024,
// tid+2048, tid+3072), so every barrier is __syncthreads (a __threadfence
// first, so plain stores have reached L2 before other threads read them
// with ld.cg) and no cooperative launch is needed.  The run rank is a
// bitonic sort in shared memory of the masked lanes' (key, lane) pairs,
// compacted first, so the sort is as long as the lanes it ranks (none for
// fewer than two); lane order breaks ties, which makes the rank the stable
// sort's.  A lane's rank is its sorted position minus the first position
// of its key.  Planes a wave writes are read with __ldcg (L2, coherent
// across the CTA's threads), the ones it only reads by the read-only path.
// Lane inputs are read where used rather than held, to keep each thread
// within the 64 registers that 1024 threads leave it.
//
// Preconditions (as in kernels.py): at most one lane writes a given
// (row, slot) per batch; valid lanes name rows in [0, G) (a valid lane
// outside is treated as invalid, so the kernel never touches memory outside
// the state); a chunk holds at most 4096 lanes.
//
// C interface for ctypes: every pointer and the stream as void*, each
// function returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = 4096;
constexpr int kLPT = kMaxLanes / kThreads;  // lanes a thread owns
constexpr int kEmitted = 1 << 30;           // types.py EMITTED_BIT
constexpr int kVoteMask = kEmitted - 1;

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

struct SortSmem {
  unsigned long long key[kMaxLanes];
  unsigned short lane[kMaxLanes];
  int n;
};

__device__ __forceinline__ int lane_of(int k) {
  return threadIdx.x + k * kThreads;
}

__device__ __forceinline__ bool in_range(int g, int G) {
  return g >= 0 && g < G;
}

// A barrier after which every thread of the CTA reads, through L2, what
// any thread stored before it.
__device__ __forceinline__ void phase_barrier() {
  __threadfence();
  __syncthreads();
}

__device__ __forceinline__ int* vote_word(const Planes& s, int row, int w) {
  return reinterpret_cast<int*>(s.prop + (size_t)row * s.W + w) + 3;
}

// rank[k] = the number of earlier lanes with mask set and the same key,
// for each masked lane k the thread owns (0 for the others).  Every thread
// of the CTA calls it; it starts and ends with a barrier.
__device__ void run_rank(SortSmem& sm, const bool (&mask)[kLPT],
                         const unsigned long long (&key)[kLPT],
                         int (&rank)[kLPT]) {
  const int tid = threadIdx.x;
  if (tid == 0) sm.n = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    rank[k] = 0;
    if (mask[k]) {
      int p = atomicAdd(&sm.n, 1);
      sm.key[p] = key[k];
      sm.lane[p] = (unsigned short)lane_of(k);
    }
  }
  __syncthreads();
  const int n = sm.n;
  if (n < 2) {  // uniform: no two lanes to order
    __syncthreads();
    return;
  }
  int N = 2;
  while (N < n) N <<= 1;
  for (int p = n + tid; p < N; p += kThreads) {
    sm.key[p] = ~0ull;  // no masked key is this large (g < 2^31)
    sm.lane[p] = 0xffff;
  }
  __syncthreads();
  // bitonic sort, ascending by (key, lane); all of a pair's moves are made
  // by the thread that owns its lower index
  for (int size = 2; size <= N; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N; i += kThreads) {
        int l = i ^ j;
        if (l > i) {
          unsigned long long ka = sm.key[i], kb = sm.key[l];
          unsigned short la = sm.lane[i], lb = sm.lane[l];
          bool a_after_b = ka > kb || (ka == kb && la > lb);
          if (a_after_b == ((i & size) == 0)) {
            sm.key[i] = kb;
            sm.key[l] = ka;
            sm.lane[i] = lb;
            sm.lane[l] = la;
          }
        }
      }
      __syncthreads();
    }
  }
  int got_lane[kLPT], got_rank[kLPT];
#pragma unroll
  for (int j = 0; j < kLPT; ++j) {
    int p = tid + j * kThreads;
    got_lane[j] = -1;
    if (p < n) {
      unsigned long long kp = sm.key[p];
      int lo = 0, hi = p;  // the first sorted position holding kp
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (sm.key[mid] < kp) lo = mid + 1; else hi = mid;
      }
      got_lane[j] = sm.lane[p];
      got_rank[j] = p - lo;
    }
  }
  __syncthreads();
  int* rank_of = reinterpret_cast<int*>(sm.key);  // lane -> rank
#pragma unroll
  for (int j = 0; j < kLPT; ++j)
    if (got_lane[j] >= 0) rank_of[got_lane[j]] = got_rank[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kLPT; ++k)
    if (mask[k]) rank[k] = rank_of[lane_of(k)];
  __syncthreads();
}

// ---- lane sources: where a step's per-lane inputs come from --------------

// accept lanes of a packed accept input [6, B]: g, slot, bal, rlo, rhi, valid
struct AcceptIn {
  const int* in;
  int B;
  __device__ int g(int i) const { return __ldg(in + i); }
  __device__ int slot(int i) const { return __ldg(in + B + i); }
  __device__ int bal(int i) const { return __ldg(in + 2 * B + i); }
  __device__ int rlo(int i) const { return __ldg(in + 3 * B + i); }
  __device__ int rhi(int i) const { return __ldg(in + 4 * B + i); }
  __device__ bool valid(int i) const { return __ldg(in + 5 * B + i) != 0; }
};

// the coordinator's own accept: a propose input [5, B] (g, rlo, rhi,
// self_midx, valid) and the rows the propose step wrote (granted, slot,
// cbal), read back by the thread that wrote them
struct SelfAccept {
  const int* in;
  const int* out;
  int B;
  __device__ int g(int i) const { return __ldg(in + i); }
  __device__ int slot(int i) const { return out[3 * B + i]; }
  __device__ int bal(int i) const { return out[4 * B + i]; }
  __device__ int rlo(int i) const { return __ldg(in + B + i); }
  __device__ int rhi(int i) const { return __ldg(in + 2 * B + i); }
  __device__ bool valid(int i) const { return out[i] != 0; }
};

// reply lanes of a packed reply input [6, B]: g, slot, bal, sender,
// acked, valid
struct ReplyIn {
  const int* in;
  int B;
  __device__ int g(int i) const { return __ldg(in + i); }
  __device__ int slot(int i) const { return __ldg(in + B + i); }
  __device__ int bal(int i) const { return __ldg(in + 2 * B + i); }
  __device__ int sender(int i) const { return __ldg(in + 3 * B + i); }
  __device__ bool acked(int i) const { return __ldg(in + 4 * B + i) != 0; }
  __device__ bool valid(int i) const { return __ldg(in + 5 * B + i) != 0; }
};

// the coordinator's own vote on its granted lanes: ballot cbal where its
// accept acked, else the promise it met (rows 3, 4, 5, 8 of the propose
// half's output)
struct SelfVote {
  const int* in;
  const int* out;
  int B;
  __device__ int g(int i) const { return __ldg(in + i); }
  __device__ int slot(int i) const { return out[3 * B + i]; }
  __device__ int bal(int i) const {
    return acked(i) ? out[4 * B + i] : out[8 * B + i];
  }
  __device__ int sender(int i) const { return __ldg(in + 3 * B + i); }
  __device__ bool acked(int i) const { return out[5 * B + i] != 0; }
  __device__ bool valid(int i) const { return out[i] != 0; }
};

// commit lanes: g, slot, rlo, rhi and valid, each a [B] row
struct CommitIn {
  const int* g;
  const int* slot;
  const int* rlo;
  const int* rhi;
  const int* valid;
};

// ---- the steps -----------------------------------------------------------

// accept: outputs acked, stale, out_window and cur_bal where the pointers
// are given
template <class Src>
__device__ void accept_step(const Planes& s, const Src& src, int B,
                            int* o_acked, int* o_stale, int* o_ow,
                            int* o_cur) {
  int row[kLPT], cur[kLPT];
  bool live[kLPT];
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    row[k] = 0;
    cur[k] = 0;
    live[k] = false;
    if (i < B) {
      int g = src.g(i);
      bool v = src.valid(i) && in_range(g, s.G);
      row[k] = v ? g : 0;
      live[k] = v && __ldg(s.active + row[k]) != 0;
      cur[k] = __ldcg(s.cursor + row[k]);
      int seen = __ldcg(s.bal + row[k]);
      gp::accept_raise(s.bal, row[k], live[k], src.bal(i), seen);
    }
  }
  phase_barrier();  // every raise of the batch before any decision
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    if (i >= B) continue;
    int cb = __ldcg(s.bal + row[k]);
    int slot = src.slot(i), lane_bal = src.bal(i);
    gp::AcceptDecision d =
        gp::accept_decide(live[k], lane_bal, slot, cur[k], cb, s.W);
    if (d.store)
      gp::accept_store(s.acc, row[k], s.W, slot, lane_bal, src.rlo(i),
                       src.rhi(i));
    o_acked[i] = d.acked;
    if (o_stale) o_stale[i] = d.stale;
    if (o_ow) o_ow[i] = d.out_window;
    o_cur[i] = cb;
  }
  phase_barrier();
}

// commit: outputs applied, stale, out_window (where given), new_cursor
__device__ void commit_step(const Planes& s, const CommitIn& in, int B,
                            int* o_applied, int* o_stale, int* o_ow,
                            int* o_cursor) {
  int row[kLPT], cur[kLPT];
  bool store[kLPT];
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    row[k] = 0;
    cur[k] = 0;
    store[k] = false;
    if (i >= B) continue;
    int g = in.g[i];
    bool v = in.valid[i] != 0 && in_range(g, s.G);
    row[k] = v ? g : 0;
    bool act = __ldg(s.active + row[k]) != 0;
    cur[k] = __ldcg(s.cursor + row[k]);
    int slot = in.slot[i];
    int hi = gp::add_wrap(cur[k], s.W);
    store[k] = v && act && slot >= cur[k] && slot < hi;
    o_applied[i] = store[k];
    o_stale[i] = v && act && slot < cur[k];
    if (o_ow) o_ow[i] = v && act && slot >= hi;
    if (store[k]) {
      int* d = s.dec + ((size_t)row[k] * s.W + gp::floor_mod(slot, s.W)) * 3;
      d[0] = slot;
      d[1] = in.rlo[i];
      d[2] = in.rhi[i];
    }
  }
  phase_barrier();  // every store of the batch before any scan
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    if (!store[k]) continue;
    const int* drow = s.dec + (size_t)row[k] * s.W * 3;
    int adv = 0;
    for (; adv < s.W; ++adv) {
      int want = gp::add_wrap(cur[k], adv);
      if (__ldcg(drow + gp::floor_mod(want, s.W) * 3) != want) break;
    }
    atomicMax(s.cursor + row[k], gp::add_wrap(cur[k], adv));
  }
  phase_barrier();  // every advance before any read of the new cursor
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    if (i < B) o_cursor[i] = __ldcg(s.cursor + row[k]);
  }
}

// propose over a propose input [5, B]: writes rows 0-4 of `out` (granted,
// rejected, throttled, slot, cbal)
__device__ void propose_step(const Planes& s, SortSmem& sm, const int* in,
                             int B, int* out) {
  int row[kLPT], ns[kLPT], cur[kLPT];
  bool can[kLPT];
  unsigned long long key[kLPT];
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    row[k] = ns[k] = cur[k] = 0;
    can[k] = false;
    key[k] = 0;
    if (i >= B) continue;
    int g = __ldg(in + i);
    bool v = __ldg(in + 4 * B + i) != 0 && in_range(g, s.G);
    row[k] = v ? g : 0;
    bool act = __ldg(s.active + row[k]) != 0;
    bool coord = __ldcg(s.is_coord + row[k]) != 0 &&
                 __ldcg(s.coord_active + row[k]) != 0;
    can[k] = v && act && coord;
    ns[k] = __ldcg(s.next_slot + row[k]);
    cur[k] = __ldcg(s.cursor + row[k]);
    key[k] = (unsigned)g;
    out[B + i] = v && act && !coord;
    out[4 * B + i] = __ldg(s.cbal + row[k]);
  }
  int rank[kLPT];
  run_rank(sm, can, key, rank);  // every next_slot read before any add
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    if (i >= B) continue;
    int slot = gp::add_wrap(ns[k], rank[k]);
    bool in_win = slot < gp::add_wrap(cur[k], s.W);
    bool granted = can[k] && in_win;
    out[i] = granted;
    out[2 * B + i] = can[k] && !in_win;
    out[3 * B + i] = slot;
    if (granted) {
      atomicAdd(s.next_slot + row[k], 1);
      s.prop[(size_t)row[k] * s.W + gp::floor_mod(slot, s.W)] =
          make_int4(slot, __ldg(in + B + i), __ldg(in + 2 * B + i), 0);
    }
  }
  phase_barrier();
}

// vote (accept_reply): writes newly_decided and preempted, and where given
// dec_bal, req_lo, req_hi and dec_slot
template <class Src>
__device__ void vote_step(const Planes& s, SortSmem& sm, const Src& src,
                          int B, int* o_newly, int* o_pre, int* o_decbal,
                          int* o_rlo, int* o_rhi, int* o_slot) {
  int row[kLPT], w[kLPT], prev[kLPT];
  bool match[kLPT], pre[kLPT];
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    row[k] = w[k] = prev[k] = 0;
    match[k] = pre[k] = false;
    if (i >= B) continue;
    int g = src.g(i), slot = src.slot(i);
    bool v = src.valid(i) && in_range(g, s.G);
    row[k] = v ? g : 0;
    w[k] = v ? gp::floor_mod(slot, s.W) : 0;
    bool ic = __ldcg(s.is_coord + row[k]) != 0;
    bool ca = __ldcg(s.coord_active + row[k]) != 0;
    int cb = __ldg(s.cbal + row[k]);
    int bal = src.bal(i);
    bool acked = src.acked(i);
    int4 pc = __ldcg(s.prop + (size_t)row[k] * s.W + w[k]);  // pre-batch
    match[k] = v && ic && ca && bal == cb && acked && slot >= 0 &&
               pc.x == slot;
    prev[k] = pc.w;
    int sender = src.sender(i);
    if (match[k] && ((prev[k] >> sender) & 1) == 0)
      atomicAdd(vote_word(s, row[k], w[k]), 1 << sender);
    pre[k] = v && ic && !acked && bal > cb;
    if (o_decbal) {
      o_decbal[i] = cb;
      o_rlo[i] = pc.y;
      o_rhi[i] = pc.z;
      o_slot[i] = slot;
    }
  }
  phase_barrier();  // every vote before any re-gather, every flag read
                    // before any resign
  bool quorum[kLPT];
  unsigned long long key[kLPT];
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    quorum[k] = false;
    key[k] = 0;
    if (!match[k]) continue;
    const int i = lane_of(k);
    int cnt = __popc(__ldcg(vote_word(s, row[k], w[k])) & kVoteMask);
    quorum[k] = cnt >= gp::floor_half(__ldg(s.members + row[k])) + 1;
    key[k] = ((unsigned long long)(unsigned)row[k] << 32) |
             (unsigned)src.slot(i);
  }
  int rank[kLPT];
  run_rank(sm, quorum, key, rank);  // the first quorum lane of a column
#pragma unroll
  for (int k = 0; k < kLPT; ++k) {
    const int i = lane_of(k);
    if (i >= B) continue;
    bool newly = quorum[k] && (prev[k] & kEmitted) == 0 && rank[k] == 0;
    if (newly) atomicAdd(vote_word(s, row[k], w[k]), kEmitted);
    if (pre[k]) {
      s.is_coord[row[k]] = 0;
      s.coord_active[row[k]] = 0;
    }
    o_newly[i] = newly;
    o_pre[i] = pre[k];
  }
  phase_barrier();  // the next step sees the emitted bits and resigns
}

__global__ void __launch_bounds__(kThreads, 1)
    acceptor_wave_kernel(Planes s, Half acc, Half com) {
  if (acc.B > 0) {
    const int B = acc.B;
    accept_step(s, AcceptIn{acc.in, B}, B, acc.out, acc.out + B,
                acc.out + 2 * B, acc.out + 3 * B);
  }
  if (com.B > 0) {
    const int B = com.B;
    const int* in = com.in;  // g, slot, rlo, rhi, valid
    commit_step(s, CommitIn{in, in + B, in + 2 * B, in + 3 * B, in + 4 * B},
                B, com.out, com.out + B, com.out + 2 * B, com.out + 3 * B);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    coordinator_wave_kernel(Planes s, Half req, Half rep) {
  __shared__ SortSmem sm;
  if (req.B > 0) {
    const int B = req.B;
    int* out = req.out;
    propose_step(s, sm, req.in, B, out);
    accept_step(s, SelfAccept{req.in, out, B}, B, out + 5 * B, nullptr,
                nullptr, out + 8 * B);
    vote_step(s, sm, SelfVote{req.in, out, B}, B, out + 6 * B, out + 7 * B,
              nullptr, nullptr, nullptr, nullptr);
  }
  if (rep.B > 0) {
    const int B = rep.B;
    int* out = rep.out;
    vote_step(s, sm, ReplyIn{rep.in, B}, B, out, out + B, out + 2 * B,
              out + 3 * B, out + 4 * B, out + 5 * B);
    // the newly decided lanes commit {slot, req_lo, req_hi}
    commit_step(s, CommitIn{rep.in, rep.in + B, out + 3 * B, out + 4 * B,
                            out},
                B, out + 6 * B, out + 7 * B, nullptr, out + 8 * B);
  }
}

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

}  // namespace

// The launch geometry: threads of the one CTA, and the most lanes a half
// of a chunk may hold.
extern "C" int gp_wave_limits(int* threads, int* max_lanes) {
  *threads = kThreads;
  *max_lanes = kMaxLanes;
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
  if (bad_half(Ba) || bad_half(Bc) || W < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes s = planes(active, members, bal, acc, dec, cursor, is_coord,
                    coord_active, cbal, next_slot, prop, G, W);
  acceptor_wave_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, Half{static_cast<const int*>(acc_in), static_cast<int*>(acc_out), Ba},
      Half{static_cast<const int*>(com_in), static_cast<int*>(com_out), Bc});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gp_coordinator_wave(const void* req_in, void* req_out, int Bq,
                                   const void* rep_in, void* rep_out, int Br,
                                   const void* active, const void* members,
                                   void* bal, void* acc, void* dec,
                                   void* cursor, void* is_coord,
                                   void* coord_active, const void* cbal,
                                   void* next_slot, void* prop, int G, int W,
                                   void* stream) {
  if (bad_half(Bq) || bad_half(Br) || W < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes s = planes(active, members, bal, acc, dec, cursor, is_coord,
                    coord_active, cbal, next_slot, prop, G, W);
  coordinator_wave_kernel<<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      s, Half{static_cast<const int*>(req_in), static_cast<int*>(req_out), Bq},
      Half{static_cast<const int*>(rep_in), static_cast<int*>(rep_out), Br});
  return static_cast<int>(cudaGetLastError());
}
