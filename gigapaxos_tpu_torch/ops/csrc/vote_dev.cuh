// The vote (accept-reply) step of a chunk of at most 4096 lanes, as device
// code: one lane a thread, one CTA of up to kCtaLanes lanes or one
// thread-block cluster of kClusterCtas CTAs, the run rank in shared memory
// and, across a cluster's CTAs, in distributed shared memory.  The runtime's
// coordinator wave (wave.cu) runs vote_step; the small path of the
// accept-reply kernel (accept_reply.cu) shares the geometry, the launch,
// the barriers and the run rank, and ranks only contested columns.
//
// The vote of one lane, row r, W = window width, col = prop[r, slot mod W]
// as it stood before the step (kernels.py:accept_reply_batch):
//   match   = v && is_coord && coord_active && bal == cbal && acked
//             && slot >= 0 && col.slot == slot
//   fresh   = match && bit `sender` of col.votes clear -> votes += 1 << sender
//   | barrier
//   quorum  = match && popcount(votes & VOTE_MASK) >= members / 2 + 1
//   newly   = quorum && !(col.votes & EMITTED_BIT) && the lane's rank among
//             the quorum lanes of its (row, slot) is 0 -> votes += EMITTED_BIT
//   pre     = v && is_coord && !acked && bal > cbal
//             -> is_coord = coord_active = 0 (after the barrier: every lane
//             read the flags first)
//
// The run rank without a sort: inside a warp __match_any_sync gives each
// lane its peers, and __popc of the earlier peers its rank there.  One
// leader a key and warp enters the key in the CTA's shared-memory hash table
// (linear probing, 2x as many slots as threads), with a count of its lanes
// in each warp (rank_enter).  After one barrier a lane's rank is its rank in
// the warp (rank_read),
// plus its key's lanes in the CTA's earlier warps (one table read), plus, in
// a cluster, its key's lanes in the earlier CTAs: one lookup in each of
// their tables through distributed shared memory, the first probes of all of
// them issued together.  Lane order breaks no tie (the lanes of a key are
// counted, never ordered), so the rank is the stable lexsort's, with any mix
// of repeated keys, up to 4096 lanes on one row.  A one-warp CTA needs no
// table.
//
// Barriers: inside one CTA, __syncthreads alone (bar.sync orders the CTA's
// memory operations).  Across a cluster, the hardware cluster barrier
// (barrier.cluster.arrive.release / wait.acquire, through cooperative_groups'
// cluster sync), not a grid sync.  The prop column and the flags are read
// through L2 (__ldcg): the step writes them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_dev.cuh"

namespace gp {

constexpr int kChunkLanes = 4096;  // lanes of a chunk, at most
constexpr int kCtaLanes = 512;     // a chunk up to this many is one CTA
constexpr int kClusterCtas = 8;    // a larger one, one cluster of this many
constexpr int kWarp = 32;
constexpr int kMaxWarps = kCtaLanes / kWarp;  // warps of a CTA, at most
constexpr int kEmittedBit = 1 << 30;          // types.py EMITTED_BIT
constexpr int kVoteBits = kEmittedBit - 1;    // types.py VOTE_MASK
constexpr unsigned long long kNoKey = ~0ull;  // an empty table slot

// One slot of a CTA's run-rank table: a key, its masked lanes in the CTA
// and in each of its warps.  key and total are read together, as 16 bytes.
struct alignas(16) RankSlot {
  unsigned long long key;
  int total;
  int pad;
  unsigned char per_warp[kMaxWarps];
};
static_assert(sizeof(RankSlot) == 32, "a table slot is two 16-byte words");

// ---- launch geometry --------------------------------------------------------

struct ChunkGeometry {
  int ctas;     // 1, or kClusterCtas: one cluster
  int threads;  // of a CTA: one a lane, rounded up to a warp
};

inline ChunkGeometry chunk_geometry(int B) {
  const int ctas = B <= kCtaLanes ? 1 : kClusterCtas;
  const int per = (B + ctas - 1) / ctas;
  return ChunkGeometry{ctas, (per + kWarp - 1) / kWarp * kWarp};
}

// slots of one run-rank table for CTAs of `threads`: a power of two, at
// least twice the lanes a CTA enters
__host__ __device__ __forceinline__ int table_cap(int threads) {
  int cap = 2 * kWarp;
  while (cap < 2 * threads) cap <<= 1;
  return cap;
}

// a one-warp CTA ranks in its warp alone and needs no table
__host__ __device__ __forceinline__ bool needs_tables(int ctas, int threads) {
  return ctas > 1 || threads > kWarp;
}

// shared memory of a chunk launch over B lanes with `tables` tables
inline size_t chunk_table_bytes(int B, int tables) {
  const ChunkGeometry g = chunk_geometry(B);
  if (!needs_tables(g.ctas, g.threads)) return 0;
  return (size_t)tables * table_cap(g.threads) * sizeof(RankSlot);
}

// Launch `kernel` over a B-lane chunk: one CTA, or one cluster of
// kClusterCtas, with `smem` bytes of dynamic shared memory.
template <class... Args>
cudaError_t launch_chunk(void (*kernel)(Args...), int B, size_t smem,
                         cudaStream_t stream, Args... args) {
  const ChunkGeometry g = chunk_geometry(B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ctas);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.ctas > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---- barriers and small helpers ------------------------------------------

// The barrier between two phases: every thread of the chunk has made its
// memory operations of the phase before visible to every other.
template <bool kCl>
__device__ __forceinline__ void chunk_barrier() {
  if constexpr (kCl) {
    cooperative_groups::this_cluster().sync();  // barrier.cluster arrive
                                                // (release) + wait (acquire)
  } else {
    __syncthreads();
  }
}

// 1 << s and x >> s as torch and XLA shift int32
__device__ __forceinline__ int bit_of(int s) {
  return s >= 0 && s < 32 ? (int)(1u << s) : 0;
}
__device__ __forceinline__ int shift_right(int x, int s) {
  return x >> (s >= 0 && s < 31 ? s : 31);
}

__device__ __forceinline__ int* vote_word(int4* prop, int W, int row, int w) {
  return reinterpret_cast<int*>(prop + (size_t)row * W + w) + 3;
}

__device__ __forceinline__ int hash_slot(unsigned long long key, int cap) {
  return (int)((key * 0x9E3779B97F4A7C15ull) >> 40) & (cap - 1);
}

// ---- the run rank ----------------------------------------------------------

// Every slot of `n` run-rank table slots empty.
__device__ __forceinline__ void clear_tables(RankSlot* t, int n) {
  uint4* words = reinterpret_cast<uint4*>(t);
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x)
    words[k] = (k & 1) ? make_uint4(0, 0, 0, 0)
                       : make_uint4(~0u, ~0u, 0, 0);  // kNoKey, total 0
}

// The lanes with `key` in the cluster's CTAs before this one: a lookup in
// each of their tables through distributed shared memory.
__device__ __forceinline__ int earlier_ctas(const RankSlot* tab, int cap,
                                            unsigned long long key) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int me = (int)cl.block_rank();
  const int h = hash_slot(key, cap);
  ulonglong2 first[kClusterCtas];
#pragma unroll
  for (int c = 0; c < kClusterCtas; ++c)  // the first probes, all at once
    first[c] = c < me ? *reinterpret_cast<const ulonglong2*>(
                            cl.map_shared_rank(tab + h, c))
                      : make_ulonglong2(kNoKey, 0);
  int n = 0;
#pragma unroll
  for (int c = 0; c < kClusterCtas; ++c) {
    ulonglong2 got = first[c];
    int e = h;
    while (got.x != key && got.x != kNoKey) {  // a collision: probe on
      e = (e + 1) & (cap - 1);
      got = *reinterpret_cast<const ulonglong2*>(
          cl.map_shared_rank(tab + e, c));
    }
    if (got.x == key) n += (int)(unsigned)got.y;  // total, the low word
  }
  return n;
}

// The stable run rank in two halves around a chunk barrier: for a lane with
// `mask`, the number of earlier lanes of the chunk with `mask` and the same
// `key` (0 for a lane without).  Every thread calls both halves.  `tab` is
// this CTA's table, cleared, with a barrier between the clear and
// rank_enter; the caller holds one chunk barrier between rank_enter and
// rank_read (none is needed in a one-warp CTA), and after rank_read a
// cluster's CTAs wait at one more before any leaves (its table is read by
// the later CTAs).  No masked key is kNoKey.
struct RankTicket {
  unsigned peers;  // the warp's lanes with this lane's key and mask
  int in_warp;     // this lane's rank among them
  int leader;      // the first of them (this lane if unmasked)
  int e;           // the leader's table slot
};

template <bool kCl>
__device__ __forceinline__ RankTicket rank_enter(RankSlot* tab, int cap,
                                                 bool mask,
                                                 unsigned long long key) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  RankTicket t;
  t.peers = __match_any_sync(~0u, key) & __ballot_sync(~0u, mask);
  t.in_warp = __popc(t.peers & ((1u << lane) - 1));
  t.leader = mask ? __ffs(t.peers) - 1 : lane;
  t.e = 0;
  if (!needs_tables(kCl ? kClusterCtas : 1, blockDim.x)) return t;
  if (mask && t.leader == lane) {
    int e = hash_slot(key, cap);
    for (;;) {
      const unsigned long long was = atomicCAS(&tab[e].key, kNoKey, key);
      if (was == kNoKey || was == key) break;
      e = (e + 1) & (cap - 1);
    }
    tab[e].per_warp[warp] = (unsigned char)__popc(t.peers);
    atomicAdd(&tab[e].total, __popc(t.peers));
    t.e = e;
  }
  return t;
}

template <bool kCl>
__device__ __forceinline__ int rank_read(const RankSlot* tab, int cap,
                                         bool mask, unsigned long long key,
                                         const RankTicket& t) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (!needs_tables(kCl ? kClusterCtas : 1, blockDim.x))
    return mask ? t.in_warp : 0;
  int base = 0;
  if (mask && t.leader == lane) {
    if (tab[t.e].total != __popc(t.peers))  // the key has lanes in other
                                            // warps
      for (int w = 0; w < warp; ++w) base += tab[t.e].per_warp[w];
    if constexpr (kCl) base += earlier_ctas(tab, cap, key);
  }
  base = __shfl_sync(~0u, base, t.leader);
  return mask ? base + t.in_warp : 0;
}

// The run rank with its own chunk barrier between the halves (none in a
// one-warp CTA, which ranks without a table).
template <bool kCl>
__device__ __forceinline__ int run_rank(RankSlot* tab, int cap, bool mask,
                                        unsigned long long key) {
  const RankTicket t = rank_enter<kCl>(tab, cap, mask, key);
  if (needs_tables(kCl ? kClusterCtas : 1, blockDim.x))
    chunk_barrier<kCl>();  // every CTA's table whole
  return rank_read<kCl>(tab, cap, mask, key, t);
}

// ---- the vote step ---------------------------------------------------------

// a vote lane: its row and window column (0 unless valid), slot, ballot,
// sender and ack, and its row's flags, cbal and members
struct VoteLane {
  int row, w, slot, bal, sender, cb, members;
  bool v, ic, ca, acked;
};

struct VoteOut {
  bool newly, pre;
  int4 col;  // the prop column before the step
};

// vote: the fresh votes | barrier | the re-gathered count, the run rank of
// the quorum lanes of one (row, slot), EMITTED_BIT once a column, the
// resignations.  `s` holds the planes: prop ([G, W] of {slot, rlo, rhi,
// votes}), is_coord, coord_active and W.  Every thread calls it; `on` marks
// a lane of the chunk; `tab` is this CTA's table, cleared (the step's first
// barrier orders the clear before any entry).
template <bool kCl, class Planes>
__device__ __forceinline__ VoteOut vote_step(const Planes& s, bool on,
                                             const VoteLane& l, RankSlot* tab,
                                             int cap) {
  VoteOut o{false, false, make_int4(0, 0, 0, 0)};
  bool match = false;
  if (on) {
    o.col = __ldcg(s.prop + (size_t)l.row * s.W + l.w);
    match = l.v && l.ic && l.ca && l.bal == l.cb && l.acked && l.slot >= 0 &&
            o.col.x == l.slot;
    if (match && ((o.col.w >> l.sender) & 1) == 0)
      atomicAdd(vote_word(s.prop, s.W, l.row, l.w), 1 << l.sender);
    o.pre = l.v && l.ic && !l.acked && l.bal > l.cb;
  }
  chunk_barrier<kCl>();  // every vote before any re-gather, every flag read
                         // before any resign
  bool quorum = false;
  if (match) {
    const int cnt =
        __popc(__ldcg(vote_word(s.prop, s.W, l.row, l.w)) & kVoteBits);
    quorum = cnt >= floor_half(l.members) + 1;
  }
  const int rank = run_rank<kCl>(
      tab, cap, quorum,
      ((unsigned long long)(unsigned)l.row << 32) | (unsigned)l.slot);
  o.newly = quorum && (o.col.w & kEmittedBit) == 0 && rank == 0;
  if (o.newly) atomicAdd(vote_word(s.prop, s.W, l.row, l.w), kEmittedBit);
  if (o.pre) {
    s.is_coord[l.row] = 0;
    s.coord_active[l.row] = 0;
  }
  return o;
}

}  // namespace gp
