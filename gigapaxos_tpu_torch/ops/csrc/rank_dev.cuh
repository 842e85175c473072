// The run rank at any width, as device code: for each masked lane, the
// number of EARLIER masked lanes of the batch (in lane order) with the same
// key.  It replaces the stable lexsort and run-start cummax of
// kernels.py:_run_rank (two sorts and a scan) with counting, and no sort.
// The propose kernel (propose.cu) ranks its lanes by row with it.
//
// A key is a row in [0, G) and a second int32 word (0 where the row alone
// is the key).  The batch is cut into tiles of kThreads lanes; a block of a
// cooperative grid takes its tiles one at a time, and "earlier" means an
// earlier tile, or an earlier lane of the same tile.
//
// In a tile (tile_rank, every thread of the block calls it, three block
// barriers): __match_any_sync gives each lane its warp's peers, and __popc
// of the earlier ones its rank in the warp; one leader a key and warp
// enters the key in the block's shared-memory table with its warp's count
// and its lane index (atomicMin keeps the tile's first lane of the key).
// After a barrier a leader's base is its key's lanes in the earlier warps
// of the tile (one table read), and the leader whose lane is the key's
// first in the tile holds the tile's count of the key.  Then the leaders
// clear their slots, so the table is empty for the next tile.
//
// Across tiles (a workspace in device memory, a grid barrier between the
// two steps):
//   1. the tile's first lane of each key appends one entry {tile, count,
//      key2} to its row's list: the entry's index is the lane's, and
//      atomicExch on head[row] links it in front (rank_append);
//   2. after the grid barrier the same lane walks its row's list and sums
//      the counts of the entries of its key from earlier tiles
//      (rank_earlier).  The other lanes of the key in its tile read that
//      sum (a block barrier later) where the lane stored it.
// A row's list holds one entry a tile with the row, so a walk is about one
// or two entries when rows are spread, and at most one entry a tile when
// every lane is on one row.  head[row] carries the epoch of the call that
// wrote it in its high word (the list's index in its low word), and an
// entry's link the head it replaced: a walk stops at the first link of
// another epoch, so no call clears a list.  Epoch 0 is no call's (a zeroed
// head is empty); the caller clears every head once its epoch wraps.
//
// Semantics note: lanes are counted, never ordered, so the rank equals the
// stable lexsort's with any mix of repeated keys.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace gp {

constexpr unsigned long long kNoRankKey = ~0ull;  // an empty table slot
constexpr int kCountBits = 9;  // an entry's count: at most 256 lanes

// One slot of a tile's table: a key, the tile's first lane with it, and
// its lanes in each warp of the tile.
template <int kWarps>
struct alignas(8) TileSlot {
  unsigned long long key;
  int first;
  unsigned char per_warp[kWarps];
};

// A list entry: the head it replaced (epoch << 32 | index), the tile and
// its count of the key (tile << kCountBits | count), the key's second word.
struct alignas(16) RankEntry {
  unsigned long long next;
  unsigned tile_count;
  int key2;
};
static_assert(sizeof(RankEntry) == 16, "a list entry is one 16-byte word");

struct TileRank {
  int rank;   // earlier lanes of the key in the tile (0 if unmasked)
  int first;  // the tile's first lane with the key (-1 if unmasked)
  int count;  // the tile's lanes with the key (at the first lane only)
};

__device__ __forceinline__ unsigned long long rank_key(int row, int key2) {
  return ((unsigned long long)(unsigned)row << 32) | (unsigned)key2;
}

__device__ __forceinline__ int rank_hash(unsigned long long key, int cap) {
  return (int)((key * 0x9E3779B97F4A7C15ull) >> 40) & (cap - 1);
}

// Every slot of a table of `cap` slots empty (every thread of the block
// calls it; tile_rank's first barrier orders it before any entry).
template <int kWarps>
__device__ void tile_table_clear(TileSlot<kWarps>* tab, int cap) {
  for (int k = threadIdx.x; k < cap; k += blockDim.x) {
    tab[k].key = kNoRankKey;
    tab[k].first = INT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tab[k].per_warp[w] = 0;
  }
}

// The rank of lane `i` (masked by `mask`, key (row, key2)) among the
// earlier lanes of its tile.  Every thread of the block calls it with its
// lane of the same tile; `tab` holds 2 x kThreads slots, empty.
template <int kThreads>
__device__ TileRank tile_rank(TileSlot<kThreads / 32>* tab, bool mask,
                              int row, int key2, int i) {
  constexpr int kCap = 2 * kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long key = mask ? rank_key(row, key2) : kNoRankKey;
  const unsigned peers =
      __match_any_sync(~0u, key) & __ballot_sync(~0u, mask);
  const int in_warp = __popc(peers & ((1u << lane) - 1));
  const int leader = mask ? __ffs(peers) - 1 : lane;
  const bool lead = mask && leader == lane;
  __syncthreads();  // the table empty: cleared, or by the last tile's lanes
  int e = 0;
  if (lead) {
    e = rank_hash(key, kCap);
    for (;;) {
      const unsigned long long was = atomicCAS(&tab[e].key, kNoRankKey, key);
      if (was == kNoRankKey || was == key) break;
      e = (e + 1) & (kCap - 1);
    }
    tab[e].per_warp[warp] = (unsigned char)__popc(peers);
    atomicMin(&tab[e].first, i);
  }
  __syncthreads();  // every entry of the tile in the table
  int base = 0, count = 0, first = -1;
  if (lead) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int n = tab[e].per_warp[w];
      if (w < warp) base += n;
      count += n;
    }
    first = tab[e].first;
  }
  __syncthreads();  // every read of the table before the leaders clear it
  if (lead) {
    tab[e].key = kNoRankKey;
    tab[e].first = INT_MAX;
    tab[e].per_warp[warp] = 0;
  }
  base = __shfl_sync(~0u, base, leader);
  first = __shfl_sync(~0u, first, leader);
  TileRank r;
  r.rank = mask ? base + in_warp : 0;
  r.first = mask ? first : -1;
  r.count = count;
  return r;
}

// Step 1: the tile's first lane `i` of a key appends the tile's entry.
__device__ __forceinline__ void rank_append(unsigned long long* head,
                                            RankEntry* pool, unsigned epoch,
                                            int row, int key2, int tile,
                                            int count, int i) {
  const unsigned long long was =
      atomicExch(head + row, ((unsigned long long)epoch << 32) | (unsigned)i);
  RankEntry e;
  e.next = was;
  e.tile_count = ((unsigned)tile << kCountBits) | (unsigned)count;
  e.key2 = key2;
  pool[i] = e;
}

// Step 2 (after a grid barrier): the lanes of key (row, key2) in the tiles
// before `tile`, from the row's list of this epoch.  Entries are read
// through L2: other SMs wrote them.
__device__ __forceinline__ int rank_earlier(const unsigned long long* head,
                                            const RankEntry* pool,
                                            unsigned epoch, int row, int key2,
                                            int tile) {
  unsigned long long h = __ldcg(head + row);
  int n = 0;
  while ((unsigned)(h >> 32) == epoch) {
    const ulonglong2 e =
        __ldcg(reinterpret_cast<const ulonglong2*>(pool) + (unsigned)h);
    const unsigned tc = (unsigned)e.y;
    if ((int)(e.y >> 32) == key2 && (tc >> kCountBits) < (unsigned)tile)
      n += (int)(tc & ((1u << kCountBits) - 1));
    h = e.x;
  }
  return n;
}

}  // namespace gp
