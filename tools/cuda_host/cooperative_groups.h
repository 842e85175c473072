#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { emu::ctx.grid->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
// a launch is one cluster: its barrier is the grid's, its blocks' shared
// memory emu::peer_shared's
struct cluster_group {
  void sync() { emu::ctx.grid->arrive_and_wait(); }
  unsigned block_rank() const { return emu::ctx.bid.x; }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    return emu::peer_shared(p, rank);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
