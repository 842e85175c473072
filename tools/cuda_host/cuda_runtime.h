// Host stand-ins for the CUDA runtime and the intrinsics the port's kernels
// use, to run a kernel's logic on a CPU host (g++ -std=c++20): one
// std::thread a CUDA thread, std::barrier for __syncthreads, the grid sync,
// the cluster barrier and the warp's lock-step intrinsics
// (__match_any_sync, __ballot_sync, __shfl_sync), seq_cst builtins for the
// atomics.  A kernel's one __shared__ array becomes emu::block_shared<T>()
// (the check scripts rewrite the declaration); emu::launch runs a grid,
// which is also the cluster when the kernel asks for one (its blocks read
// each other's shared memory through map_shared_rank), starting its threads
// in a shuffled order.  It checks the logic, not the memory model: every
// load here is coherent.
#pragma once
#include <atomic>
#include <barrier>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <memory>
#include <random>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct alignas(16) ulonglong2 { unsigned long long x, y; };
inline ulonglong2 make_ulonglong2(unsigned long long a,
                                  unsigned long long b) {
  return {a, b};
}

typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch,
                      cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1; return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1; return 0;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3,
                                               void**, size_t, cudaStream_t) {
  return 1;  // the harness launches the kernel itself
}
inline cudaError_t cudaGetLastError() { return 0; }

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
// gridDim and blockDim are the kernel's macros here: the check scripts
// rename a launch config's members to these
struct cudaLaunchConfig_t {
  dim3 gridDim_, blockDim_;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(K...),
                               A...) {
  return 1;  // the harness launches the kernel itself
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute,
                                        int) {
  return 0;
}

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  unsigned long long val[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::atomic<int> count{0};  // __syncthreads_count
  alignas(64) unsigned char smem[96 * 1024];
};
struct Ctx {
  uint3 tid, bid;
  dim3 bdim, gdim;
  Block* block;
  std::barrier<>* grid;
  std::vector<std::unique_ptr<Block>>* blocks;
};
inline thread_local Ctx ctx;

template <class T> T& block_shared() {
  return *reinterpret_cast<T*>(ctx.block->smem);
}

// the block `rank`'s copy of the shared-memory object at `p` in this one
template <class T> T* peer_shared(T* p, unsigned rank) {
  const ptrdiff_t off =
      reinterpret_cast<const unsigned char*>(p) - ctx.block->smem;
  return reinterpret_cast<T*>((*ctx.blocks)[rank]->smem + off);
}

inline unsigned long long exchange(unsigned long long v, int src,
                                   unsigned long long* all = nullptr) {
  Warp& w = *ctx.block->warps[ctx.tid.x / 32];
  const int lane = ctx.tid.x % 32;
  w.val[lane] = v;
  w.bar.arrive_and_wait();
  unsigned long long r = src >= 0 ? w.val[src] : 0;
  if (all)
    for (int j = 0; j < 32; ++j) all[j] = w.val[j];
  w.bar.arrive_and_wait();
  return r;
}

template <class F>
void launch(int blocks, int threads, F kernel) {
  std::barrier<> grid(blocks * threads);
  std::vector<std::unique_ptr<Block>> bl;
  for (int b = 0; b < blocks; ++b) {
    auto p = std::make_unique<Block>();
    p->bar = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      p->warps.push_back(std::make_unique<Warp>());
    bl.push_back(std::move(p));
  }
  // threads start in a shuffled order (a fixed seed), so a kernel's
  // atomics do not arrive in lane order by accident
  std::vector<std::pair<int, int>> order;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) order.emplace_back(b, t);
  std::shuffle(order.begin(), order.end(), std::mt19937(1));
  std::vector<std::thread> ts;
  for (auto [b, t] : order)
    ts.emplace_back([&, b, t] {
      ctx = Ctx{{(unsigned)t, 0, 0}, {(unsigned)b, 0, 0},
                dim3(threads), dim3(blocks), bl[b].get(), &grid, &bl};
      kernel();
    });
  for (auto& t : ts) t.join();
}
}  // namespace emu

#define threadIdx (emu::ctx.tid)
#define blockIdx (emu::ctx.bid)
#define blockDim (emu::ctx.bdim)
#define gridDim (emu::ctx.gdim)

inline void __syncthreads() { emu::ctx.block->bar->arrive_and_wait(); }
inline int __syncthreads_count(int pred) {
  emu::Block& b = *emu::ctx.block;
  if (pred) b.count.fetch_add(1);
  b.bar->arrive_and_wait();
  const int n = b.count.load();
  b.bar->arrive_and_wait();
  if (emu::ctx.tid.x == 0) b.count.store(0);
  b.bar->arrive_and_wait();
  return n;
}

template <class T>
unsigned __match_any_sync(unsigned, T key) {
  unsigned long long all[32];
  emu::exchange((unsigned long long)key, -1, all);
  unsigned m = 0;
  for (int j = 0; j < 32; ++j)
    if (all[j] == (unsigned long long)key) m |= 1u << j;
  return m;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned long long all[32];
  emu::exchange(pred != 0, -1, all);
  unsigned m = 0;
  for (int j = 0; j < 32; ++j)
    if (all[j]) m |= 1u << j;
  return m;
}
inline int __shfl_sync(unsigned, int v, int src) {
  return (int)emu::exchange((unsigned)v, src);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }

template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) {
  return __atomic_load_n(const_cast<T*>(p), __ATOMIC_SEQ_CST);
}
inline ulonglong2 __ldcg(const ulonglong2* p) { return *p; }
inline int4 __ldcg(const int4* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicOr(int* p, int v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline unsigned long long atomicCAS(unsigned long long* p,
                                    unsigned long long cmp,
                                    unsigned long long v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return cmp;
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
