// Runs csrc/propose.cu's kernel on the host (cuda_runtime.h's stand-ins)
// over a sequence of calls read from a file, and writes each call's output
// and the final state; propose_check.py writes the file, runs this and
// holds the results against propose_reference.
//
// Input (native endianness): int32 calls, G, W, maxB; uint8 active[G],
// is_coord[G], coord_active[G]; int32 cbal[G], exec_cursor[G],
// next_slot[G], prop[G*W*4]; uint32 epoch; then a call: int32 B, blocks;
// int32 g[B], rlo[B], rhi[B]; uint8 valid[B].  Output: int32 out[5*B]
// a call, then next_slot[G], prop[G*W*4] and uint32 epoch.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "propose_host.cu"

template <class T>
void rd(FILE* f, T* p, size_t n) {
  if (fread(p, sizeof(T), n, f) != n) {
    fprintf(stderr, "propose_harness: short read\n");
    exit(2);
  }
}

template <class T>
void wr(FILE* f, const T* p, size_t n) {
  fwrite(p, sizeof(T), n, f);
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: propose_harness IN OUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  int hdr[4];
  rd(f, hdr, 4);
  const int calls = hdr[0], G = hdr[1], W = hdr[2], maxB = hdr[3];
  std::vector<uint8_t> active(G), is_coord(G), coord_active(G);
  std::vector<int32_t> cbal(G), cursor(G), next_slot(G),
      prop((size_t)G * W * 4);
  unsigned epoch;
  rd(f, active.data(), G);
  rd(f, is_coord.data(), G);
  rd(f, coord_active.data(), G);
  rd(f, cbal.data(), G);
  rd(f, cursor.data(), G);
  rd(f, next_slot.data(), G);
  rd(f, prop.data(), prop.size());
  rd(f, &epoch, 1);
  std::vector<unsigned long long> head(G, 0);
  std::vector<gp::RankEntry> pool(maxB > 0 ? maxB : 1);
  std::vector<int32_t> base(maxB > 0 ? maxB : 1);
  FILE* o = fopen(argv[2], "wb");
  for (int c = 0; c < calls; ++c) {
    int cb[2];
    rd(f, cb, 2);
    const int B = cb[0], blocks = cb[1];
    std::vector<int32_t> g(B), rlo(B), rhi(B), out((size_t)5 * B, -7);
    std::vector<uint8_t> valid(B);
    rd(f, g.data(), B);
    rd(f, rlo.data(), B);
    rd(f, rhi.data(), B);
    rd(f, valid.data(), B);
    Args a{g.data(), rlo.data(), rhi.data(), valid.data(), active.data(),
           is_coord.data(), coord_active.data(), cbal.data(), cursor.data(),
           next_slot.data(), reinterpret_cast<int4*>(prop.data()),
           out.data(), head.data(), pool.data(), base.data(), &epoch,
           B, G, W};
    if (B) emu::launch(blocks, kThreads, [&] { propose_coop_kernel(a); });
    wr(o, out.data(), out.size());
  }
  wr(o, next_slot.data(), G);
  wr(o, prop.data(), prop.size());
  wr(o, &epoch, 1);
  fclose(o);
  fclose(f);
  return 0;
}
