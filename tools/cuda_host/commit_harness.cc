// Runs csrc/commit.cu's kernel on the host (cuda_runtime.h's stand-ins)
// over a sequence of calls read from a file, and writes each call's output
// and the final state; commit_check.py writes the file, runs this and holds
// the results against commit_reference.
//
// Input (native endianness): int32 calls, G, W; uint8 active[G]; int32
// exec_cursor[G], dec[G*W*3]; then a call: int32 B, blocks; int32 g[B],
// slot[B], rlo[B], rhi[B]; uint8 valid[B].  Output: int32 out[4*B] a call,
// then exec_cursor[G], dec[G*W*3], and the readers word (0 between calls).
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "commit_host.cu"

template <class T>
void rd(FILE* f, T* p, size_t n) {
  if (fread(p, sizeof(T), n, f) != n) {
    fprintf(stderr, "commit_harness: short read\n");
    exit(2);
  }
}

template <class T>
void wr(FILE* f, const T* p, size_t n) {
  fwrite(p, sizeof(T), n, f);
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: commit_harness IN OUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  int hdr[3];
  rd(f, hdr, 3);
  const int calls = hdr[0], G = hdr[1], W = hdr[2];
  std::vector<uint8_t> active(G);
  std::vector<int32_t> cursor(G), dec((size_t)G * W * 3);
  rd(f, active.data(), G);
  rd(f, cursor.data(), G);
  rd(f, dec.data(), dec.size());
  unsigned readers = 0;
  FILE* o = fopen(argv[2], "wb");
  for (int c = 0; c < calls; ++c) {
    int cb[2];
    rd(f, cb, 2);
    const int B = cb[0], blocks = cb[1];
    std::vector<int32_t> g(B), slot(B), rlo(B), rhi(B),
        out((size_t)4 * B, -7);
    std::vector<uint8_t> valid(B);
    rd(f, g.data(), B);
    rd(f, slot.data(), B);
    rd(f, rlo.data(), B);
    rd(f, rhi.data(), B);
    rd(f, valid.data(), B);
    Args a{g.data(), slot.data(), rlo.data(), rhi.data(), valid.data(),
           active.data(), cursor.data(), dec.data(), out.data(), &readers,
           B, G, W};
    if (B) emu::launch(blocks, kThreads, [&] { commit_coop_kernel(a); });
    wr(o, out.data(), out.size());
  }
  wr(o, cursor.data(), G);
  wr(o, dec.data(), dec.size());
  wr(o, &readers, 1);
  fclose(o);
  fclose(f);
  return 0;
}
