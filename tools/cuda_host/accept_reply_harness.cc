// Runs csrc/accept_reply.cu's kernels on the host (cuda_runtime.h's
// stand-ins) over a sequence of calls read from a file, and writes each
// call's output and the final state; accept_reply_check.py writes the file,
// runs this and holds the results against accept_reply_reference.  A call
// of at most 4096 lanes runs the small path (one CTA, or one cluster: the
// launch's blocks), a wider one the wide path's cooperative grid on
// `blocks` blocks, with the contested columns' table (zero at the start),
// the epoch and the contest word (which must be 0 after every call).
//
// Input (native endianness): int32 calls, G, W, maxB; uint8 is_coord[G],
// coord_active[G]; int32 cbal[G], members[G], prop[G*W*4]; uint32 epoch;
// then a call: int32 B, blocks, flag_bytes; int32 g[B], slot[B], bal[B],
// sender[B]; acked[B] and valid[B], flag_bytes each.  Output: int32
// out[6*B] a call, then uint8 is_coord[G], coord_active[G], int32
// prop[G*W*4] and uint32 epoch.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "accept_reply_host.cu"

template <class T>
void rd(FILE* f, T* p, size_t n) {
  if (fread(p, sizeof(T), n, f) != n) {
    fprintf(stderr, "accept_reply_harness: short read\n");
    exit(2);
  }
}

template <class T>
void wr(FILE* f, const T* p, size_t n) {
  fwrite(p, sizeof(T), n, f);
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: accept_reply_harness IN OUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  int hdr[4];
  rd(f, hdr, 4);
  const int calls = hdr[0], G = hdr[1], W = hdr[2], maxB = hdr[3];
  std::vector<uint8_t> is_coord(G), coord_active(G);
  std::vector<int32_t> cbal(G), members(G), prop((size_t)G * W * 4);
  unsigned epoch;
  rd(f, is_coord.data(), G);
  rd(f, coord_active.data(), G);
  rd(f, cbal.data(), G);
  rd(f, members.data(), G);
  rd(f, prop.data(), prop.size());
  rd(f, &epoch, 1);
  (void)maxB;
  std::vector<unsigned long long> first((size_t)G * W, 0);
  unsigned contested = 0;
  FILE* o = fopen(argv[2], "wb");
  for (int c = 0; c < calls; ++c) {
    int cb[3];
    rd(f, cb, 3);
    const int B = cb[0], blocks = cb[1], fb = cb[2];
    std::vector<int32_t> g(B), slot(B), bal(B), sender(B),
        out((size_t)6 * B, -7);
    std::vector<uint8_t> acked((size_t)B * fb), valid((size_t)B * fb);
    rd(f, g.data(), B);
    rd(f, slot.data(), B);
    rd(f, bal.data(), B);
    rd(f, sender.data(), B);
    rd(f, acked.data(), acked.size());
    rd(f, valid.data(), valid.size());
    Args a{g.data(), slot.data(), bal.data(), sender.data(), acked.data(),
           valid.data(), is_coord.data(), coord_active.data(), cbal.data(),
           members.data(), reinterpret_cast<int4*>(prop.data()), out.data(),
           first.data(), &epoch, &contested, B, G, W, fb};
    if (B > gp::kChunkLanes) {
      emu::launch(blocks, kThreads, [&] { accept_reply_grid_kernel(a); });
    } else if (B) {
      const gp::ChunkGeometry geo = gp::chunk_geometry(B);
      if (geo.ctas > 1)
        emu::launch(geo.ctas, geo.threads,
                    [&] { accept_reply_chunk_kernel<true>(a); });
      else
        emu::launch(1, geo.threads,
                    [&] { accept_reply_chunk_kernel<false>(a); });
    }
    if (contested) {
      fprintf(stderr, "accept_reply_harness: contest word %u after a call\n",
              contested);
      return 3;
    }
    wr(o, out.data(), out.size());
  }
  wr(o, is_coord.data(), G);
  wr(o, coord_active.data(), G);
  wr(o, prop.data(), prop.size());
  wr(o, &epoch, 1);
  fclose(o);
  fclose(f);
  return 0;
}
