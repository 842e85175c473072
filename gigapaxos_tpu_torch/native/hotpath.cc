// Native host hot path: wire-format scan/parse/encode, batched group-key
// lookup, and the WAL record batch encoders.
//
// The reference (rchiesse/gigapaxos) is pure Java; its host CPU goes into
// NIO frame extraction (nio/MessageExtractor.java), per-packet
// byteification (gigapaxos/paxospackets/*.toBytes), and the paxosID→
// instance map (utils/MultiArrayMap.java, gigapaxos/paxosutil/
// IntegerMap.java).  This module is the TPU-native rebuild's C++ analog of
// exactly those paths: the per-ITEM work that cannot be columnarized into
// the device kernels runs here instead of in Python.
//
// C ABI only (loaded via ctypes); all buffers are caller-allocated numpy
// arrays.  No Python.h dependency, so it builds with a bare g++.
//
// Build: see build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Frame scan (ref: nio/MessageExtractor.java reassembly loop)
//
// Stream layout: repeated [u32 len | len bytes].  Scans up to `cap` frames;
// writes payload offsets/lengths; *consumed = bytes of fully-received
// frames.  Returns frame count, or -1 on a frame larger than max_frame
// (protocol violation; caller drops the connection).
// ---------------------------------------------------------------------------

int64_t gp_scan_frames(const uint8_t* buf, int64_t n, int64_t cap,
                       int64_t max_frame, int64_t* offs, int64_t* lens,
                       int64_t* consumed) {
  int64_t pos = 0, count = 0;
  while (count < cap && pos + 4 <= n) {
    uint32_t len;
    std::memcpy(&len, buf + pos, 4);
    if ((int64_t)len > max_frame) { *consumed = pos; return -1; }
    if (pos + 4 + (int64_t)len > n) break;  // torn frame: wait for more
    offs[count] = pos + 4;
    lens[count] = (int64_t)len;
    pos += 4 + (int64_t)len;
    ++count;
  }
  *consumed = pos;
  return count;
}

// ---------------------------------------------------------------------------
// REQUEST parse (ref: paxospackets/RequestPacket byte ctor)
//
// Frame body: u8 type | u32 sender | u32 n_items | u64 gkey | u64 req_id |
// u8 flags | payload...   (see paxos/packets.py Request)
//
// Parses n frames into SoA; payload bytes are packed into `pay` with
// prefix offsets in pay_off[n+1].  Returns 0, -1 malformed, -2 pay buffer
// too small (caller re-calls with a bigger buffer).
// ---------------------------------------------------------------------------

static const int64_t kReqHdr = 1 + 4 + 4 + 8 + 8 + 1;

int64_t gp_parse_requests(const uint8_t* buf, const int64_t* offs,
                          const int64_t* lens, int64_t n, uint32_t* sender,
                          uint64_t* gkey, uint64_t* req_id, uint8_t* flags,
                          int64_t* pay_off, uint8_t* pay, int64_t pay_cap) {
  int64_t w = 0;
  pay_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* f = buf + offs[i];
    const int64_t len = lens[i];
    if (len < kReqHdr) return -1;
    std::memcpy(&sender[i], f + 1, 4);
    std::memcpy(&gkey[i], f + 9, 8);
    std::memcpy(&req_id[i], f + 17, 8);
    flags[i] = f[25];
    const int64_t plen = len - kReqHdr;
    if (w + plen > pay_cap) return -2;
    std::memcpy(pay + w, f + kReqHdr, plen);
    w += plen;
    pay_off[i + 1] = w;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// RESPONSE batch encode (ref: paxospackets byteification + the per-reply
// ClientMessenger sends): n responses -> ONE pre-framed buffer
// [u32 len | frame]* ready for a single socket write.
//
// Frame body: u8 type(2) | u32 sender | u32 1 | u64 gkey | u64 req_id |
// u8 status | payload    (see paxos/packets.py Response)
//
// Returns total bytes written, or -1 if out_cap too small.
// ---------------------------------------------------------------------------

int64_t gp_encode_responses(uint32_t sender, int64_t n,
                            const uint64_t* gkey, const uint64_t* req_id,
                            const uint8_t* status, const int64_t* pay_off,
                            const uint8_t* pay, uint8_t* out,
                            int64_t out_cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t plen = pay_off[i + 1] - pay_off[i];
    const uint32_t flen = (uint32_t)(kReqHdr + plen);
    if (w + 4 + (int64_t)flen > out_cap) return -1;
    std::memcpy(out + w, &flen, 4);
    uint8_t* f = out + w + 4;
    f[0] = 2;  // PacketType.RESPONSE
    std::memcpy(f + 1, &sender, 4);
    uint32_t one = 1;
    std::memcpy(f + 5, &one, 4);
    std::memcpy(f + 9, &gkey[i], 8);
    std::memcpy(f + 17, &req_id[i], 8);
    f[25] = status[i];
    std::memcpy(f + kReqHdr, pay + pay_off[i], plen);
    w += 4 + flen;
  }
  return w;
}

// ---------------------------------------------------------------------------
// (row, slot) -> max-ballot coalesce (ref: PaxosPacketBatcher coalescing).
// keep[i]=1 iff lane i is the winning lane of its (row,slot) pair: highest
// ballot, first occurrence on ties.  Negative rows (unknown group) are
// dropped.  Returns kept count.
// ---------------------------------------------------------------------------

int64_t gp_coalesce_max(const int32_t* row, const int32_t* slot,
                        const int32_t* bal, int64_t n, uint8_t* keep) {
  // open addressing on (row,slot) -> winning lane index
  int64_t cap = 16;
  while (cap < n * 2) cap <<= 1;
  int64_t* tab = (int64_t*)std::malloc(cap * sizeof(int64_t));
  if (!tab) return -1;
  for (int64_t i = 0; i < cap; ++i) tab[i] = -1;
  const uint64_t mask = (uint64_t)cap - 1;
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    keep[i] = 0;
    if (row[i] < 0) continue;
    uint64_t h = ((uint64_t)(uint32_t)row[i] << 32) |
                 (uint64_t)(uint32_t)slot[i];
    h ^= h >> 33; h *= 0xff51afd7ed558ccdULL; h ^= h >> 33;
    uint64_t j = h & mask;
    for (;;) {
      int64_t cur = tab[j];
      if (cur < 0) {
        tab[j] = i;
        keep[i] = 1;
        ++kept;
        break;
      }
      if (row[cur] == row[i] && slot[cur] == slot[i]) {
        if (bal[i] > bal[cur]) { keep[cur] = 0; keep[i] = 1; tab[j] = i; }
        break;
      }
      j = (j + 1) & mask;
    }
  }
  std::free(tab);
  return kept;
}

// ---------------------------------------------------------------------------
// u64 -> i32 open-addressing map (ref: utils/MultiArrayMap.java +
// paxosutil/IntegerMap.java — the paxosID→instance table).  Backs the
// group table's gkey→device-row index with O(1) native lookups and a
// BATCHED get that replaces a Python dict hit per packet item.
//
// Tombstone-free deletion via backward-shift; splitmix64 finalizer on keys
// (gkeys are blake2b hashes already, the mix is belt-and-braces).
// ---------------------------------------------------------------------------

struct GpMap {
  uint64_t* keys;
  int32_t* vals;
  uint8_t* used;
  int64_t cap;     // power of two
  int64_t size;
};

static inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27; x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

static GpMap* map_alloc(int64_t cap) {
  GpMap* m = (GpMap*)std::malloc(sizeof(GpMap));
  if (!m) return nullptr;
  m->keys = (uint64_t*)std::calloc(cap, 8);
  m->vals = (int32_t*)std::calloc(cap, 4);
  m->used = (uint8_t*)std::calloc(cap, 1);
  m->cap = cap;
  m->size = 0;
  if (!m->keys || !m->vals || !m->used) {
    std::free(m->keys); std::free(m->vals); std::free(m->used);
    std::free(m);
    return nullptr;
  }
  return m;
}

void* gp_map_new(int64_t cap_hint) {
  int64_t cap = 64;
  while (cap < cap_hint * 2) cap <<= 1;
  return map_alloc(cap);
}

void gp_map_free(void* h) {
  if (!h) return;
  GpMap* m = (GpMap*)h;
  std::free(m->keys); std::free(m->vals); std::free(m->used);
  std::free(m);
}

static int64_t map_put(GpMap* m, uint64_t k, int32_t v);

static GpMap* map_grow(GpMap* m) {
  GpMap* bigger = map_alloc(m->cap << 1);
  if (!bigger) return nullptr;
  for (int64_t i = 0; i < m->cap; ++i)
    if (m->used[i]) map_put(bigger, m->keys[i], m->vals[i]);
  std::free(m->keys); std::free(m->vals); std::free(m->used);
  *m = *bigger;
  std::free(bigger);
  return m;
}

static int64_t map_put(GpMap* m, uint64_t k, int32_t v) {
  const uint64_t mask = (uint64_t)m->cap - 1;
  uint64_t j = mix64(k) & mask;
  for (;;) {
    if (!m->used[j]) {
      m->used[j] = 1; m->keys[j] = k; m->vals[j] = v; ++m->size;
      return 0;
    }
    if (m->keys[j] == k) { m->vals[j] = v; return 0; }
    j = (j + 1) & mask;
  }
}

// put (upsert).  Returns 0, or -1 on allocation failure during growth.
int64_t gp_map_put(void* h, uint64_t k, int32_t v) {
  GpMap* m = (GpMap*)h;
  if (m->size * 10 >= m->cap * 7)  // load factor 0.7
    if (!map_grow(m)) return -1;
  return map_put(m, k, v);
}

// batched get: vals[i] = map[k[i]] or `missing`.
void gp_map_get_batch(void* h, const uint64_t* k, int64_t n, int32_t* vals,
                      int32_t missing) {
  GpMap* m = (GpMap*)h;
  const uint64_t mask = (uint64_t)m->cap - 1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t j = mix64(k[i]) & mask;
    vals[i] = missing;
    while (m->used[j]) {
      if (m->keys[j] == k[i]) { vals[i] = m->vals[j]; break; }
      j = (j + 1) & mask;
    }
  }
}

// delete with backward-shift compaction.  Returns 1 if present.
int64_t gp_map_del(void* h, uint64_t k) {
  GpMap* m = (GpMap*)h;
  const uint64_t mask = (uint64_t)m->cap - 1;
  uint64_t j = mix64(k) & mask;
  while (m->used[j] && m->keys[j] != k) j = (j + 1) & mask;
  if (!m->used[j]) return 0;
  m->used[j] = 0;
  --m->size;
  // re-seat the rest of the cluster
  uint64_t i = (j + 1) & mask;
  while (m->used[i]) {
    uint64_t k2 = m->keys[i];
    int32_t v2 = m->vals[i];
    m->used[i] = 0;
    --m->size;
    map_put(m, k2, v2);
    i = (i + 1) & mask;
  }
  return 1;
}

int64_t gp_map_size(void* h) { return ((GpMap*)h)->size; }

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// WAL record batch encode (ref: SQLPaxosLogger batched logging): n records
// -> one contiguous buffer in logger.py's _REC layout
// [u8 rtype | u64 gkey | i32 slot | i32 bal | u64 req | u32 len | payload].
// Returns bytes written or -1 if out_cap too small.
// ---------------------------------------------------------------------------

int64_t gp_encode_wal(int64_t n, const uint8_t* rtype, const uint64_t* gkey,
                      const int32_t* slot, const int32_t* bal,
                      const uint64_t* req, const int64_t* pay_off,
                      const uint8_t* pay, uint8_t* out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t plen = pay_off[i + 1] - pay_off[i];
    if (w + 29 + plen > out_cap) return -1;
    out[w] = rtype[i];
    std::memcpy(out + w + 1, &gkey[i], 8);
    std::memcpy(out + w + 9, &slot[i], 4);
    std::memcpy(out + w + 13, &bal[i], 4);
    std::memcpy(out + w + 17, &req[i], 8);
    const uint32_t pl32 = (uint32_t)plen;
    std::memcpy(out + w + 25, &pl32, 4);
    std::memcpy(out + w + 29, pay + pay_off[i], plen);
    w += 29 + plen;
  }
  return w;
}

// ---------------------------------------------------------------------------
// v2 (PC.WAL_CRC) variant: each record carries a trailing CRC32 over
// header+payload.  The polynomial/reflection/init/final-xor match
// zlib.crc32 exactly — logger.py verifies with zlib on replay.
// ---------------------------------------------------------------------------

static const uint32_t* gp_crc32_table() {
  static uint32_t table[256];
  static const bool init = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)init;
  return table;
}

static uint32_t gp_crc32(const uint8_t* p, int64_t n) {
  const uint32_t* table = gp_crc32_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i)
    crc = table[(crc ^ p[i]) & 0xFFu] ^ (crc >> 8);
  return ~crc;
}

int64_t gp_encode_wal_crc(int64_t n, const uint8_t* rtype,
                          const uint64_t* gkey, const int32_t* slot,
                          const int32_t* bal, const uint64_t* req,
                          const int64_t* pay_off, const uint8_t* pay,
                          uint8_t* out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t plen = pay_off[i + 1] - pay_off[i];
    if (w + 33 + plen > out_cap) return -1;
    out[w] = rtype[i];
    std::memcpy(out + w + 1, &gkey[i], 8);
    std::memcpy(out + w + 9, &slot[i], 4);
    std::memcpy(out + w + 13, &bal[i], 4);
    std::memcpy(out + w + 17, &req[i], 8);
    const uint32_t pl32 = (uint32_t)plen;
    std::memcpy(out + w + 25, &pl32, 4);
    std::memcpy(out + w + 29, pay + pay_off[i], plen);
    const uint32_t crc = gp_crc32(out + w, 29 + plen);
    std::memcpy(out + w + 29 + plen, &crc, 4);
    w += 33 + plen;
  }
  return w;
}

}  // extern "C"
