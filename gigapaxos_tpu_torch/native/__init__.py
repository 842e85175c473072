"""Native host hot path (C++ via ctypes) with pure-Python fallbacks.

See ``hotpath.cc`` for what runs native and why (ref analogs:
``nio/MessageExtractor``, ``paxospackets`` byteification,
``utils/MultiArrayMap``/``paxosutil/IntegerMap``).  The port's own copy
of ``gigapaxos_tpu/native/`` (the same surface, less the C++ per-instance
group store ``groupstore.cc``/``GroupStore``, which only the native
engine uses and which waits for that engine's port; the WAL encoders of
that file live in ``hotpath.cc`` here).  The module
compiles itself with ``g++`` on first use into ``native/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is loaded as it is; set
``GP_NO_NATIVE=1`` to force the Python fallbacks (used by tests to check
parity).  The node runtime on the card must not run on the fallbacks:
``chip_smoke.py`` fails unless :func:`have_native` is true there.

Public surface:

- ``HAVE_NATIVE``: bool
- ``scan_frames(buf) -> (offs, lens, consumed)``
- ``parse_requests(buf, offs, lens) -> (sender, gkey, req_id, flags,
  pay_off, pay)``
- ``encode_responses(sender, gkey, req_id, status, payloads) -> bytes``
  (pre-framed: ready to write to a socket as-is)
- ``coalesce_max(row, slot, bal) -> keep`` (bool mask)
- ``KeyRowMap``: u64 -> i32 map with ``put/get/delete/get_batch``
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gigapaxos_tpu_torch.utils.engineledger import EngineLedger
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "hotpath.cc")]
_BUILD_DIR = os.path.join(_DIR, "_build")
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def _so_path() -> str:
    """Where the library lives at the current sources and flags."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"_hotpath-{h.hexdigest()[:16]}.so")


def _build() -> Tuple[Optional[str], bool]:
    """Compile the .cc sources into ``_build/`` unless that build exists;
    return its path (None when no compiler is at hand) and whether it
    was built now."""
    try:
        so = _so_path()
        if os.path.exists(so):
            return so, False
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so + f".tmp.{os.getpid()}"
        t0 = time.monotonic()
        subprocess.run(
            ["g++"] + _CXX_FLAGS + ["-o", tmp] + _SRCS,
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic under concurrent builders
        EngineLedger.note_build("native:_hotpath", time.monotonic() - t0)
        return so, True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build unavailable (%s); using Python fallback",
                    e)
        return None, False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("GP_NO_NATIVE"):
        return None
    with _build_lock:
        if _lib is not None:
            return _lib
        so, built = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            # stale/foreign cached .so (different arch or libstdc++):
            # rebuild once from source, else fall back to Python
            log.warning("cached %s unloadable (%s); rebuilding", so, e)
            try:
                os.remove(so)
                so, built = _build()
                lib = ctypes.CDLL(so) if so else None
            except OSError:
                lib = None
            if lib is None:
                return None
        # All pointer params are declared c_void_p so call sites can pass
        # the cheap forms _p() produces (a zero-length ctypes view of the
        # array buffer, or a raw int address) — data_as(POINTER(T)) costs
        # ~4 us per argument, ~10x the whole C call for small batches
        i64 = ctypes.c_int64
        u64p = i64p = u8p = u32p = i32p = ctypes.c_void_p
        lib.gp_scan_frames.restype = i64
        lib.gp_scan_frames.argtypes = [u8p, i64, i64, i64, i64p, i64p,
                                       i64p]
        lib.gp_parse_requests.restype = i64
        lib.gp_parse_requests.argtypes = [u8p, i64p, i64p, i64, u32p, u64p,
                                          u64p, u8p, i64p, u8p, i64]
        lib.gp_encode_responses.restype = i64
        lib.gp_encode_responses.argtypes = [ctypes.c_uint32, i64, u64p,
                                            u64p, u8p, i64p, u8p, u8p, i64]
        lib.gp_coalesce_max.restype = i64
        lib.gp_coalesce_max.argtypes = [i32p, i32p, i32p, i64, u8p]
        lib.gp_map_new.restype = ctypes.c_void_p
        lib.gp_map_new.argtypes = [i64]
        lib.gp_map_free.argtypes = [ctypes.c_void_p]
        lib.gp_map_put.restype = i64
        lib.gp_map_put.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int32]
        lib.gp_map_get_batch.argtypes = [ctypes.c_void_p, u64p, i64, i32p,
                                         ctypes.c_int32]
        lib.gp_map_del.restype = i64
        lib.gp_map_del.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gp_map_size.restype = i64
        lib.gp_map_size.argtypes = [ctypes.c_void_p]
        lib.gp_encode_wal.restype = i64
        lib.gp_encode_wal.argtypes = [i64, u8p, u64p, i32p, i32p, u64p,
                                      i64p, u8p, u8p, i64]
        lib.gp_encode_wal_crc.restype = i64
        lib.gp_encode_wal_crc.argtypes = [i64, u8p, u64p, i32p, i32p,
                                          u64p, i64p, u8p, u8p, i64]
        EngineLedger.note_load("native:_hotpath", built)
        _lib = lib
        return _lib


_C0 = ctypes.c_char * 0


def _p(a: np.ndarray, ctype=None):
    """Cheapest pointer form ctypes accepts for a c_void_p param: a
    zero-length view sharing the array's buffer (~0.4 us) for writable
    contiguous arrays, falling back to the raw address int (~2 us) for
    read-only/strided ones.  The ``ctype`` arg is kept for call-site
    readability only — the C prototypes carry the real types."""
    try:
        return _C0.from_buffer(a)
    except (TypeError, ValueError, BufferError):
        # read-only: data_as keeps a reference to the array on the
        # returned object (a bare .ctypes.data int would let a temporary
        # be freed before the C call reads it).  A strided view must
        # fail loudly here — the C side assumes contiguous layout and
        # would silently read mis-laid-out memory.
        if not a.flags.c_contiguous:
            raise ValueError("native call requires a C-contiguous array")
        return a.ctypes.data_as(ctypes.c_void_p)


MAX_FRAME = 64 * 1024 * 1024
_REQ_HDR = 1 + 4 + 4 + 8 + 8 + 1


# --------------------------------------------------------------------------
# scan_frames
# --------------------------------------------------------------------------


def scan_frames(buf: bytes | bytearray | memoryview
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split a length-prefixed stream into frame (offset, length) arrays
    plus the count of consumed bytes.  Raises ValueError on an oversized
    frame (protocol violation)."""
    lib = _load()
    n = len(buf)
    cap = max(1, n // 4)
    if lib is not None:
        arr = np.frombuffer(buf, np.uint8)
        offs = np.empty(cap, np.int64)
        lens = np.empty(cap, np.int64)
        consumed = ctypes.c_int64(0)
        cnt = lib.gp_scan_frames(
            _p(arr, ctypes.c_uint8), n, cap, MAX_FRAME,
            _p(offs, ctypes.c_int64), _p(lens, ctypes.c_int64),
            ctypes.byref(consumed))
        if cnt < 0:
            raise ValueError("oversized frame")
        return offs[:cnt], lens[:cnt], consumed.value
    # fallback
    mv = memoryview(buf)
    offs_l, lens_l, pos = [], [], 0
    while pos + 4 <= n:
        ln = int.from_bytes(mv[pos:pos + 4], "little")
        if ln > MAX_FRAME:
            raise ValueError("oversized frame")
        if pos + 4 + ln > n:
            break
        offs_l.append(pos + 4)
        lens_l.append(ln)
        pos += 4 + ln
    return (np.asarray(offs_l, np.int64), np.asarray(lens_l, np.int64),
            pos)


# --------------------------------------------------------------------------
# parse_requests
# --------------------------------------------------------------------------


def parse_requests(buf, offs: np.ndarray, lens: np.ndarray):
    """Parse REQUEST frames (at ``offs/lens`` within ``buf``) into SoA:
    ``(sender u32[n], gkey u64[n], req_id u64[n], flags u8[n],
    pay_off i64[n+1], pay bytes)``."""
    n = len(offs)
    lib = _load()
    if lib is not None and n:
        arr = np.frombuffer(buf, np.uint8)
        offs = np.ascontiguousarray(offs, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        sender = np.empty(n, np.uint32)
        gkey = np.empty(n, np.uint64)
        req_id = np.empty(n, np.uint64)
        flags = np.empty(n, np.uint8)
        pay_off = np.empty(n + 1, np.int64)
        cap = int(lens.sum())  # payloads are subsets of the frames
        pay = np.empty(max(cap, 1), np.uint8)
        rc = lib.gp_parse_requests(
            _p(arr, ctypes.c_uint8), _p(offs, ctypes.c_int64),
            _p(lens, ctypes.c_int64), n, _p(sender, ctypes.c_uint32),
            _p(gkey, ctypes.c_uint64), _p(req_id, ctypes.c_uint64),
            _p(flags, ctypes.c_uint8), _p(pay_off, ctypes.c_int64),
            _p(pay, ctypes.c_uint8), len(pay))
        if rc != 0:
            raise ValueError(f"malformed request frame (rc={rc})")
        return (sender, gkey, req_id, flags, pay_off,
                pay[:int(pay_off[n])].tobytes())
    # fallback
    import struct
    mv = memoryview(buf)
    sender = np.empty(n, np.uint32)
    gkey = np.empty(n, np.uint64)
    req_id = np.empty(n, np.uint64)
    flags = np.empty(n, np.uint8)
    pay_off = np.zeros(n + 1, np.int64)
    chunks: List[bytes] = []
    w = 0
    for i in range(n):
        o, ln = int(offs[i]), int(lens[i])
        if ln < _REQ_HDR:
            raise ValueError("malformed request frame")
        f = mv[o:o + ln]
        sender[i] = struct.unpack_from("<I", f, 1)[0]
        gkey[i], req_id[i] = struct.unpack_from("<QQ", f, 9)
        flags[i] = f[25]
        chunks.append(bytes(f[_REQ_HDR:]))
        w += ln - _REQ_HDR
        pay_off[i + 1] = w
    return sender, gkey, req_id, flags, pay_off, b"".join(chunks)


# --------------------------------------------------------------------------
# encode_responses
# --------------------------------------------------------------------------


def encode_responses(sender: int, gkey: np.ndarray, req_id: np.ndarray,
                     status: np.ndarray,
                     payloads: Sequence[bytes]) -> bytes:
    """Encode n Response frames into ONE pre-framed buffer (each frame
    length-prefixed) for a single socket write."""
    n = len(gkey)
    lib = _load()
    if lib is not None and n:
        gkey = np.ascontiguousarray(gkey, np.uint64)
        req_id = np.ascontiguousarray(req_id, np.uint64)
        status = np.ascontiguousarray(status, np.uint8)
        pay_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in payloads], out=pay_off[1:])
        pay = np.frombuffer(b"".join(payloads), np.uint8) if pay_off[n] \
            else np.empty(1, np.uint8)
        cap = int(pay_off[n]) + n * (4 + _REQ_HDR)
        out = np.empty(cap, np.uint8)
        w = lib.gp_encode_responses(
            sender, n, _p(gkey, ctypes.c_uint64),
            _p(req_id, ctypes.c_uint64), _p(status, ctypes.c_uint8),
            _p(pay_off, ctypes.c_int64), _p(pay, ctypes.c_uint8),
            _p(out, ctypes.c_uint8), cap)
        if w < 0:
            raise ValueError("encode_responses: buffer overflow")
        return out[:w].tobytes()
    # fallback
    import struct
    parts = []
    for i in range(n):
        body = (bytes([2]) + struct.pack("<II", sender, 1) +
                struct.pack("<QQB", int(gkey[i]), int(req_id[i]),
                            int(status[i])) + payloads[i])
        parts.append(struct.pack("<I", len(body)) + body)
    return b"".join(parts)


# --------------------------------------------------------------------------
# coalesce_max
# --------------------------------------------------------------------------


def coalesce_max(row: np.ndarray, slot: np.ndarray,
                 bal: np.ndarray) -> np.ndarray:
    """Bool mask keeping, per (row, slot), the highest-ballot lane (first
    occurrence on ties); negative rows dropped."""
    n = len(row)
    lib = _load()
    if lib is not None and n:
        row = np.ascontiguousarray(row, np.int32)
        slot = np.ascontiguousarray(slot, np.int32)
        bal = np.ascontiguousarray(bal, np.int32)
        keep = np.empty(n, np.uint8)
        kept = lib.gp_coalesce_max(
            _p(row, ctypes.c_int32), _p(slot, ctypes.c_int32),
            _p(bal, ctypes.c_int32), n, _p(keep, ctypes.c_uint8))
        if kept < 0:
            raise MemoryError("coalesce_max")
        return keep.astype(bool)
    best: dict = {}
    for i in range(n):
        if row[i] < 0:
            continue
        k = (int(row[i]), int(slot[i]))
        if k not in best or int(bal[i]) > int(bal[best[k]]):
            best[k] = i
    keep = np.zeros(n, bool)
    for i in best.values():
        keep[i] = True
    return keep


# --------------------------------------------------------------------------
# KeyRowMap
# --------------------------------------------------------------------------


class KeyRowMap:
    """u64 gkey -> i32 device row (ref: ``MultiArrayMap``/``IntegerMap``).

    Native open-addressing map when available, else a dict.  ``get_batch``
    is the hot call: one C call for a whole packet batch.

    Thread safety: the native map is NOT internally synchronized, and
    ctypes releases the GIL during calls — a ``put`` that grows the table
    frees the arrays a concurrent ``get_batch`` could be scanning.  All
    native calls therefore take a Python-level lock (mutations come from
    the worker thread and the public create/delete API; contention is
    negligible next to the batch work).
    """

    MISSING = -1

    def __init__(self, cap_hint: int = 1024):
        self._lib = _load()
        self._h = None
        self._d: Optional[dict] = None
        self._lock = threading.Lock()
        if self._lib is not None:
            self._h = self._lib.gp_map_new(cap_hint)
        if self._h is None:
            self._d = {}

    def put(self, key: int, row: int) -> None:
        if self._d is not None:
            self._d[key] = row
            return
        with self._lock:
            if self._lib.gp_map_put(self._h, key, row) != 0:
                raise MemoryError("gp_map_put")

    def get(self, key: int) -> int:
        if self._d is not None:
            return self._d.get(key, self.MISSING)
        out = np.empty(1, np.int32)
        with self._lock:
            self._lib.gp_map_get_batch(
                self._h, _p(np.asarray([key], np.uint64),
                            ctypes.c_uint64), 1,
                _p(out, ctypes.c_int32), self.MISSING)
        return int(out[0])

    def get_batch(self, keys: np.ndarray) -> np.ndarray:
        """i32 rows; MISSING (-1) where absent."""
        if self._d is not None:
            return np.asarray(
                [self._d.get(int(k), self.MISSING) for k in keys],
                np.int32)
        keys = np.ascontiguousarray(keys, np.uint64)
        out = np.empty(len(keys), np.int32)
        with self._lock:
            self._lib.gp_map_get_batch(
                self._h, _p(keys, ctypes.c_uint64), len(keys),
                _p(out, ctypes.c_int32), self.MISSING)
        return out

    def delete(self, key: int) -> bool:
        if self._d is not None:
            return self._d.pop(key, None) is not None
        with self._lock:
            return bool(self._lib.gp_map_del(self._h, key))

    def __len__(self) -> int:
        if self._d is not None:
            return len(self._d)
        with self._lock:
            return int(self._lib.gp_map_size(self._h))

    def __del__(self):
        if self._h is not None and self._lib is not None:
            self._lib.gp_map_free(self._h)
            self._h = None


def have_native() -> bool:
    return _load() is not None


# --------------------------------------------------------------------------
# encode_wal
# --------------------------------------------------------------------------


def encode_wal(rtype: np.ndarray, gkey: np.ndarray, slot: np.ndarray,
               bal: np.ndarray, req: np.ndarray,
               payloads: Sequence[bytes], crc: bool = False) -> bytes:
    """Encode n WAL records into one contiguous buffer in the logger's
    ``_REC`` layout — ONE C call instead of a struct.pack per record.
    ``crc=True`` emits the v2 frame (PC.WAL_CRC): a trailing zlib-CRC32
    over header+payload per record; callers pass ``logger.wal_crc`` so
    the buffer matches the segment files' version."""
    n = len(rtype)
    lib = _load()
    pay_off = np.zeros(n + 1, np.int64)
    if payloads:
        np.cumsum([len(p) for p in payloads], out=pay_off[1:])
    if lib is not None and n:
        rtype = np.ascontiguousarray(rtype, np.uint8)
        gkey = np.ascontiguousarray(gkey, np.uint64)
        slot = np.ascontiguousarray(slot, np.int32)
        bal = np.ascontiguousarray(bal, np.int32)
        req = np.ascontiguousarray(req, np.uint64)
        pay = np.frombuffer(b"".join(payloads), np.uint8) if pay_off[n] \
            else np.empty(1, np.uint8)
        cap = int(pay_off[n]) + n * (33 if crc else 29)
        out = np.empty(cap, np.uint8)
        fn = lib.gp_encode_wal_crc if crc else lib.gp_encode_wal
        w = fn(
            n, _p(rtype, ctypes.c_uint8), _p(gkey, ctypes.c_uint64),
            _p(slot, ctypes.c_int32), _p(bal, ctypes.c_int32),
            _p(req, ctypes.c_uint64), _p(pay_off, ctypes.c_int64),
            _p(pay, ctypes.c_uint8), _p(out, ctypes.c_uint8), cap)
        if w < 0:
            raise ValueError("encode_wal: buffer overflow")
        return out[:w].tobytes()
    # fallback (logger._REC layout)
    import struct
    import zlib
    rec = struct.Struct("<BQiiQI")
    crc_s = struct.Struct("<I")
    parts = []
    for i in range(n):
        p = payloads[i] if payloads else b""
        hdr = rec.pack(int(rtype[i]), int(gkey[i]), int(slot[i]),
                       int(bal[i]), int(req[i]), len(p))
        if crc:
            body = hdr + p
            parts.append(body)
            parts.append(crc_s.pack(zlib.crc32(body)))
        else:
            parts.append(hdr)
            if p:
                parts.append(p)
    return b"".join(parts)
