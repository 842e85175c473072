"""Durable log: append-only WAL + checkpoint/pause tables.

Reference analog: ``gigapaxos/AbstractPaxosLogger.java`` (async batched
logging SPI) + ``gigapaxos/SQLPaxosLogger.java`` (embedded-Derby WAL with
messages/checkpoint/pause tables, group-commit batching, log GC below the
checkpointed slot) + ``paxosutil/LargeCheckpointer`` (out-of-band big
checkpoints — here unnecessary: blobs live in sqlite, which handles large
values; a file-streaming path can be added behind the same SPI).

Design:

- **WAL**: append-only *segments* ``wal-<k>.log``, one per engine lane
  (PC.ENGINE_SHARDS; a single-lane node has exactly ``wal-0.log``).  A
  group's records live in exactly one segment (its shard's), so
  per-group record order is preserved across the split and recovery
  simply replays every segment.  Each segment has its own file handle,
  lock, and group commit — lanes fsync concurrently (``os.fsync``
  releases the GIL).  A dedicated writer thread drains a queue, writes
  a batch, fsyncs ONCE per touched segment, then resolves the batch's
  futures — group commit.  The durability ordering contract (SURVEY
  §7.3.2: log the accept BEFORE sending the accept-reply) is expressed
  by awaiting the returned future before the reply batch is sent — one
  fsync barrier per kernel batch, never per packet.  Migration: a
  legacy single ``wal.log`` is adopted as segment 0 on first boot.
- **sqlite3** (stdlib; the Derby analog) for cold structured state:
  checkpoints(gkey -> name, version, members, slot, app-state blob),
  pause(gkey -> hot-state blob), groups (birth records).
- **GC/compaction**: when the WAL exceeds a threshold, live entries (slot >
  group's checkpointed slot) are rewritten to a fresh segment and the old
  one is deleted.

Durability hardening (the storage fault plane's counterpart):

- **Per-record CRC32 (v2 frame, PC.WAL_CRC)**: a v2 segment file opens
  with an 8-byte magic header and every record carries a trailing
  CRC32 over header+payload.  Version-gated: a headerless file replays
  with the old torn-tail-only semantics, and boot normalizes the
  *current* generation of each active segment to the configured
  version (rewrite in place).  A mid-segment CRC mismatch QUARANTINES
  the segment from that record on — the clean prefix replays, the
  damage is surfaced in :meth:`wal_health`, and checkpoint transfer
  re-syncs the affected groups — instead of silently replaying garbage
  or truncating acked records.
- **fsync-failure semantics (fsyncgate)**: a failed fsync means the
  kernel may have DROPPED the dirty pages; retrying fsync on the same
  fd silently succeeds over lost data.  So a failed fsync (or write)
  poisons that segment handle permanently: the lane rotates to a fresh
  generation file ``wal-<k>.<gen>.log``, re-appends the not-yet-acked
  group-commit buffer, and fsyncs THAT before the caller acks.  If the
  rotated handle fails too, the device (not the fd) is broken and the
  node enters declared **degraded mode** (:class:`WalDegradedError`;
  the owning node stops acking accepts, keeps learning commits, flips
  ``/healthz``).
- **ENOSPC**: raises :class:`WalFullError` (the node sheds new
  proposals with a distinct status) and requests emergency compaction;
  the flag clears on the next successful append.
- The deterministic fault injector driving all of this lives in
  ``chaos/faults.py``
  (:class:`~gigapaxos_tpu_torch.chaos.faults.StorageChaos`);
  :func:`corrupt_wal_record` is its offline half (post-crash bit
  flips).
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import queue
import sqlite3
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from gigapaxos_tpu_torch.chaos.faults import StorageChaos
from gigapaxos_tpu_torch.utils.logutil import get_logger
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

log = get_logger("gp.logger")

# WAL record: type u8 | gkey u64 | slot i32 | bal i32 | req u64 | len u32
_REC = struct.Struct("<BQiiQI")
REC_ACCEPT = 1
REC_DECIDE = 2

# v2 frame (PC.WAL_CRC): file magic + a trailing CRC32 (zlib/IEEE, over
# header+payload) per record.  A v1 record never starts with 'G'
# (rtype is 1 or 2), so detection is unambiguous.
_WAL_MAGIC = b"GPWAL2\r\n"
_CRC = struct.Struct("<I")
# checkpoint state-blob envelope (same CRC discipline as WAL records)
_CKPT_MAGIC = b"gpck2\x00"


class WalImpairedError(RuntimeError):
    """Base: the WAL cannot make this batch durable — callers must NOT
    ack anything riding on it."""


class WalFullError(WalImpairedError):
    """ENOSPC: nothing was appended; emergency compaction was
    requested.  Clears on the next successful append."""


class WalDegradedError(WalImpairedError):
    """A poisoned handle's replacement generation ALSO failed: the
    device, not the fd, is broken.  Sticky until restart."""


@dataclass
class LogEntry:
    rtype: int
    gkey: int
    slot: int
    bal: int
    req_id: int
    payload: bytes = b""


@dataclass
class CheckpointRec:
    gkey: int
    name: str
    version: int
    members: Tuple[int, ...]
    slot: int
    state: bytes


def corrupt_wal_record(path: str, index: int,
                       field: str = "payload") -> int:
    """Flip one bit in the ``index``-th record of a WAL segment file —
    the OFFLINE half of the storage fault plane (post-crash media
    corruption at a chosen record; scenarios call it between kill and
    restart, never on a live file).

    ``field`` picks the byte class: ``"len"`` (the u32 length word),
    ``"header"`` (a gkey byte), ``"payload"`` (first payload byte), or
    ``"crc"`` (first checksum byte; v2 files only).  Returns the
    absolute byte offset flipped."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    v2 = bytes(data[:len(_WAL_MAGIC)]) == _WAL_MAGIC
    off = len(_WAL_MAGIC) if v2 else 0
    i = 0
    while off + _REC.size <= len(data):
        _t, _g, _s, _b, _r, ln = _REC.unpack_from(data, off)
        end = off + _REC.size + ln + (_CRC.size if v2 else 0)
        if end > len(data):
            break
        if i == index:
            if field == "len":
                at = off + 25
            elif field == "header":
                at = off + 1
            elif field == "payload":
                if ln == 0:
                    raise ValueError(f"record {index} has no payload")
                at = off + _REC.size
            elif field == "crc":
                if not v2:
                    raise ValueError("v1 records carry no CRC")
                at = off + _REC.size + ln
            else:
                raise ValueError(f"unknown field {field!r}")
            data[at] ^= 0x40
            with open(path, "wb") as f:
                f.write(data)
            return at
        off = end
        i += 1
    raise IndexError(f"record {index} not found in {path}")


class PaxosLogger:
    """WAL + checkpoint store for one node."""

    def __init__(self, dirpath: str, sync: bool = True,
                 compact_threshold_bytes: int = 256 * 1024 * 1024,
                 segments: int = 1, node_id: int = 0,
                 wal_crc: bool = True):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.sync = sync
        self.compact_threshold = compact_threshold_bytes
        self.segments = max(1, int(segments))
        # identity for the storage fault plane's (node, segment) keying
        self.node_id = int(node_id)
        # v2 CRC framing for everything written from here on (files the
        # node APPENDS to are normalized below; read paths auto-detect
        # per file, so foreign/old segments replay either way)
        self.wal_crc = bool(wal_crc)
        # migration from the pre-segmented layout: the old single
        # wal.log becomes segment 0 on first boot (rename, no rewrite)
        legacy = os.path.join(dirpath, "wal.log")
        if os.path.exists(legacy):
            if not os.path.exists(self._seg_path(0)):
                os.replace(legacy, self._seg_path(0))
            else:
                log.warning("both wal.log and wal-0.log exist in %s; "
                            "reading the legacy file as an extra "
                            "segment-0 prefix", dirpath)
        # health/fault state (guarded by _health_lock; the booleans are
        # also dirty-read on hot paths, the ChaosPlane.enabled idiom)
        self._health_lock = threading.Lock()
        self._degraded = False
        self._disk_full = False
        self._rotations = 0
        self._quarantined: List[dict] = []
        self._ckpt_bad = 0
        # per-segment write generation: gen 0 is wal-<k>.log, a rotated
        # lane appends to wal-<k>.<gen>.log.  Boot resumes at the
        # highest generation on disk; older generations are read-only
        # (replayed, then GC'd like stale segments).
        disk = self._disk_segments()
        self._gen = [0] * self.segments
        for s, g, _p in disk:
            if 0 <= s < self.segments:
                self._gen[s] = max(self._gen[s], g)
        # normalize the CURRENT generation of each active segment to
        # the configured frame version (the WAL_CRC migration path:
        # upgrade adds per-record CRCs, downgrade strips them)
        for k in range(self.segments):
            self._normalize_format(self._seg_path(k, self._gen[k]))
        self._wals = [self._open_seg(k) for k in range(self.segments)]
        # segments left over from a larger ENGINE_SHARDS setting (and a
        # legacy wal.log kept because wal-0.log already existed, index
        # -1), plus superseded generations of active segments: still
        # replayed by read_wal, never written again; compaction GCs
        # them below the checkpoints and deletes fully-drained files so
        # neither taxes recovery forever
        self._stale_segs = [
            p for s, g, p in disk
            if s >= self.segments or s < 0
            or (0 <= s < self.segments and g < self._gen[s])]
        # compaction runs on the writer thread (it rewrites a whole
        # segment); the hot path only ever *requests* it when the inline
        # write crosses the threshold
        self._compact_pending = [False] * self.segments
        # per-segment lock: serializes that segment's file writes
        # (writer thread, inline lane writes) vs compaction's
        # snapshot+replace+handle-swap — without it, entries fsync-acked
        # between compact's snapshot and its replace would be silently
        # lost.  Locks are per segment so lanes never convoy on each
        # other's fsync.
        self._wal_locks = [threading.Lock()
                           for _ in range(self.segments)]
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # flight recorder (set by the owning node after construction,
        # boot-path single-writer): when armed, inline WAL appends note
        # their post-write segment offsets into the capture ring
        self.blackbox = None
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True, name="gp-wal")
        self._writer.start()

        self._db = sqlite3.connect(
            os.path.join(dirpath, "meta.db"), check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            self._db.executescript(
                """
                CREATE TABLE IF NOT EXISTS checkpoints(
                  gkey INTEGER PRIMARY KEY, name TEXT, version INTEGER,
                  members TEXT, slot INTEGER, state BLOB);
                CREATE TABLE IF NOT EXISTS pause(
                  gkey INTEGER PRIMARY KEY, hot BLOB);
                CREATE TABLE IF NOT EXISTS groups(
                  gkey INTEGER PRIMARY KEY, name TEXT, version INTEGER,
                  members TEXT);
                """)
            self._db.commit()

    # -- WAL ---------------------------------------------------------------

    def _seg_path(self, seg: int, gen: int = 0) -> str:
        if gen:
            return os.path.join(self.dir, f"wal-{seg}.{gen}.log")
        return os.path.join(self.dir, f"wal-{seg}.log")

    def _open_seg(self, seg: int):
        f = open(self._seg_path(seg, self._gen[seg]), "ab")
        if self.wal_crc and f.tell() == 0:
            f.write(_WAL_MAGIC)
            f.flush()
        return f

    def _normalize_format(self, path: str) -> None:
        """Rewrite ``path`` in the configured frame version if it is
        non-empty and disagrees (boot-time WAL_CRC migration; the
        rewrite verifies nothing on upgrade — v1 carries no checksums
        to verify — and drops any quarantined suffix on downgrade)."""
        try:
            if os.path.getsize(path) == 0:
                return
        except OSError:
            return
        with open(path, "rb") as f:
            head = f.read(len(_WAL_MAGIC))
        if (head == _WAL_MAGIC) == self.wal_crc:
            return
        with open(path, "rb") as f:
            entries, _q = self._parse_ex(f.read())
        self._rewrite(path, entries, self.wal_crc)
        log.info("wal %s: rewritten as %s frames (WAL_CRC migration)",
                 path, "v2" if self.wal_crc else "v1")

    def segment_stats(self) -> List[dict]:
        """Per-segment WAL lag view for the introspection plane: bytes
        written since the segment's last compaction rewrite (``tell()``
        of the append handle — no stat syscall) and whether a
        compaction is queued.  Growth toward ``compact_threshold``
        is the 'WAL segment lag' signal ``GET /groups`` reports."""
        out = []
        for k, wal in enumerate(self._wals):
            with self._wal_locks[k]:
                try:
                    size = wal.tell()
                except ValueError:  # closed mid-shutdown
                    size = -1
                gen = self._gen[k]
            out.append({"segment": k, "bytes": size, "gen": gen,
                        "compacting": bool(self._compact_pending[k])})
        return out

    def wal_health(self) -> dict:
        """Durability health for the node's metrics/healthz surface:
        degraded/disk-full flags, successful handle rotations,
        quarantined-segment records (CRC mismatches found at
        recovery), and dropped corrupt checkpoints."""
        gens = []
        for k in range(self.segments):
            with self._wal_locks[k]:
                gens.append(self._gen[k])
        with self._health_lock:
            return {
                "degraded": self._degraded,
                "disk_full": self._disk_full,
                "rotations": self._rotations,
                "quarantined": list(self._quarantined),
                "ckpt_bad": self._ckpt_bad,
                "generations": gens,
            }

    def impaired(self) -> Optional[str]:
        """``"degraded"`` / ``"disk_full"`` / None — ONE dirty read per
        call, cheap enough for the request hot path (mutations are
        under ``_health_lock``; the flags are monotone enough that a
        stale read only delays gating by one batch)."""
        if self._degraded:
            return "degraded"
        if self._disk_full:
            return "disk_full"
        return None

    def log_batch(self, entries: List[LogEntry], seg: int = 0) -> Future:
        """Queue entries; the future resolves AFTER they are fsync-durable.
        (ref: AbstractPaxosLogger.logBatch + group commit in
        SQLPaxosLogger)"""
        fut: Future = Future()
        if self._closed:
            # never hand out a future nobody will resolve (shutdown race)
            fut.set_exception(RuntimeError("logger closed"))
            return fut
        if not entries:
            fut.set_result(0)
            return fut
        self._q.put((entries, fut, seg))
        return fut

    def log_raw(self, buf: bytes, seg: int = 0) -> Future:
        """Queue a PRE-ENCODED record buffer (``native.encode_wal`` — the
        hot path's one-C-call replacement for a struct.pack per entry;
        callers must encode with ``crc=logger.wal_crc`` so the frame
        version matches the segment files).  Future resolves after
        fsync, same contract as :meth:`log_batch`."""
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("logger closed"))
            return fut
        if not buf:
            fut.set_result(0)
            return fut
        self._q.put((buf, fut, seg))
        return fut

    def log_raw_inline(self, buf: bytes, fsync: Optional[bool] = None,
                       n_entries: int = 1, seg: int = 0) -> None:
        """Write + (fsync) a pre-encoded buffer ON THE CALLING THREAD.

        All hot-path logging comes from one engine lane's worker thread
        (``seg`` = that lane's WAL segment), so the writer-thread
        hand-off buys no extra group commit — it only adds two GIL
        convoy hops (queue put -> writer wake -> future wake) per batch,
        which measured ~2-5ms each on a saturated 1-core host.  Group
        commit across packets already happened when the worker built the
        batch; across lanes, each segment group-commits independently.
        The queue path remains for callers that want async durability
        (checkpoint writers, tests).

        Raises :class:`WalFullError` / :class:`WalDegradedError` when
        the batch could NOT be made durable — the caller must not ack
        anything riding on it.  A transient fsync/write failure is
        absorbed here (poison + rotate + re-append) and does NOT raise.
        """
        if self._closed:
            raise RuntimeError("logger closed")
        t0 = time.monotonic()
        # hot-path WAL logging runs on the worker's engine stage, so
        # this span carries that batch's wave id — the "WAL fsync"
        # slice of a traced request's decomposition
        sp = RequestInstrumenter.span_begin("wal", entries=n_entries,
                                            seg=seg)
        try:
            with self._wal_locks[seg]:
                off, over = self._append_locked(
                    seg, buf, self.sync if fsync is None else fsync)
        finally:
            RequestInstrumenter.span_end(sp)
        bb = self.blackbox
        if bb is not None:
            bb.note_wal(RequestInstrumenter.current_wave(), seg, off,
                        n_entries)
        DelayProfiler.update_delay("wal.fsync", t0)
        if self.segments > 1:
            # per-segment tail next to the node-wide one: lane skew
            # (one hot shard fsyncing 10x the others) must be visible
            DelayProfiler.update_delay(f"wal.fsync@{seg}", t0)
        DelayProfiler.update_rate("wal.entries", n_entries)
        if over and not self._compact_pending[seg]:
            # hand the rewrite to the writer thread — the worker must
            # not stall for a whole-segment rewrite (ref: SQLPaxosLogger
            # log GC below the checkpointed slot, done off-path)
            self._compact_pending[seg] = True
            self._q.put(("__compact__", None, seg))

    def _append_locked(self, seg: int, buf: bytes,
                       want_sync: bool) -> Tuple[int, bool]:
        """Write ``buf`` to the segment's current generation and make
        it durable (``want_sync``), absorbing storage faults per the
        hardening contract (module docstring).  Caller holds
        ``_wal_locks[seg]``.  Returns (post-write offset, over
        compaction threshold)."""
        if self._degraded:
            # fail fast: the device is declared broken; don't grind a
            # rotation attempt per batch
            raise WalDegradedError("wal is in degraded mode")
        wal = self._wals[seg]
        # the handle MUST be resolved under the lock: compact_segment
        # and rotation swap self._wals[seg] and close the old handle
        # while holding it, so a reference captured before blocking on
        # the lock dangles at a closed file
        if StorageChaos.enabled:
            full, keep = StorageChaos.on_append(self.node_id, seg,
                                                len(buf))
            if full:
                self._note_disk_full(seg)
                raise WalFullError(
                    f"injected ENOSPC on wal seg {seg}")
            if keep < len(buf):
                # torn append: a prefix lands, then the device errors —
                # this generation's tail can no longer be trusted, so
                # poison it and move the WHOLE batch to a fresh one
                # (recovery drops the torn prefix as a torn tail)
                with contextlib.suppress(OSError):
                    wal.write(buf[:keep])
                    wal.flush()
                return self._rotate_locked(seg, buf, want_sync,
                                           "torn append")
        try:
            wal.write(buf)
            wal.flush()
        except OSError as exc:
            if exc.errno == errno.ENOSPC:
                self._note_disk_full(seg)
                raise WalFullError(str(exc)) from exc
            return self._rotate_locked(seg, buf, want_sync,
                                       f"write failed ({exc})")
        if want_sync:
            if StorageChaos.enabled:
                fail, delay = StorageChaos.on_fsync(self.node_id, seg)
                if delay > 0.0:
                    time.sleep(delay)  # injected slow disk
                if fail:
                    return self._rotate_locked(seg, buf, want_sync,
                                               "injected fsync EIO")
            try:
                os.fsync(wal.fileno())
            except OSError as exc:
                if exc.errno == errno.ENOSPC:
                    self._note_disk_full(seg)
                    raise WalFullError(str(exc)) from exc
                return self._rotate_locked(seg, buf, want_sync,
                                           f"fsync failed ({exc})")
        if self._disk_full:
            # a successful durable append means space came back
            with self._health_lock:
                self._disk_full = False
        off = wal.tell()
        return off, off >= self.compact_threshold

    def _rotate_locked(self, seg: int, buf: bytes, want_sync: bool,
                       reason: str) -> Tuple[int, bool]:
        """fsyncgate handling: the old handle is POISONED (a failed
        fsync may have dropped the dirty pages; retrying fsync on the
        same fd silently succeeds over lost data — never do that).
        Open the next generation file, re-append the not-yet-acked
        buffer, and fsync THAT.  If the fresh handle fails too the
        device is broken: declare degraded mode.  Caller holds
        ``_wal_locks[seg]``."""
        old = self._wals[seg]
        new_gen = self._gen[seg] + 1
        new_path = self._seg_path(seg, new_gen)
        log.warning("wal seg %d: %s — poisoning generation %d, "
                    "rotating to %s", seg, reason, self._gen[seg],
                    os.path.basename(new_path))
        nf = None
        try:
            nf = open(new_path, "ab")
            if self.wal_crc and nf.tell() == 0:
                nf.write(_WAL_MAGIC)
            if buf:
                nf.write(buf)
            nf.flush()
            # latch-only consult (no probability draw): a transient
            # injected EIO is an error on the OLD fd's dirty pages — a
            # fresh handle succeeds, that's WHY rotation saves the
            # batch.  Only a persistent rule (whole device latched
            # dead) makes the rotated handle fail too.
            if StorageChaos.enabled and \
                    StorageChaos.is_poisoned(self.node_id, seg):
                raise OSError(errno.EIO,
                              "injected fsync EIO (device latched)")
            if want_sync:
                os.fsync(nf.fileno())
        except OSError as exc:
            if nf is not None:
                with contextlib.suppress(OSError):
                    nf.close()
            with self._health_lock:
                self._degraded = True
            raise WalDegradedError(
                f"wal seg {seg}: rotation after '{reason}' failed too "
                f"({exc}) — storage declared degraded") from exc
        old_path = self._seg_path(seg, self._gen[seg])
        self._wals[seg] = nf
        self._gen[seg] = new_gen
        with self._health_lock:
            self._rotations += 1
        # the poisoned generation still holds every previously-fsynced
        # record: recovery replays it like any stale segment, and
        # compaction GCs it below the checkpoints
        self._stale_segs.append(old_path)
        with contextlib.suppress(OSError):
            old.close()
        if self._disk_full:
            with self._health_lock:
                self._disk_full = False
        off = nf.tell()
        return off, off >= self.compact_threshold

    def _note_disk_full(self, seg: int) -> None:
        """ENOSPC: flag the node (the owner sheds new proposals with a
        distinct status) and request emergency compaction — dropping
        below-checkpoint entries is the one way to FREE space.  Caller
        holds ``_wal_locks[seg]``."""
        with self._health_lock:
            self._disk_full = True
        if not self._compact_pending[seg]:
            self._compact_pending[seg] = True
            self._q.put(("__compact__", None, seg))

    def _pack_entries(self, entries: List[LogEntry]) -> List[bytes]:
        parts: List[bytes] = []
        for e in entries:
            hdr = _REC.pack(e.rtype, e.gkey, e.slot, e.bal, e.req_id,
                            len(e.payload))
            if self.wal_crc:
                body = hdr + e.payload
                parts.append(body)
                parts.append(_CRC.pack(zlib.crc32(body)))
            else:
                parts.append(hdr)
                if e.payload:
                    parts.append(e.payload)
        return parts

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            # opportunistically coalesce everything queued (group commit)
            try:
                while True:
                    nxt = self._q.get_nowait()
                    if nxt is None:
                        self._q.put(None)
                        break
                    batch.append(nxt)
            except queue.Empty:
                pass
            t0 = time.monotonic()
            bufs: dict = {}  # seg -> [chunks]
            compact_req: List[int] = []
            for entries, _, seg in batch:
                if entries == "__compact__":
                    compact_req.append(seg)
                    continue
                chunks = bufs.setdefault(seg, [])
                if isinstance(entries, (bytes, bytearray)):
                    chunks.append(entries)  # pre-encoded (log_raw)
                    continue
                chunks.extend(self._pack_entries(entries))
            try:
                for seg, chunks in bufs.items():
                    with self._wal_locks[seg]:
                        self._append_locked(seg, b"".join(chunks),
                                            self.sync)
                for _, fut, _seg in batch:
                    if fut is not None:
                        fut.set_result(len(batch))
            except Exception as exc:
                for _, fut, _seg in batch:
                    if fut is not None:
                        fut.set_exception(exc)
            DelayProfiler.update_delay("wal.fsync", t0)
            DelayProfiler.update_rate(
                "wal.entries",
                sum(1 if isinstance(e, (bytes, bytearray)) else len(e)
                    for e, _, _ in batch if e != "__compact__"))
            for seg in compact_req:
                try:
                    self.compact_if_needed(seg)
                except Exception:  # pragma: no cover
                    log.exception("WAL segment %d compaction failed", seg)
                finally:
                    self._compact_pending[seg] = False

    def _disk_segments(self) -> List[Tuple[int, int, str]]:
        """(index, generation, path) of every WAL segment file on
        disk, sorted — recovery must read them ALL: segments left over
        from a larger ENGINE_SHARDS setting AND superseded generations
        of active segments (a group's records never span segments, so
        replay order across files of different segments doesn't
        matter; within a segment, generation order IS append order)."""
        out = []
        for fn in os.listdir(self.dir):
            if not (fn.startswith("wal-") and fn.endswith(".log")):
                continue
            stem = fn[4:-4]
            try:
                if "." in stem:
                    k, g = stem.split(".", 1)
                    out.append((int(k), int(g),
                                os.path.join(self.dir, fn)))
                else:
                    out.append((int(stem), 0,
                                os.path.join(self.dir, fn)))
            except ValueError:
                continue
        legacy = os.path.join(self.dir, "wal.log")
        if os.path.exists(legacy):  # both-files edge (see __init__)
            out.append((-1, 0, legacy))
        return sorted(out)

    def read_wal(self) -> List[LogEntry]:
        """Scan all WAL records across every segment file (recovery
        roll-forward).  Per-group order is intact: a group writes to
        exactly one segment, and a segment's generations are read in
        rotation order.

        A CRC mismatch mid-file (v2 frames) quarantines that file from
        the mismatch on: the clean prefix replays, the event is
        recorded in :meth:`wal_health`, and — if the file is an active
        segment's current generation — the segment rotates to a fresh
        generation so new appends never land after the damage."""
        out: List[LogEntry] = []
        for seg, gen, path in self._disk_segments():
            active = (0 <= seg < self.segments
                      and gen == self._gen[seg])
            lock = self._wal_locks[seg] if active \
                else contextlib.nullcontext()
            with lock:
                if active:
                    self._wals[seg].flush()
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    continue  # stale segment GC'd between list and open
            entries, qoff = self._parse_ex(data)
            out.extend(entries)
            if qoff is not None:
                log.error(
                    "wal %s: CRC mismatch at offset %d — quarantined "
                    "from that record on (%d clean records replayed; "
                    "checkpoint transfer re-syncs the rest)",
                    path, qoff, len(entries))
                with self._health_lock:
                    self._quarantined.append({
                        "segment": seg, "gen": gen,
                        "file": os.path.basename(path),
                        "offset": qoff})
                if active:
                    with self._wal_locks[seg]:
                        self._rotate_locked(seg, b"", False,
                                            "crc quarantine")
        return out

    @staticmethod
    def _parse(data: bytes) -> List[LogEntry]:
        return PaxosLogger._parse_ex(data)[0]

    @staticmethod
    def _parse_ex(data: bytes) -> Tuple[List[LogEntry], Optional[int]]:
        """Decode one WAL file image -> (entries, quarantine_offset).
        Version-gated: a file opening with the v2 magic carries a
        trailing CRC32 per record; anything else parses as v1 (the
        pre-CRC format — old logs replay unchanged).  In both versions
        an INCOMPLETE trailing record is a torn tail (pre-fsync crash):
        dropped silently, no quarantine.  Only a v2 record that is
        fully present but fails its checksum quarantines the file from
        that offset (corruption, not a crash artifact)."""
        out: List[LogEntry] = []
        n = len(data)
        v2 = data[:len(_WAL_MAGIC)] == _WAL_MAGIC
        off = len(_WAL_MAGIC) if v2 else 0
        while off + _REC.size <= n:
            rtype, gkey, slot, bal, req, ln = _REC.unpack_from(data,
                                                               off)
            end = off + _REC.size + ln
            if v2:
                if end + _CRC.size > n:
                    break  # torn tail write: ignore (pre-fsync crash)
                want = _CRC.unpack_from(data, end)[0]
                if zlib.crc32(data[off:end]) != want:
                    return out, off  # corrupt: quarantine from here
                payload = data[off + _REC.size:end]
                off = end + _CRC.size
            else:
                payload = data[off + _REC.size:end]
                if len(payload) < ln:
                    break  # torn tail write: ignore (pre-fsync crash)
                off = end
            out.append(LogEntry(rtype, gkey, slot, bal, req,
                                bytes(payload)))
        return out, None

    def compact_if_needed(self, seg: Optional[int] = None) -> bool:
        """Rewrite oversized segment(s) keeping only entries above each
        group's checkpointed slot (ref: SQLPaxosLogger log GC below
        checkpoint).  ``seg=None`` checks every segment."""
        segs = range(self.segments) if seg is None else (seg,)
        did = False
        for k in segs:
            if self._wals[k].tell() >= self.compact_threshold \
                    or self._disk_full:
                self.compact_segment(k)
                did = True
        if did and self._stale_segs:
            self._compact_stale()
        return did

    def compact(self) -> None:
        """Compact every segment (tests/maintenance; the runtime path
        compacts per segment as each crosses the threshold)."""
        for k in range(self.segments):
            self.compact_segment(k)
        if self._stale_segs:
            self._compact_stale()

    def _compact_stale(self) -> None:
        """GC leftover segment files — shards from a larger
        ENGINE_SHARDS AND poisoned/superseded generations.  They are
        read-only at runtime (no lane writes them, so no lock), shrink
        as their groups checkpoint past the logged slots, and a fully
        drained file is deleted outright — bounding the disk and
        recovery-scan cost of lowering the shard count or surviving a
        rotation storm."""
        cps = {c.gkey: c.slot for c in self.all_checkpoints()}
        for path in list(self._stale_segs):
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except FileNotFoundError:
                self._stale_segs.remove(path)
                continue
            entries = self._parse(data)
            live = [e for e in entries
                    if e.slot > cps.get(e.gkey, -1)]
            if not live:
                os.remove(path)
                self._stale_segs.remove(path)
                continue
            if len(live) == len(entries):
                continue  # nothing to drop; skip the rewrite
            self._rewrite(path, live, self.wal_crc)

    @staticmethod
    def _rewrite(path: str, entries: List[LogEntry],
                 v2: bool) -> None:
        """Atomically replace a WAL file with exactly ``entries`` in
        frame version ``v2`` (tmp-file + fsync + rename) — the one
        copy of the record byte format shared by live and stale
        compaction, and the WAL_CRC up/downgrade path."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            if v2:
                f.write(_WAL_MAGIC)
            for e in entries:
                hdr = _REC.pack(e.rtype, e.gkey, e.slot, e.bal,
                                e.req_id, len(e.payload))
                if v2:
                    body = hdr + e.payload
                    f.write(body)
                    f.write(_CRC.pack(zlib.crc32(body)))
                else:
                    f.write(hdr)
                    if e.payload:
                        f.write(e.payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def compact_segment(self, seg: int) -> None:
        """Rewrite ONE segment's current generation; sibling segments
        are untouched (their locks are never taken, their bytes never
        read).  Also the WAL_CRC upgrade path: the rewrite emits the
        configured frame version whatever the file held."""
        cps = {c.gkey: c.slot for c in self.all_checkpoints()}
        with self._wal_locks[seg]:
            path = self._seg_path(seg, self._gen[seg])
            self._wals[seg].flush()
            with open(path, "rb") as f:
                data = f.read()
            live = [e for e in self._parse(data)
                    if e.slot > cps.get(e.gkey, -1)]
            old = self._wals[seg]
            self._rewrite(path, live, self.wal_crc)
            self._wals[seg] = open(path, "ab")
            old.close()

    # -- checkpoints -------------------------------------------------------

    def _wrap_state(self, state: bytes) -> bytes:
        """Envelope an app-state blob with a CRC32 (WAL_CRC gates it —
        the checkpoint write path has the same silent-corruption
        exposure as WAL records)."""
        if not self.wal_crc:
            return state
        return _CKPT_MAGIC + _CRC.pack(zlib.crc32(state)) + state

    def _unwrap_state(self, state: bytes) -> Optional[bytes]:
        """Undo :meth:`_wrap_state`.  Un-enveloped blobs (pre-CRC rows)
        pass through.  Returns None when the checksum fails — callers
        treat the checkpoint as ABSENT, so recovery falls back to
        WAL-only replay (and peer checkpoint transfer) instead of
        loading garbage state."""
        if state is None or state[:len(_CKPT_MAGIC)] != _CKPT_MAGIC:
            return state
        body = state[len(_CKPT_MAGIC) + _CRC.size:]
        want = _CRC.unpack_from(state, len(_CKPT_MAGIC))[0]
        if zlib.crc32(body) != want:
            with self._health_lock:
                self._ckpt_bad += 1
            return None
        return body

    def checkpoint(self, rec: CheckpointRec) -> None:
        self.checkpoint_many([rec])

    def checkpoint_many(self, recs: List[CheckpointRec]) -> None:
        with self._db_lock:
            self._db.executemany(
                "INSERT OR REPLACE INTO checkpoints VALUES (?,?,?,?,?,?)",
                [(_signed(r.gkey), r.name, r.version,
                  json.dumps(list(r.members)), r.slot,
                  self._wrap_state(r.state))
                 for r in recs])
            self._db.commit()

    def _ckpt_from_row(self, row) -> Optional[CheckpointRec]:
        state = self._unwrap_state(row[5])
        if state is None:
            log.error("checkpoint for gkey %d failed its CRC — "
                      "dropped (WAL replay / peer transfer recovers "
                      "the group)", _unsigned(row[0]))
            return None
        return CheckpointRec(_unsigned(row[0]), row[1], row[2],
                             tuple(json.loads(row[3])), row[4], state)

    def get_checkpoint(self, gkey: int) -> Optional[CheckpointRec]:
        with self._db_lock:
            row = self._db.execute(
                "SELECT gkey,name,version,members,slot,state "
                "FROM checkpoints WHERE gkey=?",
                (_signed(gkey),)).fetchone()
        if row is None:
            return None
        return self._ckpt_from_row(row)

    def all_checkpoints(self) -> List[CheckpointRec]:
        with self._db_lock:
            rows = self._db.execute(
                "SELECT gkey,name,version,members,slot,state "
                "FROM checkpoints").fetchall()
        return [c for c in (self._ckpt_from_row(r) for r in rows)
                if c is not None]

    def checkpoints_for(self, gkeys: List[int]) -> List[CheckpointRec]:
        """Checkpoint records for exactly these groups, chunked IN
        queries (SQLite's default bound-variable cap is 999) — recovery
        uses this to avoid materializing every state blob in the table
        (paused groups' checkpoints can dominate at million-group
        scale)."""
        out: List[CheckpointRec] = []
        chunk = 500
        with self._db_lock:
            for at in range(0, len(gkeys), chunk):
                part = [_signed(g) for g in gkeys[at:at + chunk]]
                marks = ",".join("?" * len(part))
                out.extend(self._db.execute(
                    "SELECT gkey,name,version,members,slot,state "
                    f"FROM checkpoints WHERE gkey IN ({marks})",
                    part).fetchall())
        return [c for c in (self._ckpt_from_row(r) for r in out)
                if c is not None]

    def delete_checkpoint(self, gkey: int) -> None:
        with self._db_lock:
            self._db.execute("DELETE FROM checkpoints WHERE gkey=?",
                             (_signed(gkey),))
            self._db.commit()

    # -- group birth records (recovery discovers groups from these) -------

    def put_group(self, gkey: int, name: str, version: int,
                  members: Tuple[int, ...]) -> None:
        self.put_groups([(gkey, name, version, members)])

    def put_groups(self, items: List[Tuple[int, str, int,
                                           Tuple[int, ...]]]) -> None:
        """Batched birth records: ONE transaction for n groups (ref: the
        reconfiguration batched-creates knob; 10K-churn configs die on a
        commit per create)."""
        with self._db_lock:
            self._db.executemany(
                "INSERT OR REPLACE INTO groups VALUES (?,?,?,?)",
                [(_signed(g), n, v, json.dumps(list(m)))
                 for g, n, v, m in items])
            self._db.commit()

    def delete_group(self, gkey: int) -> None:
        self.delete_groups([gkey])

    def delete_groups(self, gkeys: List[int]) -> None:
        """Batched delete of birth/checkpoint/pause records: ONE txn."""
        with self._db_lock:
            keys = [(_signed(g),) for g in gkeys]
            self._db.executemany("DELETE FROM groups WHERE gkey=?", keys)
            self._db.executemany("DELETE FROM checkpoints WHERE gkey=?",
                                 keys)
            self._db.executemany("DELETE FROM pause WHERE gkey=?", keys)
            self._db.commit()

    def all_groups(self) -> List[Tuple[int, str, int, Tuple[int, ...]]]:
        with self._db_lock:
            rows = self._db.execute(
                "SELECT gkey,name,version,members FROM groups").fetchall()
        return [(_unsigned(r[0]), r[1], r[2], tuple(json.loads(r[3])))
                for r in rows]

    # -- pause table (ref: DiskMap + hot-restore pause table) --------------

    def pause(self, gkey: int, hot: bytes) -> None:
        self.pause_many([(gkey, hot)])

    def pause_many(self, items: List[Tuple[int, bytes]]) -> None:
        """Batched pause: ONE txn for n groups (the deactivator pauses in
        sweeps; a commit per group would stall the worker)."""
        with self._db_lock:
            self._db.executemany(
                "INSERT OR REPLACE INTO pause VALUES (?,?)",
                [(_signed(g), h) for g, h in items])
            self._db.commit()

    def peek_pause(self, gkey: int) -> Optional[bytes]:
        """Read a pause blob WITHOUT deleting it — the caller deletes via
        :meth:`delete_pause` only after hydration succeeds, so a failed
        unpause never strands the group."""
        with self._db_lock:
            row = self._db.execute(
                "SELECT hot FROM pause WHERE gkey=?",
                (_signed(gkey),)).fetchone()
        return None if row is None else row[0]

    def delete_pause(self, gkey: int) -> None:
        with self._db_lock:
            self._db.execute("DELETE FROM pause WHERE gkey=?",
                             (_signed(gkey),))
            self._db.commit()

    def paused_keys(self) -> List[int]:
        """gkeys of all paused groups (recovery must know them so it can
        leave their rows unhydrated; ref: pause table scan)."""
        with self._db_lock:
            rows = self._db.execute("SELECT gkey FROM pause").fetchall()
        return [_unsigned(r[0]) for r in rows]

    def unpause(self, gkey: int) -> Optional[bytes]:
        with self._db_lock:
            row = self._db.execute(
                "SELECT hot FROM pause WHERE gkey=?",
                (_signed(gkey),)).fetchone()
            if row is None:
                return None
            self._db.execute("DELETE FROM pause WHERE gkey=?",
                             (_signed(gkey),))
            self._db.commit()
        return row[0]

    # -- lifecycle ---------------------------------------------------------

    def close(self, discard: bool = False) -> None:
        """``discard=True`` emulates a crash: queued-but-unwritten WAL
        batches are dropped (their futures fail) instead of being
        flushed — recovery then sees only what was already durable."""
        if self._closed:
            return
        self._closed = True
        if discard:
            try:
                while True:
                    item = self._q.get_nowait()
                    if item is not None and item[1] is not None:
                        item[1].set_exception(
                            RuntimeError("logger aborted"))
            except queue.Empty:
                pass
        self._q.put(None)
        self._writer.join(timeout=5)
        # drain anything enqueued behind the sentinel: fail its futures
        # rather than leaving callers blocked on .result() forever
        try:
            while True:
                item = self._q.get_nowait()
                if item is not None and item[1] is not None:
                    item[1].set_exception(RuntimeError("logger closed"))
        except queue.Empty:
            pass
        for wal in self._wals:
            with contextlib.suppress(OSError, ValueError):
                wal.close()
        with self._db_lock:
            self._db.close()


def _signed(u64: int) -> int:
    """sqlite INTEGER is signed 64-bit; map u64 keys losslessly."""
    return u64 - (1 << 64) if u64 >= 1 << 63 else u64


def _unsigned(i64: int) -> int:
    return i64 + (1 << 64) if i64 < 0 else i64
