"""PaxosNode: the node runtime (ref: ``gigapaxos/PaxosManager.java``).

One ``PaxosNode`` is the analog of one ``PaxosManager`` + its
``PaxosInstanceStateMachine``s: it owns the transport endpoint, the group
table, the durable log, the payload store, and an :class:`AcceptorBackend`
holding ALL groups' consensus state (columnar device arrays or scalar
objects).  Where the reference dispatches each packet to a per-instance
heap object, this runtime drains the demux queue into struct-of-arrays
*kernel batches* (ref analog: ``PaxosPacketBatcher``) and drives whole
batches through the backend — the north-star design (BASELINE.json).

Pipeline (one worker iteration; SURVEY.md §3.1 hot path):

    inq ─ drain ─> partition by type
      REQUEST/PROPOSAL ──> backend.propose ──> AcceptBatch to members
      ACCEPT_BATCH      ──> backend.accept ──> WAL fsync ──> AcceptReplyBatch
      ACCEPT_REPLY      ──> backend.accept_reply ──> CommitBatch to members
      COMMIT_BATCH      ──> backend.commit ──> in-order app.execute
                             ──> Response to waiting clients, checkpoint cut

Threading model: the asyncio loop thread owns sockets only; every frame is
decoded and queued to the single *worker thread*, which owns the backend,
the logger handles, and the app — the single-writer discipline that replaces
the reference's per-instance synchronized blocks.

The port's own copy of ``gigapaxos_tpu/paxos/manager.py``.  It departs
from the reference only where the port differs: the columnar engine is
the port's ``ColumnarBackend`` on ``PC.COLUMNAR_DEVICE`` (``"cuda"``
unless the caller asks for the CPU), and each option whose module is not
ported yet — the native engine, a device mesh (``ENGINE_MESH > 1``)
and the lock witness (``LOCK_WITNESS``) — raises ``NotImplementedError``
at construction instead of running without it.  Engine lanes
(``ENGINE_SHARDS > 1``) run on the port's ``ShardedColumnarBackend``,
one slab and one CUDA stream a lane, and the decode thread hands each
lane one sub-batch at a time (``_worker_loop_sharded``).
"""

from __future__ import annotations

import base64
import contextlib
import itertools
import json
import threading
import time
import queue as queue_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from gigapaxos_tpu_torch import native
from gigapaxos_tpu_torch.net.transport import Transport, WireChunk
from gigapaxos_tpu_torch.ops.types import (NODE_BITS, NODE_MASK, NO_BALLOT,
                                           NO_SLOT, pack_ballot,
                                           unpack_ballot)
from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.paxos.backend import (AcceptorBackend,
                                               ColumnarBackend, ScalarBackend,
                                               ShardedColumnarBackend)
from gigapaxos_tpu_torch.paxos.grouptable import GroupTable
from gigapaxos_tpu_torch.paxos.interfaces import Replicable
from gigapaxos_tpu_torch.paxos.logger import (CheckpointRec, LogEntry,
                                              PaxosLogger, REC_ACCEPT,
                                              REC_DECIDE, WalDegradedError,
                                              WalImpairedError)
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.engineledger import EngineLedger
from gigapaxos_tpu_torch.utils.engineledger import \
    cache_metrics as _cache_metrics
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.logutil import get_logger
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

log = get_logger("gp.node")

FLAG_STOP = 1
FLAG_NOOP = 2
# payload unknown to the sender of this pvalue (prepare-reply carryover
# only): receivers keep their own copy if they have one; executors treat a
# still-missing payload as a gap and sync — never fabricate an empty one
FLAG_MISSING = 4
# client-forced trace sampling (the wire bit; see packets.Request).
# The coordinator also stamps it onto hash-sampled requests at propose
# time, so acceptors honor the verdict even if configured differently.
FLAG_SAMPLED = pkt.Request.FLAG_SAMPLED

_UNSET = object()  # cache-miss sentinel (None is a valid cached value)

# wire-plane frame types the intake path special-cases (hot-loop
# constants: one enum lookup at import, not per frame)
_FRAG_T = int(pkt.PacketType.FRAG)
_HELLO_T = int(pkt.PacketType.WIRE_HELLO)
_REQ_T = int(pkt.PacketType.REQUEST)


def _frames_in(item) -> int:
    """Frame count of one intake-queue item: a raw frame or packet
    object counts 1, a read-chunk list counts its members, a WireChunk
    counts its scanned frames."""
    if isinstance(item, list):
        n = 0
        for x in item:
            n += _frames_in(x)
        return n
    if type(item) is WireChunk:
        return len(item)
    return 1


def _no_cpu_clock():
    """Stand-in for time.thread_time when PC.PROFILE_CPU is off —
    update_total skips the CPU column for a None t0."""
    return None


@dataclass
class _InFlight:
    """Coordinator-side in-flight proposal (dedupe + accept re-drive).

    ``bal`` is the ballot the slot was assigned under: the re-drive only
    ever retransmits at THAT ballot — re-emitting an old value at a newer
    ballot could collide with the new regime's carryover at the same
    (ballot, slot) and fork the RSM.  ``proposed`` feeds the GC reaper
    (never refreshed); ``redriven`` paces the re-drive."""

    row: int
    slot: int
    bal: int
    proposed: float
    redriven: float


class _ReqSoA:
    """A whole wire batch of REQUEST frames as struct-of-arrays — the
    native parse output carried intact into ``_handle_requests`` so the
    entry path runs vectorized (building one ``pkt.Request`` object per
    frame measured ~45us/request of pure Python at 12K req/s)."""

    __slots__ = ("sender", "gkey", "req_id", "flags", "pay_off", "pay")

    def __init__(self, sender, gkey, req_id, flags, pay_off, pay):
        self.sender = sender
        self.gkey = gkey
        self.req_id = req_id
        self.flags = flags
        self.pay_off = pay_off
        self.pay = pay

    def payload(self, i: int) -> bytes:
        return self.pay[self.pay_off[i]:self.pay_off[i + 1]]

    def as_request(self, i: int) -> "pkt.Request":
        return pkt.Request(int(self.sender[i]), int(self.gkey[i]),
                           int(self.req_id[i]), int(self.flags[i]),
                           self.payload(i))


@dataclass(slots=True)
class _Election:
    """Phase-1 bookkeeping at a would-be coordinator (host-side cold path;
    ref: ``PaxosCoordinatorState`` prepare phase).

    ``acks``/``merged`` are LAZY (None until first use): a mass takeover
    creates one of these per led group, and two eager container allocs
    per row were the single biggest cost of a million-row election
    kickoff (measured ~12us/row; ~2us with slots + lazy containers)."""

    bal: int
    started: float
    acks: Optional[Set[int]] = None
    # slot -> (accepted ballot, req_id, flags, payload)
    merged: Optional[Dict[int, Tuple[int, int, int, bytes]]] = None
    cursor: int = 0


class _MassElections:
    """SoA phase-1 bookkeeping for mass takeovers (the columnar analog
    of a million `_Election` dict entries).  Round-5 measurement of the
    1M-group takeover window: the per-lane dict path in the
    prepare-reply merge cost ~2.3us x 4M reply lanes = 9.3s of an
    18.9s blackout, and allocating 1M `_Election` objects another
    ~2s — both replaced here by numpy over whole frames.

    Only the idle-fleet common case lives here (empty accept window,
    cursor caught up); rows that turn out to carry state are converted
    to classic `_Election` objects on first sight and merge through
    the unchanged per-row machinery."""

    __slots__ = ("index", "rows", "bal", "started", "ackcnt",
                 "ackmask", "quorum", "cursor", "n_live", "_bits")

    def __init__(self, cap: int):
        self.index = np.full(cap, -1, np.int32)  # row -> soa position
        self.rows = np.empty(0, np.int64)
        self.bal = np.empty(0, np.int32)
        self.started = np.empty(0, np.float64)
        self.ackcnt = np.empty(0, np.int16)
        self.ackmask = np.empty(0, np.uint64)
        self.quorum = np.empty(0, np.int16)
        self.cursor = np.empty(0, np.int32)
        self.n_live = 0
        self._bits: Dict[int, int] = {}  # sender id -> ackmask bit

    def bit(self, sender: int) -> Optional[np.uint64]:
        b = self._bits.get(sender)
        if b is None:
            if len(self._bits) >= 64:
                return None  # caller degrades those lanes to dict path
            b = len(self._bits)
            self._bits[sender] = b
        return np.uint64(1 << b)

    def _live_positions(self) -> np.ndarray:
        pos = np.arange(len(self.rows))
        return pos[self.index[self.rows] == pos]

    def _compact(self) -> None:
        keep = self._live_positions()
        for f in ("rows", "bal", "started", "ackcnt", "ackmask",
                  "quorum", "cursor"):
            setattr(self, f, getattr(self, f)[keep])
        self.index[self.rows] = np.arange(len(self.rows),
                                          dtype=np.int32)

    def start(self, rows: np.ndarray, bals: np.ndarray, quorum: int,
              now: float) -> None:
        """Open (or re-drive) elections for ``rows`` under ``bals``.
        Re-driven rows keep their slot with counters reset — the same
        replace semantics as the dict path's `_Election` overwrite."""
        if len(self.rows) > 4 * max(self.n_live, 1 << 14):
            self._compact()  # bound growth across repeated cohorts
        rows = np.asarray(rows, np.int64)
        bals = np.asarray(bals, np.int32)
        idx = self.index[rows]
        upd = idx >= 0
        if upd.any():
            iu = idx[upd]
            self.bal[iu] = bals[upd]
            self.started[iu] = now
            self.ackcnt[iu] = 0
            self.ackmask[iu] = 0
            self.cursor[iu] = 0
        fresh = ~upd
        if fresh.any():
            rf = rows[fresh]
            base = len(self.rows)
            self.index[rf] = np.arange(base, base + len(rf),
                                       dtype=np.int32)
            n = len(rf)
            self.rows = np.concatenate([self.rows, rf])
            self.bal = np.concatenate([self.bal, bals[fresh]])
            self.started = np.concatenate(
                [self.started, np.full(n, now)])
            self.ackcnt = np.concatenate(
                [self.ackcnt, np.zeros(n, np.int16)])
            self.ackmask = np.concatenate(
                [self.ackmask, np.zeros(n, np.uint64)])
            self.quorum = np.concatenate(
                [self.quorum, np.full(n, quorum, np.int16)])
            self.cursor = np.concatenate(
                [self.cursor, np.zeros(n, np.int32)])
            self.n_live += n

    def has(self, row: int) -> bool:
        return self.n_live > 0 and self.index[row] >= 0

    def kill(self, rows: np.ndarray) -> None:
        """Close elections for ``rows`` (all currently live)."""
        if len(rows):
            self.index[np.asarray(rows, np.int64)] = -1
            self.n_live -= len(rows)

    def pop(self, row: int):
        """Remove ``row``; returns (bal, started, cursor, acks set) or
        None — the fields a classic `_Election` needs."""
        i = int(self.index[row])
        if i < 0:
            return None
        self.index[row] = -1
        self.n_live -= 1
        mask = int(self.ackmask[i])
        acks = {s for s, b in self._bits.items() if (mask >> b) & 1}
        return (int(self.bal[i]), float(self.started[i]),
                int(self.cursor[i]), acks)

    def stale_rows(self, now: float, backoff: float) -> np.ndarray:
        if not self.n_live:
            return np.empty(0, np.int64)
        pos = self._live_positions()
        return self.rows[pos[now - self.started[pos] >= backoff]]


def _refuse_unported(bk: str) -> None:
    """Raise ``NotImplementedError`` for an option whose module the port
    has not ported yet, before the node opens any file or socket: the
    node never runs without a plane its configuration asks for."""
    # as the reference resolves it: "off", "auto" or an integer N
    mesh = str(Config.get(PC.ENGINE_MESH)).strip().lower()
    refused = [
        (bk == "native", "backend='native' (the C++ per-instance engine, "
         "NativeBackend; ROADMAP module 6b)"),
        (mesh not in ("auto", "off") and int(mesh) > 1,
         "ENGINE_MESH > 1 (a device mesh; ROADMAP module 16)"),
        (bool(Config.get(PC.LOCK_WITNESS)),
         "LOCK_WITNESS (the runtime lock witness; ROADMAP module 15)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(
                f"gigapaxos_tpu_torch: {what} is not ported yet")


class PaxosNode:
    """One replica node (server)."""

    # class-level default so partially built instances (tests drive
    # _decode_batch on a bare __new__ instance) read the plane as off
    blackbox = None

    def __init__(self, node_id: int, addr_map: Dict[int, Tuple[str, int]],
                 app: Replicable, logdir: str,
                 backend: Optional[str] = None,
                 capacity: Optional[int] = None,
                 window: Optional[int] = None):
        self.id = node_id
        self.addr_map = dict(addr_map)
        self.app = app
        cap = capacity or Config.get(PC.CAPACITY)
        win = window or Config.get(PC.WINDOW)
        bk = backend or Config.get(PC.BACKEND)
        _refuse_unported(bk)
        # row-sharded engine lanes (PC.ENGINE_SHARDS; the multi-core
        # scale-up tentpole): shard = gkey % S, each lane owning a slab
        # of cap/S rows on its own CUDA stream, its own worker, and its
        # own WAL segment.  Columnar-only: the scalar engine is a single
        # store with no per-shard state to parallelize.
        self.shards = max(1, int(Config.get(PC.ENGINE_SHARDS)))
        if self.shards > 1 and (bk != "columnar"
                                or cap % self.shards != 0):
            log.warning(
                "ENGINE_SHARDS=%d needs the columnar backend and "
                "capacity %% shards == 0 (backend=%s capacity=%d); "
                "running single-lane", self.shards, bk, cap)
            self.shards = 1
        if bk == "columnar":
            dev = Config.get(PC.COLUMNAR_DEVICE)
            if self.shards > 1:
                self.backend: AcceptorBackend = ShardedColumnarBackend(
                    cap, win, self.shards, device=dev)
            else:
                self.backend = ColumnarBackend(cap, win, device=dev)
        else:
            self.backend = ScalarBackend(win)
        # the native engine's fused C stage handlers: the native engine
        # is not ported, so the handlers' columnar/scalar paths run
        self._fused = None
        # fused columnar coordinator path (propose + own accept + own
        # vote in ONE device call — kernels.propose_accept_self_packed):
        # cuts two kernel calls AND the loopback self-wave per batch,
        # which on a remote accelerator is two fewer link round trips.
        # The sharded facade exposes the same fused surface per slab.
        self._col_self = self.backend \
            if isinstance(self.backend, (ColumnarBackend,
                                         ShardedColumnarBackend)) \
            else None
        # whole-wave fusion (accepts+commits, requests+replies — one
        # engine dispatch per node per wave): "auto" fuses when the
        # engine runs on a CUDA device, where every dispatch pays its
        # launches and host<->device copies; on the CPU it runs split.
        fw = str(Config.get(PC.FUSE_WAVES))
        self._fuse_waves = self._col_self is not None and (
            fw == "on" or (fw == "auto" and
                           self.backend.engine_platform != "cpu"))
        self.table = GroupTable(cap, shards=self.shards)
        self.logger = PaxosLogger(
            logdir, sync=bool(Config.get(PC.SYNC_WAL)),
            compact_threshold_bytes=int(Config.get(PC.WAL_COMPACT_BYTES)),
            segments=self.shards, node_id=node_id,
            wal_crc=bool(Config.get(PC.WAL_CRC)))
        # frame version every encode_wal call must emit (v2 = trailing
        # per-record CRC32) — read once; the logger normalized its
        # segment files to this version at construction
        self._wal_crc = self.logger.wal_crc
        self.batch_size = int(Config.get(PC.BATCH_SIZE))
        self.batch_timeout = float(Config.get(PC.BATCH_TIMEOUT_S))
        self.batch_coalesce = float(Config.get(PC.BATCH_COALESCE_S))
        self.batch_busy = int(Config.get(PC.BATCH_BUSY_ITEMS))
        self.checkpoint_interval = int(Config.get(PC.CHECKPOINT_INTERVAL))
        # stage CPU accounting: thread_time() is a ~6us syscall, so the
        # hot path only samples it when PC.PROFILE_CPU asks for it
        self._ct = time.thread_time \
            if bool(Config.get(PC.PROFILE_CPU)) else _no_cpu_clock

        # host-side per-row mirrors (the cold scalar state the reference
        # keeps in PaxosInstanceStateMachine fields).  Row-indexed numpy
        # arrays, not dicts: the hot handlers update them for whole
        # batches with one vectorized op (np.maximum.at / fancy index)
        # instead of a dict hit per lane.
        self._bal = np.full(cap, NO_BALLOT, np.int32)  # max packed ballot
        self._cur = np.zeros(cap, np.int32)            # host exec cursor
        self._ckpt = np.full(cap, -1, np.int32)        # last ckpt slot
        self._dec: Dict[int, Dict[int, int]] = {}  # row -> slot -> req_id
        # membership matrix for vectorized member-index lookups (rows of
        # -1 padding); MAXM bounds group size (the vote bitmap is u64
        # anyway, and the reference's quorums are 3-7 wide)
        self.MAXM = 8
        self._member_mat = np.full((cap, self.MAXM), -1, np.int32)
        self._row_gkey = np.zeros(cap, np.uint64)
        # req_id -> (flags, payload); popped at local execution
        # (§7.3.5).  Two generations: entries untouched for two GC
        # periods (never-decided requests) are dropped — see
        # _payload_get.
        self._payloads: Dict[int, Tuple[int, bytes]] = {}
        self._payloads_old: Dict[int, Tuple[int, bytes]] = {}
        # entry-replica reply table: req_id -> client node id
        # req_id -> (client/entry id, enqueue ts, gkey): clients waiting
        # on us as their entry replica for a not-yet-executed request
        self._client_wait: Dict[int, Tuple[int, float, int]] = {}
        # coordinator dedupe: req_id -> in-flight record.  The row lets a
        # group delete purge its entries — otherwise a request proposed
        # in a deleted epoch is blackholed at this node forever (every
        # retransmit into the successor epoch hits the dedupe and is
        # dropped).  `proposed` feeds the GC reaping entries whose
        # decision never landed (they would dedupe the req_id and pin the
        # row unpausable forever); `redriven` paces the accept re-drive.
        self._proposed: Dict[int, _InFlight] = {}
        # currently-suspected peers (no ping within failure_timeout).
        # Cleared the moment any frame from the peer arrives.  Drives the
        # periodic run-for-coordinator re-check in _tick (ref:
        # FailureDetection feeding checkRunForCoordinator periodically).
        self._suspects: Set[int] = set()
        # row -> quorum execution watermark learned when WE won its
        # election: until our own cursor reaches it, fresh client
        # proposals for the row are parked.  A freshly revived
        # coordinator has EMPTY dedupe tables — proposing a client
        # retransmit before catching up decides an already-executed
        # request in a second slot (observed in the torture test:
        # count 6 of 5 sends).  Cleared by _tick once caught up.
        self._catchup_barrier: Dict[int, int] = {}
        # row -> [(parked-at, Proposal)]: client traffic that would have
        # been forwarded to a suspect/unknown coordinator while an
        # election is unsettled.  Flushed by _tick or on coordinator
        # install; stale entries age out (client retransmit covers).
        self._parked: Dict[int, List[Tuple[float, pkt.Proposal]]] = {}
        # req_id -> last bounce ts: a stale-forwarded Proposal is bounced
        # onward at most once per window — the second sighting parks it,
        # breaking forward cycles without a wire-format TTL.
        self._bounced: Dict[int, float] = {}
        # Highest slot this acceptor acked + last-accept ts, per row
        # (-1 = none outstanding).  Catch-up trigger: accepted-but-
        # undecided past the cursor for longer than a grace period means
        # the commits were lost — with no later traffic there is no gap
        # signal, so _tick pulls the missing decisions via _sync_if_gap
        # (ref: SyncDecisionsPacket).
        self._acc_hi = np.full(cap, -1, np.int64)
        self._acc_ts = np.zeros(cap, np.float64)
        # Per-lane engine locks: lane k's lock serializes that lane's
        # batch processing against lifecycle calls arriving on OTHER
        # threads (library/harness create_groups/delete_groups): the
        # columnar engine swaps donated device state per call (a
        # concurrent caller can observe a deleted buffer) and ctypes
        # releases the GIL into the C engine.  RLock: control packets
        # create/delete groups from WITHIN worker processing on the
        # same thread.  Lane threads only ever hold their OWN lock;
        # multi-shard lifecycle calls acquire the locks they need in
        # index order (no lane-vs-lifecycle deadlock is possible).
        self._engine_locks = [threading.RLock()
                              for _ in range(self.shards)]
        self._engine_lock = self._engine_locks[0]  # single-lane alias
        # rows whose epoch-stop request has executed: the RSM is closed —
        # later decided slots are skipped and clients told to re-resolve
        # (ref: PaxosInstanceStateMachine stopped/final-state logic)
        self._group_stopped: Set[int] = set()
        # recently executed req_ids — practical at-most-once for client
        # retransmits that cross a coordinator change (ref:
        # GCConcurrentHashMap outstanding-request tables).  TWO
        # GENERATIONS, not timestamps: a sweep that rebuilds a dict of
        # minutes×rate entries on the worker thread stalls it for tens of
        # ms at 30K+ req/s; a generation swap is O(1).  Membership =
        # either generation; entries age out after one-to-two periods.
        self._executed_recent: Dict[int, int] = {}
        self._executed_old: Dict[int, int] = {}
        # req_id -> (status, response bytes) for executed requests: a
        # deduped retransmit is ANSWERED from here, never silently
        # dropped; status-4 (deterministic app failure) entries keep a
        # retried failed request from re-executing in a new slot.  Same
        # two-generation lifetime as _executed_recent.
        self._resp_cache: Dict[int, Tuple[int, bytes]] = {}
        self._resp_cache_old: Dict[int, Tuple[int, bytes]] = {}
        self._elections: Dict[int, _Election] = {}
        self._mass_el: Optional[_MassElections] = None  # lazy (SoA)

        # deactivator (ref: DiskMap pause/unpause + HotRestoreInfo):
        # idle groups are serialized to the durable pause table and their
        # device row freed; packets for a paused group unpause on demand.
        # _la[row] = last-active ts; +inf marks a free (or unpausable)
        # row so the idle sweep is one vectorized compare.
        self._paused: Set[int] = set()
        self._la = np.full(cap, np.inf, np.float64)
        self.pause_idle_s = float(Config.get(PC.PAUSE_IDLE_S))
        self.pause_max_per_tick = int(Config.get(PC.PAUSE_MAX_PER_TICK))

        # intake rate limiting (ref: paxosutil/RateLimiter): token
        # bucket refilled continuously; excess client REQUESTs answered
        # status 1 at the door
        self.intake_rps = float(Config.get(PC.MAX_INTAKE_RPS))
        self._intake_tokens = self.intake_rps
        self._intake_ts = time.time()
        self.backlog_limit = int(Config.get(PC.INTAKE_BACKLOG_LIMIT))
        self.n_shed = 0  # requests answered "retry" by the backlog guard
        # backlog estimate in FRAMES: the queue holds chunk LISTS (one
        # item can be a whole read chunk of thousands of frames), so
        # qsize() alone wildly undercounts.  The worker extrapolates
        # from the frames-per-item ratio of the batch it just collected.
        self._backlog_est = 0
        if bool(Config.get(PC.TRACE_REQUESTS)):
            # only-enable: a manual RequestInstrumenter.enabled = True
            # (the documented runtime switch) must survive later node
            # constructions; tests reset it via their fixture
            RequestInstrumenter.enabled = True
        # cluster tracing plane (PC.TRACE_SAMPLE): deterministic
        # per-request sampling — every node reaches the same verdict
        # from the req_id alone, so a 3-node trace needs zero
        # propagated bytes.  Only-enable, like TRACE_REQUESTS.
        RequestInstrumenter.configure(
            max_age_s=float(Config.get(PC.TRACE_MAX_AGE_S)),
            slow_threshold_s=float(Config.get(PC.SLOW_TRACE_S)),
            slow_k=int(Config.get(PC.SLOW_TRACE_K)))
        trace_sample = float(Config.get(PC.TRACE_SAMPLE))
        if trace_sample > 0:
            RequestInstrumenter.configure(sample_rate=trace_sample)
            RequestInstrumenter.enabled = True
        # chaos fault plane (PC.CHAOS_*, all defaults off): only-enable
        # like the tracing knobs — a plane configured programmatically
        # (scenario runner, /chaos route) survives node constructions
        from gigapaxos_tpu_torch.chaos.faults import ChaosPlane, StorageChaos
        ChaosPlane.configure_from_pc()
        # the disk sibling (PC.STORAGE_CHAOS_*): same only-enable boot
        # mirror; the logger's IO shim consults it per append/fsync
        StorageChaos.configure_from_pc()
        # stashed for the flight recorder's wave hook (chaos fault
        # verdicts ride the W records when the plane is on)
        self._chaos = ChaosPlane
        # failure detection (ref: gigapaxos/FailureDetection.java)
        self._last_heard: Dict[int, float] = {}
        self.ping_interval = float(Config.get(PC.PING_INTERVAL_S))
        self.failure_timeout = float(Config.get(PC.FAILURE_TIMEOUT_S))

        # upper-layer plugin points (ref: AbstractPacketDemultiplexer
        # .register + PaxosManager's periodic tasks): handlers run on the
        # worker thread, preserving the single-writer discipline
        self._handlers: Dict[type, List] = {}
        self._tick_hooks: List = []

        self._inq: "queue_mod.Queue" = queue_mod.Queue()
        # Per-processing-thread batch state (THREAD-LOCAL, see the
        # property block below): the emit hand-off queue, the batched
        # response/outbound buffers, the same-pass self-route buffer,
        # and the batch start stamp.  With engine lanes (S>1) several
        # proc threads run _process concurrently, each with its own
        # buffers; single-lane nodes have exactly one processing
        # thread, so behavior is unchanged.
        self._wtls = threading.local()
        self._stopping = False
        self.transport = Transport(
            node_id, addr_map[node_id], addr_map, self._on_frame,
            on_frames=self._on_frames,
            # wire-plane aggregation (PC.WIRE_*, read once at boot like
            # the stats knobs): per-peer FRAG coalescing on the emit
            # side, SoA WireChunk delivery on the receive side
            wire_coalesce=bool(Config.get(PC.WIRE_COALESCE)),
            coalesce_min=int(Config.get(PC.WIRE_COALESCE_MIN)),
            rx_chunks=bool(Config.get(PC.WIRE_SOA_RX)))
        # flight recorder (PC.BLACKBOX_*; gigapaxos_tpu/blackbox/):
        # the per-node capture ring, armed at construction so every
        # hook site (decode boundary, engine wave, WAL append,
        # transport scan) pays exactly one attribute check when off.
        # The engine-shape knobs are stashed for the dump manifest —
        # offline replay must rebuild this exact engine.
        self._bb_knobs = {"backend": bk, "capacity": cap, "window": win}
        self.blackbox = None
        bb_mb = int(Config.get(PC.BLACKBOX_MB))
        if bb_mb > 0:
            from gigapaxos_tpu_torch.blackbox.recorder import \
                BlackboxRecorder
            self.blackbox = BlackboxRecorder(
                node_id, logdir, max_bytes=bb_mb << 20,
                max_age_s=float(Config.get(PC.BLACKBOX_S)),
                dump_on_slow=bool(Config.get(PC.BLACKBOX_ON_SLOW)),
                manifest_fn=self._blackbox_manifest)
        self.transport.blackbox = self.blackbox
        self.logger.blackbox = self.blackbox
        # the reference's retrace alarm (EngineLedger.add_trigger) has no
        # counterpart: torch does not trace, so nothing re-traces
        self._loop_thread: Optional[threading.Thread] = None
        self._worker_thread: Optional[threading.Thread] = None
        self._loop = None
        self._started = threading.Event()
        # per-node stats listener (PC.STATS_PORT; started on the loop)
        self.stats_http = None

        # ---- tick/transfer state, eagerly initialized (was lazy
        # getattr(self, ..., 0) scattered through the tick path — one
        # typo away from a silent reset and invisible to readers) ----
        # partial chunked-transfer reassembly: (sender, xfer_id) ->
        # [last-touch ts, nchunks, parts]; stalled entries age out in
        # _tick
        self._xfers: Dict[Tuple[int, int], list] = {}
        # outbound chunked-transfer ids: itertools.count is C-atomic,
        # so concurrent lanes can never mint a duplicate xfer id
        self._xfer_seq = itertools.count(1)
        self._last_bounce_gc = 0.0  # _bounced sweep pacing
        self._last_exec_gc = 0.0    # dedupe-generation swap pacing
        self._last_sync: Dict[int, float] = {}  # per-row sync pacing
        self._boot_ts = time.time()  # re-stamped by start()
        # per-lane tick pacing + the global self-stall guard state
        self._last_ticks = [0.0] * self.shards
        self._last_tick_wall = 0.0
        self._stall_streak = 0

        # counters (stats(); VERDICT r2 Weak #9: saturation-induced
        # stalls must be countable, not mystery latency).  Increments
        # happen on S concurrent lane threads, and a bare += is a
        # read-modify-write that loses updates across a GIL switch —
        # the one-per-batch bumps take this (uncontended) lock so the
        # counters stay exact at any shard count.
        self._stat_lock = threading.Lock()
        self.n_executed = 0
        self.n_decided = 0
        self.n_paused = 0
        self.n_unpaused = 0
        self.n_redriven = 0       # accept re-drives (lost-Accept recovery)
        self.n_parked = 0         # proposals parked awaiting leadership
        self.n_park_dropped = 0   # parked proposals dropped at cap
        self.n_redrive_capped = 0  # re-drive ticks that hit the 256 cap
        self.n_installs = 0       # coordinator installs won (failover)
        self.n_shed_disk = 0      # proposals shed status 5 (WAL impaired)
        self.n_wal_nacked = 0     # accepts nacked because WAL failed
        # one-shot latch so the degraded-mode blackbox trigger and log
        # line fire once, not per batch (worker threads, _stat_lock)
        self._degraded_seen = False
        # ballot churn (consensus-health introspection; PAPERS
        # 2006.01885 motivates surfacing leader/ballot churn as a
        # first-class signal): bumped wherever this node adopts a NEW
        # ballot for a row — election installs, preemption adoptions,
        # higher-ballot promises.  Per-row counts feed GET /groups;
        # the node total feeds gp_ballot_changes_total.
        self._bal_changes = np.zeros(cap, np.int64)
        self.n_ballot_changes = 0
        # trace ids FORCED onto this node via FLAG_SAMPLED while the
        # deterministic hash said no (client-forced traces): the
        # vectorized hash prefilters at the dec/com.tx stamp sites
        # would miss them, so they ride this small in-flight set
        # (entries leave at execution)
        self._forced_traces: Set[int] = set()

    # ------------------------------------------------------------------
    # per-processing-thread batch state (thread-local properties).
    # Handlers reference these as plain attributes; backing them with a
    # threading.local lets S lane threads run _process concurrently
    # with independent buffers while keeping every call site unchanged.
    # ------------------------------------------------------------------

    @property
    def _emit_q(self) -> Optional["queue_mod.Queue"]:
        """3-stage/lane hand-off: when not None, _process hands
        (responses, outbound frames) to this thread's emit stage
        instead of flushing inline."""
        return getattr(self._wtls, "emit_q", None)

    @_emit_q.setter
    def _emit_q(self, v) -> None:
        self._wtls.emit_q = v

    @property
    def _resp_out(self) -> Optional[Dict]:
        """Batched client-response buffer, live only inside _process."""
        return getattr(self._wtls, "resp_out", None)

    @_resp_out.setter
    def _resp_out(self, v) -> None:
        self._wtls.resp_out = v

    @property
    def _out_buf(self) -> Optional[List]:
        """Batched outbound sends, live only inside _process: flushed
        as ONE loop hop per worker batch (send_many_threadsafe)."""
        return getattr(self._wtls, "out_buf", None)

    @_out_buf.setter
    def _out_buf(self, v) -> None:
        self._wtls.out_buf = v

    @property
    def _self_buf(self) -> Optional[List]:
        """Self-routed packets accumulated during a pass, processed as
        follow-up waves within the same _process call.  Lane-pure by
        construction: a lane only emits packets for its own groups."""
        return getattr(self._wtls, "self_buf", None)

    @_self_buf.setter
    def _self_buf(self, v) -> None:
        self._wtls.self_buf = v

    @property
    def _batch_t0(self) -> float:
        """Per-batch start stamp (the app-retry sleep budget anchor)."""
        return getattr(self._wtls, "batch_t0", 0.0)

    @_batch_t0.setter
    def _batch_t0(self, v: float) -> None:
        self._wtls.batch_t0 = v

    def _wal_seg(self) -> int:
        """This processing thread's WAL segment (its lane's shard; 0 on
        single-lane nodes and non-lane threads)."""
        return getattr(self._wtls, "wal_seg", 0)

    def _note_wal_impaired(self, exc: WalImpairedError, n: int) -> None:
        """Bookkeeping for an accept batch whose WAL barrier failed:
        count the withdrawn acks, and on the FIRST entry into degraded
        mode fire the blackbox trigger + one error log (the logger's
        degraded flag is sticky until restart, so this fires once)."""
        first = False
        with self._stat_lock:
            self.n_wal_nacked += n
            if isinstance(exc, WalDegradedError) and \
                    not self._degraded_seen:
                self._degraded_seen = first = True
        if first:
            log.error(
                "node %d WAL DEGRADED (%s): accepts nacked and new "
                "proposals shed (status 5) until restart; commits keep "
                "executing and reads keep serving", self.id, exc)
            bb = self.blackbox
            if bb is not None:
                bb.trigger("wal_degraded")

    def _log_decides(self, gkeys, slots, reqs) -> None:
        """Decision WAL append.  Async (fsync=False) AND impairment-
        tolerant: decisions are recoverable from peers, so replies never
        gate on this record and a full/degraded WAL must not stop the
        learner — commits keep executing, recovery re-syncs from peers."""
        try:
            self.logger.log_raw_inline(native.encode_wal(
                np.full(len(slots), REC_DECIDE, np.uint8), gkeys, slots,
                np.zeros(len(slots), np.int32), reqs, [],
                crc=self._wal_crc), fsync=False, n_entries=len(slots),
                seg=self._wal_seg())
        except WalImpairedError:
            pass  # peers hold the decisions; keep learning

    def _now(self) -> float:
        """The engine clock: every time-driven consensus decision
        (redrive, election backoff, failure detection, parked/idle
        sweeps) and every stamp those decisions later compare against
        reads THIS, not ``time.time()``.  Worker loops pin it per wave
        to the batch's decode timestamp — the value the flight
        recorder's F record carries — and ticks run it unpinned (real
        time, captured in the T record), so offline replay re-pins the
        captured values and reproduces each decision bit-for-bit.
        Unpinned threads (event loop, control plane) get real time.
        Measurement-only reads (profiler spans, latency accounting,
        wall-clock sleep budgets) stay on ``time.time()``."""
        now = getattr(self._wtls, "now", 0.0)
        return now if now else time.time()

    def _locks_for(self, shards) -> list:
        """The engine locks a multi-shard lifecycle call must hold,
        acquired in index order (lanes only ever hold their own lock,
        so ordered acquisition cannot deadlock against them)."""
        return [self._engine_locks[k] for k in sorted(set(shards))] \
            or [self._engine_locks[0]]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Boot: recover from the durable log, open sockets, start the
        worker (ref: §3.2 boot & crash recovery)."""
        self._boot_ts = time.time()
        self._recover()
        import asyncio

        def loop_main():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self.transport.start())
            sport = int(Config.get(PC.STATS_PORT))
            if sport >= 0:
                # per-node observability listener: every server process
                # is scrapeable (GET /metrics Prometheus text, /stats
                # JSON) without the full HTTP gateway.  Best-effort: a
                # bind failure (fixed port + two roles in one process)
                # must never take the consensus loop down with it.
                from gigapaxos_tpu_torch.net.statshttp import StatsListener
                try:
                    self.stats_http = StatsListener(
                        self.metrics, ("127.0.0.1", sport),
                        extra_routes=self._obs_route,
                        health_fn=self.logger.impaired)
                    self._loop.run_until_complete(
                        self.stats_http.start())
                except OSError as exc:
                    log.warning("node %d: stats listener on port %d "
                                "unavailable: %s", self.id, sport, exc)
                    self.stats_http = None
            self._ping_task = self._loop.create_task(self._ping_loop())
            self._started.set()
            self._loop.run_forever()
            # drain cancellations after stop()
            if self.stats_http is not None:
                self._loop.run_until_complete(self.stats_http.stop())
            self._loop.run_until_complete(self.transport.stop())
            self._loop.close()

        self._loop_thread = threading.Thread(
            target=loop_main, daemon=True, name=f"gp-loop-{self.id}")
        self._loop_thread.start()
        self._started.wait(10)
        self._worker_thread = threading.Thread(
            target=self._worker_loop, daemon=True, name=f"gp-work-{self.id}")
        self._worker_thread.start()

    def stop(self, abort: bool = False) -> None:
        """Graceful stop, or crash-stop with ``abort=True``: pending
        inbound packets and queued-but-unfsynced WAL writes are DROPPED,
        emulating a real crash for recovery tests (ref: TESTPaxosConfig
        crash emulation)."""
        self._stopping = True
        if abort:
            try:
                while True:
                    self._inq.get_nowait()
            except queue_mod.Empty:
                pass
        self._inq.put(None)
        if self._worker_thread:
            self._worker_thread.join(5)
        if self._loop:
            self._loop.call_soon_threadsafe(self._ping_task.cancel)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(5)
        if self.blackbox is not None:
            # deregister from the live set: a stopped node must not
            # receive later dump_all() triggers (its engine is gone)
            self.blackbox.close()
        self.logger.close(discard=abort)

    @property
    def port(self) -> int:
        return self.transport.port

    # ------------------------------------------------------------------
    # group lifecycle (ref: PaxosManager.createPaxosInstance, §3.3)
    # ------------------------------------------------------------------

    def create_group(self, name: str, members: Tuple[int, ...],
                     version: int = 0, initial_state: bytes = b"",
                     durable: bool = True) -> bool:
        """Local create (called by harness/reconfiguration on each member).
        Initial coordinator is deterministic from the group key, and every
        replica starts promised to it at ballot (0, coord) — so it safely
        skips phase 1 (no prior accepts can exist)."""
        return self.create_groups([(name, members)], version,
                                  initial_state, durable) == 1

    def create_groups(self, items: List[Tuple[str, Tuple[int, ...]]],
                      version: int = 0, initial_state: bytes = b"",
                      durable: bool = True) -> int:
        """Batched create (ref: batched CreateServiceName): ONE device
        scatter + ONE durable transaction for n groups — the 10K/s churn
        path.  Returns how many were actually created (existing names
        skipped).  Thread-safe: serialized against the worker lane(s)
        owning the touched shards."""
        with contextlib.ExitStack() as stack:
            for lk in self._locks_for(
                    pkt.group_key(n) % self.shards for n, _m in items):
                stack.enter_context(lk)
            return self._create_groups_locked(items, version,
                                              initial_state, durable)

    def _create_groups_locked(self, items, version, initial_state,
                              durable) -> int:
        metas = []
        for name, members in items:
            # validate BEFORE any mutation: a failure mid-batch after
            # device scatter would leave groups visible without mirrors
            if len(members) > self.MAXM:
                raise ValueError(
                    f"group {name!r}: {len(members)} members > "
                    f"MAXM={self.MAXM} (vote bitmap / member matrix "
                    "width)")
        try:
            for name, members in items:
                if (self.table.by_name(name) is not None
                        or pkt.group_key(name) in self._paused):
                    continue  # exists (possibly paused)
                meta = self.table.create(name, members, version)
                self._group_stopped.discard(meta.row)  # recycled rows
                metas.append(meta)
        except (MemoryError, ValueError):
            # capacity exhausted / key collision mid-batch: a group must
            # never be visible in the table without device state and a
            # durable birth record — roll the partial batch back
            for meta in metas:
                self.table.delete(meta.gkey)
            raise
        if not metas:
            return 0
        # _now(): unpinned control threads get real time; replay pins
        # the capture's clock so create-time _la stamps are capture-era
        self._install_rows(metas, self_coord=True, now=self._now())
        if initial_state:
            for meta in metas:
                self.app.restore(meta.name, initial_state)
        if durable:
            self.logger.put_groups(
                [(m.gkey, m.name, m.version, m.members) for m in metas])
            self.logger.checkpoint_many(
                [CheckpointRec(m.gkey, m.name, m.version, m.members, -1,
                               self.app.checkpoint(m.name))
                 for m in metas])
        return len(metas)

    def _install_rows(self, metas: List, self_coord: bool,
                      now: float) -> None:
        """Batched device-row + host-mirror install for freshly created
        table metas — shared by ``create_groups`` and ``_recover`` so
        the row invariants live in one place.  ``self_coord=False``
        (recovery) starts every group promised to its boot coordinator
        but NEVER coordinating until re-elected (safe default)."""
        coords = [m.members[m.gkey % len(m.members)] for m in metas]
        bals = np.asarray([pack_ballot(0, c) for c in coords], np.int32)
        rows = np.asarray([m.row for m in metas], np.int32)
        self.backend.create(
            rows,
            np.asarray([len(m.members) for m in metas], np.int32),
            np.asarray([m.version for m in metas], np.int32),
            bals,
            np.asarray([self_coord and c == self.id for c in coords]))
        self._bal[rows] = bals
        self._cur[rows] = 0
        self._ckpt[rows] = -1
        self._bal_changes[rows] = 0  # recycled rows start clean
        # idle-from-birth groups must still be pause-eligible
        self._la[rows] = now
        self._member_mat[rows] = -1
        for m in metas:
            self._group_stopped.discard(m.row)  # recycled rows
            # _dec entries are created lazily on first decision — an
            # eager empty dict costs 64B x a million idle groups
            self._dec.pop(m.row, None)
            self._member_mat[m.row, :len(m.members)] = m.members
            self._row_gkey[m.row] = m.gkey

    def delete_group(self, name: str) -> bool:
        return self.delete_groups([name]) == 1

    def delete_groups(self, names: List[str]) -> int:
        """Batched delete: ONE device scatter + ONE durable txn.
        Paused groups delete without hydration (their pause record goes
        with the birth record).  Thread-safe: serialized against the
        worker lane(s) owning the touched shards."""
        with contextlib.ExitStack() as stack:
            for lk in self._locks_for(
                    pkt.group_key(n) % self.shards for n in names):
                stack.enter_context(lk)
            return self._delete_groups_locked(names)

    def _delete_groups_locked(self, names: List[str]) -> int:
        paused_gone = []
        for n in dict.fromkeys(names):  # dedupe, order-preserving
            gk = pkt.group_key(n)
            if gk in self._paused:
                self._paused.discard(gk)
                paused_gone.append(gk)
        if paused_gone:
            self.logger.delete_groups(paused_gone)
        metas_by_key = {m.gkey: m
                        for m in (self.table.by_name(n) for n in names)
                        if m is not None}  # dedupe repeated names
        metas = list(metas_by_key.values())
        if not metas:
            return len(paused_gone)
        self.backend.delete(
            np.asarray([m.row for m in metas], np.int32))
        for meta in metas:
            self.table.delete(meta.gkey)
            self._reset_row(meta.row)
            self._elections.pop(meta.row, None)
            if self._mass_el is not None:
                self._mass_el.pop(meta.row)
            self._group_stopped.discard(meta.row)
        self.logger.delete_groups([m.gkey for m in metas])
        for meta in metas:
            self.app.restore(meta.name, b"")
        # Purge coordinator dedupe entries for the deleted rows: a
        # request proposed-but-undecided in a dying epoch must be
        # re-proposable when its retransmit arrives in the successor
        # epoch (same gkey, new instance) — stale entries blackhole it.
        dead_rows = {m.row for m in metas}
        for row in dead_rows:
            self._catchup_barrier.pop(row, None)
        for rid in [r for r, fl in self._proposed.items()
                    if fl.row in dead_rows]:
            self._proposed.pop(rid, None)
            self._payload_pop(rid)
        for row in dead_rows:
            # parked proposals from remote entry replicas: answer their
            # waiting clients via the relay (locally-entered ones are
            # answered through _client_wait below)
            for _ts, p in self._parked.pop(row, []):
                if p.sender != self.id:
                    self._route(p.sender, pkt.Response(
                        self.id, p.gkey, p.req_id, 3, b""))
        # Answer clients still waiting on an in-flight (undecided)
        # request for a deleted group: the delete is the cutoff — without
        # this they silently wait out their whole timeout.  Status 3
        # ("epoch stopped") makes a reconfiguration-aware client refresh
        # its actives and retry on the new epoch's replicas.
        gone = set(metas_by_key) | set(paused_gone)
        for rid, w in list(self._client_wait.items()):
            if len(w) > 2 and w[2] in gone:
                self._client_wait.pop(rid, None)
                self._route(w[0], pkt.Response(self.id, w[2], rid, 3, b""))
        return len(metas) + len(paused_gone)

    # ------------------------------------------------------------------
    # pause / unpause (ref: DiskMap + HotRestoreInfo, SURVEY §5)
    # ------------------------------------------------------------------

    def _reset_row(self, row: int) -> None:
        """Return a row's host mirrors to free-row defaults (delete/
        pause)."""
        self._bal[row] = NO_BALLOT
        self._cur[row] = 0
        self._ckpt[row] = -1
        self._acc_hi[row] = -1
        self._la[row] = np.inf
        self._member_mat[row] = -1
        self._row_gkey[row] = 0
        self._dec.pop(row, None)
        self._catchup_barrier.pop(row, None)

    def _touch(self, row: int) -> None:
        self._la[row] = self._now()

    def _sweep_idle(self, now: float, shard: int = 0) -> int:
        """One deactivator sweep: pause up to pause_max_per_tick rows
        idle past the threshold (called from _tick and from an unpause
        that found the row table full).  A lane sweeps only its own
        shard's rows — pausing touches the engine slab, which needs
        that lane's lock (held by the caller)."""
        if self.pause_idle_s <= 0:
            return 0
        cutoff = now - self.pause_idle_s
        idle = self._own_rows(np.flatnonzero(self._la <= cutoff),
                              shard)[:self.pause_max_per_tick].tolist()
        return self._pause_rows(idle) if idle else 0

    def _pause_rows(self, rows: List[int]) -> int:
        """Serialize idle groups to the pause table and free their rows:
        ONE device gather + ONE durable txn for the sweep.  A row is
        skipped while anything is in flight for it locally."""
        eligible = []
        inflight_rows = {fl.row for fl in self._proposed.values()}
        for row in rows:
            meta = self.table.by_row(row)
            if meta is None:
                self._la[row] = np.inf
                continue
            if (row in self._elections or self._mass_has(row)
                    or self._dec.get(row)
                    or row in self._group_stopped
                    or row in inflight_rows
                    or self._parked.get(row)):
                # in-flight proposals pin the row: pausing it would orphan
                # coordinator-dedupe entries across a row reuse
                self._touch(row)  # re-check later
                continue
            eligible.append((row, meta))
        if not eligible:
            return 0
        snaps = self.backend.snapshot_rows([r for r, _ in eligible])
        items = []
        for (row, meta), snap in zip(eligible, snaps):
            blob = json.dumps({
                "name": meta.name,
                "members": list(meta.members),
                "version": meta.version,
                "cursor": int(self._cur[row]),
                "bal_seen": int(self._bal[row]),
                "ckpt_slot": int(self._ckpt[row]),
                "app": base64.b64encode(
                    self.app.checkpoint(meta.name)).decode(),
                "snap": snap,
            }, default=_np_jsonable).encode()
            items.append((meta.gkey, blob))
        self.logger.pause_many(items)
        self.backend.delete(
            np.asarray([r for r, _ in eligible], np.int32))
        for row, meta in eligible:
            self.table.delete(meta.gkey)
            self._reset_row(row)
            self._paused.add(meta.gkey)
            # shed the app's resident state too — _maybe_unpause
            # restores it from the blob
            self.app.restore(meta.name, b"")
        with self._stat_lock:
            self.n_paused += len(eligible)
        return len(eligible)

    def _maybe_unpause(self, gkey: int):
        """Hydrate a paused group on first touch; returns its GroupMeta
        or None (ref: PaxosManager.getInstance unpause-on-access).  The
        durable pause record is deleted only AFTER hydration succeeds —
        a failure (e.g. capacity full) leaves the group cold but
        reachable."""
        if gkey not in self._paused:
            return None
        blob = self.logger.peek_pause(gkey)
        if blob is None:
            self._paused.discard(gkey)
            return None
        d = json.loads(blob)
        try:
            meta = self.table.create(d["name"], tuple(d["members"]),
                                     d["version"])
        except MemoryError:
            # Capacity exhausted: leave the group cold-but-reachable and
            # fail only this lookup — propagating would drop the whole
            # worker batch (every unrelated packet in it) on each touch of
            # the paused group.  Nudge the deactivator so a sweep can free
            # rows before the client's retransmit lands.
            log.warning("unpause of %r deferred: row capacity exhausted",
                        d["name"])
            self._sweep_idle(self._now(), self._wal_seg())
            return None
        except ValueError:
            # 64-bit group-key collision with a live group: permanent —
            # no sweep can help; surface it loudly and keep the batch
            log.error("unpause of %r impossible: group-key collision",
                      d["name"])
            return None
        self.backend.restore_row(meta.row, d["snap"])
        self._cur[meta.row] = d["cursor"]
        self._bal[meta.row] = d["bal_seen"]
        self._ckpt[meta.row] = d["ckpt_slot"]
        self._member_mat[meta.row] = -1
        self._member_mat[meta.row, :len(meta.members)] = meta.members
        self._row_gkey[meta.row] = meta.gkey
        self._dec.pop(meta.row, None)  # lazily recreated on decisions
        self.app.restore(d["name"], base64.b64decode(d["app"]))
        self.logger.delete_pause(gkey)
        self._paused.discard(gkey)
        self._touch(meta.row)
        with self._stat_lock:
            self.n_unpaused += 1
        # the coordinator may have died while this group was cold — the
        # dead-node scan only covers hydrated rows, so re-check here
        now = self._now()
        _num, coord = unpack_ballot(int(self._bal[meta.row]))
        if coord >= 0 and coord != self.id and coord in self.addr_map:
            last = self._last_heard.get(coord, self._boot_ts)
            if now - last > self.failure_timeout:
                self._run_if_next_in_line(meta, coord, now)
        return meta

    def _lookup(self, gkey: int):
        """by_key with unpause-on-demand."""
        meta = self.table.by_key(gkey)
        if meta is None:
            meta = self._maybe_unpause(gkey)
        return meta

    def _rows_for_keys(self, gkeys: np.ndarray) -> np.ndarray:
        """Batched gkey->row that hydrates paused groups on demand."""
        rows = self.table.rows_for_keys(gkeys)
        if self._paused and (rows < 0).any():
            hit = False
            for i in np.flatnonzero(rows < 0):
                if self._maybe_unpause(int(gkeys[i])) is not None:
                    hit = True
            if hit:
                rows = self.table.rows_for_keys(gkeys)
        return rows

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------

    def _on_frame(self, frame: bytes) -> None:
        """Event-loop side: hand the RAW frame to the worker — decode
        happens off the event loop (the demux thread-pool analog collapses
        to one hand-off queue), and REQUEST frames decode natively in
        batch there."""
        self._inq.put(frame)

    def _on_frames(self, frames: List[bytes]) -> None:
        """Batch intake: one queue hand-off per read chunk."""
        self._inq.put(frames)

    def _decode_batch(self, batch: List) -> List:
        """Worker-side decode: raw frames -> packet objects.  REQUEST
        frames (the per-client-item hot type) go through the native SoA
        parser in one C call; everything else decodes per frame."""
        out = []
        req_frames: List[bytes] = []
        # request groups that arrived as WireChunk SoA columns:
        # (blob, offs, lens) — when a batch's requests all came from
        # ONE chunk they parse straight out of the receive blob (no
        # join, no per-frame slicing)
        req_chunks: List[Tuple] = []
        # flight recorder: the decode boundary is where the capture
        # sees EVERY packet the engine will consume — wire frames by
        # reference (zero copy), self-routed objects re-encoded at
        # their consumption point, so the F-record stream is a complete
        # deterministic replay input with live batch boundaries.  FRAG
        # super-frames are captured as their post-split canonical
        # members, so capture->replay stays bit-for-bit regardless of
        # how the wire coalesced them.
        bb = self.blackbox
        cap: Optional[List[bytes]] = [] if bb is not None else None
        for item in batch:
            if isinstance(item, list):
                # chunk of frames (batch intake): flatten inline
                batch.extend(item)
                continue
            if type(item) is WireChunk:
                rc = self._decode_chunk(item, batch, out, req_frames,
                                        cap)
                if rc is not None:
                    req_chunks.append(rc)
                continue
            if not isinstance(item, (bytes, bytearray, memoryview)):
                out.append(item)  # self-routed object
                if cap is not None:
                    try:
                        cap.append(item.encode())
                    except Exception:
                        log.exception(
                            "blackbox: un-encodable self-routed %s",
                            type(item).__name__)
                continue
            if len(item) and item[0] == _FRAG_T:
                # split first: members re-enter this loop as canonical
                # frames (capture and decode see post-split frames)
                try:
                    batch.extend(pkt.Frag.split(item))
                except Exception:
                    log.exception("dropping malformed super-frame")
                continue
            if len(item) and item[0] == _HELLO_T:
                continue  # stray version hello: link control, not data
            if cap is not None:
                cap.append(item)
            if len(item) == 0:
                log.warning("dropping empty frame")
            elif item[0] == int(pkt.PacketType.REQUEST):
                req_frames.append(item)
            else:
                try:
                    out.append(pkt.decode(item))
                except Exception:
                    log.exception("dropping malformed frame type %d",
                                  item[0])
        if req_frames:
            if len(req_chunks) == 1 and \
                    len(req_frames) == len(req_chunks[0][1]):
                # zero-copy fast path: every request in the batch sits
                # in one receive blob — one native parse, no join
                blob, offs, lens = req_chunks[0]
                try:
                    out.append(_ReqSoA(*native.parse_requests(
                        blob, offs, lens)))
                    req_frames = []
                except ValueError:
                    pass  # fall through to the join path below
        if req_frames:
            try:
                buf = b"".join(req_frames)
                offs = np.cumsum(
                    [0] + [len(f) for f in req_frames[:-1]],
                    dtype=np.int64)
                lens = np.asarray([len(f) for f in req_frames], np.int64)
                out.append(_ReqSoA(*native.parse_requests(buf, offs,
                                                          lens)))
            except ValueError:
                # a malformed frame poisons the batch parse: fall back to
                # per-frame decode, dropping only the bad ones
                for f in req_frames:
                    try:
                        out.append(pkt.decode(f))
                    except Exception:
                        log.exception("dropping malformed request frame")
        if cap is not None and cap:
            # the recorded ts IS this wave's pinned engine clock — the
            # one value replay needs to reproduce time-driven decisions
            bb.note_frames(self._now(),
                           RequestInstrumenter.current_wave(),
                           self._wal_seg(), cap)
        return out

    def _decode_chunk(self, ck: WireChunk, batch: List, out: List,
                      req_frames: List,
                      cap: Optional[List]) -> Optional[Tuple]:
        """SoA intake for one :class:`WireChunk`: classify every frame
        in the chunk with ONE vectorized pass over its type column,
        decode non-request frames from zero-copy ``memoryview`` slices
        of the receive blob, and return the REQUEST columns as a
        ``(blob, offs, lens)`` descriptor so the caller can parse them
        natively without a join.  FRAG super-frames re-enter ``batch``
        as canonical member frames.  When the flight recorder is armed
        the frames are captured as ``bytes`` copies (the capture ring's
        byte accounting must not pin whole receive blobs)."""
        blob = ck.blob
        mv = memoryview(blob)
        types = ck.types
        offs = ck.offs
        lens = ck.lens
        sel = types == _REQ_T
        nreq = int(sel.sum())
        if nreq:
            for i in np.flatnonzero(sel).tolist():
                o = int(offs[i])
                f = mv[o:o + int(lens[i])]
                req_frames.append(f)
                if cap is not None:
                    cap.append(bytes(f))
        if nreq == len(types):
            return (blob, offs, lens)
        for i in np.flatnonzero(~sel).tolist():
            o = int(offs[i])
            ln = int(lens[i])
            t = int(types[i])
            if t == _FRAG_T:
                try:
                    batch.extend(pkt.Frag.split(mv[o:o + ln]))
                except Exception:
                    log.exception("dropping malformed super-frame")
                continue
            if t == _HELLO_T:
                continue
            f = mv[o:o + ln]
            if cap is not None:
                cap.append(bytes(f))
            try:
                out.append(pkt.decode(f))
            except Exception:
                log.exception("dropping malformed frame type %d", t)
        if nreq:
            return (blob, offs[sel], lens[sel])
        return None

    def _was_executed(self, rid: int) -> bool:
        """At-most-once membership across both dedupe generations."""
        return rid in self._executed_recent or rid in self._executed_old

    def _cached_resp(self, rid: int) -> Tuple[int, bytes]:
        got = self._resp_cache.get(rid)
        if got is None:
            got = self._resp_cache_old.get(rid, (0, b""))
        return got

    def _store_payload(self, req: int, flags: int, payload: bytes) -> None:
        """Keep the best copy: a real payload always beats a FLAG_MISSING
        placeholder, regardless of arrival order."""
        cur = self._payload_get(req)  # promotes a hot old-gen entry
        if cur is None or ((cur[0] & FLAG_MISSING)
                           and not (flags & FLAG_MISSING)):
            self._payloads[req] = (flags, payload)

    def _payload_get(self, req: int) -> Optional[Tuple[int, bytes]]:
        """Two-generation payload lookup; touching an old-gen entry
        promotes it (GCConcurrentHashMap-style time GC: anything
        untouched for two GC periods is dropped — payloads of requests
        whose decision never lands must not accumulate forever)."""
        got = self._payloads.get(req)
        if got is None:
            got = self._payloads_old.pop(req, None)
            if got is not None:
                self._payloads[req] = got
        return got

    def _payload_pop(self, req: int) -> Optional[Tuple[int, bytes]]:
        got = self._payloads.pop(req, None)
        old = self._payloads_old.pop(req, None)
        return got if got is not None else old

    def _route(self, dst: int, obj) -> None:
        """Send a packet object to ``dst``; self-sends loop back through
        the worker queue without touching the wire."""
        if dst == self.id:
            if self._self_buf is not None:
                # same-pass wave: a self-routed packet (coordinator's own
                # accept, its own commit, ...) is processed before this
                # worker batch ends instead of waiting a queue round trip
                # — cuts the per-request pipeline from ~4 worker
                # iterations to 1-2 and keeps batches coherent
                self._self_buf.append(obj)
            else:
                self._inq.put(obj)
        elif self._loop is not None:
            if self._resp_out is not None and \
                    type(obj) is pkt.Response:
                # batch client responses for the end of this worker batch:
                # ONE native encode + ONE writer call per destination
                self._resp_out.setdefault(dst, []).append(
                    (obj.gkey, obj.req_id, obj.status, obj.payload))
                return
            buf = obj.encode()
            if len(buf) > pkt.CHUNK_THRESHOLD:
                # LargeCheckpointer analog: slice oversized frames so
                # they never hit the single-frame ceiling, and send them
                # paced by the socket's own flow control (one burst of a
                # multi-hundred-MB checkpoint would congestion-drop its
                # own tail against the transport byte budget)
                xid = (self.id << 32) | next(self._xfer_seq)
                self.transport.send_paced_threadsafe(
                    dst, [ch.encode()
                          for ch in pkt.chunk_frame(self.id, xid, buf)])
                return
            if self._out_buf is not None:
                # buffered: one loop hop flushes the whole worker batch
                self._out_buf.append((dst, buf, False, 1))
            else:
                self.transport.send_threadsafe(dst, buf)
        # else: recovery runs before sockets exist; peers re-sync later

    def _emit_bundle(self, resp: Optional[Dict],
                     out: Optional[List]) -> None:
        """Encode batched client responses and hand the whole batch's
        outbound frames to the event loop in ONE hop.  Runs inline at
        the end of ``_process`` in the 1- and 2-stage workers, and on
        the dedicated EMIT thread in the 3-stage pipeline — it touches
        only the transport (never consensus state), so moving it off
        the process thread is single-writer-safe, and the FIFO hand-off
        queue preserves per-destination send order."""
        if resp:
            out = out if out is not None else []
            for dst, items in resp.items():
                buf = native.encode_responses(
                    self.id,
                    np.asarray([it[0] for it in items], np.uint64),
                    np.asarray([it[1] for it in items], np.uint64),
                    np.asarray([it[2] for it in items], np.uint8),
                    [it[3] for it in items])
                out.append((dst, buf, True, len(items)))
        if out and self._loop is not None:
            try:
                self.transport.send_many_threadsafe(out)
            except RuntimeError:
                if not self._stopping:  # closed loop mid-crash-stop
                    raise

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _worker_loop(self) -> None:
        if self.shards > 1:
            # engine lanes subsume the 2/3-stage pipeline: the intake
            # thread decode-splits, each lane runs engine+WAL, each
            # lane's emit thread ships frames
            return self._worker_loop_sharded()
        if bool(Config.get(PC.PIPELINE_WORKER)):
            return self._worker_loop_pipelined()
        prev_items = 0
        while not self._stopping:
            try:
                first = self._inq.get(timeout=self.batch_timeout)
            except queue_mod.Empty:
                with self._engine_lock:
                    self._tick()
                continue
            if first is None:
                break
            if prev_items >= self.batch_busy and self.batch_coalesce > 0:
                # adaptive coalescing (SURVEY §7.3.3): under load, let
                # the batch fill before draining — fixed per-call costs
                # amortize over ~10x more lanes.  Trickle traffic skips
                # this (prev batch small), keeping the latency path hot.
                time.sleep(self.batch_coalesce)
            batch = [first]
            # the cap counts FRAMES, not queue items: with batched
            # intake one item can be a whole read chunk, and an
            # uncounted fill would build multi-second mega-batches that
            # starve _tick (elections, re-drive, catch-up)
            n_frames = _frames_in(first)
            while n_frames < self.batch_size:
                try:
                    nxt = self._inq.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is None:
                    self._stopping = True
                    break
                batch.append(nxt)
                n_frames += _frames_in(nxt)
            prev_items = n_frames
            self._backlog_est = int(
                self._inq.qsize() * n_frames / max(1, len(batch)))
            RequestInstrumenter.set_wave(RequestInstrumenter.next_wave())
            # wave-coherent engine clock: the decode timestamp is what
            # the flight recorder's F record carries, so every _now()
            # read while processing this batch must return it — replay
            # re-pins the captured value and time-driven decisions
            # (redrive windows, election backoff) reproduce exactly
            self._wtls.now = time.time()
            t0 = time.monotonic()
            c0 = self._ct()
            try:
                sp = RequestInstrumenter.span_begin(
                    "decode", node=self.id, frames=n_frames)
                decoded = self._decode_batch(batch)
                RequestInstrumenter.span_end(sp)
                t1 = time.monotonic()
                c1 = self._ct()
                DelayProfiler.update_total("w.decode", t0, len(batch),
                                           cpu_t0=c0)
                sp = RequestInstrumenter.span_begin(
                    "engine", node=self.id, items=len(decoded))
                with self._engine_lock:
                    self._process(decoded)
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.process", t1, len(batch),
                                           cpu_t0=c1)
            except Exception:
                if not self._stopping:
                    log.exception("worker batch failed (%d items)",
                                  len(batch))
                # else: crash-stop teardown races (closed DB / closed
                # event loop) are the emulated crash, not errors
            DelayProfiler.update_delay("node.batch", t0, len(batch))
            # ticks run UNPINNED (real time) — each effective tick's
            # clock is captured in its own T record instead
            self._wtls.now = 0.0
            with self._engine_lock:
                self._tick()

    def _worker_loop_pipelined(self) -> None:
        """Three-stage worker (PC.PIPELINE_WORKER; SURVEY §7.1 "build
        batch N+1 on host while the kernel runs batch N"):

            intake  — this thread: collect + decode batch N+1
            process — engine dispatch + host apply (mirrors, WAL fsync,
                      execute) for batch N; the engine's async
                      submit/collect split lets the device wave run
                      while the host halves of the same batch proceed
            emit    — response encode + socket hand-off for batch N-1

        So wave N's device compute+transfer overlaps wave N-1's emit
        and wave N+1's decode/pack.  Both hand-off queues are depth-2 —
        one batch in flight, one staged — so memory stays bounded and
        backpressure reaches the socket the same way the single-stage
        loop's service rate does.  Per-group in-order execution is
        preserved: ALL consensus state (engine, mirrors, WAL, app)
        stays single-writer on the process thread in batch order, and
        the emit stage only ships already-encoded transport frames in
        FIFO order.  The WAL-before-reply durability barrier is
        unchanged too: handlers fsync inside _process, strictly before
        the batch's frames are handed to emit."""
        stage: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
        emitq: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)

        def emit_loop() -> None:
            while True:
                item = emitq.get()
                if item is None:
                    return
                t0 = time.monotonic()
                wid, resp, out = item
                RequestInstrumenter.set_wave(wid)
                # count BEFORE _emit_bundle: it appends the encoded
                # response frames to `out`, which would double-count
                n_items = (len(out) if out else 0) + \
                    (sum(len(v) for v in resp.values()) if resp else 0)
                sp = RequestInstrumenter.span_begin(
                    "emit", node=self.id, items=n_items)
                try:
                    self._emit_bundle(resp, out)
                except Exception:
                    if not self._stopping:
                        log.exception("emit stage failed")
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.emit", t0, n_items)

        def proc_loop() -> None:
            # _emit_q is thread-local: bind the hand-off queue on THIS
            # thread, the one that runs _process
            self._emit_q = emitq
            while True:
                try:
                    item = stage.get(timeout=self.batch_timeout)
                except queue_mod.Empty:
                    with self._engine_lock:
                        self._tick()
                    continue
                if item is None:
                    return
                wid, ts, decoded = item
                RequestInstrumenter.set_wave(wid)
                # pin the engine clock to the batch's decode timestamp
                # (the F record's ts) for the whole _process pass
                self._wtls.now = ts
                t0 = time.monotonic()
                sp = RequestInstrumenter.span_begin(
                    "engine", node=self.id, items=len(decoded))
                try:
                    with self._engine_lock:
                        self._process(decoded)
                except Exception:
                    if not self._stopping:
                        log.exception("pipelined batch failed "
                                      "(%d items)", len(decoded))
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.process", t0, len(decoded))
                DelayProfiler.update_delay("node.batch", t0,
                                           len(decoded))
                self._wtls.now = 0.0  # ticks run unpinned (T records)
                with self._engine_lock:
                    self._tick()

        emit = threading.Thread(target=emit_loop, daemon=True,
                                name=f"gp-node{self.id}-emit")
        emit.start()
        proc = threading.Thread(target=proc_loop, daemon=True,
                                name=f"gp-node{self.id}-proc")
        proc.start()
        prev_items = 0
        try:
            while not self._stopping:
                try:
                    first = self._inq.get(timeout=self.batch_timeout)
                except queue_mod.Empty:
                    continue  # proc thread ticks on its own timeout
                if first is None:
                    break
                if prev_items >= self.batch_busy and \
                        self.batch_coalesce > 0:
                    time.sleep(self.batch_coalesce)
                batch = [first]
                n_frames = _frames_in(first)
                while n_frames < self.batch_size:
                    try:
                        nxt = self._inq.get_nowait()
                    except queue_mod.Empty:
                        break
                    if nxt is None:
                        self._stopping = True
                        break
                    batch.append(nxt)
                    n_frames += _frames_in(nxt)
                prev_items = n_frames
                self._backlog_est = int(
                    self._inq.qsize() * n_frames / max(1, len(batch)))
                # one wave id per batch, handed down the pipeline with
                # the batch itself so every stage's spans (and the
                # trace events recorded while processing it) join up
                wid = RequestInstrumenter.next_wave()
                RequestInstrumenter.set_wave(wid)
                # decode timestamp rides down the pipeline with the
                # batch: the process stage pins the engine clock to it
                ts = time.time()
                self._wtls.now = ts
                t0 = time.monotonic()
                sp = RequestInstrumenter.span_begin(
                    "decode", node=self.id, frames=n_frames)
                try:
                    decoded = self._decode_batch(batch)
                except Exception:
                    log.exception("pipelined decode failed (%d items)",
                                  len(batch))
                    continue
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.decode", t0, len(batch))
                t0 = time.monotonic()
                # blocks at depth 2: backpressure
                stage.put((wid, ts, decoded))
                DelayProfiler.update_total("w.decode_blocked", t0)
        finally:
            stage.put(None)
            # the process stage can legitimately sit in a 10-20s cold
            # jit compile mid-batch; the emit sentinel must not be
            # enqueued while proc is still alive, or proc's remaining
            # hand-offs land in a consumer-less queue (blocked put +
            # silently dropped responses).  60s covers the worst
            # observed compile; past that the daemon threads die with
            # the process anyway.
            proc.join(60)
            # emit drains AFTER the process stage: frames of the last
            # batch must still ship on a graceful stop
            emitq.put(None)
            emit.join(10)
            self._emit_q = None

    # -- engine lanes (PC.ENGINE_SHARDS > 1) ---------------------------

    def _split_soa(self, sb: "_ReqSoA") -> Dict[int, "_ReqSoA"]:
        """Split a decoded REQUEST SoA by shard (= gkey % S, one
        vectorized modulo over the key array).  The steady-state wire
        chunk mixes shards, so payload bytes are regrouped per lane;
        the offsets rebuild is numpy, the byte gather one join."""
        S = self.shards
        sh = (sb.gkey % np.uint64(S)).astype(np.int64)
        lo = int(sh.min())
        if lo == int(sh.max()):
            return {lo: sb}
        po = np.asarray(sb.pay_off)
        lens = po[1:] - po[:-1]
        out: Dict[int, "_ReqSoA"] = {}
        for k in np.unique(sh).tolist():
            idx = np.flatnonzero(sh == k)
            noff = np.zeros(len(idx) + 1, po.dtype)
            np.cumsum(lens[idx], out=noff[1:])
            pay = b"".join(bytes(sb.pay[po[i]:po[i + 1]])
                           for i in idx.tolist())
            out[k] = _ReqSoA(sb.sender[idx], sb.gkey[idx],
                             sb.req_id[idx], sb.flags[idx], noff, pay)
        return out

    def _split_decoded(self, decoded: List) -> List[List]:
        """Decode-split stage: partition one decoded batch into S lane
        sub-batches.  Batched SoA packets split vectorized
        (pkt.shard_split); single-group packets route by gkey modulo;
        chunks by transfer id (reassembly state stays lane-local);
        everything without a group identity (liveness pings, control
        envelopes, upper-layer packets) runs on lane 0."""
        S = self.shards
        lanes: List[List] = [[] for _ in range(S)]
        for obj in decoded:
            t = type(obj)
            if t is _ReqSoA:
                for k, sub in self._split_soa(obj).items():
                    lanes[k].append(sub)
            elif t in (pkt.AcceptBatch, pkt.AcceptReplyBatch,
                       pkt.CommitBatch, pkt.PrepareBatch,
                       pkt.PrepareReplyBatch):
                for k, sub in pkt.shard_split(obj, S).items():
                    lanes[k].append(sub)
            elif t is pkt.CreateGroup:
                lanes[pkt.group_key(obj.name) % S].append(obj)
            elif t is pkt.Chunk:
                lanes[obj.xfer_id % S].append(obj)
            else:
                gk = getattr(obj, "gkey", None)
                if type(gk) is int:
                    lanes[gk % S].append(obj)
                else:
                    lanes[0].append(obj)
        return lanes

    def _worker_loop_sharded(self) -> None:
        """S independent engine lanes (the row-sharded tentpole).  This
        thread is the decode-split stage: it drains the socket queue,
        batch-decodes, splits decoded items by shard, and hands each
        lane its sub-batch.  Lane k's proc thread owns shard k's slab
        rows, engine lock, and WAL segment ``wal-<k>.log``; its emit
        thread ships that lane's frames.  XLA dispatch, ``os.fsync``,
        and the C codecs all release the GIL, so lanes overlap on real
        cores.  Safety: a group lives in exactly one lane, so
        per-group packet order, the single-writer discipline over its
        row state, and the WAL-fsync-before-reply barrier are per-lane
        invariants exactly as they were node-wide with one worker."""
        S = self.shards
        # one sub-batch waits a lane (the reference queues four): a
        # wave costs milliseconds of host time whatever its size, so a
        # decode thread that runs four sub-batches ahead cuts the
        # socket's backlog into about four times as many small waves;
        # held back at one, it takes the backlog whole into the next
        # decode batch (PERF.md §5, the lanes phase)
        procqs = [queue_mod.Queue(maxsize=1) for _ in range(S)]
        threads: List[threading.Thread] = []

        def emit_loop(emitq) -> None:
            while True:
                item = emitq.get()
                if item is None:
                    return
                t0 = time.monotonic()
                wid, resp, out = item
                RequestInstrumenter.set_wave(wid)
                n_items = (len(out) if out else 0) + \
                    (sum(len(v) for v in resp.values()) if resp else 0)
                sp = RequestInstrumenter.span_begin(
                    "emit", node=self.id, items=n_items)
                try:
                    self._emit_bundle(resp, out)
                except Exception:
                    if not self._stopping:
                        log.exception("emit stage failed")
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.emit", t0, n_items)

        def proc_loop(k: int, procq, emitq) -> None:
            # lane identity, bound thread-locally: WAL segment + the
            # emit hand-off this lane's _process writes to
            self._wtls.wal_seg = k
            self._emit_q = emitq
            lock = self._engine_locks[k]
            while True:
                try:
                    item = procq.get(timeout=self.batch_timeout)
                except queue_mod.Empty:
                    with lock:
                        self._tick(k)
                    continue
                if item is None:
                    emitq.put(None)  # FIFO: drains after our last batch
                    return
                wid, ts, decoded = item
                RequestInstrumenter.set_wave(wid)
                # pin the engine clock to the batch's decode timestamp
                # (the F record's ts) for the whole _process pass
                self._wtls.now = ts
                t0 = time.monotonic()
                sp = RequestInstrumenter.span_begin(
                    "engine", node=self.id, items=len(decoded),
                    shard=k)
                try:
                    with lock:
                        self._process(decoded)
                except Exception:
                    if not self._stopping:
                        log.exception("lane %d batch failed (%d items)",
                                      k, len(decoded))
                RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.process", t0,
                                           len(decoded))
                DelayProfiler.update_total(f"w.process@{k}", t0,
                                           len(decoded))
                DelayProfiler.update_delay("node.batch", t0,
                                           len(decoded))
                self._wtls.now = 0.0  # ticks run unpinned (T records)
                with lock:
                    self._tick(k)

        for k in range(S):
            emitq: "queue_mod.Queue" = queue_mod.Queue(maxsize=4)
            emit = threading.Thread(
                target=emit_loop, args=(emitq,), daemon=True,
                name=f"gp-node{self.id}-emit{k}")
            emit.start()
            proc = threading.Thread(
                target=proc_loop, args=(k, procqs[k], emitq),
                daemon=True, name=f"gp-node{self.id}-lane{k}")
            proc.start()
            threads += [proc, emit]
        prev_items = 0
        try:
            while not self._stopping:
                try:
                    first = self._inq.get(timeout=self.batch_timeout)
                except queue_mod.Empty:
                    continue  # lanes tick on their own timeouts
                if first is None:
                    break
                if prev_items >= self.batch_busy and \
                        self.batch_coalesce > 0:
                    time.sleep(self.batch_coalesce)
                batch = [first]
                n_frames = _frames_in(first)
                while n_frames < self.batch_size:
                    try:
                        nxt = self._inq.get_nowait()
                    except queue_mod.Empty:
                        break
                    if nxt is None:
                        self._stopping = True
                        break
                    batch.append(nxt)
                    n_frames += _frames_in(nxt)
                prev_items = n_frames
                self._backlog_est = int(
                    self._inq.qsize() * n_frames / max(1, len(batch)))
                wid = RequestInstrumenter.next_wave()
                RequestInstrumenter.set_wave(wid)
                # decode timestamp rides to every lane with its
                # sub-batch: each proc thread pins its engine clock to
                # it, so one wave shares one clock across all lanes
                ts = time.time()
                self._wtls.now = ts
                t0 = time.monotonic()
                sp = RequestInstrumenter.span_begin(
                    "decode", node=self.id, frames=n_frames)
                try:
                    decoded = self._decode_batch(batch)
                    lanes = self._split_decoded(decoded)
                except Exception:
                    log.exception("decode-split failed (%d items)",
                                  len(batch))
                    continue
                finally:
                    # end the span on the failure path too, or the
                    # begun/ended accounting diverges forever
                    RequestInstrumenter.span_end(sp)
                DelayProfiler.update_total("w.decode", t0, len(batch))
                t0 = time.monotonic()
                for k in range(S):
                    if lanes[k]:
                        # blocking at depth 1: backpressure reaches the
                        # socket exactly as the single lane's did
                        procqs[k].put((wid, ts, lanes[k]))
                DelayProfiler.update_total("w.decode_blocked", t0)
        finally:
            for q in procqs:
                q.put(None)
            # each lane forwards the sentinel to its emit queue after
            # its last batch; bounded joins cover in-flight compiles
            for t in threads:
                t.join(30)

    def _tick(self, shard: int = 0) -> None:
        """Periodic duties: failure detection → run-for-coordinator.
        With engine lanes, lane ``shard`` services only its own rows
        (row % S == shard masks every row scan); node-global state —
        liveness, suspect detection, dict-generation GC — belongs to
        lane 0.  Exception-guarded: a failover-path bug must not kill
        the worker."""
        # a tick's sends (catch-up sync requests, accept re-drives, the
        # tick hooks' control packets) leave as ONE loop hop, as a
        # worker batch's do: one hop a packet (thousands a tick behind
        # a burst of lagging rows) kept the loop thread from reading
        # the replies that would end the lag (ROADMAP F2)
        own = self._out_buf is None
        if own:
            self._out_buf = []
        try:
            self._tick_inner(shard)
        except Exception:
            log.exception("tick failed")
        finally:
            if own:
                out, self._out_buf = self._out_buf, None
                self._emit_bundle(None, out)

    def _own_rows(self, rows: np.ndarray, shard: int) -> np.ndarray:
        """Mask an array of row indices down to this lane's shard."""
        if self.shards == 1:
            return rows
        return rows[rows % self.shards == shard]

    def _tick_inner(self, shard: int) -> None:
        now = self._now()
        if self._last_ticks[shard] + self.ping_interval > now:
            return
        self._last_ticks[shard] = now
        # flight recorder: effective ticks are part of the replay input
        # — failure detection, elections, and redrives below are all
        # time-driven, so replay must re-run each one at the captured
        # stream position with the captured clock
        bb = self.blackbox
        if bb is not None:
            bb.note_tick(now, RequestInstrumenter.current_wave(), shard)
        S = self.shards
        if shard == 0:
            for fn in self._tick_hooks:
                try:
                    fn()
                except Exception:
                    log.exception("tick hook %r failed", fn)
            # self-stall guard: if WE went dark longer than the failure
            # timeout (mass create holding the engine lock, GC, a
            # compile storm), the missing pings are OUR silence, not
            # the peers' — declaring deaths now starts a spurious mass
            # election (observed: a 100K-group create made every node
            # suspect every other and a rogue coordinator took over the
            # whole fleet).  Give peers a fresh window instead.
            prev_tick = self._last_tick_wall or now
            self._last_tick_wall = now
            if now - prev_tick > self.failure_timeout:
                # bounded: under CHRONIC load (every tick gap >
                # timeout, e.g. a successor grinding through a
                # 1M-group takeover) the guard must not suppress
                # detection forever — live peers refresh _last_heard
                # out-of-band as their frames are processed, so after
                # a few guarded ticks real deaths still age out
                self._stall_streak += 1
                if self._stall_streak <= 3:
                    for k in self._last_heard:
                        self._last_heard[k] = now
                    return
            else:
                self._stall_streak = 0
            dead = [n for n, t in self._last_heard.items()
                    if now - t > self.failure_timeout]
            for n in dead:
                self._on_node_dead(n)
        # election liveness (ref: FailureDetection feeding a PERIODIC
        # checkRunForCoordinator, SURVEY §3.5): one lost Prepare or
        # PrepareReply must never wedge a group.  (a) re-drive stalled
        # elections past the 2s backoff; (b) while any peer is suspect,
        # rescan for rows still led by it (covers elections that never
        # started: we weren't next in line, or the next-in-line died too)
        if self._elections:
            stalled: List[int] = []
            for row, el in list(self._elections.items()):
                if S > 1 and row % S != shard:
                    continue  # another lane's row
                if now - el.started >= 2.0:
                    if self.table.by_row(row) is None:
                        self._elections.pop(row, None)
                    else:
                        stalled.append(row)
            if len(stalled) >= 64 and S == 1:
                # mass takeover re-drive: one PrepareBatch wave, not one
                # Prepare frame per (row, member)
                by_mems: Dict[Tuple[int, ...], List[int]] = {}
                for row in stalled:
                    by_mems.setdefault(self.table.by_row(row).members,
                                       []).append(row)
                self._start_elections_batch(by_mems, now)
            else:
                for row in stalled:
                    self._start_election(row, self.table.by_row(row))
        if self._mass_el is not None and self._mass_el.n_live:
            # same liveness invariant for the SoA cohort ("one lost
            # Prepare or PrepareReply must never wedge a group") — and
            # it must not depend on the victim still being a suspect
            # (a rejoining victim clears suspicion, which stops the
            # rescan re-drive below).  Backoff scales with cohort size:
            # re-driving a million mid-merge elections at a fixed 2s
            # would reset ack counts while replies are still arriving.
            backoff = max(2.0, self._mass_el.n_live / 2e5)
            rows_st = self._mass_el.stale_rows(now, backoff)
            if len(rows_st):
                by_mems2: Dict[Tuple[int, ...], List[int]] = {}
                by_row = self.table._by_row
                dead_rows = []
                for row in rows_st.tolist():
                    meta = by_row[row]
                    if meta is None:
                        dead_rows.append(row)
                    else:
                        by_mems2.setdefault(meta.members,
                                            []).append(row)
                if dead_rows:
                    self._mass_el.kill(np.asarray(dead_rows, np.int64))
                if by_mems2:
                    self._start_elections_batch(by_mems2, now)
        if self._suspects and shard == 0:
            # vectorized rescan (was a Python loop over every meta per
            # tick — minutes at 1M groups); rows with an election fresher
            # than the re-drive backoff are skipped inside.  Lane 0 owns
            # the scan: it only routes Prepare frames and seeds election
            # records — the engine-touching installs happen when the
            # replies arrive, on each row's owning lane.
            for s in list(self._suspects):
                self._elect_rows_led_by(s, now)
        # accept re-drive (ref: the coordinator's accept retransmitter):
        # an in-flight proposal whose decision hasn't landed within ~1s
        # is re-emitted to every member — a lost Accept otherwise stalls
        # its slot forever (and every later one: execution is in-order),
        # while client retransmits die on the _proposed dedupe.
        # Gated while the WAL is impaired: a re-drive would resurrect
        # accepts whose self vote never became durable (the batch whose
        # emits were skipped at the failed barrier) — the slots stay
        # parked until rotation recovers or the node restarts.
        if self._proposed and self.logger.impaired() is None:
            n_redriven = 0
            for req_id, fl in list(self._proposed.items()):
                if S > 1 and fl.row % S != shard:
                    continue  # another lane's row
                if now - fl.redriven < 1.0:
                    continue
                meta = self.table.by_row(fl.row)
                if meta is None:
                    continue
                bal = int(self._bal[fl.row])
                if bal != fl.bal or unpack_ballot(bal)[1] != self.id:
                    # the regime changed since this slot was assigned:
                    # NEVER re-emit at a different ballot (the carryover
                    # may hold a different value at this slot — equal
                    # ballot + different value forks the RSM); install-
                    # time reconciliation re-stamps or re-proposes
                    continue
                got = self._payload_get(req_id)
                if got is None:
                    continue
                fl.redriven = now
                for m in meta.members:
                    self._route(m, pkt.AcceptBatch(
                        self.id, np.asarray([meta.gkey], np.uint64),
                        np.asarray([fl.slot], np.int32),
                        np.asarray([bal], np.int32),
                        *_split_reqs([req_id]),
                        payloads=[bytes([got[0]]) + got[1]]))
                n_redriven += 1
                with self._stat_lock:
                    self.n_redriven += 1
                if n_redriven >= 256:
                    with self._stat_lock:
                        self.n_redrive_capped += 1
                    break
        # catch-up: slots we acked an Accept for but never saw decided —
        # the commit was lost and nothing later will signal a gap; pull
        # the decisions (or a checkpoint) from the coordinator
        pend = self._own_rows(np.flatnonzero(self._acc_hi >= 0), shard)
        if len(pend):
            done = pend[self._cur[pend] > self._acc_hi[pend]]
            self._acc_hi[done] = -1
            for row in pend[(self._cur[pend] <= self._acc_hi[pend])
                            & (now - self._acc_ts[pend] > 0.5)]:
                self._sync_if_gap(int(row))
        # catch-up barriers: a row whose cursor reached the quorum
        # watermark opens for fresh proposals (the parked flush below
        # handles its queue); one still behind pulls decisions again
        if self._catchup_barrier:
            for row in list(self._catchup_barrier):
                if S > 1 and row % S != shard:
                    continue
                if self.table.by_row(row) is None:
                    del self._catchup_barrier[row]
                elif int(self._cur[row]) >= self._catchup_barrier[row]:
                    del self._catchup_barrier[row]
                else:
                    self._sync_if_gap(row)
        # re-route proposals parked while leadership was unsettled
        if self._parked:
            for row in list(self._parked):
                if S > 1 and row % S != shard:
                    continue
                meta = self.table.by_row(row)
                if meta is None:
                    self._parked.pop(row, None)
                    continue
                coord = unpack_ballot(int(self._bal[row]))[1]
                if row not in self._elections and \
                        not self._mass_has(row) and coord >= 0 and \
                        coord not in self._suspects and \
                        row not in self._catchup_barrier:
                    self._flush_parked(row)
        if shard == 0 and (len(self._bounced) > 10000
                           or self._last_bounce_gc + 30 < now):
            self._last_bounce_gc = now
            # snapshot via list() (one C call, no GIL release): other
            # lanes insert into these dicts concurrently, and iterating
            # the live dict would raise "changed size during iteration".
            # An entry written to the old dict during the rebuild just
            # re-bounces/ages out next round.
            self._bounced = {r: t
                             for r, t in list(self._bounced.items())
                             if t > now - 30}
            if self._xfers:
                # partial chunked transfers whose chunks were lost: the
                # sender retries at a higher level (checkpoint catch-up
                # re-requests), so drop the stale buffers (pop, not
                # del: a lane may complete the transfer mid-scan)
                for k in [k for k, v in list(self._xfers.items())
                          if v[0] < now - 60]:
                    self._xfers.pop(k, None)
        # deactivator pass (ref: PaxosManager's pause thread); batched:
        # one device gather + one pause txn per sweep, each lane
        # sweeping only its own rows
        self._sweep_idle(now, shard)
        # GC the dedupe + response-cache + waiter tables: O(1)
        # generation swaps (a filtering rebuild at 30K+ req/s stalls the
        # worker tens of ms — the very stall that triggers client
        # retransmit avalanches).  Node-global dicts: lane 0 swaps.
        if shard == 0 and (len(self._executed_recent) > 2_000_000
                           or self._last_exec_gc + 60 < now):
            self._last_exec_gc = now
            self._executed_old = self._executed_recent
            self._executed_recent = {}
            self._resp_cache_old = self._resp_cache
            self._resp_cache = {}
            self._client_wait = {
                r: w for r, w in self._client_wait.items()
                if w[1] > now - 120}
            # reap in-flight proposals whose decision never landed
            # (preempted accept, client gave up): past any client's
            # retransmit horizon a fresh proposal is the correct answer,
            # and a stale entry would pin its row unpausable forever
            self._proposed = {
                r: fl for r, fl in self._proposed.items()
                if fl.proposed > now - 120}
            # payload generation shift: anything untouched since the
            # last shift (no decide, no sync/prepare interest) ages out
            self._payloads_old = self._payloads
            self._payloads = {}

    # -- batch processing ----------------------------------------------

    def _process(self, batch: List) -> None:
        # flight recorder: bracket the wave with order-sensitive lane
        # digests — replay's per-wave ground truth.  Lane-pure (this
        # thread's shard only): other lanes mutate their rows
        # concurrently and must not perturb the digest.
        bb = self.blackbox
        if bb is not None:
            bb_lane = self._wal_seg()
            bb_pre = self._bb_digest(bb_lane)
        self._resp_out: Optional[Dict] = {}
        self._out_buf: Optional[List] = []
        self._self_buf: Optional[List] = []
        self._batch_t0 = time.time()  # app-retry sleep budget anchor
        try:
            self._process_inner(batch)
            # follow-up waves: protocol chains are finite (request ->
            # accept -> reply -> commit -> execute; prepare -> reply ->
            # install), so this converges; cap defends against bugs
            for _ in range(8):
                if not self._self_buf:
                    break
                wave, self._self_buf = self._self_buf, []
                self._process_inner(wave)
        finally:
            if self._self_buf:
                for obj in self._self_buf:  # cap hit: requeue leftovers
                    self._inq.put(obj)
            self._self_buf = None
            resp, self._resp_out = self._resp_out, None
            out, self._out_buf = self._out_buf, None
            if self._emit_q is not None and (resp or out):
                # 3-stage pipeline: response encode + socket hand-off
                # run on the emit thread, overlapping the next batch's
                # engine wave here.  Blocking at depth 2 is the same
                # backpressure the inline flush exerted.
                t0 = time.monotonic()
                self._emit_q.put((RequestInstrumenter.current_wave(),
                                  resp, out))
                DelayProfiler.update_total("w.emit_blocked", t0)
            else:
                sp = RequestInstrumenter.span_begin("emit", node=self.id)
                self._emit_bundle(resp, out)
                RequestInstrumenter.span_end(sp)
            if bb is not None:
                ch = None
                if self._chaos.enabled:
                    ch = [self._chaos.n_dropped, self._chaos.n_blocked,
                          self._chaos.n_delayed, self._chaos.n_reordered]
                bb.note_wave(RequestInstrumenter.current_wave(),
                             bb_lane, len(batch), bb_pre,
                             self._bb_digest(bb_lane), ch)

    def _bb_digest(self, lane: int) -> int:
        """Order-sensitive digest of THIS lane's host-mirror state
        (gkey, exec cursor, max promised ballot per row) for the flight
        recorder's per-wave W records.  Strided to the lane's rows
        (row % S == lane) so concurrent lanes never read each other's
        rows mid-wave; uint64 multiply-xor fold, deterministic across
        runs and platforms."""
        S = self.shards
        gk = self._row_gkey[lane::S]
        if not len(gk):
            return 0
        h = gk * np.uint64(0x9E3779B97F4A7C15)
        h ^= (self._cur[lane::S].astype(np.uint64)
              * np.uint64(0xBF58476D1CE4E5B9))
        h ^= (self._bal[lane::S].astype(np.uint64)
              * np.uint64(0x94D049BB133111EB))
        return int(np.bitwise_xor.reduce(h))

    def _blackbox_manifest(self, reason: str) -> dict:
        """Ground truth appended to a flight-recorder dump: the engine
        shape replay must rebuild, the group table, and per-group final
        state (host + device cursors, app digest/count).  Called on the
        dump thread; the device gather runs under the engine locks."""
        metas = sorted(self.table.snapshot_metas(), key=lambda m: m.row)
        rows = np.asarray([m.row for m in metas], np.int64)
        dev = self._inspect_locked(rows) if len(rows) else {}
        app_digest = getattr(self.app, "digest", None)
        app_count = getattr(self.app, "count", None)
        groups = []
        for j, m in enumerate(metas):
            g = {"name": m.name, "gkey": int(m.gkey), "row": int(m.row),
                 "members": [int(x) for x in m.members],
                 "version": int(m.version),
                 "exec_cursor_host": int(self._cur[m.row])}
            if dev:
                g["exec_cursor"] = int(dev["exec_cursor"][j])
                g["next_slot"] = int(dev["next_slot"][j])
            if isinstance(app_digest, dict):
                g["app_digest"] = int(app_digest.get(m.name, 0))
            if isinstance(app_count, dict):
                g["app_count"] = int(app_count.get(m.name, 0))
            groups.append(g)
        man = {
            "app": type(self.app).__name__,
            "addr_map": {str(k): [v[0], int(v[1])]
                         for k, v in self.addr_map.items()},
            "knobs": {**self._bb_knobs,
                      "engine_shards": self.shards,
                      "engine_mesh": self.backend.engine_mesh,
                      "fuse_waves": "on" if self._fuse_waves else "off",
                      "sync_wal": self.logger.sync},
            "counters": {"executed": self.n_executed,
                         "decided": self.n_decided,
                         "ballot_changes": self.n_ballot_changes},
            # replay restores this so failure detection's never-heard
            # fallback (_last_heard.get(peer, _boot_ts)) reproduces
            "boot_ts": self._boot_ts,
            "groups": groups,
        }
        if self._chaos.enabled:
            man["chaos"] = self._chaos.snapshot()
        return man

    def _process_inner(self, batch: List) -> None:
        by_type: Dict[type, List] = {}
        for obj in batch:
            by_type.setdefault(type(obj), []).append(obj)
            s = getattr(obj, "sender", None)
            # (_ReqSoA carries a sender *array*; its senders are clients,
            # never peers, so liveness bookkeeping doesn't apply)
            if type(s) is int and s in self.addr_map:
                self._last_heard[s] = self._now()
                self._suspects.discard(s)

        # cold control path first (creates must precede traffic to them)
        for o in by_type.pop(pkt.CreateGroup, []):
            ok = self.create_group(o.name, o.members, o.version,
                                   o.initial_state)
            gkey = pkt.group_key(o.name)
            exists = (self.table.by_key(gkey) is not None
                      or gkey in self._paused)  # paused groups exist
            self._route(o.sender, pkt.CreateGroupAck(
                self.id, gkey, 1 if (ok or exists) else 0))
        for o in by_type.pop(pkt.DeleteGroup, []):
            meta = self._lookup(o.gkey)
            if meta is not None:
                self.delete_group(meta.name)
        for o in by_type.pop(pkt.FailureDetect, []):
            if not o.is_pong:
                self._route(o.sender, pkt.FailureDetect(self.id, 1, o.ts_ns))
            else:
                # pong carries our own ping's wall stamp: one RTT
                # sample per peer per ping interval — the per-link
                # latency baseline a cross-node trace is read against
                rtt = (time.time_ns() - o.ts_ns) / 1e9
                if 0.0 <= rtt < 60.0:  # guard clock steps
                    self.transport.note_rtt(o.sender, rtt)
        for o in by_type.pop(pkt.Response, []):
            # a peer answered a forwarded (deduped) proposal: relay to the
            # client still waiting on us as its entry replica
            waiter = self._client_wait.pop(o.req_id, None)
            if waiter is not None:
                self._route(waiter[0], pkt.Response(
                    self.id, o.gkey, o.req_id, o.status, o.payload))
        for o in by_type.pop(pkt.Chunk, []):
            self._handle_chunk(o)
        for o in by_type.pop(pkt.SyncRequest, []):
            self._handle_sync_request(o)
        for o in by_type.pop(pkt.SyncReply, []):
            self._handle_sync_reply(o)
        for o in by_type.pop(pkt.CheckpointRequest, []):
            meta = self._lookup(o.gkey)
            if meta is not None:
                self._route(o.sender, pkt.CheckpointReply(
                    self.id, meta.gkey,
                    int(self._cur[meta.row]) - 1,
                    self.app.checkpoint(meta.name)))
        for o in by_type.pop(pkt.CheckpointReply, []):
            self._handle_checkpoint_reply(o)

        # failover cold path
        prepares = by_type.pop(pkt.Prepare, [])
        if prepares:
            self._handle_prepares(prepares)
        pbs = by_type.pop(pkt.PrepareBatch, [])
        if pbs:
            t0 = time.monotonic()
            self._handle_prepare_batches(pbs)
            DelayProfiler.update_total(
                "w.prepare_batch", t0, sum(len(p.gkey) for p in pbs))
        for o in by_type.pop(pkt.PrepareReply, []):
            self._handle_prepare_reply(o)
        prbs = by_type.pop(pkt.PrepareReplyBatch, [])
        if prbs:
            t0 = time.monotonic()
            for o in prbs:
                self._handle_prepare_reply_batch(o)
            DelayProfiler.update_total(
                "w.prepare_reply_batch", t0,
                sum(len(p.gkey) for p in prbs))

        # hot path, pipeline order
        reqs = by_type.pop(pkt.Request, [])
        props = by_type.pop(pkt.Proposal, [])
        soas = by_type.pop(_ReqSoA, [])
        accepts = by_type.pop(pkt.AcceptBatch, [])
        commits = by_type.pop(pkt.CommitBatch, [])
        replies = by_type.pop(pkt.AcceptReplyBatch, [])
        # fused coordinator wave (columnar): requests + replies in one
        # device dispatch.  Reply-side state (votes/cbal) and accept-
        # side state (bal/acc) are disjoint on device, and in steady
        # state a node only receives accepts for groups it does NOT
        # coordinate and replies for groups it does, so hoisting
        # replies past accepts cannot reorder same-group work.
        # Coordinator HANDOFF is the exception worth spelling out: for
        # a beat after an election, a node can see BOTH accepts and
        # replies for the SAME group in one batch — the dying
        # coordinator's in-flight accepts arrive alongside replies to
        # the accepts we re-drove at our new ballot.  The hoist is
        # still safe then: (a) the reply kernel counts votes only at
        # bal == cbal, and stale-regime replies carry the OLD ballot,
        # so they are ignored regardless of order; (b) the accept
        # kernel's only write shared with the reply path is the
        # promised-ballot max, which is monotone — applying the old
        # coordinator's accept before or after our reply wave yields
        # the same max and the same ack/nack decision for every lane
        # (a lower-ballot accept nacks either way once our install
        # raised the promise); (c) the self-accept inside the fused
        # request kernel writes our OWN row's acc window, which the
        # foreign accept cannot touch in the same batch — the manager's
        # (row, slot) coalesce keeps one lane per slot and a foreign
        # coordinator of the same row would be a second regime whose
        # lower ballot loses the max either way.
        fuse_coord = bool(replies) and (reqs or props or soas) \
            and self._fuse_waves
        if fuse_coord:
            t0 = time.monotonic()
            c0 = self._ct()
            self._handle_requests_replies(reqs, props, soas, replies)
            DelayProfiler.update_total(
                "w.req_rep", t0,
                len(reqs) + len(props) + len(replies)
                + sum(len(s.gkey) for s in soas), cpu_t0=c0)
        elif reqs or props or soas:
            t0 = time.monotonic()
            c0 = self._ct()
            self._handle_requests(reqs, props, soas)
            DelayProfiler.update_total(
                "w.requests", t0,
                len(reqs) + len(props) + sum(len(s.gkey) for s in soas),
                cpu_t0=c0)
        fuse_wave = accepts and commits and self._fuse_waves
        # async overlapped acceptor wave (columnar, fusion off — the
        # host-XLA operating point): submit the accept wave AND the
        # commit wave back-to-back, then run the host halves in split-
        # handler order, so the commit wave's device time overlaps the
        # accept half's WAL fsync + reply build.  Same hoist-safety
        # argument as fuse_wave (commit writes dec/exec only; both
        # waves' pres touch only commutative mirror maxes).
        overlap_wave = bool(accepts) and bool(commits) \
            and not fuse_wave and self._col_self is not None
        if fuse_wave or overlap_wave:
            # fused acceptor wave: both types -> ONE device dispatch
            # (or one submit+submit overlap).  Safe to hoist commits
            # past replies: the commit kernel writes dec/exec state
            # only, the reply kernel reads vote/coordinator state only
            # (they commute), and commits in this batch are from prior
            # waves.  The C-engine path keeps the split handlers (its
            # per-stage calls are sub-ms).
            t0 = time.monotonic()
            c0 = self._ct()
            if fuse_wave:
                self._handle_accepts_commits(accepts, commits)
            else:
                self._handle_accepts_commits_overlapped(accepts,
                                                        commits)
            DelayProfiler.update_total(
                "w.acc_com", t0, len(accepts) + len(commits),
                cpu_t0=c0)
        elif accepts:
            t0 = time.monotonic()
            c0 = self._ct()
            self._handle_accepts(accepts)
            DelayProfiler.update_total("w.accepts", t0, len(accepts),
                                       cpu_t0=c0)
        if replies and not fuse_coord:
            t0 = time.monotonic()
            c0 = self._ct()
            self._handle_accept_replies(replies)
            DelayProfiler.update_total("w.replies", t0, len(replies),
                                       cpu_t0=c0)
        if commits and not fuse_wave and not overlap_wave:
            t0 = time.monotonic()
            c0 = self._ct()
            self._handle_commits(commits)
            DelayProfiler.update_total("w.commits", t0, len(commits),
                                       cpu_t0=c0)
        for t, objs in by_type.items():
            handlers = self._handlers.get(t)
            if not handlers:
                log.warning("unhandled packet type %s x%d", t.__name__,
                            len(objs))
                continue
            t0 = time.monotonic()
            for o in objs:
                for h in handlers:
                    try:
                        h(o)
                    except Exception:
                        log.exception("handler %r failed", h)
            DelayProfiler.update_total(f"w.upper.{t.__name__}", t0,
                                       len(objs))

    def register_handler(self, ptype: type, fn) -> None:
        """Register an upper-layer handler for a packet class (called on
        the worker thread; ref: ``AbstractPacketDemultiplexer.register``)."""
        self._handlers.setdefault(ptype, []).append(fn)

    def add_tick_hook(self, fn) -> None:
        """Run ``fn()`` on the worker thread every ping interval (upper
        layers: epoch-FSM retries, demand reporting)."""
        self._tick_hooks.append(fn)

    def _note_ballot_change(self, rows) -> None:
        """Count ballot/leadership churn per row + node-wide (called
        from the cold election/preemption/promise paths only)."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        if not len(rows):
            return
        np.add.at(self._bal_changes, rows, 1)
        with self._stat_lock:
            self.n_ballot_changes += len(rows)
            total = self.n_ballot_changes
        bb = self.blackbox
        if bb is not None:
            # churn-spike trigger (arXiv:2006.01885 leader-churn
            # pathology): a burst of ballot changes dumps the ring
            bb.note_churn(total)

    def metrics(self, include_profiler: bool = True) -> dict:
        """Structured node metrics: counters + engine overlap split +
        transport counters + the process-global profiler snapshot and
        span aggregates.  The machine-readable face (JSON over /stats,
        Prometheus over /metrics); :meth:`stats` renders the one-line
        human view over the same dict.  ``include_profiler=False``
        skips the profiler snapshot and span aggregation (one pass
        over every histogram and the span ring under the global locks)
        — the cheap counters-only view the one-line render needs."""
        t = DelayProfiler.totals()

        def s(tag):
            return t.get(tag, (0.0,))[0]

        out = {
            "node": self.id,
            "counters": {
                "executed": self.n_executed,
                "decided": self.n_decided,
                "paused": self.n_paused,
                "unpaused": self.n_unpaused,
                "redriven": self.n_redriven,
                "redrive_capped": self.n_redrive_capped,
                "parked": self.n_parked,
                "park_dropped": self.n_park_dropped,
                "shed": self.n_shed,
                "shed_disk": self.n_shed_disk,
                "wal_nacked": self.n_wal_nacked,
                "installs": self.n_installs,
                "ballot_changes": self.n_ballot_changes,
                "groups": len(self.table),
                "backlog_est": self._backlog_est,
                "engine_shards": self.shards,
                # "off" or the device-mesh size (PC.ENGINE_MESH)
                "engine_mesh": self.backend.engine_mesh,
            },
            # engine overlap split (process-global, like the
            # reference's DelayProfiler): sub = host wall launching
            # waves, blk = wall blocked materializing device results,
            # ovl = submit->collect gap the host spent on other work
            # while the device ran.  The flight-deck sub-dicts (PR 18):
            # ledger = compile/retrace counts, cache = persistent-cache
            # hit/miss — both O(kernels) dict copies, cheap enough for
            # every scrape
            "engine": {
                "submit_s": s("eng.submit"),
                "collect_s": s("eng.collect"),
                "overlap_s": s("eng.overlap"),
                # per-kernel rows replace the snapshot's count so the
                # prometheus render can label gp_engine_compiles_total
                # by kernel; /engine keeps the scalar summary
                "ledger": {**EngineLedger.snapshot(),
                           "kernels": EngineLedger.kernels()},
                "cache": _cache_metrics(),
            },
            "net": self.transport.metrics(),
        }
        # wire-efficiency derived metrics (PR 13): total wire bytes and
        # writer/reader calls (the syscall proxy) amortized per decided
        # slot — the two numbers the wire-aggregation plane moves
        net = out["net"]
        dec = out["counters"]["decided"]
        if dec:
            net["bytes_per_decision"] = round(
                (net["tx_bytes"] + net["rx_bytes"]) / dec, 2)
            net["syscalls_per_decision"] = round(
                (net["tx_writes"] + net["rx_reads"]) / dec, 4)
        else:
            net["bytes_per_decision"] = 0.0
            net["syscalls_per_decision"] = 0.0
        if include_profiler:
            # consensus-health aggregates (GET /groups has the per-
            # group detail; these are the per-scrape node rollups).
            # Gated with the profiler snapshot: the health scan is
            # O(groups), and the one-line stats() render — which may
            # run every few seconds against a million-group node —
            # asks for the cheap counters-only view
            out["groups_health"] = self._groups_health()
            out["wal"] = {"segments": self.logger.segment_stats(),
                          "health": self.logger.wal_health()}
            out["profiler"] = DelayProfiler.snapshot()
            out["spans"] = RequestInstrumenter.span_stats()
            # slab accounting + mesh/shard row balance: one bool-plane
            # transfer under the engine locks, gated with the heavy
            # view for the same reason as the health scan
            mem, bal = self._engine_detail()
            if mem is not None:
                out["engine"]["memory"] = mem
            if bal is not None:
                out["engine"]["balance"] = bal
            slow = RequestInstrumenter.slow_traces()
            if slow:
                out["slow_traces"] = slow
        return out

    def _engine_detail(self):
        """``(memory_info, row_ownership)`` under ALL engine locks —
        the columnar engine swaps donated state buffers per wave, so an
        unlocked read can observe a deleted buffer (same contract as
        :meth:`_inspect_locked`).  ``(None, None)`` for backends
        without device slabs."""
        if self.backend.memory_info.__func__ is \
                AcceptorBackend.memory_info:
            return None, None
        with contextlib.ExitStack() as stack:
            for lk in self._locks_for(range(self.shards)):
                stack.enter_context(lk)
            return (self.backend.memory_info(),
                    self.backend.row_ownership())

    def engine_info(self) -> dict:
        """``GET /engine``: the device-axis flight deck — compile/
        retrace ledger, persistent-cache hit/miss, slab memory math,
        and per-shard wave timing / row balance."""
        t = DelayProfiler.totals()

        def s(tag):
            return t.get(tag, (0.0,))[0]

        per_shard = {}
        for k in range(self.shards):
            sub = s(f"eng.submit@{k}")
            col = s(f"eng.collect@{k}")
            if sub or col:
                per_shard[k] = {"submit_s": sub, "collect_s": col,
                                "overlap_s": s(f"eng.overlap@{k}")}
        mem, bal = self._engine_detail()
        return {
            "node": self.id,
            "platform": self.backend.engine_platform,
            "engine_shards": self.shards,
            "engine_mesh": self.backend.engine_mesh,
            "ledger": EngineLedger.snapshot(),
            "cache": _cache_metrics(),
            "memory": mem,
            "balance": bal,
            "waves": {"submit_s": s("eng.submit"),
                      "collect_s": s("eng.collect"),
                      "overlap_s": s("eng.overlap"),
                      "per_shard": per_shard},
        }

    def engine_kernels(self) -> dict:
        """``GET /engine/kernels``: the ledger's rows, one per built
        library (builds / compile seconds / loads), joined with the hot
        waves' costs (bytes accessed from the shapes; flops null), and
        the hand-written kernels' launches in this process, by kernel
        (``cuda:accept``, ``cuda:commit``, ``cuda:propose``,
        ``cuda:accept_reply``, ``cuda:acceptor_wave``,
        ``cuda:coordinator_wave``; 0 off the card, where the wrappers run
        their plain versions).
        Read under the engine locks, as the reference's cost sweep."""
        from gigapaxos_tpu_torch.utils.engineledger import kernel_launches
        with contextlib.ExitStack() as stack:
            for lk in self._locks_for(range(self.shards)):
                stack.enter_context(lk)
            costs = self.backend.kernel_costs()
        return {"node": self.id,
                "kernels": EngineLedger.kernels(),
                "costs": costs,
                "launches": kernel_launches()}

    def _groups_health(self) -> dict:
        """Node-wide consensus-health rollup from the host mirrors
        (no device round trip — cheap enough for every scrape): exec
        lag = accepted-but-not-yet-executed slots per group."""
        rows = np.asarray([m.row for m in self.table.snapshot_metas()],
                          np.int64)
        if not len(rows):
            return {"groups": 0, "exec_lag_max": 0, "exec_lag_sum": 0,
                    "exec_lag_mean": 0.0, "ballot_changes_max": 0}
        lag = np.maximum(self._acc_hi[rows] + 1 - self._cur[rows], 0)
        return {
            "groups": int(len(rows)),
            "exec_lag_max": int(lag.max()),
            "exec_lag_sum": int(lag.sum()),
            "exec_lag_mean": float(round(lag.mean(), 3)),
            "ballot_changes_max": int(self._bal_changes[rows].max()),
        }

    def groups_info(self, limit: int = 256) -> dict:
        """``GET /groups``: per-group consensus health, worst exec-lag
        first — leader, ballot, churn count, cursors, WAL segment.
        Host mirrors are scanned vectorized; device truth (promised /
        coordinator ballots, next slot, exec cursor) comes from ONE
        columnar gather over the returned rows only."""
        metas = self.table.snapshot_metas()
        if not metas:
            return {"count": 0, "returned": 0, "truncated": False,
                    "groups": []}
        rows = np.asarray([m.row for m in metas], np.int64)
        lag = np.maximum(self._acc_hi[rows] + 1 - self._cur[rows], 0)
        sel = np.argsort(-lag, kind="stable")[:max(1, int(limit))]
        dev = self._inspect_locked(rows[sel])
        groups = [self._group_dict(metas[i], int(lag[i]), dev, j)
                  for j, i in enumerate(sel.tolist())]
        return {"count": len(metas), "returned": len(groups),
                "truncated": len(groups) < len(metas),
                "groups": groups}

    def group_info(self, ident) -> Optional[dict]:
        """``GET /groups/<id>``: one group by name (or decimal/hex
        group key); None when unknown."""
        meta = self.table.by_name(str(ident))
        if meta is None:
            try:
                meta = self.table.by_key(int(str(ident), 0))
            except ValueError:
                meta = None
        if meta is None:
            return None
        lag = int(max(0, int(self._acc_hi[meta.row]) + 1
                      - int(self._cur[meta.row])))
        return self._group_dict(
            meta, lag, self._inspect_locked(
                np.asarray([meta.row], np.int64)), 0)

    def _inspect_locked(self, rows: np.ndarray) -> dict:
        """Device-truth gather for ``rows`` under the owning engine
        locks (the columnar engine swaps donated buffers per call — an
        unlocked read can observe a deleted buffer)."""
        with contextlib.ExitStack() as stack:
            for lk in self._locks_for(int(r) % self.shards
                                      for r in rows):
                stack.enter_context(lk)
            return self.backend.inspect_rows(rows)

    def _group_dict(self, meta, lag: int, dev: dict, j: int) -> dict:
        row = meta.row
        num, coord = unpack_ballot(int(self._bal[row]))
        shard = self.table.shard_of(meta.gkey)
        d = {
            "name": meta.name,
            "gkey": f"{meta.gkey:#x}",
            "row": row,
            "shard": shard,
            "members": list(meta.members),
            "version": meta.version,
            "leader": coord,
            "ballot_num": num,
            "ballot_changes": int(self._bal_changes[row]),
            "exec_lag": lag,
            "acc_hi": int(self._acc_hi[row]),
            "exec_cursor_host": int(self._cur[row]),
            "ckpt_slot": int(self._ckpt[row]),
            "stopped": row in self._group_stopped,
            "wal_segment": shard % self.logger.segments,
        }
        if dev:
            d["promised_bal"] = int(dev["bal"][j])
            d["coord_bal"] = int(dev["cbal"][j])
            d["next_slot"] = int(dev["next_slot"][j])
            d["exec_cursor"] = int(dev["exec_cursor"][j])
        return d

    def _obs_route(self, path: str):
        """Introspection routes for the per-node stats listener."""
        from gigapaxos_tpu_torch.net.statshttp import observability_routes
        return observability_routes(path, groups_fn=self.groups_info,
                                    group_fn=self.group_info,
                                    blackbox=self.blackbox,
                                    engine_fn=self.engine_info,
                                    engine_kernels_fn=self.engine_kernels)

    def stats(self) -> str:
        """One-line node counters (ref: the reference's periodic
        DelayProfiler/NIOInstrumenter stats lines) — a thin formatter
        over :meth:`metrics`."""
        m = self.metrics(include_profiler=False)
        c = m["counters"]
        e = m["engine"]
        return (f"exec={c['executed']} dec={c['decided']} "
                f"paused={c['paused']}/{c['unpaused']} "
                f"redrive={c['redriven']}"
                f"(capped={c['redrive_capped']}) "
                f"park={c['parked']}(drop={c['park_dropped']}) "
                f"shed={c['shed']} "
                f"installs={c['installs']} "
                f"groups={c['groups']} "
                f"eng[sub={e['submit_s']:.2f}s "
                f"blk={e['collect_s']:.2f}s "
                f"ovl={e['overlap_s']:.2f}s] "
                f"net[{self.transport.stats()}]")

    # -- request/proposal → propose ------------------------------------

    def _park(self, row: int, prop: "pkt.Proposal") -> None:
        """Hold a proposal while the row's leadership is unsettled
        (election in flight / coordinator suspect or unknown) instead of
        forwarding it into a black hole."""
        q = self._parked.setdefault(row, [])
        if len(q) >= 512:
            q.pop(0)  # oldest first; its client retransmit covers it
            with self._stat_lock:
                self.n_park_dropped += 1
        with self._stat_lock:
            self.n_parked += 1
        q.append((self._now(), prop))

    def _flush_parked(self, row: int) -> None:
        """Re-inject parked proposals now that leadership settled (we won,
        or a live coordinator is known): the normal path forwards or
        proposes them."""
        q = self._parked.pop(row, None)
        if not q:
            return
        now = self._now()
        live = [p for ts, p in q if now - ts < 10.0]
        if live:
            self._handle_requests([], live)

    def _intake_take(self, n: int = 1) -> bool:
        """Take n tokens from the intake bucket; False = throttled."""
        now = self._now()
        self._intake_tokens = min(
            self.intake_rps,
            self._intake_tokens + (now - self._intake_ts) *
            self.intake_rps)
        self._intake_ts = now
        if self._intake_tokens < n:
            return False
        self._intake_tokens -= n
        return True

    def _intake_limit(self, sb: "_ReqSoA"):
        """Token-bucket intake limiter (ref: paxosutil/RateLimiter):
        admits up to the bucket's tokens, answers the rest status 1
        ("not now, retry") so clients back off instead of queueing."""
        now = self._now()
        self._intake_tokens = min(
            self.intake_rps,
            self._intake_tokens + (now - self._intake_ts) *
            self.intake_rps)
        self._intake_ts = now
        n = len(sb.req_id)
        take = int(min(n, self._intake_tokens))
        self._intake_tokens -= take
        if take >= n:
            return sb
        for i in range(take, n):
            self._route(int(sb.sender[i]), pkt.Response(
                self.id, int(sb.gkey[i]), int(sb.req_id[i]), 1, b""))
        if take == 0:
            return None
        return _ReqSoA(sb.sender[:take], sb.gkey[:take],
                       sb.req_id[:take], sb.flags[:take],
                       sb.pay_off[:take + 1], sb.pay)

    def _handle_requests(self, reqs: List, props: List,
                         soas: Tuple = ()) -> None:
        pre = self._req_pre(reqs, props, soas)
        if pre is None:
            return
        rows, req_ids, flag_parts, pay_parts, now = pre
        if self._col_self is not None:
            res, self_acked, self_newly, self_pre, self_cur = \
                self.backend.propose_self(rows, req_ids,
                                          self._self_midx(rows))
        else:
            self_acked = None
            self_newly = self_pre = self_cur = None
            res = self.backend.propose(rows, req_ids)
        self._req_post(rows, req_ids, flag_parts, pay_parts, now, res,
                       self_acked, self_newly, self_pre, self_cur)

    def _req_pre(self, reqs: List, props: List, soas: Tuple = ()):
        """Host half of the request path BEFORE the engine call: shed,
        dedupe, forward/park, lane assembly (split out for the fused
        coordinator wave)."""
        # storage degraded / disk full: shed ALL fresh proposals with
        # status 5 — the disk-full shed, distinct from the status-1
        # congestion retry so clients back off AND rotate to another
        # server rather than hammer a node that cannot make anything
        # durable.  Forwarded props are answered to their entry
        # replica, which relays the status to the waiting client (see
        # the Response handler).  Commits/decides are NOT handled here
        # and still flow: a degraded node keeps learning and serving.
        if (reqs or soas or props) and self.logger.impaired() is not None:
            n = 0
            for sb in soas:
                for i in range(len(sb.req_id)):
                    self._route(int(sb.sender[i]), pkt.Response(
                        self.id, int(sb.gkey[i]), int(sb.req_id[i]),
                        5, b""))
                n += len(sb.req_id)
            for o in reqs:
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 5, b""))
            for o in props:
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 5, b""))
            n += len(reqs) + len(props)
            with self._stat_lock:
                self.n_shed_disk += n
            return
        # congestion-collapse guard (PC.INTAKE_BACKLOG_LIMIT): a deep
        # inbound backlog means the engine is past its knee.  Shed a
        # PROPORTIONAL share of fresh client work (RED-style: ramps from
        # 0 at limit/2 to 100% at limit) — all-or-nothing shedding
        # oscillates (shed wave → synchronized client backoff →
        # thundering herd), wasting the engine's duty cycle.  Shed lanes
        # are answered status 1 so clients back off exponentially.  Peer
        # traffic (props) always flows: it is work already admitted
        # somewhere, and starving it deadlocks the pipeline.
        if (reqs or soas) and self.backlog_limit > 0:
            q = self._backlog_est
            half = self.backlog_limit // 2
            if q > half:
                frac = min(1.0, (q - half) / max(1, half))
                kept_soas = []
                for sb in soas:
                    n = len(sb.req_id)
                    keep = n - int(n * frac)
                    for i in range(keep, n):
                        self._route(int(sb.sender[i]), pkt.Response(
                            self.id, int(sb.gkey[i]),
                            int(sb.req_id[i]), 1, b""))
                    with self._stat_lock:
                        self.n_shed += n - keep
                    if keep:
                        kept_soas.append(_ReqSoA(
                            sb.sender[:keep], sb.gkey[:keep],
                            sb.req_id[:keep], sb.flags[:keep],
                            sb.pay_off[:keep + 1], sb.pay))
                soas = tuple(kept_soas)
                # requests this node put on its own queue (the control
                # plane's record ops and epoch stops) are not fresh
                # client work: each carries a decision already taken,
                # nothing answers a shed one but a later re-drive, so
                # they flow as peer traffic does; the tail of the
                # clients' requests is shed, as before
                n_cli = sum(o.sender != self.id for o in reqs)
                keep = n_cli - int(n_cli * frac)
                kept, seen = [], 0
                for o in reqs:
                    if o.sender != self.id:
                        seen += 1
                        if seen > keep:
                            self._route(o.sender, pkt.Response(
                                self.id, o.gkey, o.req_id, 1, b""))
                            continue
                    kept.append(o)
                with self._stat_lock:
                    self.n_shed += n_cli - keep
                reqs = kept
                if not (reqs or soas or props):
                    return
        rows_parts: List[np.ndarray] = []
        req_parts: List[np.ndarray] = []
        flag_parts: List[int] = []
        pay_parts: List[bytes] = []
        now = self._now()
        ex, exo = self._executed_recent, self._executed_old
        # req_ids taken into this batch's lanes: a retransmit that lands
        # in the same batch as its original passes the _proposed check
        # (that entry is made after the engine call) and would take a
        # second slot, whose execution then finds the payload gone with
        # the first and wedges the group on every replica
        taken: set = set()
        # ---- vectorized client batches (the hot path: one _ReqSoA per
        # wire read; per-lane Python is 3-4 dict ops) ----
        for sb in soas:
            if self.intake_rps > 0:
                sb = self._intake_limit(sb)
                if sb is None:
                    continue
            if RequestInstrumenter.enabled:
                # vectorized survivor selection: one numpy pass per
                # batch, a Python call only per SAMPLED request — a
                # 0.1% rate must not cost a per-request loop
                surv = np.flatnonzero(
                    RequestInstrumenter.sampled_mask(sb.req_id)
                    | ((np.asarray(sb.flags) & FLAG_SAMPLED) != 0))
                for i in surv.tolist():
                    RequestInstrumenter.record(
                        int(sb.req_id[i]), "recv", self.id, force=True)
            rows = self._rows_for_keys(sb.gkey)
            bal = self._bal[np.where(rows >= 0, rows, 0)]
            coords = np.where((rows >= 0) & (bal >= 0),
                              bal & NODE_MASK, -1)
            mine = coords == self.id
            slow = ~mine
            if self._group_stopped:
                for i in np.flatnonzero(mine):
                    if int(rows[i]) in self._group_stopped:
                        mine[i] = False
                        slow[i] = True
            if self._catchup_barrier:
                for i in np.flatnonzero(mine):
                    if int(rows[i]) in self._catchup_barrier:
                        mine[i] = False
                        slow[i] = True
            if slow.any():
                # unknown group / foreign coordinator / stopped row:
                # legacy per-object path below handles each such lane
                reqs = reqs + [sb.as_request(int(i))
                               for i in np.flatnonzero(slow)]
            po, snd, rid_arr = sb.pay_off, sb.sender, sb.req_id
            keep: List[int] = []
            for i in np.flatnonzero(mine).tolist():
                rid = int(rid_arr[i])
                if rid in ex or rid in exo:
                    st_, rv = self._cached_resp(rid)
                    self._route(int(snd[i]), pkt.Response(
                        self.id, int(sb.gkey[i]), rid, st_, rv))
                    continue
                if rid in self._proposed or rid in taken:
                    # in-flight duplicate: swallow the proposal, but
                    # keep what the retransmit carries — the payload (a
                    # carryover slot may hold only FLAG_MISSING) and
                    # the waiter (a carryover-registered rid has none,
                    # and without it the execute never answers)
                    self._store_payload(rid, int(sb.flags[i]),
                                        bytes(sb.payload(i)))
                    self._client_wait[rid] = (int(snd[i]), now,
                                              int(sb.gkey[i]))
                    continue
                self._client_wait[rid] = (int(snd[i]), now,
                                          int(sb.gkey[i]))
                taken.add(rid)
                keep.append(i)
            if keep:
                ka = np.asarray(keep, np.int64)
                rows_parts.append(rows[ka])
                req_parts.append(rid_arr[ka])
                flag_parts.extend(sb.flags[ka].tolist())
                pay_parts.extend(sb.pay[po[i]:po[i + 1]] for i in keep)
        # ---- legacy per-object path (forwards, parked re-injections,
        # and any slow lanes shunted from above) ----
        lanes: List[Tuple[int, int, int, bytes, int]] = []  # row,req,fl,pl,en
        for o in reqs:
            if self.intake_rps > 0 and not self._intake_take():
                # the rate limit must hold on the per-object fallback
                # path too (a malformed frame shunts whole chunks here)
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 1, b""))
                continue
            meta = self._lookup(o.gkey)
            if meta is None:
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 2, b""))
                continue
            if self._was_executed(o.req_id):
                # retransmit of an executed request: answer from the
                # response cache, never drop silently (at-most-once + reply)
                st, rv = self._cached_resp(o.req_id)
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, st, rv))
                continue
            if meta.row in self._group_stopped:
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 3, b""))
                continue
            self._client_wait[o.req_id] = (o.sender, self._now(), o.gkey)
            coord = unpack_ballot(int(self._bal[meta.row]))[1]
            if coord != self.id:
                prop = pkt.Proposal(
                    self.id, o.gkey, o.req_id, o.sender, o.flags, o.payload)
                if (meta.row in self._elections
                        or self._mass_has(meta.row) or coord < 0
                        or coord in self._suspects):
                    # leadership unsettled: park instead of forwarding to
                    # a dead/unknown coordinator (the old behavior black-
                    # holed every request until the client re-routed)
                    self._park(meta.row, prop)
                else:
                    if RequestInstrumenter.enabled:
                        # send stamp: the entry->coordinator hop of a
                        # sampled trace is measured fwd@entry -> prop@coord
                        RequestInstrumenter.record(
                            o.req_id, "fwd", self.id,
                            force=bool(o.flags & FLAG_SAMPLED))
                    self._route(coord, prop)
                continue
            if o.req_id in self._proposed or o.req_id in taken:
                # swallow the duplicate but keep its payload: a
                # carryover slot may hold only a FLAG_MISSING
                # placeholder that this retransmit can fill
                self._store_payload(o.req_id, o.flags, o.payload)
                continue
            if meta.row in self._catchup_barrier:
                self._park(meta.row, pkt.Proposal(
                    self.id, o.gkey, o.req_id, o.sender, o.flags,
                    o.payload))
                continue
            taken.add(o.req_id)
            lanes.append((meta.row, o.req_id, o.flags, o.payload, o.sender))
        for o in props:
            meta = self._lookup(o.gkey)
            if meta is None:
                # The group is gone here (deleted, or moved to a new
                # epoch hosted elsewhere): a silent drop would leave the
                # entry replica's client waiting out its whole timeout —
                # answer "no such group" so the entry relays it and the
                # client refreshes its actives and re-routes.
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 2, b""))
                continue
            if self._was_executed(o.req_id):
                # answer rides a Response to the entry replica, which
                # relays it to the waiting client (see Response handler)
                st, rv = self._cached_resp(o.req_id)
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, st, rv))
                continue
            if meta.row in self._group_stopped:
                self._route(o.sender, pkt.Response(
                    self.id, o.gkey, o.req_id, 3, b""))
                continue
            coord = unpack_ballot(int(self._bal[meta.row]))[1]
            if coord != self.id:
                # not us (stale forward): park while leadership is
                # unsettled; otherwise bounce onward AT MOST once per
                # window (the second sighting parks — breaks forward
                # cycles between stale views without a wire TTL)
                if (meta.row in self._elections
                        or self._mass_has(meta.row) or coord < 0
                        or coord in self._suspects):
                    self._park(meta.row, o)
                elif coord == o.sender:
                    # mutual disagreement (sender believes us, we believe
                    # sender): park, and on a REPEAT sighting force a
                    # view repair by running for coordinator ourselves —
                    # nothing else breaks a stable standoff on an
                    # otherwise idle row
                    t = self._now()
                    if t - self._bounced.get(o.req_id, 0.0) < 10.0:
                        self._start_election(meta.row, meta)
                    else:
                        self._bounced[o.req_id] = t
                    self._park(meta.row, o)
                else:
                    t = self._now()
                    if t - self._bounced.get(o.req_id, 0.0) < 5.0:
                        self._park(meta.row, o)
                    else:
                        self._bounced[o.req_id] = t
                        if RequestInstrumenter.enabled:
                            RequestInstrumenter.record(
                                o.req_id, "fwd", self.id,
                                force=bool(o.flags & FLAG_SAMPLED))
                        self._route(coord, o)
                continue
            if o.req_id in self._proposed or o.req_id in taken:
                # swallow the duplicate, keep its payload, and record
                # the entry replica as waiter so the carried slot's
                # execution answers it (a carryover-registered rid has
                # no waiter here)
                self._store_payload(o.req_id, o.flags, o.payload)
                self._client_wait[o.req_id] = (o.entry, self._now(),
                                               o.gkey)
                continue
            if meta.row in self._catchup_barrier:
                self._park(meta.row, o)
                continue
            taken.add(o.req_id)
            lanes.append((meta.row, o.req_id, o.flags, o.payload, o.entry))
        if lanes:
            rows_parts.append(np.asarray([l[0] for l in lanes], np.int32))
            req_parts.append(np.asarray([l[1] for l in lanes], np.uint64))
            flag_parts.extend(l[2] for l in lanes)
            pay_parts.extend(l[3] for l in lanes)
        if not rows_parts:
            return None
        rows = np.concatenate(rows_parts).astype(np.int32, copy=False)
        req_ids = np.concatenate(req_parts)
        self._la[rows] = now
        return rows, req_ids, flag_parts, pay_parts, now

    def _self_midx(self, rows) -> np.ndarray:
        """This node's member index per row (the fused self kernels
        need it to set the right vote bit)."""
        return np.argmax(self._member_mat[rows] == self.id,
                         axis=1).astype(np.int32)

    def _req_post(self, rows, req_ids, flag_parts, pay_parts, now, res,
                  self_acked, self_newly, self_pre, self_cur) -> None:
        """Host half of the request path AFTER the engine call:
        in-flight bookkeeping, payload store, fused-self WAL barrier,
        accept emission (split out for the fused coordinator wave)."""
        granted = np.asarray(res.granted)
        bal_of = self._bal[rows]
        slot_arr = np.asarray(res.slot)
        for i in np.flatnonzero(granted).tolist():
            rid = int(req_ids[i])
            self._proposed[rid] = _InFlight(
                int(rows[i]), int(slot_arr[i]), int(bal_of[i]), now, now)
            fl = int(flag_parts[i])
            if RequestInstrumenter.enabled and RequestInstrumenter \
                    .sampled(rid, bool(fl & FLAG_SAMPLED)):
                # stamp the wire bit at propose time: the accept blobs
                # carry it (blob byte 0 = flags), so acceptors honor
                # the sampling verdict without recomputing it — and
                # even when configured with a different rate
                fl = fl | FLAG_SAMPLED
                flag_parts[i] = fl
                if not RequestInstrumenter.sampled(rid):
                    # flag-forced but hash-negative: remember it so
                    # the vectorized dec/com.tx prefilters include it.
                    # Bounded: ids whose execution never happens here
                    # (group deleted, leadership lost) would leak —
                    # forced traces are rare, so on overflow drop the
                    # lot (the worst case is a missing dec/com.tx
                    # stamp on an ancient forced trace)
                    if len(self._forced_traces) >= 4096:
                        self._forced_traces.clear()
                    self._forced_traces.add(rid)
                RequestInstrumenter.record(rid, "prop", self.id,
                                           force=True)
            self._store_payload(rid, fl, bytes(pay_parts[i]))
        rej = np.asarray(res.rejected)
        if rej.any():
            for i in np.flatnonzero(rej):
                # we believed we coordinate this group but the device
                # disagrees (post-restart: coordinatorship is never
                # assumed on recovery) — regain it via phase 1; the
                # client's retransmit rides the new ballot
                row = int(rows[i])
                meta = self.table.by_row(row)
                if meta is not None and unpack_ballot(
                        int(self._bal[row]))[1] == self.id:
                    self._start_election(row, meta)
        wal_ok = True
        if self_acked is not None:
            wal_ok = self._after_propose_self(rows, req_ids, flag_parts,
                                              pay_parts, res, self_acked,
                                              self_newly, self_pre,
                                              self_cur, now)
        if wal_ok:
            self._emit_accepts(rows, req_ids, flag_parts, pay_parts, res,
                               skip_self=self_acked is not None)

    def _after_propose_self(self, rows, req_ids, flags, payloads, res,
                            self_acked, self_newly, self_pre, self_cur,
                            now) -> bool:
        """Host bookkeeping for the fused self-accept/vote: everything
        the loopback self-wave (_handle_accepts + _handle_accept_replies
        on our own frames) used to do — WAL durability BEFORE anything
        leaves this batch, acceptor mirrors, preemption adoption, and
        commits for single-member quorums.

        Returns False when the WAL barrier failed: the self vote is
        already counted on-device but is NOT durable, so nothing from
        this batch (accepts, single-member commits) may leave the node
        — a quorum formed on an erasable vote would break no_lost_acks.
        The caller skips _emit_accepts; clients retry elsewhere."""
        wal_ok = True
        ai = np.flatnonzero(self_acked)
        if len(ai):
            arows = rows[ai]
            slots_g = np.asarray(res.slot)[ai].astype(np.int32)
            cbals = np.asarray(res.cbal)[ai].astype(np.int32)
            np.maximum.at(self._acc_hi, arows, slots_g)
            self._acc_ts[arows] = now
            np.maximum.at(self._bal, arows, cbals)
            blobs = [bytes([flags[i]]) + payloads[i]
                     for i in ai.tolist()]
            wal_buf = native.encode_wal(
                np.full(len(ai), REC_ACCEPT, np.uint8),
                self._row_gkey[arows], slots_g, cbals, req_ids[ai],
                blobs, crc=self._wal_crc)
            # durability barrier: the self vote counts toward quorums,
            # so it must be durable before any resulting decision (or
            # remote accept) leaves this batch
            try:
                self.logger.log_raw_inline(wal_buf, n_entries=len(ai),
                                           seg=self._wal_seg())
            except WalImpairedError as exc:
                self._note_wal_impaired(exc, len(ai))
                wal_ok = False
            if wal_ok and RequestInstrumenter.enabled:
                ai_l = ai.tolist()
                farr = np.fromiter((flags[i] for i in ai_l), np.int64,
                                   len(ai_l))
                for k in np.flatnonzero(
                        RequestInstrumenter.sampled_mask(req_ids[ai])
                        | ((farr & FLAG_SAMPLED) != 0)).tolist():
                    RequestInstrumenter.record(
                        int(req_ids[ai_l[k]]), "acc", self.id,
                        force=True)
        pre = np.flatnonzero(self_pre)
        if len(pre):
            # our own acceptor outranked us (competitor's prepare landed
            # first): adopt the higher promise; the kernel already
            # resigned coordinatorship.  Churn = rows whose mirror
            # actually advances (see _rep_post), deduped.
            rp = rows[pre]
            cp = np.asarray(self_cur)[pre].astype(np.int32)
            gain = cp > self._bal[rp]
            if gain.any():
                self._note_ballot_change(np.unique(rp[gain]))
            np.maximum.at(self._bal, rp, cp)
        ni = np.flatnonzero(self_newly)
        if len(ni) and wal_ok:
            # single-member quorum: decided on our own vote
            with self._stat_lock:
                self.n_decided += len(ni)
            nrows = rows[ni]
            reqs = req_ids[ni]
            self._emit_commits(
                nrows, self._row_gkey[nrows],
                np.asarray(res.slot)[ni].astype(np.int32),
                np.asarray(res.cbal)[ni].astype(np.int32),
                *_split_reqs(reqs))
        return wal_ok

    def _emit_commits(self, nrows, gkeys, slots, bals, rlo, rhi,
                      skip_self: bool = False) -> None:
        """CommitBatch per member destination for newly decided lanes.
        ``skip_self``: the fused decide wave already applied our own
        commit on-device (host bookkeeping in _after_self_commit)."""
        if RequestInstrumenter.enabled:
            # send stamp: coordinator->replica commit hop of a sampled
            # trace is measured com.tx@coord -> exec@replica.  Hash
            # prefilter (one numpy pass) + the small forced-trace set;
            # no per-request payload-dict lookups on this path.
            creqs = _merge_req(np.asarray(rlo), np.asarray(rhi))
            mask = RequestInstrumenter.sampled_mask(creqs)
            FT = self._forced_traces
            if FT:  # stays vectorized: np.isin, not a Python loop
                mask = mask | np.isin(
                    creqs, np.fromiter(FT, np.uint64, len(FT)))
            for k in np.flatnonzero(mask).tolist():
                RequestInstrumenter.record(int(creqs[k]), "com.tx",
                                           self.id, force=True)
        dsts = self._member_mat[nrows]
        for dst in np.unique(dsts):
            if dst < 0 or (skip_self and dst == self.id):
                continue
            m = (dsts == dst).any(axis=1)
            self._route(int(dst), pkt.CommitBatch(
                self.id, gkeys[m], slots[m], bals[m], rlo[m], rhi[m]))

    def _emit_accepts(self, rows, req_ids, flags, payloads, res,
                      skip_self: bool = False) -> None:
        """Granted lanes → AcceptBatch per member destination (one mask
        per dst over the membership matrix; gkeys come from the row->gkey
        array, pinned u64 — a bare np.asarray of mixed int magnitudes
        would promote to float64 and corrupt keys past 53 bits)."""
        granted = np.asarray(res.granted)
        if not granted.any():
            return
        gi = np.flatnonzero(granted)
        rows_g = rows[gi]
        gkeys = self._row_gkey[rows_g]
        slots = np.asarray(res.slot)[gi].astype(np.int32)
        cbals = np.asarray(res.cbal)[gi].astype(np.int32)
        reqs_g = req_ids[gi]
        lo = (reqs_g & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(
            np.int32)
        hi = (reqs_g >> np.uint64(32)).astype(np.uint32).view(np.int32)
        pls = [bytes([flags[i]]) + payloads[i] for i in gi.tolist()]
        if RequestInstrumenter.enabled:
            # send stamp: coordinator->acceptor hop of a sampled trace
            # is measured acc.tx@coord -> acc@acceptor.  Vectorized
            # prefilter: hash mask OR the stamped wire bit.
            gi_l = gi.tolist()
            farr = np.fromiter((flags[i] for i in gi_l), np.int64,
                               len(gi_l))
            surv = np.flatnonzero(
                RequestInstrumenter.sampled_mask(reqs_g)
                | ((farr & FLAG_SAMPLED) != 0))
            for k in surv.tolist():
                RequestInstrumenter.record(int(reqs_g[k]), "acc.tx",
                                           self.id, force=True)
        dsts = self._member_mat[rows_g]
        for dst in np.unique(dsts):
            if dst < 0 or (skip_self and dst == self.id):
                # fused path: our own accept + vote already happened
                # inside the propose kernel call
                continue
            m = (dsts == dst).any(axis=1)
            self._route(int(dst), pkt.AcceptBatch(
                self.id, gkeys[m], slots[m], cbals[m], lo[m], hi[m],
                payloads=[pls[k] for k in np.flatnonzero(m)]))

    # -- accepts (acceptor side) ---------------------------------------

    def _handle_accepts(self, objs: List) -> None:
        # flatten + coalesce: one lane per (row, slot), max ballot wins.
        # gkey->row is ONE native batched lookup; the (row, slot) max-bal
        # winner mask is ONE native hash pass (ref: PaxosPacketBatcher).
        # Everything per-lane below is vectorized numpy over the batch —
        # the only Python-per-lane work left is the payload dict store.
        gkeys = _cat(objs, lambda o: np.asarray(o.gkey, np.uint64))
        slots_all = _cat(objs, lambda o: np.asarray(o.slot, np.int32))
        bals_all = _cat(objs, lambda o: np.asarray(o.bal, np.int32))
        reqs_all = _cat(objs, lambda o: _merge_req(o.req_lo, o.req_hi))
        send_all = _cat(objs, lambda o: np.full(len(o.gkey), o.sender,
                                                np.int32))
        rows_all = self._rows_for_keys(gkeys)
        if self._fused is not None:
            now = self._now()
            keep, acked_m, stale_m, ow_m, reply_bal = \
                self._fused.handle_accepts(
                    rows_all, slots_all, bals_all, reqs_all, now,
                    self._bal, self._acc_hi, self._acc_ts, self._la)
            ai = np.flatnonzero(acked_m)
            pls = _lane_payloads(objs, ai)
            blobs = []
            # inlined _store_payload (identical best-copy semantics):
            # this is the one per-lane Python loop on the accept path,
            # so every dict hop and numpy scalar conversion counts
            P, PO = self._payloads, self._payloads_old
            for blob, rid in zip(pls, reqs_all[ai].tolist()):
                fl = blob[0] if blob else 0
                cur = P.get(rid)
                if cur is None:
                    cur = PO.pop(rid, None)
                    if cur is not None:
                        P[rid] = cur
                if cur is None or ((cur[0] & FLAG_MISSING)
                                   and not (fl & FLAG_MISSING)):
                    P[rid] = (fl, bytes(blob[1:]) if blob else b"")
                blobs.append(blob if blob else b"\x00")
            wal_buf = native.encode_wal(
                np.full(len(ai), REC_ACCEPT, np.uint8), gkeys[ai],
                slots_all[ai], bals_all[ai], reqs_all[ai], blobs,
                crc=self._wal_crc) \
                if len(ai) else None
            in_reply = keep & ~ow_m
            acked_u8 = acked_m.astype(np.uint8)
            if wal_buf is not None:
                # durability barrier: fsync before replies leave.  If
                # the WAL is impaired the votes are withdrawn — replies
                # go out nacked at the same ballot (the coordinator
                # just never counts us; quorum forms elsewhere) since
                # the on-device vote is not durable.
                try:
                    self.logger.log_raw_inline(wal_buf,
                                               n_entries=len(ai),
                                               seg=self._wal_seg())
                except WalImpairedError as exc:
                    self._note_wal_impaired(exc, len(ai))
                    acked_u8[:] = 0
                else:
                    if RequestInstrumenter.enabled:
                        ai_l = ai.tolist()
                        farr = np.fromiter(
                            (b[0] for b in blobs), np.int64, len(blobs))
                        for k in np.flatnonzero(
                                RequestInstrumenter.sampled_mask(
                                    reqs_all[ai])
                                | ((farr & FLAG_SAMPLED) != 0)).tolist():
                            RequestInstrumenter.record(
                                int(reqs_all[ai_l[k]]), "acc", self.id,
                                force=True)
            out = []
            for dst in np.unique(send_all[in_reply]):
                m = in_reply & (send_all == dst)
                out.append((int(dst), pkt.AcceptReplyBatch(
                    self.id, gkeys[m], slots_all[m], reply_bal[m],
                    acked_u8[m])))
            for dst, arb in out:
                self._route(dst, arb)
            return
        pre = self._acc_pre(rows_all, slots_all, bals_all, reqs_all,
                            send_all)
        if pre is None:
            return
        idxs, rows, slots, bals, req_ids, senders, now = pre
        res = self.backend.accept(rows, slots, bals, req_ids)
        self._acc_post(objs, gkeys, idxs, rows, slots, bals, req_ids,
                       senders, now, res)

    def _acc_pre(self, rows_all, slots_all, bals_all, reqs_all,
                 send_all):
        """Host half of the acceptor path BEFORE the engine call:
        (row, slot) max-ballot coalesce + liveness stamp.  Split out so
        the fused accept+commit wave can run it, make ONE device call,
        and hand the outputs to :meth:`_acc_post`."""
        keep = native.coalesce_max(rows_all, slots_all, bals_all)
        if not keep.any():
            return None
        idxs = np.flatnonzero(keep)
        rows = rows_all[idxs]
        now = self._now()
        self._la[rows] = now
        return (idxs, rows, slots_all[idxs], bals_all[idxs],
                reqs_all[idxs], send_all[idxs], now)

    def _acc_post(self, objs, gkeys, idxs, rows, slots, bals, req_ids,
                  senders, now, res) -> None:
        """Host half AFTER the engine call: mirrors, payload store, WAL
        (fsync BEFORE replies leave — the durability barrier is in this
        half, so fusing the device call cannot reorder it), replies."""
        acked = np.asarray(res.acked)
        arows = rows[acked]
        # vectorized mirrors: catch-up watermark + max ballot seen
        np.maximum.at(self._acc_hi, arows, slots[acked])
        self._acc_ts[arows] = now
        np.maximum.at(self._bal, arows, bals[acked])
        # payload store (the one per-lane Python loop left: dict insert)
        blobs: List[bytes] = []
        ai = np.flatnonzero(acked)
        pls = _lane_payloads(objs, idxs[ai])
        for k, i in enumerate(ai):
            blob = pls[k]
            flags, payload = (blob[0], bytes(blob[1:])) if blob \
                else (0, b"")
            self._store_payload(int(req_ids[i]), flags, payload)
            blobs.append(blob if blob else b"\x00")
        # durability: fsync BEFORE replies leave (SURVEY §7.3.2).  The
        # write happens inline on this (the only logging) thread — the
        # writer-thread hand-off costs two GIL hops per batch and buys
        # no additional group commit (see logger.log_raw_inline).
        wal_buf = None
        if len(ai):
            wal_buf = native.encode_wal(
                np.full(len(ai), REC_ACCEPT, np.uint8), gkeys[idxs[ai]],
                slots[ai], bals[ai], req_ids[ai], blobs,
                crc=self._wal_crc)

        # group replies per coordinator sender (vectorized per dst)
        in_reply = ~np.asarray(res.out_window)
        reply_bal = np.where(acked, bals, np.asarray(res.cur_bal))
        acked_u8 = acked.astype(np.uint8)
        reply_gkeys = gkeys[idxs]
        if wal_buf is not None:
            # the send barrier: nothing acked leaves before durability.
            # Impaired WAL ⇒ acks withdrawn (nack at the same ballot);
            # the non-durable on-device votes stay inert.
            try:
                self.logger.log_raw_inline(wal_buf, n_entries=len(ai),
                                           seg=self._wal_seg())
            except WalImpairedError as exc:
                self._note_wal_impaired(exc, len(ai))
                res = self.backend.gate_acks(res)
                acked_u8 = np.asarray(res.acked).astype(np.uint8)
            else:
                if RequestInstrumenter.enabled:
                    # acc = accept fsync-durable at this acceptor (the
                    # arrival stamp the coordinator's acc.tx pairs with)
                    ai_l = ai.tolist()
                    farr = np.fromiter((b[0] for b in blobs), np.int64,
                                       len(blobs))
                    for k in np.flatnonzero(
                            RequestInstrumenter.sampled_mask(req_ids[ai])
                            | ((farr & FLAG_SAMPLED) != 0)).tolist():
                        RequestInstrumenter.record(
                            int(req_ids[ai_l[k]]), "acc", self.id,
                            force=True)
        out = []
        for dst in np.unique(senders[in_reply]):
            m = in_reply & (senders == dst)
            out.append((int(dst), pkt.AcceptReplyBatch(
                self.id, reply_gkeys[m], slots[m],
                reply_bal[m].astype(np.int32), acked_u8[m])))
        for dst, arb in out:
            self._route(dst, arb)

    def _acc_com_pre(self, accepts: List, commits: List):
        """Shared lane gather + host pre halves for the two acceptor-
        wave handlers (fused single-dispatch and async-overlapped), so
        the coalesce keys and hoist-safety invariants live in ONE
        place.  Returns (a_gkeys, apre, c_gkeys, cpre)."""
        a_gkeys = _cat(accepts, lambda o: np.asarray(o.gkey, np.uint64))
        a_slots = _cat(accepts, lambda o: np.asarray(o.slot, np.int32))
        a_bals = _cat(accepts, lambda o: np.asarray(o.bal, np.int32))
        a_reqs = _cat(accepts, lambda o: _merge_req(o.req_lo, o.req_hi))
        a_send = _cat(accepts, lambda o: np.full(len(o.gkey), o.sender,
                                                 np.int32))
        apre = self._acc_pre(self._rows_for_keys(a_gkeys), a_slots,
                             a_bals, a_reqs, a_send)
        c_gkeys = _cat(commits, lambda o: np.asarray(o.gkey, np.uint64))
        c_slots = _cat(commits, lambda o: np.asarray(o.slot, np.int32))
        c_bals = _cat(commits, lambda o: np.asarray(o.bal, np.int32))
        c_reqs = _cat(commits, lambda o: _merge_req(o.req_lo, o.req_hi))
        cpre = self._commit_pre(self._rows_for_keys(c_gkeys), c_slots,
                                c_bals, c_reqs, self._now())
        return a_gkeys, apre, c_gkeys, cpre

    def _handle_accepts_commits(self, accepts: List,
                                commits: List) -> None:
        """Fused acceptor wave: the accepts and commits of one worker
        batch go to the engine in ONE device dispatch
        (``backend.accept_commit`` → ``kernels.accept_commit_p``),
        with the host halves unchanged and in the split handlers'
        order — accept post (payload store + WAL durability barrier +
        replies) runs before commit post (install + execute)."""
        a_gkeys, apre, c_gkeys, cpre = self._acc_com_pre(accepts,
                                                         commits)
        if apre is not None and cpre is not None:
            idxs, rows, slots, bals, req_ids, senders, now = apre
            sel, rows_s, slots_s, reqs_s = cpre
            ares, cres = self.backend.accept_commit(
                rows, slots, bals, req_ids, rows_s, slots_s, reqs_s)
            self._acc_post(accepts, a_gkeys, idxs, rows, slots, bals,
                           req_ids, senders, now, ares)
            self._commit_post(c_gkeys, sel, rows_s, slots_s, reqs_s,
                              cres)
        elif apre is not None:
            idxs, rows, slots, bals, req_ids, senders, now = apre
            res = self.backend.accept(rows, slots, bals, req_ids)
            self._acc_post(accepts, a_gkeys, idxs, rows, slots, bals,
                           req_ids, senders, now, res)
        elif cpre is not None:
            sel, rows_s, slots_s, reqs_s = cpre
            res = self.backend.commit(rows_s, slots_s, reqs_s)
            self._commit_post(c_gkeys, sel, rows_s, slots_s, reqs_s,
                              res)

    def _handle_accepts_commits_overlapped(self, accepts: List,
                                           commits: List) -> None:
        """Async double-buffered acceptor wave (the tentpole overlap):
        SUBMIT the accept wave, SUBMIT the commit wave — the engine
        applies them in submission order, exactly the split handlers'
        order — then collect + run the host halves.  While the commit
        wave computes (and its outputs copy back), the accept half's
        host apply runs: payload store, WAL fsync durability barrier,
        reply build.  Hoisting the commit SUBMIT above the accept POST
        is safe because ``_commit_pre`` touches only the ``_bal``
        monotone-max mirror and ``_la`` stamps — commutative with
        ``_acc_post``'s own ``np.maximum.at`` writes — and the device
        ordering is fixed at submission."""
        a_gkeys, apre, c_gkeys, cpre = self._acc_com_pre(accepts,
                                                         commits)
        awave = cwave = None
        if apre is not None:
            idxs, rows, slots, bals, req_ids, senders, now = apre
            awave = self.backend.accept_submit(rows, slots, bals,
                                               req_ids)
        if cpre is not None:
            sel, rows_s, slots_s, reqs_s = cpre
            cwave = self.backend.commit_submit(rows_s, slots_s, reqs_s)
        if awave is not None:
            # accept host apply overlaps the commit wave's device time
            self._acc_post(accepts, a_gkeys, idxs, rows, slots, bals,
                           req_ids, senders, now, awave.collect())
        if cwave is not None:
            self._commit_post(c_gkeys, sel, rows_s, slots_s, reqs_s,
                              cwave.collect())

    def _handle_requests_replies(self, reqs: List, props: List,
                                 soas: Tuple, replies: List) -> None:
        """Fused coordinator wave: new proposals + accept replies of
        one worker batch in ONE device dispatch
        (``backend.propose_self_reply`` → ``kernels.request_reply_p``),
        host halves unchanged and in split-handler order (request post
        — with its fused-self WAL barrier — before reply post's
        decision fan-out)."""
        rpre = self._req_pre(reqs, props, soas)
        r_gkeys = _cat(replies, lambda o: np.asarray(o.gkey, np.uint64))
        r_slots = _cat(replies, lambda o: np.asarray(o.slot, np.int32))
        r_bals = _cat(replies, lambda o: np.asarray(o.bal, np.int32))
        r_acked = _cat(replies, lambda o: np.asarray(o.acked, np.uint8))
        r_send = _cat(replies, lambda o: np.full(len(o.gkey), o.sender,
                                                 np.int32))
        ppre = self._rep_pre(self._rows_for_keys(r_gkeys), r_slots,
                             r_bals, r_send, r_acked)
        if rpre is not None and ppre is not None:
            rows, req_ids, flag_parts, pay_parts, now = rpre
            sel, rr, rs, rb, sidx_s, acked_s = ppre
            (pres, sa, sn, sp, sc), (rres, c_app, c_st) = \
                self.backend.propose_self_reply(
                    rows, req_ids, self._self_midx(rows),
                    rr, rs, rb, sidx_s, acked_s)
            self._req_post(rows, req_ids, flag_parts, pay_parts, now,
                           pres, sa, sn, sp, sc)
            self._rep_post(r_gkeys, sel, rr, rs, rb, rres, c_app, c_st)
        elif rpre is not None:
            rows, req_ids, flag_parts, pay_parts, now = rpre
            res, sa, sn, sp, sc = self.backend.propose_self(
                rows, req_ids, self._self_midx(rows))
            self._req_post(rows, req_ids, flag_parts, pay_parts, now,
                           res, sa, sn, sp, sc)
        elif ppre is not None:
            sel, rr, rs, rb, sidx_s, acked_s = ppre
            res, c_app, c_st = self.backend.accept_reply_commit_self(
                rr, rs, rb, sidx_s, acked_s)
            self._rep_post(r_gkeys, sel, rr, rs, rb, res, c_app, c_st)

    # -- accept replies (coordinator side) ------------------------------

    def _handle_accept_replies(self, objs: List) -> None:
        gkeys = _cat(objs, lambda o: np.asarray(o.gkey, np.uint64))
        slots_a = _cat(objs, lambda o: np.asarray(o.slot, np.int32))
        bals_a = _cat(objs, lambda o: np.asarray(o.bal, np.int32))
        acked_a = _cat(objs, lambda o: np.asarray(o.acked, np.uint8))
        send_a = _cat(objs, lambda o: np.full(len(o.gkey), o.sender,
                                              np.int32))
        all_rows = self._rows_for_keys(gkeys)
        if self._fused is not None:
            newly, dec_req, dec_bal = self._fused.handle_replies(
                all_rows, slots_a, bals_a, send_a, acked_a,
                self._member_mat, self._bal)
            if not newly.any():
                return
            with self._stat_lock:
                self.n_decided += int(newly.sum())
            nrows = all_rows[newly]
            dreq = dec_req[newly]
            if RequestInstrumenter.enabled:
                for r in dreq.tolist():
                    RequestInstrumenter.record(int(r), "dec", self.id)
            cb_rlo = (dreq & np.uint64(0xFFFFFFFF)).astype(
                np.uint32).view(np.int32)
            cb_rhi = (dreq >> np.uint64(32)).astype(np.uint32).view(
                np.int32)
            self._emit_commits(nrows, gkeys[newly], slots_a[newly],
                               dec_bal[newly], cb_rlo, cb_rhi)
            return
        pre = self._rep_pre(all_rows, slots_a, bals_a, send_a, acked_a)
        if pre is None:
            return
        sel, rows, slots, bals, sidx_s, acked_s = pre
        if self._col_self is not None:
            # fused decide wave: our own commit applied in the same
            # device call as the vote counting
            res, c_applied, c_stale = \
                self.backend.accept_reply_commit_self(
                    rows, slots, bals, sidx_s, acked_s)
        else:
            c_applied = c_stale = None
            res = self.backend.accept_reply(rows, slots, bals, sidx_s,
                                            acked_s)
        self._rep_post(gkeys, sel, rows, slots, bals, res, c_applied,
                       c_stale)

    def _rep_pre(self, all_rows, slots_a, bals_a, send_a, acked_a):
        """Host half of the reply path BEFORE the engine call:
        sender->member-index resolution + (row, slot, sender) dedupe
        (split out for the fused coordinator wave)."""
        # sender -> member index, vectorized over the membership matrix
        mm = self._member_mat[np.where(all_rows >= 0, all_rows, 0)]
        sender_hits = mm == send_a[:, None]
        sidx = np.argmax(sender_hits, axis=1).astype(np.int32)
        valid = (all_rows >= 0) & sender_hits.any(axis=1)
        # dedupe (row, slot, sender): one u64 key per lane, np.unique
        key = ((all_rows.astype(np.uint64) << np.uint64(40))
               ^ (slots_a.astype(np.uint64) << np.uint64(8))
               ^ sidx.astype(np.uint64))
        _, first = np.unique(key[valid], return_index=True)
        sel = np.flatnonzero(valid)[first]
        if not len(sel):
            return None
        return (sel, all_rows[sel], slots_a[sel], bals_a[sel],
                sidx[sel], acked_a[sel].astype(bool))

    def _rep_post(self, gkeys, sel, rows, slots, bals, res, c_applied,
                  c_stale) -> None:
        """Host half AFTER the engine call: preemption adoption,
        decision fan-out, fused self-commit bookkeeping."""
        # preemption: a higher ballot exists; adopt belief, stop leading
        pre = np.asarray(res.preempted)
        if pre.any():
            # churn counts BALLOT CHANGES, not preempted lanes: one
            # leader change preempts every in-flight lane (and every
            # acceptor's reply repeats it) while the ballot moves once
            # — count only rows whose mirror actually advances, deduped
            rp, bp = rows[pre], bals[pre]
            gain = bp > self._bal[rp]
            if gain.any():
                self._note_ballot_change(np.unique(rp[gain]))
        np.maximum.at(self._bal, rows[pre], bals[pre])
        newly = np.asarray(res.newly_decided)
        if not newly.any():
            return
        with self._stat_lock:
            self.n_decided += int(newly.sum())
        if RequestInstrumenter.enabled:
            # dec = quorum crossed at the coordinator (same vectorized
            # prefilter as the com.tx stamp).  NB: no local here may
            # be named `sel` — that is this function's lane-index
            # parameter, consumed by the _emit_commits call below
            dreqs = _merge_req(np.asarray(res.req_lo),
                               np.asarray(res.req_hi))[newly]
            mask = RequestInstrumenter.sampled_mask(dreqs)
            FT = self._forced_traces
            if FT:  # stays vectorized: np.isin, not a Python loop
                mask = mask | np.isin(
                    dreqs, np.fromiter(FT, np.uint64, len(FT)))
            for k in np.flatnonzero(mask).tolist():
                RequestInstrumenter.record(int(dreqs[k]), "dec",
                                           self.id, force=True)
        # decisions -> CommitBatch to each member; with the fused path
        # our own commit already happened on-device, so only the host
        # bookkeeping (WAL, decision dict, execution) remains for self
        self._emit_commits(
            rows[newly], gkeys[sel][newly], slots[newly],
            np.asarray(res.dec_bal)[newly].astype(np.int32),
            np.asarray(res.req_lo)[newly].astype(np.int32),
            np.asarray(res.req_hi)[newly].astype(np.int32),
            skip_self=c_applied is not None)
        if c_applied is not None:
            self._after_self_commit(
                rows, gkeys[sel], slots, res, newly, c_applied, c_stale)

    def _after_self_commit(self, rows, gkeys, slots, res, newly,
                           applied, stale) -> None:
        """Host side of the fused self-commit: what _commit_install did
        for the loopback CommitBatch — decision WAL (async: decisions
        are recoverable from peers), decision dict, execution."""
        inst = newly & (applied | stale)
        ii = np.flatnonzero(inst)
        if not len(ii):
            return
        reqs = _merge_req(np.asarray(res.req_lo), np.asarray(res.req_hi))
        self._la[rows[ii]] = self._now()
        self._log_decides(gkeys[ii], slots[ii], reqs[ii])
        dec = self._dec
        for i in ii.tolist():
            dec.setdefault(int(rows[i]), {})[int(slots[i])] = \
                int(reqs[i])
        for row in np.unique(rows[ii]):
            self._execute_row(int(row))

    # -- commits → execution -------------------------------------------

    def _handle_commits(self, objs: List) -> None:
        gkeys = _cat(objs, lambda o: np.asarray(o.gkey, np.uint64))
        slots_a = _cat(objs, lambda o: np.asarray(o.slot, np.int32))
        bals_a = _cat(objs, lambda o: np.asarray(o.bal, np.int32))
        reqs_a = _cat(objs, lambda o: _merge_req(o.req_lo, o.req_hi))
        all_rows = self._rows_for_keys(gkeys)
        self._commit_install(all_rows, slots_a, bals_a, reqs_a, gkeys)

    def _commit_install(self, rows, slots, bals, req_ids,
                        gkeys) -> None:
        """Shared decision-install path (commit batches + sync replies):
        dedupe, apply, WAL, execute newly contiguous decisions, and sync
        on out-of-window lanes.  Fused C path when the native engine is
        active; numpy + backend SPI otherwise."""
        now = self._now()
        if self._fused is not None:
            applied, stale_m, ow_m, ex_rows, ex_slots, ex_reqs = \
                self._fused.handle_commits(rows, slots, bals, req_ids,
                                           now, self._bal, self._la)
            if applied.any():
                # decisions need not block on fsync (replies gate on the
                # ACCEPT records; decisions are recoverable from peers)
                self._log_decides(gkeys[applied], slots[applied],
                                  req_ids[applied])
            dec = self._dec
            for i in range(len(ex_rows)):
                dec.setdefault(int(ex_rows[i]), {})[int(ex_slots[i])] = \
                    int(ex_reqs[i])
            for row in np.unique(ex_rows):
                self._execute_row(int(row))
            for i in np.flatnonzero(ow_m):
                self._sync_if_gap(int(rows[i]))
            return
        pre = self._commit_pre(rows, slots, bals, req_ids, now)
        if pre is None:
            return
        sel, rows_s, slots_s, reqs_s = pre
        res = self.backend.commit(rows_s, slots_s, reqs_s)
        self._commit_post(gkeys, sel, rows_s, slots_s, reqs_s, res)

    def _commit_pre(self, rows, slots, bals, req_ids, now):
        """Host half of the commit path BEFORE the engine call: ballot
        mirror + (row, slot) keep-LAST dedupe + liveness stamp (split
        for the fused accept+commit wave, like :meth:`_acc_pre`)."""
        live = rows >= 0
        if not live.any():
            return None
        np.maximum.at(self._bal, rows[live], bals[live])
        # dedupe (row, slot) keep-LAST (later packets carry newer bal)
        key = ((rows.astype(np.uint64) << np.uint64(32))
               ^ slots.astype(np.uint64))
        rev = key[live][::-1]
        _, first_rev = np.unique(rev, return_index=True)
        sel = np.flatnonzero(live)[len(rev) - 1 - first_rev]
        rows_s = rows[sel]
        self._la[rows_s] = now
        return sel, rows_s, slots[sel], req_ids[sel]

    def _commit_post(self, gkeys, sel, rows_s, slots_s, reqs_s,
                     res) -> None:
        """Host half AFTER the engine call: decision WAL, install,
        in-order execute, gap sync."""
        applied = np.asarray(res.applied)
        if applied.any():
            self._log_decides(gkeys[sel][applied], slots_s[applied],
                              reqs_s[applied])
        install = applied | np.asarray(res.stale)
        for i in np.flatnonzero(install):
            self._dec.setdefault(int(rows_s[i]), {})[int(slots_s[i])] = \
                int(reqs_s[i])
        # execute newly contiguous decisions per touched row
        for row in np.unique(rows_s):
            self._execute_row(int(row))
        # out-of-window commits: requeue once the window advances — here
        # simply re-enqueue; window advance is driven by this same path
        for i in np.flatnonzero(np.asarray(res.out_window)):
            self._sync_if_gap(int(rows_s[i]))

    def _execute_row(self, row: int) -> None:
        meta = self.table.by_row(row)
        if meta is None:
            return
        cur = int(self._cur[row])
        dec = self._dec.get(row)
        if dec is None:
            dec = {}  # no installed decisions; fall through to the
            # checkpoint-cut tail with an empty view
        # the busiest per-request Python loop in the system: every dict
        # and attribute hop below runs once per decided request per
        # replica, so the shared tables are bound to locals up front
        P, PO = self._payloads, self._payloads_old
        ER, RC = self._executed_recent, self._resp_cache
        CW, PR = self._client_wait, self._proposed
        n_exec = 0
        while cur in dec:
            req_id = dec[cur]
            got = P.pop(req_id, None)
            old = PO.pop(req_id, None)
            if got is None:
                got = old
            if got is None or (got[0] & FLAG_MISSING):
                if got is not None:
                    P[req_id] = got  # keep the placeholder
                # we never saw the accept (gap): ask peers, stop here
                self._sync_if_gap(row)
                break
            dec.pop(cur)
            flags, payload = got
            status = 0
            if flags & FLAG_NOOP:
                resp = b""
            elif row in self._group_stopped:
                # decided after the epoch's stop slot: NOT applied (the
                # final state excludes it); tell the client to re-resolve
                # the group and retry (ref: stopped-instance handling)
                resp, status = b"", 3
            else:
                # Bounded retries before declaring the exception
                # deterministic: a transient, replica-local failure (I/O,
                # resource limit) must not diverge replicated state — one
                # replica applying the op while another records an error
                # would fork the RSM (ref: the upstream retries
                # app.execute to keep replicas in lockstep).  Only a
                # repeatable failure is answered with status 4, and it
                # still ADVANCES — leaving the slot unexecuted would
                # wedge the group on every replica forever.
                for attempt, backoff in enumerate((0.02, 0.2, 0.0)):
                    try:
                        resp = self.app.execute(meta.name, req_id, payload,
                                                bool(flags & FLAG_STOP))
                        break
                    except Exception:
                        log.exception(
                            "app.execute failed for %s slot %d (try %d/3)",
                            meta.name, cur, attempt + 1)
                        # brief growing backoff so a sub-second transient
                        # (fd/disk pressure) isn't misread as
                        # deterministic on just this replica — but capped
                        # per worker batch: a BURST of failing requests
                        # must not stall the single worker long enough to
                        # trip peers' failure detectors
                        if backoff and \
                                time.time() < self._batch_t0 + 0.5:
                            time.sleep(backoff)
                else:
                    resp, status = b'{"err":"app exception"}', 4
                if flags & FLAG_STOP:
                    self._group_stopped.add(row)
            n_exec += 1
            PR.pop(req_id, None)
            if self._forced_traces:
                self._forced_traces.discard(req_id)
            if RequestInstrumenter.enabled:
                RequestInstrumenter.record(
                    req_id, "exec", self.id,
                    force=bool(flags & FLAG_SAMPLED))
            if status in (0, 4):
                # APPLIED requests and deterministic app failures both
                # enter the at-most-once dedup tables: a retransmit of a
                # failed request must be answered (with its status-4
                # error) rather than re-proposed and re-executed in a new
                # slot.  A stop-skipped request (status 3) must stay
                # retryable in the next epoch — caching it would answer a
                # retransmit with an empty "success", i.e. a silently
                # lost write.
                ER[req_id] = 1
                RC[req_id] = (status, resp)
            waiter = CW.pop(req_id, None)
            if waiter is not None:
                self._route(waiter[0], pkt.Response(
                    self.id, meta.gkey, req_id, status, resp))
                if RequestInstrumenter.enabled:
                    # request done end-to-end at the answering node:
                    # feed the slow-request log (waiter[1] = intake ts)
                    total_s = time.time() - waiter[1]
                    RequestInstrumenter.note_done(
                        req_id, total_s,
                        force=bool(flags & FLAG_SAMPLED))
                    bb = self.blackbox
                    if bb is not None and bb.dump_on_slow and \
                            0 < RequestInstrumenter.slow_threshold_s \
                            <= total_s:
                        # PC.BLACKBOX_ON_SLOW: an SLO breach entering
                        # the slow-request log snapshots the ring
                        bb.trigger("slow_trace")
            cur += 1
        with self._stat_lock:
            self.n_executed += n_exec
        self._cur[row] = cur
        # (device cursor advances in the commit kernel; no set_cursor here)
        # checkpoint cut (ref: extractExecuteAndCheckpoint, every ~400)
        last = int(self._ckpt[row])
        if cur - 1 - last >= self.checkpoint_interval:
            self._checkpoint_row(row, cur - 1)

    def _checkpoint_row(self, row: int, upto_slot: int) -> None:
        meta = self.table.by_row(row)
        state = self.app.checkpoint(meta.name)
        self.logger.checkpoint(CheckpointRec(
            meta.gkey, meta.name, meta.version, meta.members, upto_slot,
            state))
        self._ckpt[row] = upto_slot
        self.backend.gc(np.asarray([row], np.int32),
                        np.asarray([upto_slot], np.int32))

    # -- sync (gap fill; ref: SyncDecisionsPacket) ----------------------

    def _sync_if_gap(self, row: int) -> None:
        now = self._now()
        last = self._last_sync
        if last.get(row, 0) + 0.2 > now:
            return
        last[row] = now
        meta = self.table.by_row(row)
        cur = int(self._cur[row])
        coord = unpack_ballot(int(self._bal[row]))[1]
        dst = coord if (coord >= 0 and coord != self.id
                        and coord not in self._suspects) else None
        if dst is None:
            # not the coordinator (dead/ourselves): any live member can
            # answer — rotate so a deterministic dead pick cannot wedge
            # the catch-up (a barriered row depends on this completing)
            others = [m for m in meta.members
                      if m != self.id and m not in self._suspects]
            if not others:
                others = [m for m in meta.members if m != self.id]
            if not others:
                return
            dst = others[int(now * 5) % len(others)]
        self._route(dst, pkt.SyncRequest(self.id, meta.gkey, cur,
                                         cur + self.backend.window))

    def _handle_chunk(self, o: "pkt.Chunk") -> None:
        """Reassemble a chunked frame; on completion the inner frame
        re-enters the worker queue as a normal packet (ref:
        LargeCheckpointer receive side)."""
        xfers = self._xfers
        if not (0 < o.nchunks <= 4096) or o.seq >= o.nchunks:
            # wire-field sanity: an unvalidated u32 would let one frame
            # force a multi-GB allocation (4096 chunks = 16GB ceiling,
            # far above any real checkpoint)
            log.warning("dropping chunk with bad geometry %d/%d",
                        o.seq, o.nchunks)
            return
        key = (o.sender, o.xfer_id)
        parts = xfers.get(key)
        if parts is None:
            parts = xfers[key] = [self._now(), o.nchunks,
                                  [None] * o.nchunks]
        if o.seq < parts[1] and parts[2][o.seq] is None:
            parts[0] = self._now()  # refresh: transfer is alive (a slow
            # link must not be GC'd mid-flight — only STALLED ones age)
            parts[2][o.seq] = o.data
            if all(p is not None for p in parts[2]):
                # pop, not del: lane 0's stale-transfer GC can reap the
                # key concurrently (this handler runs on the chunk's
                # owning lane) — the reassembled frame is still valid
                xfers.pop(key, None)
                self._inq.put(b"".join(parts[2]))
        # stale partial transfers (lost chunks) age out in _tick

    def _handle_sync_request(self, o) -> None:
        meta = self._lookup(o.gkey)
        if meta is None:
            return
        row = meta.row
        # serve only decisions whose payload we actually hold — never
        # fabricate an empty payload for one we don't (replica divergence)
        have = []
        for s in range(o.from_slot, o.to_slot):
            req = self._dec.get(row, {}).get(s)
            if req is not None and self._payload_get(req) is not None:
                have.append((s, req))
        if not have:
            # decisions already executed & GC'd: catch the laggard up with
            # a whole-state checkpoint instead (ref: StatePacket path)
            if int(self._cur[row]) > o.from_slot:
                state = self.app.checkpoint(meta.name)
                self._route(o.sender, pkt.CheckpointReply(
                    self.id, meta.gkey, int(self._cur[row]) - 1,
                    state))
            return
        pls = []
        for s, req in have:
            fl, pl = self._payload_get(req)
            pls.append(bytes([fl]) + pl)
        self._route(o.sender, pkt.SyncReply(
            self.id, meta.gkey,
            np.asarray([s for s, _ in have], np.int32),
            *_split_reqs([req for _, req in have]), payloads=pls))

    def _handle_sync_reply(self, o) -> None:
        meta = self.table.by_key(o.gkey)
        if meta is None:
            return
        pls = o.payloads or [b""] * len(o.slots)
        ded = {}
        for j in range(len(o.slots)):
            req = _join_req(int(o.req_lo[j]), int(o.req_hi[j]))
            blob = pls[j]
            if not blob or (blob[0] & FLAG_MISSING):
                continue  # sender had no payload: don't install the slot
            self._store_payload(req, blob[0], bytes(blob[1:]))
            ded[(meta.row, int(o.slots[j]))] = req
        if not ded:
            return
        keys = list(ded.keys())
        n = len(keys)
        self._commit_install(
            np.asarray([k[0] for k in keys], np.int32),
            np.asarray([k[1] for k in keys], np.int32),
            np.zeros(n, np.int32),
            np.asarray([ded[k] for k in keys], np.uint64),
            np.full(n, o.gkey, np.uint64))
        self._execute_row(meta.row)

    def _handle_checkpoint_reply(self, o) -> None:
        """Whole-state catch-up: a peer's checkpoint replaces our (lagging)
        app state and advances the frontier (ref: StatePacket install)."""
        meta = self.table.by_key(o.gkey)
        if meta is None:
            return
        row = meta.row
        cur = int(self._cur[row])
        if o.slot < cur:
            return  # stale: we are already past it
        self.app.restore(meta.name, o.state)
        newcur = o.slot + 1
        self._cur[row] = newcur
        d = self._dec.get(row, {})
        for s in [s for s in d if s < newcur]:
            self._payload_pop(d.pop(s))
        self.backend.set_cursor(np.asarray([row], np.int32),
                                np.asarray([newcur], np.int32),
                                np.asarray([newcur], np.int32))
        self._ckpt[row] = o.slot
        self.logger.checkpoint(CheckpointRec(
            meta.gkey, meta.name, meta.version, meta.members, o.slot,
            o.state))
        self._execute_row(row)

    # ------------------------------------------------------------------
    # failover (ref: §3.5 coordinator failover)
    # ------------------------------------------------------------------

    def _on_node_dead(self, node: int) -> None:
        """Scan groups whose believed coordinator is ``node``; if self is
        next in line (deterministic order), run phase 1 for them."""
        self._last_heard.pop(node, None)
        self._suspects.add(node)
        log.info("node %d: peer %d suspected dead", self.id, node)
        self._elect_rows_led_by(node, self._now())

    def _elect_rows_led_by(self, dead: int, now: float) -> None:
        """Vectorized replacement for the per-meta scan (SURVEY §3.5:
        mass failover must be a batched pass, not a Python loop over a
        million groups): one numpy compare over the packed-ballot mirror
        finds every row led by ``dead``; the next-in-line decision is
        computed once per DISTINCT member set (interned tuples — a
        million-group fleet typically has a handful)."""
        t0 = time.monotonic()
        cand = np.flatnonzero((self._bal >= 0)
                              & ((self._bal & NODE_MASK) == dead))
        if not len(cand):
            return
        if self._mass_el is not None and self._mass_el.n_live:
            # skip rows whose SoA-cohort election is fresher than the
            # re-drive backoff (the dict check below can't see them;
            # without this the per-tick suspect rescan would restart
            # the whole cohort every tick).  The backoff scales with
            # cohort size: re-driving a million in-flight elections at
            # a fixed 2s would reset ack counts mid-merge.
            m = self._mass_el
            backoff = max(2.0, m.n_live / 2e5)
            idx = m.index[cand]
            fresh = (idx >= 0) & (now - m.started[np.maximum(idx, 0)]
                                  < backoff)
            cand = cand[~fresh]
            if not len(cand):
                return
        by_row = self.table._by_row
        nxt_cache: Dict[Tuple[int, ...], Optional[int]] = {}
        by_mems: Dict[Tuple[int, ...], List[int]] = {}
        els = self._elections
        check_els = bool(els)
        my_id = self.id
        n_elect = 0
        for row in cand.tolist():
            meta = by_row[row]
            if meta is None:
                continue
            if check_els:
                el = els.get(row)
                if el is not None and now - el.started < 2.0:
                    continue
            mems = meta.members
            nxt = nxt_cache.get(mems, _UNSET)
            if nxt is _UNSET:
                # membership is a property of the (interned) member set,
                # so the self-in-members check folds into this per-set
                # computation too
                nxt = self._next_in_line(mems, dead, now) \
                    if my_id in mems else None
                nxt_cache[mems] = nxt
            if nxt == my_id:
                by_mems.setdefault(mems, []).append(row)
                n_elect += 1
        if not n_elect:
            return
        DelayProfiler.update_total("fo.scan", t0, len(cand))
        # the SoA mass-election cohort is single-writer state: with
        # engine lanes (S>1) prepare replies for different rows land on
        # different threads, so the per-row dict path (disjoint keys,
        # owning lane only) is the safe one
        if n_elect < 64 or self.shards > 1:
            for rows_ in by_mems.values():
                for row in rows_:
                    self._start_election(row, by_row[row])
        else:
            self._start_elections_batch(by_mems, now)

    def _next_in_line(self, members: Tuple[int, ...], dead: int,
                      now: float) -> Optional[int]:
        """First live member after ``dead`` in ring order (ref:
        deterministic next-in-line from ballot/coordinator order)."""
        if dead not in members:
            return None
        order = list(members)
        start = (order.index(dead) + 1) % len(order)
        for k in range(len(order)):
            cand = order[(start + k) % len(order)]
            if cand == dead:
                continue
            if cand == self.id or now - self._last_heard.get(
                    cand, 0) <= self.failure_timeout:
                return cand
        return None

    @property
    def open_elections(self) -> int:
        """Elections in flight on this node (dict + mass-SoA paths)."""
        return len(self._elections) + \
            (self._mass_el.n_live if self._mass_el is not None else 0)

    def _mass_has(self, row: int) -> bool:
        return self._mass_el is not None and self._mass_el.has(row)

    def _mass_to_dict(self, row: int) -> Optional[_Election]:
        """Move a row's election from the SoA cohort to a classic
        `_Election` (rows that turn out to need per-row merge state)."""
        got = self._mass_el.pop(row) if self._mass_el is not None \
            else None
        if got is None:
            return None
        bal, started, cursor, acks = got
        el = _Election(bal, started)
        el.acks = acks or None
        el.cursor = cursor
        self._elections[row] = el
        return el

    def _start_elections_batch(self, by_mems: Dict[Tuple[int, ...],
                                                   List[int]],
                               now: float) -> None:
        """Batched phase-1 kickoff: one ``PrepareBatch`` frame per member
        per 64K rows instead of one Prepare frame per (row, member), and
        SoA cohort bookkeeping instead of one `_Election` per row.
        Takes rows pre-grouped by (interned) member set — the scan that
        found them already knows it."""
        t0 = time.monotonic()
        if self._mass_el is None:
            self._mass_el = _MassElections(len(self._bal))
        total = 0
        CH = 1 << 16
        for mems, rows_list in by_mems.items():
            arr = np.asarray(rows_list, np.int64)
            bals = self._bal[arr].astype(np.int64)
            nums = np.where(bals >= 0, bals >> NODE_BITS, 0)
            new_bals = ((nums + 1) << NODE_BITS
                        | self.id).astype(np.int32)
            gkeys = self._row_gkey[arr]
            # a row re-driven out of the dict path must not be tracked
            # twice (dict wins the reply merge; the SoA entry would
            # rot).  Intersect from the SMALL side: dict elections are
            # few, the cohort can be a million rows.
            if self._elections:
                rowset = set(rows_list)
                for row in [r for r in self._elections if r in rowset]:
                    self._elections.pop(row, None)
            self._mass_el.start(arr, new_bals,
                                len(mems) // 2 + 1, now)
            total += len(rows_list)
            for at in range(0, len(arr), CH):
                fg = np.ascontiguousarray(gkeys[at:at + CH])
                fb = np.ascontiguousarray(new_bals[at:at + CH])
                for m in mems:
                    self._route(m, pkt.PrepareBatch(self.id, fg, fb))
        DelayProfiler.update_total("fo.elect_start", t0, total)
        log.info("node %d: batch election for %d groups", self.id, total)

    def _run_if_next_in_line(self, meta, dead: int, now: float) -> None:
        """If this row's believed coordinator is ``dead`` and self is the
        first live member after it in ring order, run phase 1 (single-row
        path; the mass path is ``_elect_rows_led_by``)."""
        row = meta.row
        _num, coord = unpack_ballot(int(self._bal[row]))
        if coord != dead or self.id not in meta.members:
            return
        if self._next_in_line(meta.members, dead, now) == self.id:
            self._start_election(row, meta)

    def _start_election(self, row: int, meta) -> None:
        num, _ = unpack_ballot(int(self._bal[row]))
        el = self._elections.get(row)
        if el is None and self._mass_has(row):
            el = self._mass_to_dict(row)  # single path takes over
        if el is not None and self._now() - el.started < 2.0:
            return
        bal = pack_ballot(num + 1, self.id)
        self._elections[row] = _Election(bal=bal, started=self._now())
        for m in meta.members:
            self._route(m, pkt.Prepare(self.id, meta.gkey, bal))

    def _handle_prepares(self, objs: List) -> None:
        # coalesce to max ballot per row
        best: Dict[int, Tuple[int, int]] = {}
        for o in objs:
            meta = self._lookup(o.gkey)
            if meta is None:
                continue
            if meta.row not in best or o.bal > best[meta.row][0]:
                best[meta.row] = (o.bal, o.sender)
        if not best:
            return
        rows = list(best.keys())
        res = self.backend.prepare(
            np.asarray(rows, np.int32),
            np.asarray([best[r][0] for r in rows], np.int32))
        for i, row in enumerate(rows):
            bal, sender = best[row]
            meta = self.table.by_row(row)
            if int(res.cur_bal[i]) > self._bal[row]:
                # promising a higher ballot = a (would-be) leader change
                self._note_ballot_change(row)
                self._bal[row] = int(res.cur_bal[i])
            m = int(np.sum(res.win_slot[i] >= 0))
            slots = res.win_slot[i][:m] if m else np.zeros(0, np.int32)
            pls = []
            for j in range(m):
                req = _join_req(int(res.win_req_lo[i][j]),
                                int(res.win_req_hi[i][j]))
                got = self._payload_get(req)
                # never fabricate a payload we don't hold: report the
                # pvalue (safety requires it) but flag it payload-less
                fl, pl = got if got is not None else (FLAG_MISSING, b"")
                pls.append(bytes([fl]) + pl)
            self._route(sender, pkt.PrepareReply(
                self.id, meta.gkey, bal if res.acked[i]
                else int(res.cur_bal[i]), bool(res.acked[i]),
                int(res.exec_cursor[i]), slots,
                res.win_bal[i][:m], res.win_req_lo[i][:m],
                res.win_req_hi[i][:m], pls))

    def _handle_prepare_batches(self, objs: List) -> None:
        """Mass-failover phase 1 at an acceptor: ONE backend.prepare call
        per frame (the batched [G, W] gather of SURVEY §3.5) and ONE
        PrepareReplyBatch back.  Windows are flattened ragged — idle
        groups (the mass-takeover common case) contribute zero entries."""
        for o in objs:
            gkeys = np.ascontiguousarray(o.gkey)
            rows = self._rows_for_keys(gkeys).astype(np.int64)
            ok = rows >= 0
            if not ok.any():
                continue
            rows_ok = rows[ok]
            bals_ok = np.ascontiguousarray(o.bal[ok], np.int32)
            res = self.backend.prepare(rows_ok.astype(np.int32), bals_ok)
            cur = np.asarray(res.cur_bal)
            self._note_ballot_change(rows_ok[cur > self._bal[rows_ok]])
            np.maximum.at(self._bal, rows_ok, cur)
            live = np.asarray(res.win_slot) >= 0  # compacted-left (SPI)
            counts = live.sum(axis=1).astype(np.int32)
            total = int(counts.sum())
            if total:
                flat = np.flatnonzero(live.reshape(-1))
                slots_f = np.asarray(res.win_slot).reshape(-1)[flat]
                wbals_f = np.asarray(res.win_bal).reshape(-1)[flat]
                rlo_f = np.asarray(res.win_req_lo).reshape(-1)[flat]
                rhi_f = np.asarray(res.win_req_hi).reshape(-1)[flat]
                pls = []
                for j in range(total):
                    req = _join_req(int(rlo_f[j]), int(rhi_f[j]))
                    got = self._payload_get(req)
                    fl, pl = got if got is not None else (FLAG_MISSING,
                                                         b"")
                    pls.append(bytes([fl]) + pl)
            else:
                slots_f = wbals_f = rlo_f = rhi_f = np.zeros(0, np.int32)
                pls = []
            acked = np.asarray(res.acked)
            self._route(o.sender, pkt.PrepareReplyBatch(
                self.id, np.ascontiguousarray(gkeys[ok]),
                np.where(acked, bals_ok,
                         np.asarray(res.cur_bal)).astype(np.int32),
                acked.astype(np.uint8),
                np.asarray(res.exec_cursor, np.int32), counts,
                slots_f.astype(np.int32), wbals_f.astype(np.int32),
                rlo_f.astype(np.int32), rhi_f.astype(np.int32), pls))

    def _handle_prepare_reply_batch(self, o) -> None:
        """Counterpart at the would-be coordinator.  The empty-window
        acked rows (idle fleet) take a vectorized fast path straight to
        ONE batched install; windowed/nacked rows reuse the per-row
        merge machinery."""
        gkeys = np.ascontiguousarray(o.gkey)
        rows = self.table.rows_for_keys(gkeys).astype(np.int64)
        counts = np.asarray(o.counts)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        lanes = range(len(rows))
        if self._mass_el is not None and self._mass_el.n_live:
            handled = self._mass_reply_frame(o, rows, counts)
            if handled is not None:
                lanes = np.flatnonzero(~handled).tolist()
                if not lanes:
                    return
        install_rows: List[int] = []
        by_row = self.table._by_row
        for i in lanes:
            row = int(rows[i])
            meta = by_row[row] if row >= 0 else None
            if meta is None:
                continue
            el = self._elections.get(row)
            if el is None:
                continue
            bal = int(o.bal[i])
            if not o.acked[i]:
                if bal > el.bal:
                    if bal > self._bal[row]:
                        self._note_ballot_change(row)
                        self._bal[row] = bal
                    del self._elections[row]
                continue
            if bal != el.bal:
                continue
            if el.acks is None:
                el.acks = set()
            el.acks.add(o.sender)
            el.cursor = max(el.cursor, int(o.cursor[i]))
            for j in range(int(offs[i]), int(offs[i + 1])):
                s = int(o.slots[j])
                b = int(o.wbals[j])
                req = _join_req(int(o.req_lo[j]), int(o.req_hi[j]))
                blob = o.payloads[j] if j < len(o.payloads) else b""
                fl, pl = (blob[0], bytes(blob[1:])) if blob \
                    else (FLAG_MISSING, b"")
                if el.merged is None:
                    el.merged = {}
                prev = el.merged.get(s)
                if prev is None or b > prev[0] or (
                        b == prev[0] and (prev[2] & FLAG_MISSING)
                        and not (fl & FLAG_MISSING)):
                    el.merged[s] = (b, req, fl, pl)
            if len(el.acks) >= len(meta.members) // 2 + 1:
                install_rows.append(row)
        if not install_rows:
            return
        # split: rows with carryover state or a catch-up need go through
        # the full per-row install; idle rows (no merged pvalues, cursor
        # already reached) install in ONE batched backend call
        simple: List[int] = []
        for row in install_rows:
            el = self._elections[row]
            if el.merged or el.cursor > int(self._cur[row]):
                self._install_as_coordinator(row, by_row[row],
                                             self._elections.pop(row))
            else:
                simple.append(row)
        if simple:
            self._install_simple_batch(simple)

    def _mass_reply_frame(self, o, rows: np.ndarray,
                          counts: np.ndarray) -> Optional[np.ndarray]:
        """Vectorized prepare-reply merge against the SoA cohort.
        Returns a bool mask of lanes fully consumed here (None = no
        lane touched the cohort); unconsumed lanes — rows on the dict
        path, or converted to it because they carry window state —
        fall through to the per-row machinery."""
        mass = self._mass_el
        idx = np.where(rows >= 0, mass.index[np.maximum(rows, 0)], -1)
        in_mass = idx >= 0
        if not in_mass.any():
            return None
        handled = np.zeros(len(rows), bool)
        bals = np.asarray(o.bal, np.int32)
        acked = np.asarray(o.acked, bool)
        cursors = np.asarray(o.cursor, np.int32)
        idx0 = np.maximum(idx, 0)
        # nacks: a higher ballot kills the election (same as the dict
        # path); a stale/equal nack is ignored — both lanes consumed
        nack = in_mass & ~acked
        if nack.any():
            hi = nack & (bals > mass.bal[idx0])
            if hi.any():
                r = rows[hi]
                np.maximum.at(self._bal, r, bals[hi])
                mass.kill(r)
            handled |= nack
        match = in_mass & acked & (bals == mass.bal[idx0])
        handled |= in_mass & acked & ~match  # stale-ballot ack: ignore
        # rows carrying accept-window state need the per-row merge:
        # convert and leave the lane unconsumed for the dict loop
        windowed = match & (counts > 0)
        if windowed.any():
            for i in np.flatnonzero(windowed).tolist():
                self._mass_to_dict(int(rows[i]))
            match &= ~windowed
        if not match.any():
            return handled
        sb = mass.bit(o.sender)
        if sb is None:  # >64 distinct senders: degrade to dict path
            for i in np.flatnonzero(match).tolist():
                self._mass_to_dict(int(rows[i]))
            return handled
        iv = idx[match]  # unique: one lane per gkey per frame
        prev = mass.ackmask[iv]
        newly = (prev & sb) == 0
        ivn = iv[newly]
        mass.ackmask[ivn] = prev[newly] | sb
        mass.ackcnt[ivn] += 1
        np.maximum.at(mass.cursor, iv, cursors[match])
        handled |= match
        ready = mass.ackcnt[iv] >= mass.quorum[iv]
        if ready.any():
            r_rows = rows[match][ready]
            r_idx = iv[ready]
            r_bals = mass.bal[r_idx].copy()
            behind = mass.cursor[r_idx] > self._cur[r_rows]
            if behind.any():
                # cursor catch-up needs the classic install (decide
                # sync); quorum is already met, so install directly
                by_row = self.table._by_row
                for row in r_rows[behind].tolist():
                    el = self._mass_to_dict(row)
                    meta = by_row[row]
                    if el is not None and meta is not None:
                        self._install_as_coordinator(
                            row, meta, self._elections.pop(row))
            simple = r_rows[~behind]
            if len(simple):
                mass.kill(simple)
                self._install_simple_rows(simple, r_bals[~behind])
        return handled

    def _install_simple_batch(self, rows: List[int]) -> None:
        """Batched coordinator install for idle rows: empty carryover,
        cursor caught up — the mass-takeover common case (dict-path
        entry; the SoA path calls ``_install_simple_rows`` directly)."""
        els = [self._elections.pop(r) for r in rows]
        self._install_simple_rows(
            np.asarray(rows, np.int64),
            np.asarray([el.bal for el in els], np.int32))

    def _install_simple_rows(self, arr: np.ndarray,
                             bals: np.ndarray) -> None:
        t0 = time.monotonic()
        n = len(arr)
        W = self.backend.window
        next_slots = self._cur[arr].astype(np.int32)
        self.backend.install_coordinator(
            arr.astype(np.int32), bals, next_slots,
            np.full((n, W), NO_SLOT, np.int32), np.zeros((n, W),
                                                         np.uint64))
        self._bal[arr] = bals
        self._note_ballot_change(arr)
        with self._stat_lock:
            self.n_installs += n
        # reconcile in-flight proposals: with an empty quorum view every
        # one of ours for these rows is an orphan — re-propose fresh
        # under the new regime (invert ONCE, not a _proposed scan per row)
        reprops: List = []
        rowset = None
        if self._proposed:
            rowset = set(arr.tolist())
            for rid, fl in [(r, f) for r, f in self._proposed.items()
                            if f.row in rowset]:
                self._proposed.pop(rid, None)
                got = self._payload_get(rid)
                if got is not None and not (got[0] & FLAG_MISSING):
                    meta = self.table.by_row(fl.row)
                    if meta is not None:
                        reprops.append(pkt.Proposal(
                            self.id, meta.gkey, rid, self.id, got[0],
                            got[1]))
        if self._parked:
            # intersect from the SMALL side: parked rows are few, the
            # install batch can be a million rows
            if rowset is None:
                rowset = set(arr.tolist())
            for row in [r for r in self._parked if r in rowset]:
                self._flush_parked(row)
        if reprops:
            self._handle_requests([], reprops)
        DelayProfiler.update_total("fo.install", t0, n)
        log.info("node %d: batch-installed coordinator for %d groups",
                 self.id, n)

    def _handle_prepare_reply(self, o) -> None:
        meta = self.table.by_key(o.gkey)
        if meta is None:
            return
        row = meta.row
        el = self._elections.get(row)
        if el is None and self._mass_has(row):
            # a singleton reply can land for a SoA-cohort row (e.g. a
            # retransmit after a re-drive): move it to the dict path
            el = self._mass_to_dict(row)
        if el is None:
            return
        if not o.acked:
            if o.bal > el.bal:
                if o.bal > self._bal[row]:
                    self._note_ballot_change(row)
                    self._bal[row] = o.bal
                del self._elections[row]
            return
        if o.bal != el.bal:
            return
        if el.acks is None:
            el.acks = set()
        el.acks.add(o.sender)
        el.cursor = max(el.cursor, o.cursor)
        pls = o.payloads or [b""] * len(o.slots)
        if len(o.slots) and el.merged is None:
            el.merged = {}
        for j in range(len(o.slots)):
            s = int(o.slots[j])
            b = int(o.bals[j])
            req = _join_req(int(o.req_lo[j]), int(o.req_hi[j]))
            blob = pls[j]
            fl, pl = (blob[0], bytes(blob[1:])) if blob \
                else (FLAG_MISSING, b"")
            prev = el.merged.get(s)
            # max-ballot wins (safety); at equal ballot the value is
            # identical, so prefer a copy that carries the payload
            if prev is None or b > prev[0] or (
                    b == prev[0] and (prev[2] & FLAG_MISSING)
                    and not (fl & FLAG_MISSING)):
                el.merged[s] = (b, req, fl, pl)
        if len(el.acks) < len(meta.members) // 2 + 1:
            return
        # majority: install + re-propose carryover, fill holes with noops
        del self._elections[row]
        self._install_as_coordinator(row, meta, el)

    def _install_as_coordinator(self, row: int, meta, el: _Election) -> None:
        cursor = max(el.cursor, int(self._cur[row]))
        carry = {s: v for s, v in (el.merged or {}).items()
                 if s >= cursor}
        # fill payload-less carryovers from our own store when possible
        for s, (b, req, fl, pl) in list(carry.items()):
            if fl & FLAG_MISSING:
                got = self._payload_get(req)
                if got is not None:
                    carry[s] = (b, req, got[0], got[1])
        top = max(carry.keys(), default=cursor - 1)
        # holes become noops (classic multipaxos hole fill)
        for s in range(cursor, top + 1):
            if s not in carry:
                noop_req = (1 << 63) | (meta.gkey & 0x7FFFFFFF00000000) | s
                carry[s] = (el.bal, noop_req, FLAG_NOOP, b"")
        next_slot = top + 1
        W = self.backend.window
        cs = np.full((1, W), NO_SLOT, np.int32)
        cr = np.zeros((1, W), np.uint64)
        for j, s in enumerate(sorted(carry.keys())[:W]):
            cs[0, j] = s
            cr[0, j] = carry[s][1]
        self.backend.install_coordinator(
            np.asarray([row], np.int32), np.asarray([el.bal], np.int32),
            np.asarray([next_slot], np.int32), cs, cr)
        self._bal[row] = el.bal
        self._note_ballot_change(row)
        with self._stat_lock:
            self.n_installs += 1
        log.info("node %d now coordinator of %s at bal %d (carry %d)",
                 self.id, meta.name, el.bal, len(carry))
        # reconcile OUR in-flight proposals with the new regime: entries
        # whose request survived into the carryover are re-stamped to the
        # carry slot/ballot (so the re-drive covers lost carry-accepts);
        # orphans (request absent from the quorum's view — its accept
        # reached nobody) are re-proposed fresh under the new ballot
        slot_of = {v[1]: s for s, v in carry.items()}
        reprops = []
        for rid, fl in [(r, f) for r, f in self._proposed.items()
                        if f.row == row]:
            if rid in slot_of:
                fl.slot, fl.bal = slot_of[rid], el.bal
                fl.redriven = self._now()
            else:
                self._proposed.pop(rid, None)
                got = self._payload_get(rid)
                if got is not None and not (got[0] & FLAG_MISSING):
                    reprops.append(pkt.Proposal(
                        self.id, meta.gkey, rid, self.id, got[0], got[1]))
        # register EVERY carried request as in-flight at its carry slot:
        # a parked/retransmitted duplicate of a carryover rid must hit
        # the _proposed dedupe, not be proposed fresh at a second slot —
        # the same client op deciding in two slots executes twice
        # (observed in the torture test: a request accepted under the
        # dying coordinator arrived again via the parked queue and the
        # flush below re-proposed it beside its own carryover)
        now_t = self._now()
        for s, (b, rid, fl_, _pl) in carry.items():
            if not (fl_ & FLAG_NOOP) and rid not in self._proposed:
                self._proposed[rid] = _InFlight(
                    row=row, slot=s, bal=el.bal, proposed=now_t,
                    redriven=now_t)
        if cursor > int(self._cur[row]):
            # the quorum has executed past us: hold fresh proposals
            # until we catch up (see _catchup_barrier field comment)
            self._catchup_barrier[row] = cursor
            self._sync_if_gap(row)
        else:
            self._flush_parked(row)
        if reprops:
            self._handle_requests([], reprops)
        # re-propose carryover pvalues at our ballot
        if carry:
            for m in meta.members:
                items = sorted(carry.items())
                self._route(m, pkt.AcceptBatch(
                    self.id,
                    np.asarray([meta.gkey] * len(items), np.uint64),
                    np.asarray([s for s, _ in items], np.int32),
                    np.asarray([el.bal] * len(items), np.int32),
                    *_split_reqs([v[1] for _, v in items]),
                    payloads=[bytes([v[2]]) + v[3] for _, v in items]))

    # ------------------------------------------------------------------
    # failure-detection ping task (event loop side)
    # ------------------------------------------------------------------

    async def _ping_loop(self):
        import asyncio
        import time as _t
        while True:
            await asyncio.sleep(self.ping_interval)
            for n in self.addr_map:
                if n == self.id:
                    continue
                self.transport.send(n, pkt.FailureDetect(
                    self.id, 0, _t.time_ns()).encode())

    # ------------------------------------------------------------------
    # recovery (ref: §3.2)
    # ------------------------------------------------------------------

    def _recover(self) -> None:
        # paused groups stay cold: their rows hydrate on first touch
        # (ref: lazy recovery at million-group scale, SURVEY §7.3.6)
        self._paused = set(self.logger.paused_keys())
        groups = self.logger.all_groups()
        if not groups:
            return
        t0 = time.time()
        # BATCHED rebuild (one backend call, one checkpoint query): the
        # per-group form — one 1-lane device create + one sqlite SELECT
        # each — measured ~52us/group, i.e. ~50s of boot at 1M groups
        metas = []
        for gkey, name, version, members in groups:
            if gkey in self._paused or self.table.by_key(gkey):
                continue
            metas.append(self.table.create(name, members, version))
        if metas:
            self._install_rows(metas, self_coord=False, now=t0)
            # checkpoints fetched ONLY for the rows just rebuilt: a
            # whole-table read would materialize every state blob —
            # including paused groups', defeating lazy recovery — and a
            # pre-existing live group must never be rolled back to a
            # stale checkpoint from a prior incarnation
            ck_rows, ck_slots = [], []
            by_key = {m.gkey: m for m in metas}
            for rec in self.logger.checkpoints_for(list(by_key)):
                meta = by_key.get(rec.gkey)
                if meta is None:
                    continue
                self.app.restore(meta.name, rec.state)
                if rec.slot >= 0:
                    self._cur[meta.row] = rec.slot + 1
                    self._ckpt[meta.row] = rec.slot
                    ck_rows.append(meta.row)
                    ck_slots.append(rec.slot + 1)
            if ck_rows:
                cs = np.asarray(ck_slots, np.int32)
                self.backend.set_cursor(
                    np.asarray(ck_rows, np.int32), cs, cs)
        # roll forward the WAL (accepts re-promise; decisions re-execute)
        acc_rows, acc_slots, acc_bals, acc_reqs = [], [], [], []
        dec_by_row: Dict[int, Dict[int, int]] = {}
        for e in self.logger.read_wal():
            meta = self.table.by_key(e.gkey)
            if meta is None:
                continue
            if e.rtype == REC_ACCEPT:
                acc_rows.append(meta.row)
                acc_slots.append(e.slot)
                acc_bals.append(e.bal)
                acc_reqs.append(e.req_id)
                if e.payload:
                    self._store_payload(
                        e.req_id, e.payload[0], bytes(e.payload[1:]))
                if e.bal > self._bal[meta.row]:
                    self._bal[meta.row] = e.bal
            else:
                dec_by_row.setdefault(meta.row, {})[e.slot] = e.req_id
        if acc_rows:
            # coalesce to the max-ballot lane per (row, slot) before the
            # engine call — the live path's invariant (one lane per
            # slot, highest ballot wins), which replay must restore by
            # VALUE, not by array order: a WAL can hold several accepts
            # for one slot across ballots, and with segmented WALs a
            # group's records can even span segments after ENGINE_SHARDS
            # was lowered between boots (segment read order is not time
            # order), so duplicate-index scatter order must not decide
            # which ballot survives recovery
            r_arr = np.asarray(acc_rows, np.int32)
            s_arr = np.asarray(acc_slots, np.int32)
            b_arr = np.asarray(acc_bals, np.int32)
            keep = native.coalesce_max(r_arr, s_arr, b_arr)
            self.backend.accept(
                r_arr[keep], s_arr[keep], b_arr[keep],
                np.asarray(acc_reqs, np.uint64)[keep])
        if dec_by_row:
            keys = [(r, s) for r, d in dec_by_row.items() for s in d]
            res = self.backend.commit(
                np.asarray([k[0] for k in keys], np.int32),
                np.asarray([k[1] for k in keys], np.int32),
                np.asarray([dec_by_row[k[0]][k[1]] for k in keys],
                           np.uint64))
            for i, (r, s) in enumerate(keys):
                if res.applied[i] or res.stale[i]:
                    if s >= self._cur[r]:
                        self._dec.setdefault(r, {})[s] = dec_by_row[r][s]
            for r in dec_by_row:
                self._execute_row(r)
        log.info("node %d recovered %d groups in %.3fs", self.id,
                 len(groups), time.time() - t0)


def _np_jsonable(o):
    """json.dumps default= hook for numpy scalars/arrays in pause blobs."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not jsonable: {type(o)}")


def _cat(objs, fn):
    """Gather one field across a packet list: the single-packet case
    (the common trickle shape) skips the concatenate copy."""
    if len(objs) == 1:
        return fn(objs[0])
    return np.concatenate([fn(o) for o in objs])


def _merge_req(lo, hi) -> np.ndarray:
    """Vectorized (lo32, hi32) -> u64 request ids for a whole batch."""
    lo = np.ascontiguousarray(lo, np.int32).view(np.uint32).astype(
        np.uint64)
    hi = np.ascontiguousarray(hi, np.int32).view(np.uint32).astype(
        np.uint64)
    return lo | (hi << np.uint64(32))


def _lane_payloads(objs, sel) -> List[bytes]:
    """Payload blobs of the selected global lanes across a packet list."""
    if len(objs) == 1:
        all_pls = objs[0].payloads or (b"",) * len(objs[0].gkey)
    else:
        all_pls = []
        for o in objs:
            all_pls.extend(o.payloads or (b"",) * len(o.gkey))
    return [all_pls[i] for i in sel.tolist()]


def _split_reqs(reqs: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(reqs, np.uint64)
    lo = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (arr >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def _join_req(lo: int, hi: int) -> int:
    return (lo & 0xFFFFFFFF) | ((hi & 0xFFFFFFFF) << 32)
