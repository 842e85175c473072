"""AcceptorBackend SPI: pluggable consensus data planes, on torch.

Port of ``gigapaxos_tpu/paxos/backend.py``.  The node runtime drives all
acceptor/coordinator state transitions through this batch-level
interface; this module carries three engines:

- :class:`ScalarBackend` — one Python object per group
  (``ops.oracle.OracleGroup``), looping over batch items: the reference
  architecture's stand-in and the per-item oracle.
- :class:`ColumnarBackend` — the columnar kernels (``ops.kernels``) over
  ``[G, W]`` tensors on one device, with the JAX engine's bucket ladder
  and chunking, every accept through the hand-written accept kernel,
  and non-blocking submit/collect waves (CUDA stream + pinned host
  buffers + an event).
- :class:`ShardedColumnarBackend` — S ``ColumnarBackend`` slabs behind
  the one SPI (engine lanes, ``PC.ENGINE_SHARDS``), each slab on a CUDA
  stream of its own.

All SPI inputs/outputs are numpy arrays (host-side), as in the JAX
package.  Not ported: ``NativeBackend``.  ``kernel_costs`` counts the
bytes each wave's bodies move from the shapes, where the reference asks
XLA's cost analysis of its compiled programs (torch compiles none).
"""

from __future__ import annotations

import abc
import contextlib
import functools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gigapaxos_tpu_torch.ops import accept_cuda, kernels, wave_cuda
from gigapaxos_tpu_torch.ops.oracle import (OracleGroup, PValue,
                                            make_oracle_group)
from gigapaxos_tpu_torch.ops.types import (FIELDS, NO_BALLOT, NO_SLOT,
                                           make_state, resolve_device,
                                           state_from_numpy,
                                           state_to_numpy)
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler


class AcceptRes(NamedTuple):
    acked: np.ndarray
    stale: np.ndarray
    out_window: np.ndarray
    cur_bal: np.ndarray


class AcceptReplyRes(NamedTuple):
    newly_decided: np.ndarray
    preempted: np.ndarray
    req_lo: np.ndarray
    req_hi: np.ndarray
    dec_bal: np.ndarray


class ProposeRes(NamedTuple):
    granted: np.ndarray
    rejected: np.ndarray
    throttled: np.ndarray
    slot: np.ndarray
    cbal: np.ndarray


class CommitRes(NamedTuple):
    applied: np.ndarray
    stale: np.ndarray
    out_window: np.ndarray
    new_cursor: np.ndarray


class PrepareRes(NamedTuple):
    acked: np.ndarray
    cur_bal: np.ndarray
    exec_cursor: np.ndarray
    win_slot: np.ndarray    # [B, W]
    win_bal: np.ndarray
    win_req_lo: np.ndarray
    win_req_hi: np.ndarray


def _split64(req: np.ndarray):
    """u64/int64 request-id array -> (lo32, hi32) int32 views."""
    req = np.ascontiguousarray(req, np.uint64)
    lo = (req & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (req >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def _join64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.view(np.uint32).astype(np.uint64) |
            (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)))


class AcceptorBackend(abc.ABC):
    """Batch-level consensus state-transition engine for all groups of one
    node.  Rows are the dense indices from ``GroupTable``."""

    @property
    @abc.abstractmethod
    def window(self) -> int: ...

    @abc.abstractmethod
    def create(self, rows, members, versions, init_bal, self_coord): ...

    @abc.abstractmethod
    def delete(self, rows): ...

    @abc.abstractmethod
    def accept(self, rows, slots, bals, req_ids) -> AcceptRes: ...

    @abc.abstractmethod
    def accept_reply(self, rows, slots, bals, senders, acked
                     ) -> AcceptReplyRes: ...

    @abc.abstractmethod
    def propose(self, rows, req_ids) -> ProposeRes: ...

    @abc.abstractmethod
    def commit(self, rows, slots, req_ids) -> CommitRes: ...

    @abc.abstractmethod
    def prepare(self, rows, bals) -> PrepareRes: ...

    @abc.abstractmethod
    def install_coordinator(self, rows, cbals, next_slots, carry_slot,
                            carry_req) -> None: ...

    @abc.abstractmethod
    def set_cursor(self, rows, cursors, next_slots) -> None: ...

    @abc.abstractmethod
    def gc(self, rows, upto) -> None: ...

    @abc.abstractmethod
    def cursor_of(self, row: int) -> int: ...

    @abc.abstractmethod
    def snapshot_row(self, row: int) -> dict:
        """Serializable per-row hot state (pause; ref HotRestoreInfo)."""

    @abc.abstractmethod
    def restore_row(self, row: int, snap: dict) -> None: ...

    def snapshot_rows(self, rows) -> List[dict]:
        """Batched snapshot (deactivator sweeps); backends override when
        they can gather many rows in one device round trip."""
        return [self.snapshot_row(int(r)) for r in rows]

    @staticmethod
    def gate_acks(res: AcceptRes) -> AcceptRes:
        """Withdraw every ack in an accept result: the durability
        barrier AFTER the engine call failed (WAL impaired), so the
        on-device votes must not be reported to any coordinator — a
        quorum counting a non-fsynced vote breaks no_lost_acks.  The
        replies go out nacked at the acceptor's current ballot (the
        coordinator simply never counts this acceptor; the vote stays
        inert on-device and is re-persisted if the slot is re-driven).
        Pure SPI-surface helper: no backend state is touched."""
        return res._replace(acked=np.zeros_like(np.asarray(res.acked)))

    def inspect_rows(self, rows) -> Dict[str, np.ndarray]:
        """Device-truth consensus cursors for the introspection plane
        (``GET /groups``): promised ballot, coordinator ballot, next
        proposal slot, exec cursor — per row, as parallel arrays.
        Default goes through the (heavier) snapshot path; the columnar
        backend overrides with one gather + one transfer."""
        snaps = self.snapshot_rows(np.asarray(rows, np.int64))

        def field(s: dict, key: str, scal_idx: int, default: int) -> int:
            # the native store packs its per-row scalars into `scal`
            # ([bal, cbal, exec_cursor, next_slot, ...]); the scalar
            # oracle snapshot carries named keys
            if "scal" in s:
                return int(s["scal"][scal_idx])
            return int(s.get(key, default))

        return {
            "bal": np.asarray(
                [field(s, "bal", 0, -1) for s in snaps], np.int64),
            "cbal": np.asarray(
                [field(s, "cbal", 1, -1) for s in snaps], np.int64),
            "next_slot": np.asarray(
                [field(s, "next_slot", 3, 0) for s in snaps], np.int64),
            "exec_cursor": np.asarray(
                [field(s, "exec_cursor", 2, 0) for s in snaps],
                np.int64),
        }

    engine_platform = "cpu"  # overridden by device-resident backends
    engine_mesh = "off"  # device-mesh size when group-axis sharded

    def memory_info(self) -> Optional[dict]:
        """Slab memory accounting (``GET /engine``): per-plane bytes,
        bytes/group, and a max-groups capacity estimate.  None for
        backends without device-resident slabs (scalar/native)."""
        return None

    def row_ownership(self) -> Optional[dict]:
        """Active-row counts per engine shard / mesh device (the device
        axis of the lane-balance view); None when not applicable."""
        return None

    def kernel_costs(self) -> Dict[str, dict]:
        """Compiled-HLO cost analysis (flops / bytes accessed) per hot
        kernel; empty for non-jit backends."""
        return {}

    def accept_commit(self, rows_a, slots_a, bals_a, reqs_a,
                      rows_c, slots_c, reqs_c
                      ) -> Tuple[AcceptRes, CommitRes]:
        """Fused acceptor wave: accepts then commits, in the order the
        manager's handlers run them.  Default is the two plain calls
        (scalar/native semantics are already per-item); the columnar
        backend overrides with ONE device dispatch."""
        return (self.accept(rows_a, slots_a, bals_a, reqs_a),
                self.commit(rows_c, slots_c, reqs_c))


# --------------------------------------------------------------------------
# scalar backend (baseline / trickle-traffic path)
# --------------------------------------------------------------------------


class ScalarBackend(AcceptorBackend):
    """Per-instance Python objects; the reference-architecture stand-in."""

    def __init__(self, window: int = 16):
        self._window = window
        self.groups: Dict[int, OracleGroup] = {}

    @property
    def window(self) -> int:
        return self._window

    def _g(self, row: int) -> Optional[OracleGroup]:
        return self.groups.get(int(row))

    def create(self, rows, members, versions, init_bal, self_coord):
        for i in range(len(rows)):
            self.groups[int(rows[i])] = make_oracle_group(
                int(members[i]), self._window, int(init_bal[i]),
                bool(self_coord[i]), int(versions[i]))

    def delete(self, rows):
        for r in rows:
            self.groups.pop(int(r), None)

    def accept(self, rows, slots, bals, req_ids) -> AcceptRes:
        n = len(rows)
        acked = np.zeros(n, bool)
        stale = np.zeros(n, bool)
        ow = np.zeros(n, bool)
        cur = np.full(n, NO_BALLOT, np.int32)
        for i in range(n):
            g = self._g(rows[i])
            if g is None:
                continue
            acked[i], stale[i], ow[i], cur[i] = g.accept(
                int(slots[i]), int(bals[i]), int(req_ids[i]))
        return AcceptRes(acked, stale, ow, cur)

    def accept_reply(self, rows, slots, bals, senders, acked
                     ) -> AcceptReplyRes:
        n = len(rows)
        newly = np.zeros(n, bool)
        pre = np.zeros(n, bool)
        rlo = np.zeros(n, np.int32)
        rhi = np.zeros(n, np.int32)
        dbal = np.full(n, NO_BALLOT, np.int32)
        for i in range(n):
            g = self._g(rows[i])
            if g is None:
                continue
            nd, p, req = g.accept_reply(int(slots[i]), int(bals[i]),
                                        int(senders[i]), bool(acked[i]))
            newly[i], pre[i] = nd, p
            if nd:
                dbal[i] = g.cbal
                r = np.asarray([req], np.uint64)
                lo, hi = _split64(r)
                rlo[i], rhi[i] = lo[0], hi[0]
        return AcceptReplyRes(newly, pre, rlo, rhi, dbal)

    def propose(self, rows, req_ids) -> ProposeRes:
        n = len(rows)
        granted = np.zeros(n, bool)
        rejected = np.zeros(n, bool)
        throttled = np.zeros(n, bool)
        slot = np.full(n, NO_SLOT, np.int32)
        cbal = np.full(n, NO_BALLOT, np.int32)
        for i in range(n):
            g = self._g(rows[i])
            if g is None:
                continue
            st, s, cb = g.propose(int(req_ids[i]))
            granted[i] = st == "granted"
            rejected[i] = st == "rejected"
            throttled[i] = st == "throttled"
            slot[i], cbal[i] = s, cb
        return ProposeRes(granted, rejected, throttled, slot, cbal)

    def commit(self, rows, slots, req_ids) -> CommitRes:
        n = len(rows)
        applied = np.zeros(n, bool)
        stale = np.zeros(n, bool)
        ow = np.zeros(n, bool)
        cur = np.zeros(n, np.int32)
        for i in range(n):
            g = self._g(rows[i])
            if g is None:
                continue
            applied[i], stale[i], ow[i], cur[i] = g.commit(
                int(slots[i]), int(req_ids[i]))
        return CommitRes(applied, stale, ow, cur)

    def prepare(self, rows, bals) -> PrepareRes:
        n = len(rows)
        W = self._window
        acked = np.zeros(n, bool)
        cur_bal = np.full(n, NO_BALLOT, np.int32)
        cursor = np.zeros(n, np.int32)
        ws = np.full((n, W), NO_SLOT, np.int32)
        wb = np.full((n, W), NO_BALLOT, np.int32)
        wl = np.zeros((n, W), np.int32)
        wh = np.zeros((n, W), np.int32)
        for i in range(n):
            g = self._g(rows[i])
            if g is None:
                continue
            a, cb, cu, pvs = g.prepare(int(bals[i]))
            acked[i], cur_bal[i], cursor[i] = a, cb, cu
            for j, pv in enumerate(pvs[:W]):
                ws[i, j] = pv.slot
                wb[i, j] = pv.bal
                r = np.asarray([pv.req_id], np.uint64)
                lo, hi = _split64(r)
                wl[i, j], wh[i, j] = lo[0], hi[0]
        return PrepareRes(acked, cur_bal, cursor, ws, wb, wl, wh)

    def install_coordinator(self, rows, cbals, next_slots, carry_slot,
                            carry_req) -> None:
        for i in range(len(rows)):
            g = self._g(rows[i])
            if g is None:
                continue
            pvs = []
            for j in range(carry_slot.shape[1]):
                if carry_slot[i, j] >= 0:
                    pvs.append(PValue(int(carry_slot[i, j]), 0,
                                      int(carry_req[i, j])))
            g.install_coordinator(int(cbals[i]), int(next_slots[i]), pvs)

    def set_cursor(self, rows, cursors, next_slots) -> None:
        for i in range(len(rows)):
            g = self._g(rows[i])
            if g is None:
                continue
            g.exec_cursor = int(cursors[i])
            g.next_slot = max(g.next_slot, int(next_slots[i]))

    def gc(self, rows, upto) -> None:
        for i in range(len(rows)):
            g = self._g(rows[i])
            if g is not None:
                g.garbage_collect(int(upto[i]))

    def cursor_of(self, row: int) -> int:
        g = self._g(row)
        return g.exec_cursor if g else 0

    def snapshot_row(self, row: int) -> dict:
        g = self.groups[int(row)]
        return {
            "members": g.members, "version": g.version, "bal": g.bal,
            "accepted": [(pv.slot, pv.bal, pv.req_id)
                         for pv in g.accepted.values()],
            "decided": list(g.decided.items()),
            "exec_cursor": g.exec_cursor, "gc_slot": g.gc_slot,
            "is_coord": g.is_coord, "coord_active": g.coord_active,
            "cbal": g.cbal, "next_slot": g.next_slot,
        }

    def restore_row(self, row: int, snap: dict) -> None:
        g = make_oracle_group(snap["members"], self._window, snap["bal"],
                              False, snap["version"])
        for s, b, r in snap["accepted"]:
            g.accepted[s] = PValue(s, b, r)
        g.decided = dict(snap["decided"])
        g.exec_cursor = snap["exec_cursor"]
        g.gc_slot = snap["gc_slot"]
        g.is_coord = snap["is_coord"]
        g.coord_active = snap["coord_active"]
        g.cbal = snap["cbal"]
        g.next_slot = snap["next_slot"]
        self.groups[int(row)] = g


# --------------------------------------------------------------------------
# columnar backend (the CUDA data plane)
# --------------------------------------------------------------------------


_BUCKET_CAP = 4096  # largest bucket; bigger batches dispatch chunked


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest 8**k * lo >= n, CLAMPED at ``_BUCKET_CAP``: the ladder is
    exactly {8, 64, 512, 4096}, and larger batches split into
    <=4096-lane chunks (:func:`_chunks`).  torch needs no jit bucket,
    but the JAX engine pads and chunks this way, and chunk boundaries
    are linearization points: the same ladder keeps the two engines'
    states bit-identical."""
    b = lo
    while b < n and b < _BUCKET_CAP:
        b <<= 3
    return b


def _chunks(n: int) -> List[Tuple[int, int]]:
    """[lo, hi) slices of at most ``_BUCKET_CAP`` lanes covering ``n``
    (a single slice for small batches; ``[(0, 0)]`` for empty input so
    fused callers still get a lane-aligned dispatch)."""
    if n <= _BUCKET_CAP:
        return [(0, n)]
    return [(at, min(at + _BUCKET_CAP, n))
            for at in range(0, n, _BUCKET_CAP)]


class EngineWave:
    """Handle for an in-flight engine wave (the submit half of a
    submit/collect pair).  ``collect()`` blocks until the results are
    host-resident and returns the op's result tuple; call it exactly
    once.  The submit already launched the kernels on the current CUDA
    stream, queued the device->host copies into pinned buffers and
    recorded an event behind them, so the wall spent inside ``collect``
    is pure blocked-on-device time — recorded under the ``eng.collect``
    DelayProfiler total, with the submit->collect gap (the overlap the
    caller actually won) under ``eng.overlap``."""

    __slots__ = ("_finish", "_n", "_submitted", "_wave", "_sfx")

    def __init__(self, finish: Callable, n: int, sfx: str = ""):
        self._finish = finish
        self._n = n
        self._sfx = sfx  # "@<shard>" on a sharded lane's slab, else ""
        self._submitted = time.monotonic()
        # bind the wave id at submit: collect may run after the worker
        # thread has moved on to a later batch's wave
        self._wave = RequestInstrumenter.current_wave()

    def collect(self):
        t0 = time.monotonic()
        overlap = t0 - self._submitted
        DelayProfiler.add_total("eng.overlap", overlap, self._n)
        if self._sfx:
            DelayProfiler.add_total("eng.overlap" + self._sfx, overlap,
                                    self._n)
        sp = RequestInstrumenter.span_begin(
            "eng.collect", wave=self._wave, lanes=self._n,
            overlap_s=round(overlap, 6))
        res = self._finish()
        RequestInstrumenter.span_end(sp)
        DelayProfiler.update_total("eng.collect", t0, self._n)
        # full wave wall (submit->materialized) as a histogram, per
        # shard when this slab is one lane of a sharded engine
        DelayProfiler.update_delay("eng.wave" + self._sfx,
                                   self._submitted)
        if self._sfx:
            DelayProfiler.update_total("eng.collect" + self._sfx, t0,
                                       self._n)
        return res


def _collect_cols(outs: List[Tuple[torch.Tensor, int]],
                  ready: Optional["torch.cuda.Event"]) -> np.ndarray:
    """Wait for ``ready`` (the event recorded behind the device->host
    copies; None on the CPU), then join the chunked [k, bucket] host
    outputs into one [k, n] array."""
    if ready is not None:
        ready.synchronize()
    parts = [o.numpy()[:, :m] for o, m in outs if m]
    if len(parts) == 1:
        return parts[0]
    if not parts:  # zero live lanes: keep the [k, 0] shape
        return outs[0][0].numpy()[:, :0]
    return np.concatenate(parts, axis=1)


# One lane's slab launches a wave at a time in the process.  A submit is
# a few dozen torch calls (a plain wave's body a few hundred), each of
# which gives up the interpreter lock and takes it back; with every
# lane's worker launching at once each call waits its turn behind the
# others'.  Without the lock, config 2 at four lanes fell into re-drive
# storms or stalls in 4 of 6 runs on the wave kernels (PERF.md §5, the
# lanes phase).  The launches only queue work: the lanes' waves still
# run side by side on the card, and their collects wait outside the
# lock.
_LANE_LAUNCH_LOCK = threading.Lock()


def _on_stream(method):
    """Run a :class:`ColumnarBackend` method with the slab's own CUDA
    stream current, when it has one: every kernel, copy and event of
    the call is then queued on that stream, in the order the calls
    come, whichever thread makes them."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.stream is None:
            return method(self, *args, **kwargs)
        with torch.cuda.stream(self.stream):
            return method(self, *args, **kwargs)
    return run


class ColumnarBackend(AcceptorBackend):
    """Columnar kernels over [G, W] torch tensors on one device.

    Batches are padded to the bucket ladder {8, 64, 512, 4096} with
    invalid lanes masked and split into <=4096-lane chunks, exactly as
    the JAX engine does: chunk boundaries are linearization points, so
    the same ladder keeps the two engines' states bit-identical.  On a
    CUDA device every plain accept wave is one launch of the hand-written
    accept kernel a chunk, and every commit wave and fused wave
    (``accept_commit``, ``propose_self``, ``accept_reply_commit_self``,
    ``propose_self_reply``) one launch of a wave kernel a chunk
    (``ops/wave_cuda.py``), with one host->device copy, one device->host
    copy and no host sync; on the CPU each runs its plain torch version.

    ``lane`` (a lane's slab of :class:`ShardedColumnarBackend`) gives
    the slab a CUDA stream of its own, made and filled there, and every
    method that touches the slab runs with it current
    (:func:`_on_stream`): the lanes' waves then run side by side on the
    card.  A pool stream does not wait for the legacy default stream,
    so nothing of such a slab may run there — a row op from the loop
    thread, a scrape's ``row_ownership`` from the stats listener's —
    and none does.  A lane's slab also launches its waves under
    ``_LANE_LAUNCH_LOCK``.  Without ``lane`` (one slab a node) the slab
    runs on the caller's current stream, unlocked.  ``prof_suffix``
    ("@<k>") tags the slab's profiler totals with its lane.
    """

    def __init__(self, capacity: int, window: int = 16, device="cuda",
                 prof_suffix: str = "", lane: bool = False):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) \
            if lane and self._cuda else None
        self._launch_lock = _LANE_LAUNCH_LOCK if lane \
            else contextlib.nullcontext()
        self._sfx = prof_suffix
        self._window = window
        self.capacity = capacity
        self.engine_platform = self.device.type
        self._kcosts: Optional[Dict[str, dict]] = None
        with torch.cuda.stream(self.stream) if self.stream is not None \
                else contextlib.nullcontext():
            self.state = make_state(capacity, window, self.device)
        if self._cuda:
            # build the kernels at construction, not inside the first
            # wave (an nvcc run mid-serving reads as a latency spike)
            accept_cuda.accept.load()
            wave_cuda.load()

    @property
    def window(self) -> int:
        return self._window

    # -- host <-> device helpers -------------------------------------------

    def _dev(self, arr) -> torch.Tensor:
        """Host array -> tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _pad1(self, arr, fill, dtype=np.int32):
        n = len(arr)
        out = np.full(_bucket(n), fill, dtype)
        out[:n] = arr
        return self._dev(out)

    def _valid(self, n):
        v = np.zeros(_bucket(n), bool)
        v[:n] = True
        return self._dev(v)

    def _stage(self, b, *halves) -> torch.Tensor:
        """Stack each half's batch columns, padded to ``b`` lanes and
        followed by its valid-mask row, into ONE [k, b] i32 tensor on
        the engine's device — a single host->device transfer per chunk.
        ``halves`` are ``(n, [(column, fill), ...])``.  On a CUDA device
        the staging buffer is pinned and the copy does not block (the
        caching host allocator keeps the buffer until the copy is done);
        on the CPU the tensor shares the buffer."""
        k = sum(len(cols) + 1 for _, cols in halves)
        if self._cuda:
            host = torch.empty((k, b), dtype=torch.int32, pin_memory=True)
            out = host.numpy()
        else:
            out = np.empty((k, b), np.int32)
        at = 0
        for n, cols in halves:
            for col, fill in cols:
                out[at, :n] = col
                out[at, n:] = fill
                at += 1
            out[at, :n] = 1  # valid mask
            out[at, n:] = 0
            at += 1
        if self._cuda:
            return host.to(self.device, non_blocking=True)
        return torch.from_numpy(out)

    def _d2h(self, out: torch.Tensor) -> torch.Tensor:
        """Queue the device->host copy of a kernel output into a pinned
        buffer without blocking; a CPU output is host-resident already."""
        if not self._cuda:
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    def _fence(self) -> Optional["torch.cuda.Event"]:
        """An event behind everything queued so far (None on the CPU)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _submit1(self, kern, n, cols):
        """Launch a packed kernel over <=``_BUCKET_CAP``-lane chunks and
        queue every chunk output's device->host copy; returns the chunk
        list and the event behind it for :func:`_collect_cols`.  Chunks
        apply sequentially (a per-chunk linearization, as in the JAX
        engine)."""
        t0 = time.monotonic()
        sp = RequestInstrumenter.span_begin("eng.submit", lanes=n,
                                            bucket=_bucket(min(
                                                n, _BUCKET_CAP)))
        cols = [(np.asarray(c), f) for c, f in cols]
        outs = []
        with self._launch_lock:
            for a, bnd in _chunks(n):
                m = bnd - a
                _, o = kern(self.state, self._stage(
                    _bucket(m), (m, [(c[a:bnd], f) for c, f in cols])))
                outs.append((self._d2h(o), m))
            ready = self._fence()
        RequestInstrumenter.span_end(sp, chunks=len(outs))
        DelayProfiler.update_total("eng.submit", t0, n)
        if self._sfx:
            DelayProfiler.update_total("eng.submit" + self._sfx, t0, n)
        return outs, ready

    def _submit2(self, wave, split, n1, cols1, n2, cols2):
        """Dual-input fused dispatch, chunked like :meth:`_submit1` with
        BOTH inputs sharing one bucket per chunk: one host->device copy
        of both inputs, ONE call of ``wave`` (``kernels.acceptor_wave``
        or ``coordinator_wave``: one kernel launch on a CUDA device),
        which writes both halves' outputs into one [k, bucket] tensor,
        and one device->host copy of it; ``split`` is the first half's
        output rows."""
        t0 = time.monotonic()
        sp = RequestInstrumenter.span_begin("eng.submit",
                                            lanes=n1 + n2, fused=True)
        cols1 = [(np.asarray(c), f) for c, f in cols1]
        cols2 = [(np.asarray(c), f) for c, f in cols2]
        r1 = len(cols1) + 1
        outs1, outs2 = [], []
        with self._launch_lock:
            for a, bnd in _chunks(max(n1, n2)):
                a1, b1 = min(a, n1), min(bnd, n1)
                a2, b2 = min(a, n2), min(bnd, n2)
                b = _bucket(max(b1 - a1, b2 - a2))
                packed = self._stage(
                    b, (b1 - a1, [(c[a1:b1], f) for c, f in cols1]),
                    (b2 - a2, [(c[a2:b2], f) for c, f in cols2]))
                host = self._d2h(wave(self.state, packed[:r1],
                                      packed[r1:]))
                outs1.append((host[:split], b1 - a1))
                outs2.append((host[split:], b2 - a2))
            ready = self._fence()
        RequestInstrumenter.span_end(sp, chunks=len(outs1))
        DelayProfiler.update_total("eng.submit", t0, n1 + n2)
        if self._sfx:
            DelayProfiler.update_total("eng.submit" + self._sfx, t0,
                                       n1 + n2)
        return (outs1, outs2), ready

    # -- ops ---------------------------------------------------------------

    @_on_stream
    def create(self, rows, members, versions, init_bal, self_coord):
        rows, members = np.asarray(rows), np.asarray(members)
        versions, init_bal = np.asarray(versions), np.asarray(init_bal)
        self_coord = np.asarray(self_coord)
        for a, b in _chunks(len(rows)):
            kernels.create_groups(
                self.state, self._pad1(rows[a:b], 0),
                self._pad1(members[a:b], 1), self._pad1(versions[a:b], 0),
                self._pad1(init_bal[a:b], NO_BALLOT),
                self._pad1(self_coord[a:b], False, bool),
                self._valid(b - a))

    @_on_stream
    def delete(self, rows):
        rows = np.asarray(rows)
        for a, b in _chunks(len(rows)):
            kernels.delete_groups(self.state, self._pad1(rows[a:b], 0),
                                  self._valid(b - a))

    @_on_stream
    def accept_submit(self, rows, slots, bals, req_ids) -> EngineWave:
        """Non-blocking accept wave through the accept kernel; the
        blocking :meth:`accept` is this submit + an immediate collect."""
        n = len(rows)
        lo, hi = _split64(req_ids)
        outs, ready = self._submit1(kernels.accept_p, n, [
            (rows, 0), (slots, NO_SLOT), (bals, NO_BALLOT), (lo, 0),
            (hi, 0)])

        def finish():
            out = _collect_cols(outs, ready)
            return AcceptRes(out[0] != 0, out[1] != 0, out[2] != 0,
                             out[3])
        return EngineWave(finish, n, self._sfx)

    def accept(self, rows, slots, bals, req_ids) -> AcceptRes:
        return self.accept_submit(rows, slots, bals, req_ids).collect()

    @_on_stream
    def accept_reply_submit(self, rows, slots, bals, senders, acked
                            ) -> EngineWave:
        n = len(rows)
        outs, ready = self._submit1(kernels.accept_reply_p, n, [
            (rows, 0), (slots, NO_SLOT), (bals, NO_BALLOT),
            (senders, 0), (np.asarray(acked, np.int32), 0)])

        def finish():
            out = _collect_cols(outs, ready)
            newly = out[0] != 0
            # decision fields only meaningful on newly-decided lanes
            return AcceptReplyRes(
                newly, out[1] != 0, np.where(newly, out[3], 0),
                np.where(newly, out[4], 0),
                np.where(newly, out[2], NO_BALLOT))
        return EngineWave(finish, n, self._sfx)

    def accept_reply(self, rows, slots, bals, senders, acked
                     ) -> AcceptReplyRes:
        return self.accept_reply_submit(rows, slots, bals, senders,
                                        acked).collect()

    @_on_stream
    def propose(self, rows, req_ids) -> ProposeRes:
        n = len(rows)
        lo, hi = _split64(req_ids)
        out = _collect_cols(*self._submit1(kernels.propose_p, n, [
            (rows, 0), (lo, 0), (hi, 0)]))
        granted = out[0] != 0
        return ProposeRes(granted, out[1] != 0, out[2] != 0,
                          np.where(granted, out[3], NO_SLOT), out[4])

    @_on_stream
    def commit_submit(self, rows, slots, req_ids) -> EngineWave:
        n = len(rows)
        lo, hi = _split64(req_ids)
        outs, ready = self._submit1(kernels.commit_p, n, [
            (rows, 0), (slots, NO_SLOT), (lo, 0), (hi, 0)])

        def finish():
            out = _collect_cols(outs, ready)
            return CommitRes(out[0] != 0, out[1] != 0, out[2] != 0,
                             out[3])
        return EngineWave(finish, n, self._sfx)

    def commit(self, rows, slots, req_ids) -> CommitRes:
        return self.commit_submit(rows, slots, req_ids).collect()

    @_on_stream
    def accept_commit_submit(self, rows_a, slots_a, bals_a, reqs_a,
                             rows_c, slots_c, reqs_c) -> EngineWave:
        """ONE fused dispatch per chunk for the acceptor wave: accepts
        then commits (``kernels.acceptor_wave``: one acceptor-wave kernel
        launch on a CUDA device)."""
        na, nc = len(rows_a), len(rows_c)
        lo_a, hi_a = _split64(reqs_a)
        lo_c, hi_c = _split64(reqs_c)
        (outs_a, outs_c), ready = self._submit2(
            kernels.acceptor_wave, 4,
            na, [(rows_a, 0), (slots_a, NO_SLOT), (bals_a, NO_BALLOT),
                 (lo_a, 0), (hi_a, 0)],
            nc, [(rows_c, 0), (slots_c, NO_SLOT), (lo_c, 0),
                 (hi_c, 0)])

        def finish():
            a = _collect_cols(outs_a, ready)
            c = _collect_cols(outs_c, None)
            return (AcceptRes(a[0] != 0, a[1] != 0, a[2] != 0, a[3]),
                    CommitRes(c[0] != 0, c[1] != 0, c[2] != 0, c[3]))
        return EngineWave(finish, na + nc, self._sfx)

    def accept_commit(self, rows_a, slots_a, bals_a, reqs_a,
                      rows_c, slots_c, reqs_c
                      ) -> Tuple[AcceptRes, CommitRes]:
        return self.accept_commit_submit(rows_a, slots_a, bals_a,
                                         reqs_a, rows_c, slots_c,
                                         reqs_c).collect()

    @_on_stream
    def accept_reply_commit_self(self, rows, slots, bals, senders, acked
                                 ) -> Tuple[AcceptReplyRes, np.ndarray,
                                            np.ndarray]:
        """Fused reply + own commit (see
        ``kernels.accept_reply_commit_self_packed``).  Returns
        (AcceptReplyRes, applied[B], stale[B])."""
        n = len(rows)
        out = _collect_cols(*self._submit1(
            kernels.accept_reply_commit_self_p, n, [
                (rows, 0), (slots, NO_SLOT), (bals, NO_BALLOT),
                (senders, 0), (np.asarray(acked, np.int32), 0)]))
        newly = out[0] != 0
        res = AcceptReplyRes(
            newly, out[1] != 0, np.where(newly, out[3], 0),
            np.where(newly, out[4], 0),
            np.where(newly, out[2], NO_BALLOT))
        return res, out[6] != 0, out[7] != 0

    @_on_stream
    def propose_self(self, rows, req_ids, self_midx):
        """Fused propose + own accept + own vote (see
        ``kernels.propose_accept_self_packed``).  Returns (ProposeRes,
        self_acked[B], newly_decided[B], preempted[B], acc_cur_bal[B])."""
        n = len(rows)
        lo, hi = _split64(req_ids)
        out = _collect_cols(*self._submit1(
            kernels.propose_accept_self_p, n, [
                (rows, 0), (lo, 0), (hi, 0), (self_midx, 0)]))
        granted = out[0] != 0
        pr = ProposeRes(granted, out[1] != 0, out[2] != 0,
                        np.where(granted, out[3], NO_SLOT), out[4])
        return pr, out[5] != 0, out[6] != 0, out[7] != 0, out[8]

    @_on_stream
    def propose_self_reply_submit(self, rows_p, reqs_p, self_midx,
                                  rows_r, slots_r, bals_r, senders_r,
                                  acked_r) -> EngineWave:
        """Fused coordinator wave (``kernels.coordinator_wave``, one
        coordinator-wave kernel launch a chunk on a CUDA device; the
        semantics of ``kernels.coordinator_wave_plain``): new proposals +
        accept replies of the same worker batch.
        ``collect()`` returns what :meth:`propose_self` and
        :meth:`accept_reply_commit_self` return, as a pair."""
        np_, nr = len(rows_p), len(rows_r)
        lo_p, hi_p = _split64(reqs_p)
        (outs_p, outs_r), ready = self._submit2(
            kernels.coordinator_wave, 9,
            np_, [(rows_p, 0), (lo_p, 0), (hi_p, 0), (self_midx, 0)],
            nr, [(rows_r, 0), (slots_r, NO_SLOT), (bals_r, NO_BALLOT),
                 (senders_r, 0), (np.asarray(acked_r, np.int32), 0)])

        def finish():
            p = _collect_cols(outs_p, ready)
            r = _collect_cols(outs_r, None)
            granted = p[0] != 0
            pres = (ProposeRes(granted, p[1] != 0, p[2] != 0,
                               np.where(granted, p[3], NO_SLOT), p[4]),
                    p[5] != 0, p[6] != 0, p[7] != 0, p[8])
            newly = r[0] != 0
            rres = (AcceptReplyRes(
                newly, r[1] != 0, np.where(newly, r[3], 0),
                np.where(newly, r[4], 0),
                np.where(newly, r[2], NO_BALLOT)), r[6] != 0, r[7] != 0)
            return pres, rres
        return EngineWave(finish, np_ + nr, self._sfx)

    def propose_self_reply(self, rows_p, reqs_p, self_midx,
                           rows_r, slots_r, bals_r, senders_r, acked_r):
        return self.propose_self_reply_submit(
            rows_p, reqs_p, self_midx, rows_r, slots_r, bals_r,
            senders_r, acked_r).collect()

    @_on_stream
    def prepare(self, rows, bals) -> PrepareRes:
        rows, bals = np.asarray(rows), np.asarray(bals)
        parts = []
        for a, b in _chunks(len(rows)):
            _, o = kernels.prepare(
                self.state, self._pad1(rows[a:b], 0),
                self._pad1(bals[a:b], NO_BALLOT), self._valid(b - a))
            parts.append(tuple(x.cpu().numpy()[:b - a] for x in o))
        acked, cur_bal, cursor, ws, wb, wl, wh = parts[0] \
            if len(parts) == 1 else \
            tuple(np.concatenate(f) for f in zip(*parts))
        # canonicalize the raw slot%W column layout into the SPI contract:
        # live pvalues (slot >= exec_cursor) compacted left, sorted by slot
        live = (ws >= 0) & (ws >= cursor[:, None])
        order = np.argsort(np.where(live, ws, np.iinfo(np.int32).max),
                           axis=1, kind="stable")
        ws2 = np.where(live, ws, NO_SLOT)
        wb2 = np.where(live, wb, NO_BALLOT)
        wl2 = np.where(live, wl, 0)
        wh2 = np.where(live, wh, 0)
        tk = np.take_along_axis
        return PrepareRes(acked, cur_bal, cursor,
                          tk(ws2, order, 1), tk(wb2, order, 1),
                          tk(wl2, order, 1), tk(wh2, order, 1))

    @_on_stream
    def install_coordinator(self, rows, cbals, next_slots, carry_slot,
                            carry_req) -> None:
        rows, cbals = np.asarray(rows), np.asarray(cbals)
        next_slots = np.asarray(next_slots)
        W = self._window
        m = carry_slot.shape[1]
        lo, hi = _split64(carry_req.reshape(-1))
        lo = lo.reshape(len(rows), m)
        hi = hi.reshape(len(rows), m)
        for a, bnd in _chunks(len(rows)):
            n = bnd - a
            b = _bucket(n)
            cs = np.full((b, W), NO_SLOT, np.int32)
            cl = np.zeros((b, W), np.int32)
            ch = np.zeros((b, W), np.int32)
            cs[:n, :m] = carry_slot[a:bnd]
            cl[:n, :m] = lo[a:bnd]
            ch[:n, :m] = hi[a:bnd]
            kernels.install_coordinator(
                self.state, self._pad1(rows[a:bnd], 0),
                self._pad1(cbals[a:bnd], NO_BALLOT),
                self._pad1(next_slots[a:bnd], 0), self._dev(cs),
                self._dev(cl), self._dev(ch), self._valid(n))

    @_on_stream
    def set_cursor(self, rows, cursors, next_slots) -> None:
        rows, cursors = np.asarray(rows), np.asarray(cursors)
        next_slots = np.asarray(next_slots)
        for a, b in _chunks(len(rows)):
            kernels.set_cursor(
                self.state, self._pad1(rows[a:b], 0),
                self._pad1(cursors[a:b], 0),
                self._pad1(next_slots[a:b], 0), self._valid(b - a))

    @_on_stream
    def gc(self, rows, upto) -> None:
        rows, upto = np.asarray(rows), np.asarray(upto)
        for a, b in _chunks(len(rows)):
            kernels.gc(self.state, self._pad1(rows[a:b], 0),
                       self._pad1(upto[a:b], NO_SLOT), self._valid(b - a))

    @_on_stream
    def cursor_of(self, row: int) -> int:
        return int(self.state.exec_cursor[row])

    @_on_stream
    def inspect_rows(self, rows) -> Dict[str, np.ndarray]:
        """ONE stacked gather + ONE device->host transfer for the four
        scalar consensus planes."""
        r = self._dev(np.asarray(rows, np.int64))
        st = self.state
        stacked = torch.stack((st.bal[r], st.cbal[r], st.next_slot[r],
                               st.exec_cursor[r])).cpu().numpy()
        stacked = stacked.astype(np.int64)
        return {"bal": stacked[0], "cbal": stacked[1],
                "next_slot": stacked[2], "exec_cursor": stacked[3]}

    def snapshot_row(self, row: int) -> dict:
        return self.snapshot_rows([row])[0]

    @_on_stream
    def snapshot_rows(self, rows) -> List[dict]:
        """ONE gather + ONE device->host transfer for the whole sweep
        (fields in the JAX engine's dtypes)."""
        host = state_to_numpy(kernels.gather_rows(
            self.state, self._dev(np.asarray(rows, np.int64))))
        return [{f: host[f][i] for f in FIELDS} for i in range(len(rows))]

    @_on_stream
    def restore_row(self, row: int, snap: dict) -> None:
        # coerce dtypes: snapshots may round-trip through JSON (pause
        # blobs), which turns u32 vote words / bool flags into int lists
        fields = {}
        for f, t in self.state.items():
            a = np.asarray(snap[f])
            if f == "prep_votes":
                a = a.astype(np.uint32)
            elif t.dtype == torch.bool:
                a = a.astype(np.bool_)
            fields[f] = a[None]
        row_state = state_from_numpy(fields, self.device)
        kernels.scatter_rows(self.state, self._dev(np.asarray([row])),
                             row_state, self._dev(np.asarray([True])))

    # -- slab accounting ---------------------------------------------------

    @_on_stream
    def memory_info(self) -> dict:
        """Per-plane slab bytes from the tensors themselves, bytes/group,
        and — on a CUDA device — the allocator's bytes in use, the
        device's total bytes and a max-groups-at-current-config
        estimate.  Cold path (introspection only)."""
        planes: Dict[str, int] = {}
        total = 0
        for f, t in self.state.items():
            nb = t.numel() * t.element_size()
            plane = _PLANE_OF.get(f, "control")
            planes[plane] = planes.get(plane, 0) + nb
            total += nb
        per_group = total / float(self.capacity)
        out: dict = {
            "planes": planes,
            "total_bytes": total,
            "capacity": self.capacity,
            "window": self._window,
            "bytes_per_group": per_group,
            "mesh": 1,
            "platform": self.engine_platform,
        }
        if self._cuda:
            _free, limit = torch.cuda.mem_get_info(self.device)
            out["device_bytes_in_use"] = int(
                torch.cuda.memory_allocated(self.device))
            out["device_bytes_limit"] = int(limit)
            # 10% reserved for batch buffers + workspace
            out["max_groups_estimate"] = int(0.9 * limit / per_group)
        return out

    @_on_stream
    def row_ownership(self) -> dict:
        n = int(self.state.active.sum())
        return {"rows_active": n, "mesh": [n]}

    def kernel_costs(self) -> Dict[str, dict]:
        """Bytes each hot wave moves at the warm (bucket-8) shape, from
        the shapes alone (:func:`wave_bytes`), and ``flops`` null: the
        waves are integer gathers and scatters, and torch has no
        compiled program to cost-analyse (the reference reports XLA's
        ``cost_analysis()`` here, and nulls where it has none).
        Memoized; no device call."""
        if self._kcosts is None:
            b = _bucket(0)
            self._kcosts = {
                name: {"flops": None,
                       "bytes_accessed": float(
                           wave_bytes(name, b, self._window))}
                for name in _WAVES}
        return self._kcosts


# The hot packed waves: the packed input and output rows of each (the
# valid mask is the last input row) and the kernel bodies it runs, in
# order (``ops/kernels.py``).
_WAVES = {
    "propose_p": ((4,), (5,), ("propose",)),
    "accept_p": ((6,), (4,), ("accept",)),
    "accept_reply_p": ((6,), (6,), ("accept_reply",)),
    "commit_p": ((5,), (4,), ("commit",)),
    "accept_commit_p": ((6, 5), (4, 4), ("accept", "commit")),
    "request_reply_p": ((5, 6), (9, 9), ("propose", "accept",
                                         "accept_reply", "accept_reply",
                                         "commit")),
}


def _row_bytes(body: str, W: int) -> int:
    """State bytes one live lane of a kernel body reads and writes on
    its row, each word once (bool planes 1 B, int32 4 B, a window
    column of ``acc``/``prop`` 16 B, of ``dec`` 12 B):

    - propose: reads active, is_coord, coord_active, next_slot,
      exec_cursor, cbal; writes next_slot and the ``prop`` column;
    - accept: reads active, bal, exec_cursor; writes bal and the
      ``acc`` column (the accept kernel's own count, ``chip_smoke``'s
      ``accept_bytes``, with every lane raising and storing);
    - accept_reply: reads is_coord, coord_active, cbal, members and
      the ``prop`` column; writes the vote word, is_coord and
      coord_active;
    - commit: reads active, exec_cursor and the W slots of the row's
      ``dec`` window (the contiguity scan); writes the ``dec`` column
      and exec_cursor."""
    return {"propose": (1 + 1 + 1 + 4 + 4 + 4) + (4 + 16),
            "accept": (1 + 4 + 4) + (4 + 16),
            "accept_reply": (1 + 1 + 4 + 4 + 16) + (4 + 1 + 1),
            "commit": (1 + 4 + 4 * W) + (12 + 4)}[body]


def wave_bytes(name: str, bucket: int, W: int) -> int:
    """Bytes a packed wave moves at ``bucket`` lanes on a window-``W``
    slab: its packed int32 inputs read once, its packed int32 outputs
    written once, and each body's row traffic (:func:`_row_bytes`) for
    every lane, one row a lane."""
    ins, outs, bodies = _WAVES[name]
    return 4 * bucket * (sum(ins) + sum(outs)) + \
        bucket * sum(_row_bytes(b, W) for b in bodies)


# plane grouping of the ColumnarState fields for the accounting view
_PLANE_OF = {
    "acc": "acc", "dec": "dec", "prop": "prop",
    "bal": "ballots", "cbal": "ballots",
    "exec_cursor": "cursors", "next_slot": "cursors",
    "gc_slot": "cursors",
    "prep_votes": "votes",
    "active": "control", "members": "control", "version": "control",
    "is_coord": "control", "coord_active": "control",
}


# --------------------------------------------------------------------------
# sharded columnar backend (row-partitioned engine lanes)
# --------------------------------------------------------------------------


class _MergedWave:
    """Collectable handle over one in-flight wave per shard slab — the
    sharded analog of :class:`EngineWave`.  ``collect()`` drains every
    slab's wave and scatters the per-shard results back into input lane
    order."""

    __slots__ = ("_waves", "_merge")

    def __init__(self, waves: List, merge: Callable):
        self._waves = waves  # [(shard, idx, wave)]
        self._merge = merge

    def collect(self):
        return self._merge([(k, idx, w.collect())
                            for k, idx, w in self._waves])


def _scatter_res(parts: List[Tuple[np.ndarray, tuple]], n: int):
    """Merge per-shard result tuples (NamedTuple or plain tuple of
    arrays, 1-D ``[B]`` or 2-D ``[B, W]``) back into input lane order.
    ``parts`` is ``[(idx, res), ...]`` with ``idx`` the global lane
    indices the shard served."""
    first = parts[0][1]
    fields = []
    for fi in range(len(first)):
        f0 = np.asarray(first[fi])
        out = np.empty((n,) + f0.shape[1:], f0.dtype)
        for idx, res in parts:
            out[idx] = np.asarray(res[fi])
        fields.append(out)
    return type(first)(*fields) if hasattr(first, "_fields") \
        else tuple(fields)


class ShardedColumnarBackend(AcceptorBackend):
    """S independent :class:`ColumnarBackend` slabs behind the single
    ``AcceptorBackend`` SPI (PC.ENGINE_SHARDS; engine lanes).

    Global row ``r`` lives in slab ``r % S`` at local row ``r // S`` —
    the interleaved mapping matches ``GroupTable``'s per-shard free
    lists, so a group (shard = ``gkey % S``) always resolves to its
    shard's slab.  Every SPI call splits its lanes by shard, drives
    each slab with local rows, and scatters results back into input
    order; a lane-pure batch (the manager's per-lane workers only ever
    send their own shard's rows) degenerates to one slab call with no
    scatter.  Each slab owns a CUDA stream (``lane``), so the lanes'
    waves queue and run side by side on the card; each slab's
    profiler tags carry an ``@<shard>`` suffix next to the node-wide
    base tags.  The reference's slab ``mesh`` has no counterpart: the
    port's slabs are one device each (ROADMAP module 16).
    """

    def __init__(self, capacity: int, window: int = 16, shards: int = 2,
                 device="cuda"):
        if capacity % shards:
            raise ValueError(
                f"capacity {capacity} not divisible by shards {shards}")
        self.capacity = capacity
        self._window = window
        self.shards = shards
        self.slabs = [
            ColumnarBackend(capacity // shards, window, device=device,
                            prof_suffix=f"@{k}", lane=True)
            for k in range(shards)]
        self.engine_platform = self.slabs[0].engine_platform
        self.engine_mesh = self.slabs[0].engine_mesh

    @property
    def window(self) -> int:
        return self._window

    # -- shard split helpers ----------------------------------------------

    def _split(self, rows) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """(shard, global lane idx, local rows) per shard present."""
        rows = np.asarray(rows)
        if not len(rows):
            return []
        sh = rows.astype(np.int64) % self.shards
        lo = sh.min()
        if lo == sh.max():  # lane-pure batch (the per-lane worker path)
            return [(int(lo), np.arange(len(rows)),
                     (rows // self.shards).astype(np.int32))]
        out = []
        for k in range(self.shards):
            idx = np.flatnonzero(sh == k)
            if len(idx):
                out.append((k, idx,
                            (rows[idx] // self.shards).astype(np.int32)))
        return out

    @staticmethod
    def _cols_at(cols: tuple, idx: np.ndarray, n: int) -> list:
        """Slice the batch columns down to one shard's lanes — skipping
        the fancy-index copy on a lane-pure batch (idx is the identity
        there)."""
        if len(idx) == n:
            return [np.asarray(c) for c in cols]
        return [np.asarray(c)[idx] for c in cols]

    def _fan1(self, op: str, rows, cols: tuple):
        """Split-call-merge for single-input ops whose slab method takes
        ``(local_rows, *cols)`` and returns a result tuple aligned to
        its lanes."""
        rows = np.asarray(rows)
        n = len(rows)
        parts = []
        for k, idx, local in self._split(rows):
            args = self._cols_at(cols, idx, n)
            parts.append((idx, getattr(self.slabs[k], op)(local, *args)))
        if not parts:
            # keep the result structure for empty input (slab handles
            # zero-length arrays)
            return getattr(self.slabs[0], op)(
                rows.astype(np.int32), *[np.asarray(c) for c in cols])
        if len(parts) == 1 and len(parts[0][0]) == n:
            return parts[0][1]
        return _scatter_res(parts, n)

    # -- SPI ---------------------------------------------------------------

    def create(self, rows, members, versions, init_bal, self_coord):
        for k, idx, local in self._split(rows):
            self.slabs[k].create(local, np.asarray(members)[idx],
                                 np.asarray(versions)[idx],
                                 np.asarray(init_bal)[idx],
                                 np.asarray(self_coord)[idx])

    def delete(self, rows):
        for k, _idx, local in self._split(rows):
            self.slabs[k].delete(local)

    def accept(self, rows, slots, bals, req_ids) -> AcceptRes:
        return self._fan1("accept", rows, (slots, bals, req_ids))

    def accept_submit(self, rows, slots, bals, req_ids):
        return self._submit_fan("accept_submit", rows,
                                (slots, bals, req_ids))

    def accept_reply(self, rows, slots, bals, senders, acked
                     ) -> AcceptReplyRes:
        return self._fan1("accept_reply", rows,
                          (slots, bals, senders, acked))

    def accept_reply_submit(self, rows, slots, bals, senders, acked):
        return self._submit_fan("accept_reply_submit", rows,
                                (slots, bals, senders, acked))

    def propose(self, rows, req_ids) -> ProposeRes:
        return self._fan1("propose", rows, (req_ids,))

    def commit(self, rows, slots, req_ids) -> CommitRes:
        return self._fan1("commit", rows, (slots, req_ids))

    def commit_submit(self, rows, slots, req_ids):
        return self._submit_fan("commit_submit", rows, (slots, req_ids))

    def prepare(self, rows, bals) -> PrepareRes:
        return self._fan1("prepare", rows, (bals,))

    def _submit_fan(self, op: str, rows, cols: tuple) -> _MergedWave:
        """Submit one wave per shard present (all launched before any
        collect — the cross-slab overlap), merged at collect()."""
        rows = np.asarray(rows)
        n = len(rows)
        waves = []
        for k, idx, local in self._split(rows):
            args = self._cols_at(cols, idx, n)
            waves.append((k, idx, getattr(self.slabs[k], op)(local,
                                                             *args)))
        if not waves:
            waves = [(0, np.arange(0),
                      getattr(self.slabs[0], op)(
                          rows.astype(np.int32),
                          *[np.asarray(c) for c in cols]))]

        def merge(done):
            if len(done) == 1 and len(done[0][1]) == n:
                return done[0][2]
            return _scatter_res([(idx, res) for _k, idx, res in done], n)
        return _MergedWave(waves, merge)

    def propose_self(self, rows, req_ids, self_midx):
        rows = np.asarray(rows)
        n = len(rows)
        parts = []
        for k, idx, local in self._split(rows):
            reqs_k, midx_k = self._cols_at((req_ids, self_midx), idx, n)
            pr, sa, sn, sp, sc = self.slabs[k].propose_self(
                local, reqs_k, midx_k)
            parts.append((idx, tuple(pr) + (sa, sn, sp, sc)))
        if not parts:
            return self.slabs[0].propose_self(
                rows.astype(np.int32), np.asarray(req_ids),
                np.asarray(self_midx))
        if len(parts) == 1 and len(parts[0][0]) == n:
            flat = parts[0][1]
        else:
            flat = _scatter_res(parts, n)
        return (ProposeRes(*flat[:5]), flat[5], flat[6], flat[7],
                flat[8])

    def accept_reply_commit_self(self, rows, slots, bals, senders,
                                 acked):
        rows = np.asarray(rows)
        n = len(rows)
        parts = []
        for k, idx, local in self._split(rows):
            sl_k, b_k, sd_k, ak_k = self._cols_at(
                (slots, bals, senders, acked), idx, n)
            res, app, st = self.slabs[k].accept_reply_commit_self(
                local, sl_k, b_k, sd_k, ak_k)
            parts.append((idx, tuple(res) + (app, st)))
        if not parts:
            return self.slabs[0].accept_reply_commit_self(
                rows.astype(np.int32), np.asarray(slots),
                np.asarray(bals), np.asarray(senders),
                np.asarray(acked))
        if len(parts) == 1 and len(parts[0][0]) == n:
            flat = parts[0][1]
        else:
            flat = _scatter_res(parts, n)
        return AcceptReplyRes(*flat[:5]), flat[5], flat[6]

    def accept_commit_submit(self, rows_a, slots_a, bals_a, reqs_a,
                             rows_c, slots_c, reqs_c) -> _MergedWave:
        """Fused acceptor wave across slabs: each shard present in
        EITHER half gets ONE slab dispatch covering its share of both
        (empty halves ride along as zero-lane inputs, preserving the
        slab's accepts-then-commits ordering)."""
        rows_a, rows_c = np.asarray(rows_a), np.asarray(rows_c)
        na, nc = len(rows_a), len(rows_c)
        pa = {k: (idx, local) for k, idx, local in self._split(rows_a)}
        pc = {k: (idx, local) for k, idx, local in self._split(rows_c)}
        e_i, e_r = np.arange(0), np.zeros(0, np.int32)
        waves = []
        for k in sorted(set(pa) | set(pc)) or [0]:
            ai, al = pa.get(k, (e_i, e_r))
            ci, cl = pc.get(k, (e_i, e_r))
            sa_k, ba_k, ra_k = self._cols_at((slots_a, bals_a, reqs_a),
                                             ai, na)
            sc_k, rc_k = self._cols_at((slots_c, reqs_c), ci, nc)
            w = self.slabs[k].accept_commit_submit(
                al, sa_k, ba_k, ra_k, cl, sc_k, rc_k)
            waves.append((k, (ai, ci), w))

        def merge(done):
            if len(done) == 1:
                ai, ci = done[0][1]
                if len(ai) == na and len(ci) == nc:
                    return done[0][2]  # lane-pure: no scatter needed
            a_parts = [(ai, res[0]) for (_k, (ai, _ci), res) in done
                       if len(ai)]
            c_parts = [(ci, res[1]) for (_k, (_ai, ci), res) in done
                       if len(ci)]
            ares = _scatter_res(a_parts, na) if a_parts \
                else done[0][2][0]
            cres = _scatter_res(c_parts, nc) if c_parts \
                else done[0][2][1]
            return ares, cres
        return _MergedWave(waves, merge)

    def accept_commit(self, rows_a, slots_a, bals_a, reqs_a,
                      rows_c, slots_c, reqs_c):
        return self.accept_commit_submit(
            rows_a, slots_a, bals_a, reqs_a, rows_c, slots_c,
            reqs_c).collect()

    def propose_self_reply_submit(self, rows_p, reqs_p, self_midx,
                                  rows_r, slots_r, bals_r, senders_r,
                                  acked_r) -> _MergedWave:
        rows_p, rows_r = np.asarray(rows_p), np.asarray(rows_r)
        n_p, n_r = len(rows_p), len(rows_r)
        pp = {k: (idx, local) for k, idx, local in self._split(rows_p)}
        pr = {k: (idx, local) for k, idx, local in self._split(rows_r)}
        e_i, e_r = np.arange(0), np.zeros(0, np.int32)
        waves = []
        for k in sorted(set(pp) | set(pr)) or [0]:
            pi, pl = pp.get(k, (e_i, e_r))
            ri, rl = pr.get(k, (e_i, e_r))
            rq_k, mi_k = self._cols_at((reqs_p, self_midx), pi, n_p)
            sr_k, br_k, se_k, ak_k = self._cols_at(
                (slots_r, bals_r, senders_r, acked_r), ri, n_r)
            w = self.slabs[k].propose_self_reply_submit(
                pl, rq_k, mi_k, rl, sr_k, br_k, se_k, ak_k)
            waves.append((k, (pi, ri), w))

        def merge(done):
            if len(done) == 1:
                pi, ri = done[0][1]
                if len(pi) == n_p and len(ri) == n_r:
                    return done[0][2]  # lane-pure: no scatter needed
            p_parts = [(pi, tuple(res[0][0]) + tuple(res[0][1:]))
                       for (_k, (pi, _ri), res) in done if len(pi)]
            r_parts = [(ri, tuple(res[1][0]) + tuple(res[1][1:]))
                       for (_k, (_pi, ri), res) in done if len(ri)]
            if p_parts:
                pf = _scatter_res(p_parts, n_p)
                pres = (ProposeRes(*pf[:5]), pf[5], pf[6], pf[7], pf[8])
            else:
                pres = done[0][2][0]
            if r_parts:
                rf = _scatter_res(r_parts, n_r)
                rres = (AcceptReplyRes(*rf[:5]), rf[5], rf[6])
            else:
                rres = done[0][2][1]
            return pres, rres
        return _MergedWave(waves, merge)

    def propose_self_reply(self, rows_p, reqs_p, self_midx,
                           rows_r, slots_r, bals_r, senders_r, acked_r):
        return self.propose_self_reply_submit(
            rows_p, reqs_p, self_midx, rows_r, slots_r, bals_r,
            senders_r, acked_r).collect()

    def install_coordinator(self, rows, cbals, next_slots, carry_slot,
                            carry_req) -> None:
        for k, idx, local in self._split(rows):
            self.slabs[k].install_coordinator(
                local, np.asarray(cbals)[idx],
                np.asarray(next_slots)[idx],
                np.asarray(carry_slot)[idx],
                np.asarray(carry_req)[idx])

    def set_cursor(self, rows, cursors, next_slots) -> None:
        for k, idx, local in self._split(rows):
            self.slabs[k].set_cursor(local, np.asarray(cursors)[idx],
                                     np.asarray(next_slots)[idx])

    def gc(self, rows, upto) -> None:
        for k, idx, local in self._split(rows):
            self.slabs[k].gc(local, np.asarray(upto)[idx])

    def cursor_of(self, row: int) -> int:
        return self.slabs[row % self.shards].cursor_of(
            row // self.shards)

    def inspect_rows(self, rows) -> Dict[str, np.ndarray]:
        rows = np.asarray(rows)
        out = {k: np.zeros(len(rows), np.int64)
               for k in ("bal", "cbal", "next_slot", "exec_cursor")}
        for k, idx, local in self._split(rows):
            part = self.slabs[k].inspect_rows(local)
            for f, arr in part.items():
                out[f][idx] = arr
        return out

    def snapshot_row(self, row: int) -> dict:
        return self.slabs[row % self.shards].snapshot_row(
            row // self.shards)

    def snapshot_rows(self, rows) -> List[dict]:
        rows = np.asarray(rows)
        out: List[Optional[dict]] = [None] * len(rows)
        for k, idx, local in self._split(rows):
            for i, snap in zip(idx.tolist(),
                               self.slabs[k].snapshot_rows(local)):
                out[i] = snap
        return out

    def restore_row(self, row: int, snap: dict) -> None:
        self.slabs[row % self.shards].restore_row(row // self.shards,
                                                  snap)

    # -- flight deck: aggregate the slabs ---------------------------------

    def memory_info(self) -> dict:
        """Sum of the slabs' accounting, with a per-shard breakdown —
        ``bytes_per_group`` stays the whole-engine ratio (total bytes /
        global capacity), so the capacity math is shard-invariant."""
        per = [s.memory_info() for s in self.slabs]
        planes: Dict[str, int] = {}
        for p in per:
            for name, nb in p["planes"].items():
                planes[name] = planes.get(name, 0) + nb
        total = sum(p["total_bytes"] for p in per)
        out: dict = {
            "planes": planes,
            "total_bytes": total,
            "capacity": self.capacity,
            "window": self._window,
            "bytes_per_group": total / float(self.capacity),
            "mesh": per[0]["mesh"],
            "platform": self.engine_platform,
            "engine_shards": self.shards,
            "per_shard": [{"total_bytes": p["total_bytes"],
                           "capacity": p["capacity"]} for p in per],
        }
        ests = [p["max_groups_estimate"] for p in per
                if "max_groups_estimate" in p]
        if ests:
            # the slabs share one device: each slab's estimate is already
            # the groups the whole device holds at this bytes/group (the
            # reference multiplies it by the shard count, S times over)
            out["max_groups_estimate"] = min(ests)
        return out

    def row_ownership(self) -> dict:
        per = [s.row_ownership() for s in self.slabs]
        return {
            "rows_active": sum(p["rows_active"] for p in per),
            "shards": [p["rows_active"] for p in per],
            "mesh": per[0]["mesh"],
        }

    def kernel_costs(self) -> Dict[str, dict]:
        # the slabs share one window and ladder: slab 0 speaks for all
        return self.slabs[0].kernel_costs()
