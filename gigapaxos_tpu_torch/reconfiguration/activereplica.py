"""Active replica: the data-plane front of the reconfiguration substrate.

The port's own copy of ``gigapaxos_tpu/reconfiguration/activereplica.py``,
with one repair (ROADMAP §3): its epoch handlers find a group the
deactivator paused (:meth:`ActiveReplica._group`), where the reference
reads it as absent and so never stops or drops it.

Reference analog: ``reconfiguration/ActiveReplica.java`` — demultiplexes
app traffic vs reconfiguration packets; handles ``StartEpoch`` /
``StopEpoch`` / ``DropEpochFinalState``; emits ``DemandReport``s.  Here it
owns a :class:`PaxosNode` whose app is a :class:`PaxosReplicaCoordinator`
wrapping the user app, and registers a ``Control`` handler on the node's
worker thread (single-writer discipline preserved).

Epoch-stop design: ``stop_epoch`` injects a *stop request* (FLAG_STOP) into
the group through normal paxos with a deterministic request id, so every
replica stops at the same slot; the coordinator wrapper captures
``checkpoint(name)`` at that slot as the epoch final state (ref:
``AbstractReplicaCoordinator`` stoppable wrappers + ``EpochFinalState``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.paxos.interfaces import Replicable
from gigapaxos_tpu_torch.paxos.manager import FLAG_STOP, PaxosNode
from gigapaxos_tpu_torch.reconfiguration import rcpackets as rc
from gigapaxos_tpu_torch.reconfiguration.coordinator import \
    PaxosReplicaCoordinator
from gigapaxos_tpu_torch.reconfiguration.rcdb import b64d, b64e
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.active")


def stop_req_id(name: str, epoch: int) -> int:
    """Deterministic id for a group-epoch's stop request: every active (and
    every reconfigurator retry) proposes the SAME id, so the engine's
    request dedup collapses them into one decided stop."""
    return pkt.group_key(f"{name}:{epoch}:__stop__") | (1 << 63)


class ActiveReplica:
    """One active node: engine + epoch lifecycle + demand reporting."""

    def __init__(self, node_id: int, addr_map: Dict[int, Tuple[str, int]],
                 reconfigurators: Tuple[int, ...], app: Replicable,
                 logdir: str, demand_report_every: Optional[int] = None,
                 **node_kw):
        self.id = node_id
        self.reconfigurators = tuple(reconfigurators)
        self.coordinator = PaxosReplicaCoordinator(app)
        self.node = PaxosNode(node_id, addr_map, self.coordinator, logdir,
                              **node_kw)
        self.coordinator.bind(self.node)
        if demand_report_every is None:
            from gigapaxos_tpu_torch.reconfiguration.rcconfig import RC
            from gigapaxos_tpu_torch.utils.config import Config as _C
            demand_report_every = int(_C.get(RC.DEMAND_REPORT_EVERY))
        self.demand_report_every = demand_report_every
        self._demand_acc: Dict[str, int] = {}
        # stops we have been asked for but whose group is still running:
        # name -> (epoch, rc, injected_ts); the ts gates re-injection so
        # reconfigurator retry waves don't flood the data plane with
        # duplicate stop requests (they dedupe, but each one still costs
        # a full request-path pass)
        self._pending_stops: Dict[str, Tuple[int, int, float]] = {}
        self.node.register_handler(pkt.Control, self._on_control)
        self.node.add_tick_hook(self._tick)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.node.start()

    def stop(self) -> None:
        self.node.stop()

    @property
    def port(self) -> int:
        return self.node.port

    # -- control handling (worker thread) ----------------------------------

    def _group(self, name: str):
        """The node's record of ``name``'s group, hydrating it first if
        the deactivator paused it: a paused group is not in the node's
        table, and a stop or drop that read it as absent would ack
        without stopping it, or leave it on this node for good."""
        meta = self.node._lookup(pkt.group_key(name))
        return meta if meta is not None and meta.name == name else None

    def _on_control(self, o: pkt.Control) -> None:
        import time as _time

        from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
        _t0 = _time.monotonic()
        _c0 = _time.thread_time()
        try:
            self._on_control_inner(o)
        finally:
            DelayProfiler.update_total(
                f"w.ar.{o.body.get('rc')}", _t0, cpu_t0=_c0)

    def _on_control_inner(self, o: pkt.Control) -> None:
        b = o.body
        t = b.get("rc")
        if t == rc.START_EPOCH:
            self._handle_start_epoch(o.sender, b)
        elif t == rc.STOP_EPOCH:
            self._handle_stop_epoch(o.sender, b)
        elif t == rc.DROP_EPOCH:
            self._handle_drop_epoch(o.sender, b)
        elif t == rc.START_EPOCH_BATCH:
            self._handle_start_epoch_batch(o.sender, b)
        elif t == rc.STOP_EPOCH_BATCH:
            self._handle_stop_epoch_batch(o.sender, b)
        elif t == rc.DROP_EPOCH_BATCH:
            self._handle_drop_epoch_batch(o.sender, b)
        elif t == rc.ECHO:
            self.node._route(o.sender, pkt.Control(self.id, b))
        else:
            log.warning("active %d: unexpected control %r", self.id, t)

    def _handle_start_epoch(self, sender: int, b: dict) -> None:
        name, epoch = b["name"], b["epoch"]
        ok = self.coordinator.create_replica_group(
            name, epoch, tuple(b["actives"]), b64d(b.get("init", "")))
        if ok:
            self._pending_stops.pop(name, None)
            self.node._route(sender, pkt.Control(
                self.id, rc.ack_start(name, epoch)))

    def _handle_stop_epoch(self, sender: int, b: dict) -> None:
        name, epoch = b["name"], b["epoch"]
        done = self.coordinator.stopped_state(name)
        if done is not None and done[0] >= epoch:
            self.node._route(sender, pkt.Control(
                self.id, rc.ack_stop(name, done[0], b64e(done[1]))))
            return
        meta = self._group(name)
        if meta is None or meta.version > epoch:
            # group already dropped/advanced: ack without state (the
            # reconfigurator only needs one state-bearing ack)
            self.node._route(sender, pkt.Control(
                self.id, rc.ack_stop(name, epoch, "")))
            return
        prev = self._pending_stops.get(name)
        now = time.time()
        if prev is not None and prev[0] >= epoch and now - prev[2] < 2.0:
            self._pending_stops[name] = (prev[0], sender, prev[2])
            return  # stop already in flight; just note the new asker
        self._pending_stops[name] = (epoch, sender, now)
        # propose the epoch-stop through paxos (dedup via deterministic id)
        self.node._inq.put(pkt.Request(
            self.id, meta.gkey, stop_req_id(name, epoch), FLAG_STOP, b""))

    def _handle_drop_epoch(self, sender: int, b: dict) -> None:
        name, epoch = b["name"], b["epoch"]
        meta = self._group(name)
        if meta is not None and meta.version <= epoch:
            self.coordinator.delete_replica_group(name)
        self._pending_stops.pop(name, None)
        self.node._route(sender, pkt.Control(
            self.id, rc.ack_drop(name, epoch)))

    # -- batched epoch ops (ref: batched CreateServiceName path) -----------

    def _handle_start_epoch_batch(self, sender: int, b: dict) -> None:
        items = [(nm, epoch, tuple(actives), b64d(init))
                 for nm, epoch, actives, init in b["items"]]
        self.coordinator.create_replica_groups(items)
        acks = []
        for nm, epoch, _a, _i in items:
            meta = self._group(nm)
            if meta is not None and meta.version >= epoch:
                self._pending_stops.pop(nm, None)
                acks.append([nm, epoch])
        if acks:
            self.node._route(sender, pkt.Control(
                self.id, rc.ack_start_batch(acks)))

    def _handle_stop_epoch_batch(self, sender: int, b: dict) -> None:
        acks = []
        now = time.time()
        for nm, epoch in b["items"]:
            done = self.coordinator.stopped_state(nm)
            if done is not None and done[0] >= epoch:
                acks.append([nm, done[0], b64e(done[1])])
                continue
            meta = self._group(nm)
            if meta is None or meta.version > epoch:
                acks.append([nm, epoch, ""])
                continue
            prev = self._pending_stops.get(nm)
            if prev is not None and prev[0] >= epoch and \
                    now - prev[2] < 2.0:
                self._pending_stops[nm] = (prev[0], sender, prev[2])
                continue  # in flight: don't re-inject on retry waves
            # only the group's boot coordinator injects on first sight:
            # every member proposing the same stop triples the request
            # traffic (two of three are dedup-dropped at the
            # coordinator, but only after riding the per-object slow
            # path).  Non-preferred members record the pending stop and
            # inject only if it is still unexecuted ~2s later — the
            # dead-coordinator fallback, reached via the RC re-drive
            # waves.
            preferred = meta.members[meta.gkey % len(meta.members)] \
                == self.node.id
            if prev is None and not preferred:
                self._pending_stops[nm] = (epoch, sender, now)
                continue
            self._pending_stops[nm] = (epoch, sender, now)
            self.node._inq.put(pkt.Request(
                self.id, meta.gkey, stop_req_id(nm, epoch), FLAG_STOP,
                b""))
        if acks:
            self.node._route(sender, pkt.Control(
                self.id, rc.ack_stop_batch(acks)))

    def _handle_drop_epoch_batch(self, sender: int, b: dict) -> None:
        gone = []
        for nm, epoch in b["items"]:
            meta = self._group(nm)
            if meta is not None and meta.version <= epoch:
                gone.append(nm)
            self._pending_stops.pop(nm, None)
        if gone:
            self.coordinator.delete_replica_groups(gone)

    # -- periodic (worker thread) ------------------------------------------

    def _tick(self) -> None:
        # answer pending stops whose stop request has now executed; acks
        # batch per destination reconfigurator (the churn path).
        # Event-driven: only names whose stop executed since the last
        # tick are examined — a full _pending_stops scan per tick was
        # O(pending) per worker batch and went quadratic under delete
        # waves.  A stop that executes before its StopEpoch arrives is
        # covered by _handle_stop_epoch's stopped_state() check.
        ack_by_dst: Dict[int, list] = {}
        for name in self.coordinator.drain_newly_stopped():
            ent = self._pending_stops.get(name)
            if ent is None:
                continue
            epoch, sender, _ts = ent
            done = self.coordinator.stopped_state(name)
            if done is not None and done[0] >= epoch:
                del self._pending_stops[name]
                ack_by_dst.setdefault(sender, []).append(
                    [name, done[0], b64e(done[1])])
        for dst, items in ack_by_dst.items():
            if len(items) == 1:
                self.node._route(dst, pkt.Control(self.id, rc.ack_stop(
                    items[0][0], items[0][1], items[0][2])))
            else:
                self.node._route(dst, pkt.Control(
                    self.id, rc.ack_stop_batch(items)))
        # demand reporting (ref: DemandReport via AggregateDemandProfiler)
        for name, cnt in self.coordinator.drain_demand().items():
            self._demand_acc[name] = self._demand_acc.get(name, 0) + cnt
        ready = {n: c for n, c in self._demand_acc.items()
                 if c >= self.demand_report_every}
        if ready and self.reconfigurators:
            for n in ready:
                del self._demand_acc[n]
            dst = self.reconfigurators[self.id % len(self.reconfigurators)]
            self.node._route(dst, pkt.Control(self.id, rc.demand(ready)))
