"""Reconfigurator: the control-plane brain.

The port's own copy of ``gigapaxos_tpu/reconfiguration/reconfigurator.py``,
with one repair (ROADMAP §3): the deactivator never pauses the record
groups, whose records this class reads from memory.

Reference analog: ``reconfiguration/Reconfigurator.java`` — handles
``CreateServiceName`` / ``DeleteServiceName`` / ``RequestActiveReplicas`` /
``DemandReport``; drives the epoch FSM by committing record ops into *its
own RC paxos groups* (ref ``RCRecordRequest``), then emitting
``StartEpoch``/``StopEpoch``/``DropEpochFinalState`` to actives.

Design mapping (SURVEY.md §3.4): every RC node executes every committed
record op of the groups it belongs to (the engine replicates the
:class:`ReconfiguratorDB`), so epoch side effects are emitted *by all group
members idempotently* — acks dedupe at the actives, and FSM transitions
dedupe in the DB (stale ops are no-ops).  This removes the reference's
"responsible reconfigurator + backup timeout" complexity with no loss of
fault tolerance: any surviving member completes any in-flight epoch change.

RC group layout: one group per reconfigurator, ``_RC_<id>``, with
``k`` consecutive members in sorted-id order; a name's record lives in the
group of its consistent-hash owner (ref: ``ConsistentHashing`` of names
onto reconfigurator groups).
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.reconfiguration import rcpackets as rc
from gigapaxos_tpu_torch.reconfiguration.consistenthash import \
    ConsistentHashing
from gigapaxos_tpu_torch.reconfiguration.demand import AbstractDemandProfile
from gigapaxos_tpu_torch.reconfiguration.rcdb import (READY, WAIT_ACK_START,
                                                      WAIT_ACK_STOP, RCRecord,
                                                      ReconfiguratorDB)
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.rc")

# demand-profile SPI (ref: reconfigurationutils/AbstractDemandProfile):
# (name, total_request_count, current_actives, all_actives) -> new actives
# or None to leave placement alone
DemandPolicy = Callable[[str, int, List[int], List[int]], Optional[List[int]]]


class Reconfigurator:
    """One reconfigurator node."""

    def __init__(self, node_id: int, addr_map: Dict[int, Tuple[str, int]],
                 reconfigurators: Tuple[int, ...],
                 actives: Tuple[int, ...], logdir: str,
                 actives_per_name: int = 3, rc_group_size: int = 3,
                 demand_policy: Optional[DemandPolicy] = None, **node_kw):
        self.id = node_id
        self.rcs = tuple(sorted(reconfigurators))
        self.actives = tuple(sorted(actives))
        self.k_active = min(actives_per_name, len(self.actives))
        self.k_rc = min(rc_group_size, len(self.rcs))
        self.ch_rc = ConsistentHashing(self.rcs)
        self.ch_active = ConsistentHashing(self.actives)
        self.db = ReconfiguratorDB()
        self.db.on_commit = self._on_commit
        self.node = PaxosNode(node_id, addr_map, self.db, logdir, **node_kw)
        # the deactivator never pauses the record groups: a paused group's
        # app state leaves memory (ReconfiguratorDB.restore(g, b"")), and
        # this class reads its records straight from self.db, where they
        # would read as absent (a delete then acknowledges names whose
        # epochs were never dropped).  There are only a handful of them.
        self.node.pause_idle_s = 0.0
        self.node.register_handler(pkt.Control, self._on_control)
        self.node.add_tick_hook(self._tick)
        self._seq = itertools.count(1)
        # name -> [(rid, client, kind)] awaiting a terminal transition
        self._pending: Dict[str, List[Tuple[int, int, str]]] = {}
        self._relay: Dict[int, int] = {}          # rid -> original client
        # batched name ops: rid -> {"client", "left": set(names), "ts",
        # "n_total", "n_done"}; (name, kind) -> [rids] reverse index
        # (kind keyed: a delete batch waiting on a name mid-create must
        # not be credited by the create's READY transition; a LIST
        # because concurrent clients can batch the same name)
        self._batches: Dict[int, dict] = {}
        self._batch_of: Dict[Tuple[str, str], List[int]] = {}
        # batch-relay aggregation: parent rid -> {"client", "subs": set,
        # "n_ok", "n_total", "ts"}
        self._agg: Dict[int, dict] = {}
        self._sub_parent: Dict[int, int] = {}
        self._acks_start: Dict[Tuple[str, int], Set[int]] = {}
        self._final: Dict[Tuple[str, int], str] = {}   # epoch final states
        self._demand: Dict[str, int] = {}
        self.demand_policy = demand_policy
        self._last_retry = 0.0
        # re-drive backoff clocks: (name, state, epoch) -> (due,
        # attempts), rebuilt by every _tick pass (analysis `lazy-init`
        # rule: eagerly initialized so the first tick and every later
        # tick share one state machine)
        self._state_ts: Dict[tuple, tuple] = {}
        from gigapaxos_tpu_torch.reconfiguration.rcconfig import RC
        from gigapaxos_tpu_torch.utils.config import Config as _C
        self.retry_s = float(_C.get(RC.RETRY_S))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.node.start()
        # deterministic boot creates (idempotent vs recovery; every member
        # creates its copy, like actives do on StartEpoch)
        for g in self.my_groups():
            self.node.create_group(g, self.group_members(g), version=0)
            # proactive anti-entropy for OUR record groups (there are
            # only a handful): ops committed while this node was down
            # would otherwise only arrive lazily with the next decision
            # in each group — pull them now so recovered reconfigurators
            # serve current records immediately
            meta = self.node.table.by_name(g)
            if meta is not None:
                self.node._sync_if_gap(meta.row)

    def stop(self) -> None:
        self.node.stop()

    @property
    def port(self) -> int:
        return self.node.port

    # -- RC group layout ---------------------------------------------------

    def group_of(self, name: str) -> str:
        return f"_RC_{self.ch_rc.server(name)}"

    def group_members(self, rc_group: str) -> Tuple[int, ...]:
        owner = int(rc_group.rsplit("_", 1)[1])
        i = self.rcs.index(owner)
        return tuple(self.rcs[(i + j) % len(self.rcs)]
                     for j in range(self.k_rc))

    def my_groups(self) -> List[str]:
        return [f"_RC_{x}" for x in self.rcs
                if self.id in self.group_members(f"_RC_{x}")]

    def _live_member(self, rc_group: str) -> int:
        """First group member not currently suspected dead (fall back to
        the first member if all are suspect)."""
        now = time.time()
        members = self.group_members(rc_group)
        for m in members:
            heard = self.node._last_heard.get(m)
            if heard is None or now - heard <= self.node.failure_timeout:
                return m
        return members[0]

    # -- proposing record ops into our own engine --------------------------

    def _propose(self, rc_group: str, cmd: dict) -> None:
        req_id = (self.id << 32) | next(self._seq)
        self.node._inq.put(pkt.Request(
            self.id, pkt.group_key(rc_group), req_id, 0,
            json.dumps(cmd, separators=(",", ":")).encode()))

    # -- client/active control traffic (worker thread) ---------------------

    def _on_control(self, o: pkt.Control) -> None:
        import time as _time

        from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
        _t0 = _time.monotonic()
        _c0 = _time.thread_time()
        try:
            self._on_control_inner(o)
        finally:
            DelayProfiler.update_total(
                f"w.rc.{o.body.get('rc')}", _t0, cpu_t0=_c0)

    def _on_control_inner(self, o: pkt.Control) -> None:
        b = o.body
        t = b.get("rc")
        if t in (rc.CREATE_NAME, rc.DELETE_NAME, rc.REQ_ACTIVES,
                 rc.MOVE_NAME):
            self._client_op(o.sender, t, b)
        elif t in (rc.CREATE_BATCH, rc.DELETE_BATCH):
            self._client_batch(o.sender, t, b)
        elif t == rc.REPLY and b.get("rid") in self._sub_parent:
            self._on_sub_reply(b)
        elif t == rc.REPLY and b.get("rid") in self._relay:
            self.node._route(self._relay.pop(b["rid"])[0],
                             pkt.Control(self.id, b))
        elif t == rc.ACK_START:
            self._on_ack_start(o.sender, b)
        elif t == rc.ACK_START_BATCH:
            self._on_ack_start_batch(o.sender, b)
        elif t == rc.ACK_STOP:
            self._on_ack_stop(o.sender, b)
        elif t == rc.ACK_STOP_BATCH:
            self._on_ack_stop_batch(o.sender, b)
        elif t == rc.ACK_DROP:
            pass
        elif t == rc.DEMAND:
            self._on_demand(o.sender, b)
        elif t == rc.ECHO:
            self.node._route(o.sender, pkt.Control(self.id, b))
        else:
            log.warning("rc %d: unexpected control %r", self.id, t)

    def _client_op(self, sender: int, t: str, b: dict) -> None:
        name, rid = b["name"], b["rid"]
        grp = self.group_of(name)
        if self.id not in self.group_members(grp):
            # not our record: relay to a live member of the owning group
            # (ref: reconfigurator forwarding), remember who to answer
            self._relay[rid] = (sender, time.time())
            self.node._route(self._live_member(grp),
                             pkt.Control(self.id, b))
            return
        rec = self.db.lookup(grp, name)
        if t == rc.REQ_ACTIVES:
            if rec is None:
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, False, err="nonexistent")))
            else:
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, True, rec.actives)))
            return
        if t == rc.CREATE_NAME:
            if rec is not None and rec.state == READY:
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, True, rec.actives)))
                return
            self._pending.setdefault(name, []).append(
                (rid, sender, "create", b, time.time()))
            if rec is None:
                self._propose(grp, {
                    "op": "create", "name": name,
                    "actives": self.ch_active.replicated_servers(
                        name, self.k_active),
                    "init": b.get("init", "")})
            return
        if t == rc.DELETE_NAME:
            if rec is None:
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, False, err="nonexistent")))
                return
            self._pending.setdefault(name, []).append(
                (rid, sender, "delete", b, time.time()))
            if rec.state == READY:
                self._propose(grp, {"op": "delete", "name": name})
            return
        if t == rc.MOVE_NAME:
            if rec is None or rec.state != READY:
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, False, err="not-ready")))
                return
            bad = set(b["new_actives"]) - set(self.actives)
            if bad or not b["new_actives"]:
                # reject unknown/empty targets up front — once committed,
                # an unreachable active set would wedge WAIT_ACK_START
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, False,
                                      err=f"bad actives: {sorted(bad)}")))
                return
            if sorted(b["new_actives"]) == sorted(rec.actives):
                self.node._route(sender, pkt.Control(
                    self.id, rc.reply(rid, True, rec.actives)))
                return
            self._pending.setdefault(name, []).append(
                (rid, sender, "move", b, time.time()))
            self._propose(grp, {"op": "move", "name": name,
                                "new_actives": list(b["new_actives"])})

    # -- batched name ops (ref: batched CreateServiceName) -----------------

    def _client_batch(self, sender: int, t: str, b: dict) -> None:
        """CREATE_BATCH / DELETE_BATCH: bucket names by owning RC group,
        run owned buckets through one proposed batch op each, relay
        foreign buckets to their owners as sub-batches and aggregate the
        replies for the client."""
        rid = b["rid"]
        now = time.time()
        if t == rc.CREATE_BATCH:
            by_grp: Dict[str, list] = {}
            for nm, init in b["items"]:
                by_grp.setdefault(self.group_of(nm), []).append((nm, init))
        else:
            by_grp = {}
            for nm in b["names"]:
                by_grp.setdefault(self.group_of(nm), []).append(nm)
        if not by_grp:  # empty batch: trivially complete
            self.node._route(sender, pkt.Control(
                self.id, rc.reply_batch(rid, 0, 0)))
            return
        agg = {"client": sender, "subs": set(), "n_ok": 0,
               "n_total": sum(len(v) for v in by_grp.values()),
               "ts": now}
        self._agg[rid] = agg
        for grp, items in by_grp.items():
            sub_rid = (self.id << 32) | next(self._seq)
            agg["subs"].add(sub_rid)
            self._sub_parent[sub_rid] = rid
            if self.id in self.group_members(grp):
                self._local_batch(grp, t, items, sub_rid, self.id)
            else:
                body = rc.create_batch(items, sub_rid) \
                    if t == rc.CREATE_BATCH \
                    else rc.delete_batch(items, sub_rid)
                self.node._route(self._live_member(grp),
                                 pkt.Control(self.id, body))

    def _local_batch(self, grp: str, t: str, items: list, rid: int,
                     client: int) -> None:
        """One owned bucket: register completion tracking and propose the
        batch FSM op.  Names already in the target state count done."""
        now = time.time()
        if t == rc.CREATE_BATCH:
            todo, done = [], 0
            left = set()
            for nm, init in items:
                rec = self.db.lookup(grp, nm)
                if rec is not None and rec.state == READY:
                    done += 1
                    continue
                left.add(nm)
                self._batch_of.setdefault((nm, "create"), []).append(rid)
                if rec is None:
                    todo.append([nm, self.ch_active.replicated_servers(
                        nm, self.k_active), init])
            self._batches[rid] = {"client": client, "left": left,
                                  "ts": now, "n_total": len(items),
                                  "n_done": done, "kind": "create",
                                  "grp": grp}
            if todo:
                self._propose(grp, {"op": "create_batch", "items": todo})
            self._maybe_finish_batch(rid)
        else:
            todo2, done = [], 0
            left = set()
            for nm in items:
                rec = self.db.lookup(grp, nm)
                if rec is None:
                    done += 1  # already gone: delete is idempotent-ok
                    continue
                left.add(nm)
                self._batch_of.setdefault((nm, "delete"), []).append(rid)
                if rec.state == READY:
                    todo2.append(nm)
            self._batches[rid] = {"client": client, "left": left,
                                  "ts": now, "n_total": len(items),
                                  "n_done": done, "kind": "delete",
                                  "grp": grp}
            if todo2:
                self._propose(grp, {"op": "delete_batch", "names": todo2})
            self._maybe_finish_batch(rid)

    def _batch_name_done(self, name: str, kind: str) -> None:
        rids = self._batch_of.pop((name, kind), None)
        if kind == "create":
            # a delete batch pended while this name was mid-create can
            # proceed now that the record is READY
            if self._batch_of.get((name, "delete")):
                self._propose(self.group_of(name),
                              {"op": "delete", "name": name})
        for rid in rids or ():
            batch = self._batches.get(rid)
            if batch is None:
                continue
            if name in batch["left"]:
                batch["left"].discard(name)
                batch["n_done"] += 1
                self._maybe_finish_batch(rid)

    def _maybe_finish_batch(self, rid: int) -> None:
        batch = self._batches.get(rid)
        if batch is None or batch["left"]:
            return
        del self._batches[rid]
        self.node._route(batch["client"], pkt.Control(
            self.id, rc.reply_batch(rid, batch["n_done"],
                                    batch["n_total"])))

    def _on_sub_reply(self, b: dict) -> None:
        """A relayed sub-batch completed at its owner: fold into the
        parent aggregate; reply to the client when all buckets land."""
        sub = b["rid"]
        parent = self._sub_parent.pop(sub, None)
        if parent is None:
            return
        agg = self._agg.get(parent)
        if agg is None:
            return
        agg["subs"].discard(sub)
        agg["n_ok"] += int(b.get("n_ok", 0))
        if not agg["subs"]:
            del self._agg[parent]
            self.node._route(agg["client"], pkt.Control(
                self.id, rc.reply_batch(parent, agg["n_ok"],
                                        agg["n_total"])))

    def _on_ack_start_batch(self, sender: int, b: dict) -> None:
        ready_by_grp: Dict[str, list] = {}
        for name, epoch in b["items"]:
            rec = self.db.lookup(self.group_of(name), name)
            if rec is None or rec.state != WAIT_ACK_START or \
                    rec.epoch != epoch:
                continue
            acks = self._acks_start.setdefault((name, epoch), set())
            acks.add(sender)
            if len(acks & set(rec.new_actives)) >= \
                    len(rec.new_actives) // 2 + 1:
                ready_by_grp.setdefault(self.group_of(name), []).append(
                    [name, epoch])
        # names that crossed majority in THIS ack wave commit READY
        # together — one RC-paxos round per OWNING group (retry waves
        # mix names from every group this node serves)
        for grp, items in ready_by_grp.items():
            self._propose(grp, {"op": "ready_batch", "items": items})

    def _on_ack_stop_batch(self, sender: int, b: dict) -> None:
        dropped = []
        for name, epoch, final in b["items"]:
            rec = self.db.lookup(self.group_of(name), name)
            if rec is None or rec.state != WAIT_ACK_STOP or \
                    epoch < rec.epoch:
                continue
            if rec.deleting:
                dropped.append(name)
            else:
                # batched acks only drive deletes; moves stay on the
                # single-op path (they carry final state per name)
                if final:
                    self._final[(name, rec.epoch)] = final
                    self._propose(self.group_of(name), {
                        "op": "start_next", "name": name, "init": final})
        by_grp: Dict[str, list] = {}
        for nm in dropped:
            by_grp.setdefault(self.group_of(nm), []).append(nm)
        for grp, names in by_grp.items():
            self._propose(grp, {"op": "dropped_batch", "names": names})

    # -- acks from actives -------------------------------------------------

    def _on_ack_start(self, sender: int, b: dict) -> None:
        name, epoch = b["name"], b["epoch"]
        rec = self.db.lookup(self.group_of(name), name)
        if rec is None or rec.state != WAIT_ACK_START or rec.epoch != epoch:
            return
        acks = self._acks_start.setdefault((name, epoch), set())
        acks.add(sender)
        if len(acks & set(rec.new_actives)) >= \
                len(rec.new_actives) // 2 + 1:
            self._propose(self.group_of(name),
                          {"op": "ready", "name": name, "epoch": epoch})

    def _on_ack_stop(self, sender: int, b: dict) -> None:
        name, epoch = b["name"], b["epoch"]
        rec = self.db.lookup(self.group_of(name), name)
        if rec is None or rec.state != WAIT_ACK_STOP or epoch < rec.epoch:
            return
        if b.get("final"):
            self._final[(name, rec.epoch)] = b["final"]
        final = self._final.get((name, rec.epoch))
        if rec.deleting:
            # one committed-stop ack suffices: the stop was decided by the
            # group itself, so it is durable at a majority already
            self._propose(self.group_of(name),
                          {"op": "dropped", "name": name})
        elif final is not None:
            self._propose(self.group_of(name),
                          {"op": "start_next", "name": name, "init": final})

    def _on_demand(self, sender: int, b: dict) -> None:
        if self.demand_policy is None:
            return
        profile = self.demand_policy \
            if isinstance(self.demand_policy, AbstractDemandProfile) \
            else None
        for name, cnt in b.get("reports", {}).items():
            grp = self.group_of(name)
            if self.id not in self.group_members(grp):
                # not our record: forward the report to the owning group
                # (actives report by active id, not by record owner)
                self.node._route(self._live_member(grp), pkt.Control(
                    sender, rc.demand({name: int(cnt)})))
                continue
            rec = self.db.lookup(grp, name)
            if profile is not None:
                # profile SPI (ref: AbstractDemandProfile.register +
                # shouldReconfigure): per-reporter aggregation
                profile.register(name, sender, int(cnt))
                if rec is None or rec.state != READY:
                    continue
                new = profile.should_reconfigure(
                    name, list(rec.actives), list(self.actives))
            else:
                # legacy callable SPI: (name, total, current, all)
                total = self._demand.get(name, 0) + int(cnt)
                self._demand[name] = total
                if rec is None or rec.state != READY:
                    continue
                new = self.demand_policy(name, total, list(rec.actives),
                                         list(self.actives))
            if new and sorted(new) != sorted(rec.actives):
                if profile is not None:
                    profile.on_moved(name)
                else:
                    self._demand[name] = 0
                self._propose(grp, {"op": "move", "name": name,
                                    "new_actives": list(new)})

    # -- committed-record side effects (worker thread, every member) -------

    def _on_commit(self, rc_group: str, cmd: dict,
                   rec: Optional[RCRecord]) -> None:
        if rec is None:
            return  # stale/duplicate op: first application already acted
        op = cmd["op"]
        if op.endswith("_batch"):
            self._on_commit_batch(op, rec)  # rec is a list here
            return
        name = rec.name
        if op in ("create", "start_next"):
            self._send_start_epoch(rec)
        elif op == "ready":
            self._acks_start.pop((name, rec.epoch), None)
            self._final.pop((name, rec.epoch - 1), None)
            # retire the previous epoch's replicas (ref:
            # DropEpochFinalState after the new epoch is READY)
            for a in rec.prev_actives:
                self.node._route(a, pkt.Control(
                    self.id, rc.drop_epoch(name, rec.epoch - 1)))
            rec.prev_actives = []
            self._flush_pending(name, ("create", "move"), True, rec.actives)
            self._batch_name_done(name, "create")
        elif op in ("delete", "move"):
            self._send_stop_epoch(rec)
        elif op == "dropped":
            for a in rec.actives:
                self.node._route(a, pkt.Control(
                    self.id, rc.drop_epoch(name, rec.epoch)))
            self._final.pop((name, rec.epoch), None)
            self._flush_pending(name, ("delete",), True, [])
            self._batch_name_done(name, "delete")

    def _on_commit_batch(self, op: str, recs: List[RCRecord]) -> None:
        """Side effects of a committed batch FSM op (every RC group
        member runs this idempotently, like the single-op path)."""
        if op == "create_batch":
            # one start_epoch_batch per active carrying all its names
            per_active: Dict[int, list] = {}
            for r in recs:
                for a in r.new_actives:
                    per_active.setdefault(a, []).append(
                        [r.name, r.epoch, r.new_actives, r.init_b64])
            for a, items in per_active.items():
                self.node._route(a, pkt.Control(
                    self.id, rc.start_epoch_batch(items)))
        elif op == "ready_batch":
            for r in recs:
                self._acks_start.pop((r.name, r.epoch), None)
                self._final.pop((r.name, r.epoch - 1), None)
                for a in r.prev_actives:
                    self.node._route(a, pkt.Control(
                        self.id, rc.drop_epoch(r.name, r.epoch - 1)))
                r.prev_actives = []
                self._flush_pending(r.name, ("create", "move"), True,
                                    r.actives)
                self._batch_name_done(r.name, "create")
        elif op == "delete_batch":
            per_active = {}
            for r in recs:
                for a in r.actives:
                    per_active.setdefault(a, []).append([r.name, r.epoch])
            for a, items in per_active.items():
                self.node._route(a, pkt.Control(
                    self.id, rc.stop_epoch_batch(items)))
        elif op == "dropped_batch":
            per_active = {}
            for r in recs:
                for a in r.actives:
                    per_active.setdefault(a, []).append([r.name, r.epoch])
                self._final.pop((r.name, r.epoch), None)
            for a, items in per_active.items():
                self.node._route(a, pkt.Control(
                    self.id, rc.drop_epoch_batch(items)))
            for r in recs:
                self._flush_pending(r.name, ("delete",), True, [])
                self._batch_name_done(r.name, "delete")

    _KIND_TYPE = {"create": rc.CREATE_NAME, "delete": rc.DELETE_NAME,
                  "move": rc.MOVE_NAME}

    def _flush_pending(self, name: str, kinds: Tuple[str, ...], ok: bool,
                       actives: List[int]) -> None:
        left = []
        for rid, client, kind, b, ts in self._pending.pop(name, []):
            if kind in kinds:
                self.node._route(client, pkt.Control(
                    self.id, rc.reply(rid, ok, actives)))
            else:
                left.append((rid, client, kind, b, ts))
        # re-drive ops pended while the record was in a non-matching FSM
        # state (e.g. a DELETE that arrived during WAIT_ACK_START): the
        # flush marks a state transition, so run them through _client_op
        # again — they either proceed now or re-pend for the next one
        for rid, client, kind, b, _ts in left:
            self._client_op(client, self._KIND_TYPE[kind], b)

    def _send_start_epoch(self, rec: RCRecord) -> None:
        for a in rec.new_actives:
            self.node._route(a, pkt.Control(self.id, rc.start_epoch(
                rec.name, rec.epoch, rec.new_actives, rec.init_b64)))

    def _send_stop_epoch(self, rec: RCRecord) -> None:
        for a in rec.actives:
            self.node._route(a, pkt.Control(
                self.id, rc.stop_epoch(rec.name, rec.epoch)))

    # -- retries (worker thread) -------------------------------------------

    def _tick(self) -> None:
        now = time.time()
        if now - self._last_retry < self.retry_s:
            return
        self._last_retry = now
        # GC stale relay entries (client long gone by 60s)
        cutoff = now - 60
        self._relay = {rid: v for rid, v in self._relay.items()
                       if v[1] > cutoff}
        # abandoned client ops (client stopped retrying) must not pin
        # _pending forever
        self._pending = {
            n: kept for n, es in self._pending.items()
            if (kept := [e for e in es if e[4] > cutoff])}
        for rid in [r for r, v in self._batches.items()
                    if v["ts"] < cutoff]:
            batch = self._batches.pop(rid)
            for nm in batch["left"]:
                rids = self._batch_of.get((nm, batch["kind"]))
                if rids and rid in rids:
                    rids.remove(rid)
                    if not rids:
                        del self._batch_of[(nm, batch["kind"])]
        for rid in [r for r, v in self._agg.items() if v["ts"] < cutoff]:
            agg = self._agg.pop(rid)
            for sub in agg["subs"]:
                self._sub_parent.pop(sub, None)
        # BATCHED re-drives: with hundreds of in-flight records (churn
        # batches), per-record singles here would storm the actives with
        # single-op epochs and flood the RC groups' windows with
        # single-name FSM proposals — the very stampede batching exists
        # to avoid
        # age gating: a record is only re-driven after sitting in its
        # WAIT_* state for a full retry period — without this, every
        # in-flight batch gets re-sent every second while it is making
        # normal progress, and the duplicate epochs/stops saturate the
        # actives (measured: 10x churn slowdown)
        start_by_active: Dict[int, list] = {}
        stop_by_active: Dict[int, list] = {}
        state_ts = self._state_ts
        new_ts: Dict[tuple, tuple] = {}
        for grp in self.my_groups():
            for rec in list(self.db.groups.get(grp, {}).values()):
                if rec.state == READY:
                    continue
                key = (rec.name, rec.state, rec.epoch)
                got = state_ts.get(key)
                # exponential backoff per (name, state, epoch): under a
                # large churn backlog a stage legitimately takes longer
                # than one retry period, and flat-period re-drives
                # re-send whole epoch batches every tick — the duplicate
                # work then makes the backlog slower still (measured:
                # 30K-op churn collapsed 20x from the re-drive storm)
                if got is None:
                    got = (now + self.retry_s, 0)
                due, attempts = got
                if now < due:
                    new_ts[key] = got
                    continue  # young: in-flight machinery still working
                attempts += 1
                # exponent capped: attempts grows forever for a record
                # whose active is permanently down, and 2.0**1024
                # overflows — which would abort every future tick
                new_ts[key] = (
                    now + min(self.retry_s * (2.0 ** min(attempts, 8)),
                              30.0),
                    attempts)
                if rec.state == WAIT_ACK_START:
                    for a in rec.new_actives:
                        start_by_active.setdefault(a, []).append(
                            [rec.name, rec.epoch, rec.new_actives,
                             rec.init_b64])
                elif rec.state == WAIT_ACK_STOP:
                    for a in rec.actives:
                        stop_by_active.setdefault(a, []).append(
                            [rec.name, rec.epoch])
        self._state_ts = new_ts  # entries for departed states fall away
        for a, items in start_by_active.items():
            self.node._route(a, pkt.Control(
                self.id, rc.start_epoch_batch(items)))
        for a, items in stop_by_active.items():
            self.node._route(a, pkt.Control(
                self.id, rc.stop_epoch_batch(items)))
