"""Replicated reconfigurator record store.

The port's own copy of ``gigapaxos_tpu/reconfiguration/rcdb.py`` (pure
Python, unchanged but for its imports).

Reference analog: ``reconfiguration/SQLReconfiguratorDB.java`` +
``AbstractReconfiguratorDB`` + ``RepliconfigurableReconfiguratorDB`` — the
durable name→record map (epoch, state, actives) that is *itself replicated
via paxos among the reconfigurators* (SURVEY.md §3.4 "layered
re-entrancy").  Here the store is a :class:`Replicable` app executed inside
the reconfigurators' own RC paxos groups on the same columnar engine, so
durability and replication come from L2/L3 for free (WAL + checkpoints).

Epoch FSM states (ref: ``RCStates``)::

    (none) --create--> WAIT_ACK_START --ready--> READY
    READY  --delete--> WAIT_ACK_STOP(del)  --dropped--> (none)
    READY  --move----> WAIT_ACK_STOP(move) --start_next--> WAIT_ACK_START
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional

from gigapaxos_tpu_torch.paxos.interfaces import Replicable

READY = "READY"
WAIT_ACK_START = "WAIT_ACK_START"
WAIT_ACK_STOP = "WAIT_ACK_STOP"


@dataclass
class RCRecord:
    """One service name's control record (ref: ``ReconfigurationRecord``)."""

    name: str
    epoch: int
    state: str
    actives: List[int]
    new_actives: List[int] = field(default_factory=list)
    prev_actives: List[int] = field(default_factory=list)  # for drop at READY
    init_b64: str = ""        # initial/epoch-start state until READY
    deleting: bool = False

    def to_json(self) -> dict:
        # hand-rolled: dataclasses.asdict recurses via deep-copy helpers
        # (~15 internal calls per record) and dominated the churn
        # profile; every field here is a flat scalar or int list
        return {"name": self.name, "epoch": self.epoch,
                "state": self.state, "actives": list(self.actives),
                "new_actives": list(self.new_actives),
                "prev_actives": list(self.prev_actives),
                "init_b64": self.init_b64, "deleting": self.deleting}

    @classmethod
    def from_json(cls, d: dict) -> "RCRecord":
        return cls(**d)


# drift guard: the hand-rolled to_json must cover every dataclass field
# — a field added later but missed there would serialize fine and then
# silently restore to its default across checkpoint/restore
assert (set(RCRecord("", 0, "", []).to_json())
        == {f.name for f in fields(RCRecord)}), \
    "RCRecord.to_json out of sync with its fields"


class ReconfiguratorDB(Replicable):
    """The Replicable app run by RC paxos groups.  One records-dict per RC
    group name; commands are deterministic JSON ops.  ``on_commit`` fires
    after every applied op (on the RC node's worker thread) so the
    :class:`Reconfigurator` can drive epoch side effects."""

    def __init__(self) -> None:
        self.groups: Dict[str, Dict[str, RCRecord]] = {}
        self.on_commit: Optional[Callable[[str, dict, Optional[RCRecord]],
                                          None]] = None

    # -- Replicable --------------------------------------------------------

    def execute(self, name: str, req_id: int, payload: bytes,
                is_stop: bool = False) -> bytes:
        recs = self.groups.setdefault(name, {})
        if not payload:
            return b""
        cmd = json.loads(payload.decode())
        rec = self._apply(recs, cmd)
        if self.on_commit is not None:
            self.on_commit(name, cmd, rec)
        return json.dumps({"ok": rec is not None}).encode()

    def _apply(self, recs: Dict[str, RCRecord], cmd: dict
               ) -> Optional[RCRecord]:
        """Deterministic FSM transition; returns the (possibly removed)
        record on success, None if the op was stale/invalid (idempotence:
        duplicate proposals from multiple reconfigurators are no-ops)."""
        op = cmd["op"]
        if op.endswith("_batch"):
            return self._apply_batch(recs, op, cmd)
        n = cmd["name"]
        rec = recs.get(n)
        if op == "create":
            if rec is not None:
                return None
            rec = recs[n] = RCRecord(
                n, 0, WAIT_ACK_START, list(cmd["actives"]),
                list(cmd["actives"]), cmd.get("init", ""))
            return rec
        if rec is None:
            return None
        if op == "ready":
            if rec.state != WAIT_ACK_START or rec.epoch != cmd["epoch"]:
                return None
            rec.state = READY
            rec.actives = list(rec.new_actives)
            rec.init_b64 = ""
            return rec
        if op == "delete":
            if rec.state != READY:
                return None
            rec.state = WAIT_ACK_STOP
            rec.deleting = True
            return rec
        if op == "move":
            if rec.state != READY:
                return None
            rec.state = WAIT_ACK_STOP
            rec.new_actives = list(cmd["new_actives"])
            return rec
        if op == "start_next":
            # stop phase done (move): begin the next epoch on new actives
            if rec.state != WAIT_ACK_STOP or rec.deleting:
                return None
            rec.prev_actives = list(rec.actives)
            rec.epoch += 1
            rec.state = WAIT_ACK_START
            rec.init_b64 = cmd.get("init", "")
            return rec
        if op == "dropped":
            # stop phase done (delete): remove the record
            if rec.state != WAIT_ACK_STOP or not rec.deleting:
                return None
            return recs.pop(n)
        return None

    def _apply_batch(self, recs: Dict[str, RCRecord], op: str, cmd: dict
                     ) -> Optional[List[RCRecord]]:
        """Batched FSM transitions (ref: batched CreateServiceName):
        per-name semantics identical to the single ops; returns the list
        of records that transitioned (None if none did)."""
        out: List[RCRecord] = []
        if op == "create_batch":
            for nm, actives, init in cmd["items"]:
                if nm in recs:
                    continue
                out.append(recs.setdefault(nm, RCRecord(
                    nm, 0, WAIT_ACK_START, list(actives), list(actives),
                    init)))
        elif op == "ready_batch":
            for nm, epoch in cmd["items"]:
                r = recs.get(nm)
                if r is None or r.state != WAIT_ACK_START or \
                        r.epoch != epoch:
                    continue
                r.state = READY
                r.actives = list(r.new_actives)
                r.init_b64 = ""
                out.append(r)
        elif op == "delete_batch":
            for nm in cmd["names"]:
                r = recs.get(nm)
                if r is None or r.state != READY:
                    continue
                r.state = WAIT_ACK_STOP
                r.deleting = True
                out.append(r)
        elif op == "dropped_batch":
            for nm in cmd["names"]:
                r = recs.get(nm)
                if r is None or r.state != WAIT_ACK_STOP or not r.deleting:
                    continue
                out.append(recs.pop(nm))
        return out or None

    def checkpoint(self, name: str) -> bytes:
        recs = self.groups.get(name, {})
        return json.dumps({k: r.to_json() for k, r in
                           sorted(recs.items())}).encode()

    def restore(self, name: str, state: bytes) -> bool:
        if not state:
            self.groups[name] = {}
            return True
        self.groups[name] = {
            k: RCRecord.from_json(d)
            for k, d in json.loads(state.decode()).items()}
        return True

    # -- read side (committed view) ---------------------------------------

    def lookup(self, rc_group: str, name: str) -> Optional[RCRecord]:
        return self.groups.get(rc_group, {}).get(name)


def b64e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def b64d(s: str) -> bytes:
    return base64.b64decode(s) if s else b""
