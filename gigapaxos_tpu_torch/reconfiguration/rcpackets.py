"""Control-plane packet bodies (ride the generic ``packets.Control`` JSON
envelope).

The port's own copy of ``gigapaxos_tpu/reconfiguration/rcpackets.py``
(pure Python, unchanged but for its imports).

Reference analog: ``reconfiguration/reconfigurationpackets/*`` — the ~15
JSON packet classes.  Mapping (reference → ``body["rc"]``)::

    CreateServiceName      -> create_name      (client → reconfigurator)
    DeleteServiceName      -> delete_name      (client → reconfigurator)
    RequestActiveReplicas  -> req_actives      (client → reconfigurator)
    (move/admin op)        -> move_name        (admin  → reconfigurator)
    ClientReconfigurationPacket response -> reply (reconfigurator → client)
    StartEpoch             -> start_epoch      (reconfigurator → active)
    AckStartEpoch          -> ack_start        (active → reconfigurator)
    StopEpoch              -> stop_epoch       (reconfigurator → active)
    AckStopEpoch + EpochFinalState -> ack_stop (active → reconfigurator;
                                               carries the final state)
    DropEpochFinalState    -> drop_epoch       (reconfigurator → active)
    AckDropEpochFinalState -> ack_drop         (active → reconfigurator)
    DemandReport           -> demand           (active → reconfigurator)
    EchoRequest            -> echo             (any → any)

``RCRecordRequest`` has no wire form here: record-FSM ops are the *paxos
payloads* proposed into RC groups (see ``rcdb.ReconfiguratorDB``), which is
exactly the reference's RCRecordRequest-committed-via-paxos design.
"""

from __future__ import annotations

from typing import Dict, List

CREATE_NAME = "create_name"
DELETE_NAME = "delete_name"
REQ_ACTIVES = "req_actives"
MOVE_NAME = "move_name"
REPLY = "reply"
START_EPOCH = "start_epoch"
ACK_START = "ack_start"
STOP_EPOCH = "stop_epoch"
ACK_STOP = "ack_stop"
DROP_EPOCH = "drop_epoch"
ACK_DROP = "ack_drop"
DEMAND = "demand"
ECHO = "echo"
# batched name ops (ref: ReconfigurationConfig batched creates — the
# 10K-churn configs die on one control round trip + two RC-paxos rounds
# PER NAME; a batch pays them once per few hundred names)
CREATE_BATCH = "create_batch"
DELETE_BATCH = "delete_batch"
START_EPOCH_BATCH = "start_epoch_b"
ACK_START_BATCH = "ack_start_b"
STOP_EPOCH_BATCH = "stop_epoch_b"
ACK_STOP_BATCH = "ack_stop_b"
DROP_EPOCH_BATCH = "drop_epoch_b"


def create_name(name: str, init_b64: str, rid: int) -> dict:
    return {"rc": CREATE_NAME, "name": name, "init": init_b64, "rid": rid}


def delete_name(name: str, rid: int) -> dict:
    return {"rc": DELETE_NAME, "name": name, "rid": rid}


def req_actives(name: str, rid: int) -> dict:
    return {"rc": REQ_ACTIVES, "name": name, "rid": rid}


def move_name(name: str, new_actives: List[int], rid: int) -> dict:
    return {"rc": MOVE_NAME, "name": name, "new_actives": new_actives,
            "rid": rid}


def reply(rid: int, ok: bool, actives: List[int] = (), err: str = "") -> dict:
    return {"rc": REPLY, "rid": rid, "ok": ok, "actives": list(actives),
            "err": err}


def start_epoch(name: str, epoch: int, actives: List[int],
                init_b64: str) -> dict:
    return {"rc": START_EPOCH, "name": name, "epoch": epoch,
            "actives": list(actives), "init": init_b64}


def ack_start(name: str, epoch: int) -> dict:
    return {"rc": ACK_START, "name": name, "epoch": epoch}


def stop_epoch(name: str, epoch: int) -> dict:
    return {"rc": STOP_EPOCH, "name": name, "epoch": epoch}


def ack_stop(name: str, epoch: int, final_b64: str) -> dict:
    return {"rc": ACK_STOP, "name": name, "epoch": epoch,
            "final": final_b64}


def drop_epoch(name: str, epoch: int) -> dict:
    return {"rc": DROP_EPOCH, "name": name, "epoch": epoch}


def ack_drop(name: str, epoch: int) -> dict:
    return {"rc": ACK_DROP, "name": name, "epoch": epoch}


def demand(reports: Dict[str, int]) -> dict:
    return {"rc": DEMAND, "reports": reports}


def create_batch(items: List, rid: int) -> dict:
    """items: [[name, init_b64], ...]"""
    return {"rc": CREATE_BATCH, "items": [list(i) for i in items],
            "rid": rid}


def delete_batch(names: List[str], rid: int) -> dict:
    return {"rc": DELETE_BATCH, "names": list(names), "rid": rid}


def reply_batch(rid: int, n_ok: int, n_total: int) -> dict:
    return {"rc": REPLY, "rid": rid, "ok": n_ok == n_total,
            "n_ok": n_ok, "n_total": n_total}


def start_epoch_batch(items: List) -> dict:
    """items: [[name, epoch, actives, init_b64], ...]"""
    return {"rc": START_EPOCH_BATCH, "items": [list(i) for i in items]}


def ack_start_batch(items: List) -> dict:
    """items: [[name, epoch], ...]"""
    return {"rc": ACK_START_BATCH, "items": [list(i) for i in items]}


def stop_epoch_batch(items: List) -> dict:
    """items: [[name, epoch], ...]"""
    return {"rc": STOP_EPOCH_BATCH, "items": [list(i) for i in items]}


def ack_stop_batch(items: List) -> dict:
    """items: [[name, epoch, final_b64], ...]"""
    return {"rc": ACK_STOP_BATCH, "items": [list(i) for i in items]}


def drop_epoch_batch(items: List) -> dict:
    """items: [[name, epoch], ...]"""
    return {"rc": DROP_EPOCH_BATCH, "items": [list(i) for i in items]}
