"""Replica-coordinator SPI at active replicas.

The port's own copy of ``gigapaxos_tpu/reconfiguration/coordinator.py``
(pure Python, unchanged but for its imports).

Reference analog: ``reconfiguration/AbstractReplicaCoordinator.java`` +
``PaxosReplicaCoordinator.java`` — the layer that wraps the user app as a
``Replicable``, maps replica-group create/delete onto the paxos engine, and
intercepts epoch-stop requests so the active replica can capture the
group's final state.
"""

from __future__ import annotations

import abc
import threading
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.paxos.interfaces import Replicable


class AbstractReplicaCoordinator(abc.ABC):
    """SPI: ``coordinateRequest`` is implicit (requests ride the engine);
    group lifecycle + stop interception are the explicit surface."""

    @abc.abstractmethod
    def create_replica_group(self, name: str, epoch: int,
                             members: Tuple[int, ...],
                             initial_state: bytes) -> bool: ...

    @abc.abstractmethod
    def delete_replica_group(self, name: str) -> bool: ...

    @abc.abstractmethod
    def get_replica_group(self, name: str) -> Optional[Tuple[int, ...]]: ...


class PaxosReplicaCoordinator(AbstractReplicaCoordinator, Replicable):
    """The bundled coordinator: wraps the user app, delegates lifecycle to
    the local :class:`PaxosNode` (set via :meth:`bind`), and captures final
    state when a stop request executes (ref: ``PaxosReplicaCoordinator``'s
    use of ``PaxosManager`` + stoppable app wrappers)."""

    def __init__(self, app: Replicable):
        self.app = app
        self.node = None  # set by bind()
        # name -> (epoch, final_state) captured at stop execution
        self._stopped: Dict[str, Tuple[int, bytes]] = {}
        # stop-execution events since the last drain: lets the active
        # replica ack exactly the names that just stopped instead of
        # rescanning every pending stop per tick (O(pending) per batch
        # went quadratic under churn waves of thousands of deletes)
        self._newly_stopped: List[str] = []
        # names whose current epoch is stopped: reject new requests
        self._lock = threading.Lock()
        self.demand: Dict[str, int] = {}  # name -> request count (demand)

    def bind(self, node) -> None:
        self.node = node

    # -- Replicable (the engine calls us; we call the user app) -----------

    def execute(self, name: str, req_id: int, payload: bytes,
                is_stop: bool = False) -> bytes:
        with self._lock:
            if name in self._stopped:
                return b""  # epoch over: no further mutations
            self.demand[name] = self.demand.get(name, 0) + 1
        if is_stop:
            # the stop request is the epoch's last decided slot: everything
            # before it has executed, so checkpoint() IS the final state
            final = self.app.checkpoint(name)
            meta = self.node.table.by_name(name) if self.node else None
            epoch = meta.version if meta else 0
            with self._lock:
                self._stopped[name] = (epoch, final)
                self._newly_stopped.append(name)
            return b""
        return self.app.execute(name, req_id, payload, False)

    def checkpoint(self, name: str) -> bytes:
        return self.app.checkpoint(name)

    def restore(self, name: str, state: bytes) -> bool:
        return self.app.restore(name, state)

    # -- lifecycle ---------------------------------------------------------

    def create_replica_group(self, name: str, epoch: int,
                             members: Tuple[int, ...],
                             initial_state: bytes) -> bool:
        existing = self.node.table.by_name(name)
        if existing is not None:
            if existing.version >= epoch:
                return True  # idempotent re-create of the same/newer epoch
            # stale prior epoch still present locally: clear it first
            self.node.delete_group(name)
        with self._lock:
            # clear stop state only when actually starting a NEWER epoch —
            # a retried start_epoch(e) arriving after epoch e stopped must
            # not erase the captured final state and re-open the epoch
            st = self._stopped.get(name)
            if st is not None and st[0] < epoch:
                del self._stopped[name]
        return self.node.create_group(name, tuple(members), version=epoch,
                                      initial_state=initial_state)

    def create_replica_groups(self, items) -> int:
        """Batched create (ref: batched CreateServiceName): ``items`` is
        ``[(name, epoch, members, initial_state), ...]``; one engine
        ``create_groups`` call per distinct (epoch, initial_state) class
        — the 10K-churn path.  Returns how many are (now) present."""
        ok = 0
        classes: Dict[Tuple[int, bytes], list] = {}
        for name, epoch, members, init in items:
            existing = self.node.table.by_name(name)
            if existing is not None:
                if existing.version >= epoch:
                    ok += 1
                    continue
                self.node.delete_group(name)
            with self._lock:
                st = self._stopped.get(name)
                if st is not None and st[0] < epoch:
                    del self._stopped[name]
            classes.setdefault((epoch, init), []).append(
                (name, tuple(members)))
        for (epoch, init), batch in classes.items():
            ok += self.node.create_groups(batch, version=epoch,
                                          initial_state=init)
        return ok

    def delete_replica_group(self, name: str) -> bool:
        with self._lock:
            self._stopped.pop(name, None)
        return self.node.delete_group(name)

    def delete_replica_groups(self, names) -> int:
        """Batched delete: one engine ``delete_groups`` call."""
        with self._lock:
            for n in names:
                self._stopped.pop(n, None)
        return self.node.delete_groups(list(names))

    def get_replica_group(self, name: str) -> Optional[Tuple[int, ...]]:
        meta = self.node.table.by_name(name)
        return meta.members if meta else None

    # -- stop state --------------------------------------------------------

    def stopped_state(self, name: str) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            return self._stopped.get(name)

    def drain_newly_stopped(self) -> List[str]:
        """Names whose stop executed since the last call (see field
        comment; consumed by ``ActiveReplica._tick``)."""
        if not self._newly_stopped:
            return []
        with self._lock:
            out, self._newly_stopped = self._newly_stopped, []
            return out

    def drain_demand(self) -> Dict[str, int]:
        with self._lock:
            d = self.demand
            self.demand = {}
            return d
