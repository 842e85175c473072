"""App-callback boundary: the ``Replicable`` SPI.

Reference analog: ``gigapaxos/interfaces/Replicable.java`` — ``boolean
execute(Request)``, ``String checkpoint(String name)``, ``boolean
restore(String name, String state)`` — the black-box RSM contract
everything above L2 programs against (SURVEY.md §1 "key boundary").

TPU-native adjustment: ``execute`` is invoked with *batches implicitly* (the
runtime executes decided slots in order per group, many groups per kernel
batch), but the per-call semantics are identical: in-order, exactly-once
per (group, slot), with ``checkpoint``/``restore`` cutting the log.
State is ``bytes`` (not Java String) — payloads on the wire are bytes.
"""

from __future__ import annotations

import abc
import json
import threading
from typing import Dict, Optional


class Replicable(abc.ABC):
    """The replicated-state-machine callback boundary."""

    @abc.abstractmethod
    def execute(self, name: str, req_id: int, payload: bytes,
                is_stop: bool = False) -> bytes:
        """Apply one decided request to group ``name``'s state; returns the
        response bytes for the requesting client.  Must be deterministic.
        ``is_stop`` marks the group's end-of-epoch request (reconfiguration);
        apps that don't reconfigure can ignore it."""

    @abc.abstractmethod
    def checkpoint(self, name: str) -> bytes:
        """Serialize group ``name``'s current state."""

    @abc.abstractmethod
    def restore(self, name: str, state: bytes) -> bool:
        """Reset group ``name``'s state to ``state`` (b"" = initial)."""


class NoopApp(Replicable):
    """The benchmark app (ref: ``gigapaxos/examples/NoopPaxosApp.java``):
    execution is a no-op, checkpoint is a constant — isolates consensus
    throughput from app cost."""

    def execute(self, name, req_id, payload, is_stop=False) -> bytes:
        return payload

    def checkpoint(self, name) -> bytes:
        return b"noop"

    def restore(self, name, state) -> bool:
        return True


class CounterApp(Replicable):
    """Deterministic test app: per-group counter + xor-digest of executed
    requests — execution-order divergence between replicas changes the
    digest, making safety violations visible in tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count: Dict[str, int] = {}
        self.digest: Dict[str, int] = {}

    def execute(self, name, req_id, payload, is_stop=False) -> bytes:
        with self._lock:
            c = self.count.get(name, 0) + 1
            self.count[name] = c
            d = self.digest.get(name, 0)
            # order-sensitive mix (not commutative)
            d = ((d * 1000003) ^ req_id) & 0xFFFFFFFFFFFFFFFF
            self.digest[name] = d
            return json.dumps({"count": c, "digest": d}).encode()

    def checkpoint(self, name) -> bytes:
        with self._lock:
            return json.dumps({"count": self.count.get(name, 0),
                               "digest": self.digest.get(name, 0)}).encode()

    def restore(self, name, state) -> bool:
        with self._lock:
            if not state:
                self.count.pop(name, None)
                self.digest.pop(name, None)
                return True
            d = json.loads(state.decode())
            self.count[name] = d["count"]
            self.digest[name] = d["digest"]
            return True


class KVApp(Replicable):
    """A small real app: per-group key-value store with GET/PUT/CAS —
    the tutorial-app analog (ref: upstream examples)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stores: Dict[str, Dict[str, str]] = {}

    def execute(self, name, req_id, payload, is_stop=False) -> bytes:
        try:
            cmd = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return b'{"err":"bad request"}'
        with self._lock:
            store = self.stores.setdefault(name, {})
            op = cmd.get("op")
            k = cmd.get("k", "")
            if op == "put":
                store[k] = cmd.get("v", "")
                return b'{"ok":true}'
            if op == "get":
                v = store.get(k)
                return json.dumps({"ok": True, "v": v}).encode()
            if op == "cas":
                if store.get(k) == cmd.get("old"):
                    store[k] = cmd.get("v", "")
                    return b'{"ok":true}'
                return b'{"ok":false}'
            return b'{"err":"bad op"}'

    def checkpoint(self, name) -> bytes:
        with self._lock:
            return json.dumps(self.stores.get(name, {}),
                              sort_keys=True).encode()

    def restore(self, name, state) -> bool:
        with self._lock:
            if not state:
                self.stores.pop(name, None)
            else:
                self.stores[name] = json.loads(state.decode())
            return True
