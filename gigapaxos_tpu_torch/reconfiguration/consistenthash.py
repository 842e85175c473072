"""Consistent hashing of names onto node rings.

The port's own copy of ``gigapaxos_tpu/reconfiguration/consistenthash.py``
(pure Python, unchanged but for its imports).

Reference analog: ``reconfiguration/reconfigurationutils/ConsistentHashing.
java`` — maps service names onto (a) the reconfigurator group responsible
for the name's record and (b) the default set of active replicas.  Classic
ring with virtual nodes so that churn in the node set moves few names.
"""

from __future__ import annotations

import bisect
import functools
from typing import List, Sequence, Tuple

# one name-hash primitive for the whole framework (byte order is
# irrelevant for ring placement)
from gigapaxos_tpu_torch.paxos.packets import group_key as _h


class ConsistentHashing:
    """Ring of node ids; ``replicated_servers(name, k)`` returns the k
    distinct successors of hash(name) on the ring."""

    def __init__(self, nodes: Sequence[int], vnodes: int = 64):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, int]] = []  # (point, node)
        self._points: List[int] = []
        self.refresh(nodes)

    def refresh(self, nodes: Sequence[int]) -> None:
        ring = []
        for n in sorted(set(nodes)):
            for v in range(self.vnodes):
                ring.append((_h(f"{n}:{v}"), n))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]
        self._nodes = sorted(set(nodes))
        # placement cache: the FSM asks for the same name's placement at
        # every stage.  A fresh per-instance lru_cache is built here
        # because any ring change can move any name; LRU eviction keeps
        # hot long-lived names when churn floods it.
        self._cached_walk = functools.lru_cache(maxsize=1 << 18)(
            self._ring_walk)

    def _ring_walk(self, name: str, k: int) -> Tuple[int, ...]:
        out: List[int] = []
        i = bisect.bisect(self._points, _h(name))
        n = len(self._ring)
        for step in range(n):
            node = self._ring[(i + step) % n][1]
            if node not in out:
                out.append(node)
                if len(out) == k:
                    break
        return tuple(out)

    def replicated_servers(self, name: str, k: int) -> List[int]:
        """The k distinct nodes clockwise from hash(name)."""
        if not self._ring:
            return []
        return list(self._cached_walk(name, min(k, len(self._nodes))))

    def server(self, name: str) -> int:
        return self.replicated_servers(name, 1)[0]
