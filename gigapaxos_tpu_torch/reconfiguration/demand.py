"""Demand-driven placement profiles.

The port's own copy of ``gigapaxos_tpu/reconfiguration/demand.py`` (pure
Python, unchanged but for its imports).

Reference analog: ``reconfiguration/reconfigurationutils/
AbstractDemandProfile.java`` (the pluggable policy SPI) and
``DemandProfile.java`` (the bundled default) + ``AggregateDemandProfiler``
(per-name aggregation).  Actives report per-name request counts
(``DemandReport``); the record's owning reconfigurator aggregates them
and asks the profile whether (and where) to move the name.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional


class AbstractDemandProfile(abc.ABC):
    """Aggregates demand reports for names owned by this reconfigurator
    and decides placement.  Methods run on the reconfigurator's worker
    thread — no locking needed."""

    @abc.abstractmethod
    def register(self, name: str, active: int, count: int) -> None:
        """Fold one report: ``active`` handled ``count`` more requests
        for ``name``."""

    @abc.abstractmethod
    def should_reconfigure(self, name: str, current: List[int],
                           all_actives: List[int]
                           ) -> Optional[List[int]]:
        """Return the new active set (a move is proposed and the name's
        aggregates reset), or None to leave placement alone."""

    def clear(self, name: str) -> None:
        """Drop ``name``'s aggregates (no placement change happened)."""

    def on_moved(self, name: str) -> None:
        """A move for ``name`` was proposed; default: drop aggregates."""
        self.clear(name)


class LocalityDemandProfile(AbstractDemandProfile):
    """The bundled default (ref: ``DemandProfile``): after a name has
    seen ``threshold`` reported requests, place its replicas on the
    actives that reported the most traffic for it — "replicas follow
    demand".  Ties and missing reporters fill from the current set, so
    a move is proposed only when the top reporters actually differ.
    """

    def __init__(self, threshold: int = 1000):
        self.threshold = threshold
        self._per: Dict[str, Dict[int, int]] = {}  # name -> active -> n
        self._total: Dict[str, int] = {}

    def register(self, name: str, active: int, count: int) -> None:
        d = self._per.setdefault(name, {})
        d[active] = d.get(active, 0) + count
        self._total[name] = self._total.get(name, 0) + count

    def should_reconfigure(self, name, current, all_actives):
        if self._total.get(name, 0) < self.threshold:
            return None
        k = len(current)
        per = self._per.get(name, {})
        ranked = sorted((a for a in per if a in all_actives),
                        key=lambda a: (-per[a], a))
        new = ranked[:k]
        for a in sorted(current):  # fill from current, stable
            if len(new) >= k:
                break
            if a not in new:
                new.append(a)
        for a in sorted(all_actives):  # then from anywhere
            if len(new) >= k:
                break
            if a not in new:
                new.append(a)
        if sorted(new) == sorted(current):
            self.clear(name)  # demand already matches placement
            return None
        return new

    def clear(self, name: str) -> None:
        self._per.pop(name, None)
        self._total.pop(name, None)


class LoadBalancingDemandProfile(AbstractDemandProfile):
    """Spread hot names: once a name crosses ``threshold`` reported
    requests, move it onto the ``k`` least-loaded actives (load = total
    reported requests per active across all names this reconfigurator
    owns).  Useful when entry traffic concentrates on few actives;
    complements :class:`LocalityDemandProfile`, which is only effective
    when reports arrive from non-member entry points."""

    def __init__(self, threshold: int = 1000, decay: float = 0.5):
        self.threshold = threshold
        self.decay = decay  # applied to per-active load after each move
        self._total: Dict[str, int] = {}
        self._load: Dict[int, int] = {}

    def register(self, name: str, active: int, count: int) -> None:
        self._total[name] = self._total.get(name, 0) + count
        self._load[active] = self._load.get(active, 0) + count

    def should_reconfigure(self, name, current, all_actives):
        if self._total.get(name, 0) < self.threshold:
            return None
        k = len(current)
        ranked = sorted(all_actives,
                        key=lambda a: (self._load.get(a, 0), a))
        new = ranked[:k]
        if sorted(new) == sorted(current):
            self.clear(name)
            return None
        return new

    def clear(self, name: str) -> None:
        self._total.pop(name, None)

    def on_moved(self, name: str) -> None:
        self.clear(name)
        # decay ONLY after an actual move, so one hot burst doesn't pin
        # future placement forever; matching-placement clears must not
        # erode the load signal
        self._load = {a: int(v * self.decay)
                      for a, v in self._load.items()}
