"""Scalar per-group paxos oracle.

The port's own copy of ``gigapaxos_tpu/ops/oracle.py`` (pure Python,
unchanged but for importing the port's constants).

A deliberately simple, obviously-correct, per-instance implementation of the
same acceptor/coordinator state machine the columnar kernels implement —
the analog of the reference's one-heap-object-per-group
``PaxosAcceptor``/``PaxosCoordinator`` design, and therefore:

1. the *property-test oracle* for the columnar kernels (batch-of-1 streams
   must match exactly; larger batches must preserve safety invariants), and
2. the *scalar AcceptorBackend* — the measured stand-in for the reference's
   per-instance Java hot path in the ≥10× BASELINE comparison.

Message semantics mirror SURVEY.md §3.1/§3.5.  Ballots are packed ints
(see ops.types).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.ops.types import NO_BALLOT, NO_SLOT


@dataclass
class PValue:
    slot: int
    bal: int          # packed ballot
    req_id: int       # 64-bit


@dataclass
class OracleGroup:
    """One paxos group's full (acceptor + coordinator) state."""

    members: int
    window: int
    version: int = 0
    # acceptor
    bal: int = NO_BALLOT                      # promised (packed)
    accepted: Dict[int, PValue] = field(default_factory=dict)  # slot -> pv
    decided: Dict[int, int] = field(default_factory=dict)      # slot -> req
    exec_cursor: int = 0
    gc_slot: int = NO_SLOT
    # coordinator
    is_coord: bool = False
    coord_active: bool = False
    cbal: int = NO_BALLOT
    next_slot: int = 0
    votes: Dict[int, int] = field(default_factory=dict)        # slot -> bitmap
    prop_req: Dict[int, int] = field(default_factory=dict)     # slot -> req
    emitted: Dict[int, bool] = field(default_factory=dict)

    @property
    def majority(self) -> int:
        return self.members // 2 + 1

    # -- acceptor ----------------------------------------------------------

    def accept(self, slot: int, bal: int, req_id: int
               ) -> Tuple[bool, bool, bool, int]:
        """-> (acked, stale, out_window, cur_bal)"""
        stale = slot < self.exec_cursor
        if bal >= self.bal:
            self.bal = bal
        else:
            return False, stale, False, self.bal
        if stale:
            return True, True, False, self.bal
        if slot >= self.exec_cursor + self.window:
            return False, False, True, self.bal
        self.accepted[slot] = PValue(slot, bal, req_id)
        return True, False, False, self.bal

    def prepare(self, bal: int) -> Tuple[bool, int, int, List[PValue]]:
        """-> (acked, cur_bal, exec_cursor, accepted window pvalues)"""
        if bal >= self.bal:
            self.bal = bal
            acked = True
        else:
            acked = False
        window = [pv for s, pv in sorted(self.accepted.items())
                  if s >= self.exec_cursor]
        return acked, self.bal, self.exec_cursor, window

    def commit(self, slot: int, req_id: int) -> Tuple[bool, bool, bool, int]:
        """-> (applied, stale, out_window, new_cursor)"""
        if slot < self.exec_cursor:
            return False, True, False, self.exec_cursor
        if slot >= self.exec_cursor + self.window:
            return False, False, True, self.exec_cursor
        self.decided[slot] = req_id
        while self.exec_cursor in self.decided:
            self.exec_cursor += 1
        return True, False, False, self.exec_cursor

    # -- coordinator -------------------------------------------------------

    def propose(self, req_id: int) -> Tuple[str, int, int]:
        """-> (status in {granted, rejected, throttled}, slot, cbal)"""
        if not (self.is_coord and self.coord_active):
            return "rejected", NO_SLOT, self.cbal
        slot = self.next_slot
        if slot >= self.exec_cursor + self.window:
            return "throttled", NO_SLOT, self.cbal
        self.next_slot += 1
        self.votes[slot] = 0
        self.prop_req[slot] = req_id
        self.emitted[slot] = False
        return "granted", slot, self.cbal

    def accept_reply(self, slot: int, bal: int, sender: int, acked: bool
                     ) -> Tuple[bool, bool, Optional[int]]:
        """-> (newly_decided, preempted, decided_req)"""
        if not acked:
            if self.is_coord and bal > self.cbal:
                self.is_coord = False
                self.coord_active = False
                return False, True, None
            return False, False, None
        if not (self.is_coord and self.coord_active and bal == self.cbal):
            return False, False, None
        if slot not in self.votes:
            return False, False, None
        self.votes[slot] |= 1 << sender
        cnt = bin(self.votes[slot]).count("1")
        if cnt >= self.majority and not self.emitted.get(slot, False):
            self.emitted[slot] = True
            return True, False, self.prop_req[slot]
        return False, False, None

    def install_coordinator(self, cbal: int, next_slot: int,
                            carryover: List[PValue]) -> None:
        self.is_coord = True
        self.coord_active = True
        self.cbal = cbal
        self.next_slot = next_slot
        for pv in carryover:
            self.votes[pv.slot] = 0
            self.prop_req[pv.slot] = pv.req_id
            self.emitted[pv.slot] = False

    def garbage_collect(self, upto: int) -> None:
        self.gc_slot = max(self.gc_slot, upto)
        for s in [s for s in self.accepted if s <= upto]:
            del self.accepted[s]
        for s in [s for s in self.decided if s <= upto]:
            del self.decided[s]
        for d in (self.votes, self.prop_req, self.emitted):
            for s in [s for s in d if s <= upto]:
                del d[s]


def make_oracle_group(members: int, window: int, init_bal: int,
                      self_is_coord: bool, version: int = 0) -> OracleGroup:
    g = OracleGroup(members=members, window=window, version=version)
    g.bal = init_bal
    if self_is_coord:
        g.is_coord = True
        g.coord_active = True
        g.cbal = init_bal
    return g
