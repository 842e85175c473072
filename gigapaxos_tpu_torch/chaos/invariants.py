"""Invariant checker for chaos scenarios.

The port's own copy of ``gigapaxos_tpu/chaos/invariants.py`` (unchanged
but for its imports): the same checks, read through the port's node
listeners, and the port's flight recorder on a violation.

Each check answers one question an operator would ask after a fault
drill, and each reads the SAME surfaces an operator has — the per-node
``/groups`` and ``/stats`` listeners (the introspection plane) plus
the app's own acked responses — so a scenario that passes here proves
both the cluster *and* its instruments:

- :func:`check_single_order` — no two acked operations were told they
  were the same linearization point, and no completed op was ordered
  before one that finished earlier (real-time).  CounterApp's response
  carries the per-group count at execution, i.e. the op's position in
  the group's single order — no Wing-Gong search needed.
- :func:`no_lost_acks` — every acked operation is still in the final
  replicated history: per group, acked positions are unique and the
  converged count on every live replica covers the highest acked
  position.  THE durability contract: an ack that later vanishes is
  the worst bug a consensus system can have.
- :func:`digests_converged` — per-group order-sensitive digests are
  identical on every live replica (divergence = forked history).
- :func:`wait_cursors_converged` — polls every node's ``/groups``
  until each group's device-truth ``exec_cursor`` agrees across the
  replicas that host it (heal completed; stragglers caught up).
- :func:`churn_settled` — two ``/stats`` scrapes over a quiet window:
  ``counters.ballot_changes`` stopped moving (arXiv:2006.01885's
  consecutive-ballots signal back at steady state).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.net.cluster import scrape_cluster
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.chaos.inv")

# one completed client op: (invoke_ts, response_ts, req_id, position)
Rec = Tuple[float, float, int, int]


def check_single_order(recs: List[Rec]) -> List[str]:
    """Violations in ONE group's completed-op history (empty = clean):
    duplicate linearization positions, and real-time inversions (op A
    finished before op B was invoked, yet A's position is later)."""
    errs: List[str] = []
    seen: Dict[int, int] = {}
    for _inv, _resp, rid, pos in recs:
        if pos in seen and seen[pos] != rid:
            errs.append(f"position {pos} granted to two requests "
                        f"({seen[pos]:#x} and {rid:#x})")
        seen[pos] = rid
    by_pos = sorted(recs, key=lambda r: r[3])
    n = len(by_pos)
    # suffix-min of response times in position order: a later-positioned
    # op that responded before an earlier-invoked one is an inversion
    suf_min = [float("inf")] * (n + 1)
    suf_who: List[Optional[Rec]] = [None] * (n + 1)
    for i in range(n - 1, -1, -1):
        if by_pos[i][1] < suf_min[i + 1]:
            suf_min[i], suf_who[i] = by_pos[i][1], by_pos[i]
        else:
            suf_min[i], suf_who[i] = suf_min[i + 1], suf_who[i + 1]
    for i, (inv, _resp, rid, pos) in enumerate(by_pos):
        if suf_min[i + 1] < inv:
            a = suf_who[i + 1]
            errs.append(f"real-time violation: req {a[2]:#x} "
                        f"(pos {a[3]}) responded before req {rid:#x} "
                        f"(pos {pos}) was invoked")
    return errs


def no_lost_acks(hist: Dict[str, List[Rec]],
                 counts_by_node: Dict[int, Dict[str, int]],
                 members: Optional[Dict[str, Tuple[int, ...]]] = None
                 ) -> List[str]:
    """Every acked op survives: per group, positions unique and every
    live replica's converged count >= the highest acked position.
    ``members`` maps group -> hosting node ids; without it every node
    in ``counts_by_node`` is expected to host every group (only true
    when group_size == n_nodes — pass it for rotated memberships)."""
    errs: List[str] = []
    for g, recs in sorted(hist.items()):
        if not recs:
            continue
        pos_seen: Dict[int, int] = {}
        for _inv, _resp, rid, pos in recs:
            if pos in pos_seen and pos_seen[pos] != rid:
                errs.append(f"group {g}: position {pos} double-granted")
            pos_seen[pos] = rid
        hi = max(pos for _i, _r, _id, pos in recs)
        hosts = None if members is None else set(members.get(g, ()))
        for node, counts in sorted(counts_by_node.items()):
            if hosts is not None and node not in hosts:
                continue
            have = counts.get(g, 0)
            if have < hi:
                errs.append(
                    f"group {g}: node {node} count {have} < highest "
                    f"acked position {hi} — an acked request was LOST")
    return errs


def digests_converged(
        digests_by_node: Dict[int, Dict[str, int]]) -> List[str]:
    """Per-group order-sensitive digests identical on every replica."""
    errs: List[str] = []
    groups = set()
    for d in digests_by_node.values():
        groups |= set(d)
    for g in sorted(groups):
        vals = {node: d[g] for node, d in digests_by_node.items()
                if g in d}
        if len(set(vals.values())) > 1:
            errs.append(f"group {g}: digests diverged {vals}")
    return errs


async def _scrape_groups(peers: Dict[int, Tuple[str, int]],
                         timeout: float) -> Dict[int, Optional[dict]]:
    # every group on every node (limit above any scenario's group count)
    return await scrape_cluster(peers, "/groups?limit=100000", timeout)


async def wait_cursors_converged(peers: Dict[int, Tuple[str, int]],
                                 deadline_s: float,
                                 poll_s: float = 0.25) -> Tuple[
                                     bool, float, List[str]]:
    """Poll ``/groups`` on every peer until each group's device-truth
    ``exec_cursor`` agrees across all replicas hosting it (and no node
    is unreachable).  Returns ``(ok, seconds_to_converge, errors)`` —
    the seconds are the scenario's recovery-time metric."""
    t0 = time.monotonic()
    errs: List[str] = []
    while True:
        errs = []
        views = await _scrape_groups(peers, timeout=5.0)
        per_group: Dict[str, Dict[int, int]] = {}
        for node, v in sorted(views.items()):
            if v is None:
                errs.append(f"node {node}: /groups unreachable")
                continue
            for g in v.get("groups", []):
                per_group.setdefault(g["name"], {})[node] = \
                    int(g["exec_cursor"])
        for name, cur in sorted(per_group.items()):
            if len(set(cur.values())) > 1:
                errs.append(f"group {name}: exec cursors diverge {cur}")
        if not errs:
            return True, time.monotonic() - t0, []
        if time.monotonic() - t0 > deadline_s:
            return False, time.monotonic() - t0, errs
        await asyncio.sleep(poll_s)


async def churn_settled(peers: Dict[int, Tuple[str, int]],
                        window_s: float = 1.0,
                        deadline_s: float = 10.0) -> Tuple[bool,
                                                           List[str]]:
    """Ballot churn back to steady state: ``counters.ballot_changes``
    (summed over nodes) unchanged across a quiet ``window_s``.  Retries
    until ``deadline_s`` — elections may still be settling when the
    first window opens."""
    t0 = time.monotonic()

    async def total() -> Tuple[int, List[str]]:
        views = await scrape_cluster(peers, "/stats", timeout=5.0)
        tot, bad = 0, []
        for node, v in sorted(views.items()):
            if v is None:
                bad.append(f"node {node}: /stats unreachable")
            else:
                tot += int(v.get("counters", {})
                           .get("ballot_changes", 0))
        return tot, bad

    while True:
        a, bad_a = await total()
        await asyncio.sleep(window_s)
        b, bad_b = await total()
        if not bad_a and not bad_b and a == b:
            return True, []
        if time.monotonic() - t0 > deadline_s:
            errs = bad_a + bad_b
            if a != b:
                errs.append(f"ballot churn still moving: {a} -> {b} "
                            f"over {window_s}s")
            return False, errs


async def storage_healthy(peers: Dict[int, Tuple[str, int]],
                          allow_quarantine: bool = False,
                          expect_rotation_on: Optional[int] = None
                          ) -> List[str]:
    """Storage-plane epilogue for fault drills (reads ``/stats`` ->
    ``wal.health``, the operator surface): after the storm no live node
    may still be DEGRADED (rotation was supposed to save it) or stuck
    disk-full (emergency compaction was supposed to clear it).
    ``allow_quarantine``: a corrupt-and-restart drill legitimately
    leaves quarantined segment records behind — without it any
    quarantine is a violation.  ``expect_rotation_on``: assert the
    fsync-EIO victim actually rotated its segment handle at least once
    (the drill bit; zero rotations means the fault never landed)."""
    errs: List[str] = []
    views = await scrape_cluster(peers, "/stats", timeout=5.0)
    for node, v in sorted(views.items()):
        if v is None:
            errs.append(f"node {node}: /stats unreachable")
            continue
        h = (v.get("wal") or {}).get("health") or {}
        if h.get("degraded"):
            errs.append(f"node {node}: WAL still DEGRADED after the "
                        "storm (rotation failed to restore service)")
        if h.get("disk_full"):
            errs.append(f"node {node}: WAL still disk-full after the "
                        "storm (emergency compaction never cleared it)")
        if h.get("quarantined") and not allow_quarantine:
            errs.append(f"node {node}: unexpected quarantined WAL "
                        f"segment(s): {h['quarantined']}")
        if expect_rotation_on == node and not h.get("rotations"):
            errs.append(f"node {node}: zero WAL rotations — the "
                        "injected fsync failures never bit")
    return errs


def capture_on_violation(violations: List[str]) -> List[str]:
    """Flight-recorder hookup: when a scenario's invariant checks
    failed, snapshot every live node's black-box ring so the violating
    history can be re-driven offline (``python -m gigapaxos_tpu_torch.blackbox
    replay``).  Returns the dump paths — empty when nothing violated or
    no recorder is armed (``PC.BLACKBOX_MB`` 0).  The scenario runner
    attaches them to the failing row in ``CHAOS_*.json``."""
    if not violations:
        return []
    from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
    paths = BlackboxRecorder.dump_all("invariant_violation")
    if paths:
        log.warning("invariant violation: dumped %d flight-recorder "
                    "capture(s): %s", len(paths), paths)
    return paths
