"""Staged chaos scenarios against an in-process cluster.

The port's own copy of ``gigapaxos_tpu/chaos/scenarios.py``: the same
timelines, seeds and rows.  Every scenario runs the port's columnar
engine on ``PC.COLUMNAR_DEVICE`` (the card unless
``GP_PC_COLUMNAR_DEVICE=cpu``), its hand-written kernels included; the
reference runs seven of its eight on the C++ per-instance engine
(``backend="native"``), which the port does not have: asking for it
raises ``NotImplementedError``.  The row's ``backend`` names the engine.

Each scenario is a TIMELINE — boot a real multi-node cluster (loopback
sockets, real WALs), drive concurrent client load, inject faults
through the :class:`~gigapaxos_tpu_torch.chaos.faults.ChaosPlane` and the
harness's crash/restart hooks at staged points, heal, then hand the
whole run to :mod:`~gigapaxos_tpu_torch.chaos.invariants`:

- ``partition_heal``      — WAN jitter, then a full ``{0,1} | {2}``
  partition under load (the majority keeps deciding; groups led by the
  isolated node fail over), then heal.
- ``leader_crash``        — the node coordinating the most groups is
  crash-stopped mid-load, survivors take over, the victim restarts and
  catches up.
- ``rolling_restart``     — every node in turn is crash-stopped and
  rebooted while the others serve.
- ``shard_storm``         — crash-recovery storm across an
  ``ENGINE_SHARDS`` change (columnar engine, fsync on): the victim
  restarts with a DIFFERENT lane count and must merge the previous
  layout's ``wal-<k>.log`` set, twice, with frame loss on the links.
- ``zipf_hot``            — zipf-skewed hot-group load under jitter +
  1% loss (the realistic skewed-traffic mix).
- ``mini_partition_heal`` — 2-node partition-heal in <20s, the
  ``smoke``-gate version: a full partition stalls the 2-quorum, acked
  history survives, heal restores service.
- ``disk_storm``          — the STORAGE fault plane's storm (real
  fsync): transient fsync EIO mid-load (segment rotation saves the
  group-commit buffer — ``no_lost_acks`` is the headline), a
  disk-full window (status-5 sheds + emergency compaction), then a
  kill + bit-flip a mid-file WAL record + restart (CRC quarantine +
  catch-up re-convergence).
- ``mini_disk_fault``     — 2-node 100%-fsync-EIO drill in seconds,
  the ``smoke``-gate proof that rotation keeps every ack durable.

Every scenario returns one JSON-able row (the ``CHAOS_*.json``
artifact format rendered by ``render_perf.py``): staged timeline,
injected-fault counters, the schedule fingerprint (same seed -> same
fingerprint, so "replays exactly" is checkable), invariant verdicts,
and recovery seconds (last disruption -> cursors converged).

CLI: ``python -m gigapaxos_tpu_torch.chaos`` (see ``__main__.py``).
"""

from __future__ import annotations

import asyncio
import glob
import os
import random
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.chaos import invariants as inv
from gigapaxos_tpu_torch.chaos.faults import ChaosPlane, StorageChaos
from gigapaxos_tpu_torch.paxos.client import PaxosClientAsync
from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
from gigapaxos_tpu_torch.paxos.packets import group_key
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.chaos.sc")


def _scale(t: float) -> float:
    """Deadline scaling for slow hosts — the test suite's policy
    (``testing.harness.tscale``), imported lazily so ``--list`` stays
    light."""
    from gigapaxos_tpu_torch.testing.harness import tscale
    return tscale(t)


class _Ctx:
    """One scenario run: the cluster, the acked-op history, and the
    staged-timeline log."""

    def __init__(self, emu, seed: int):
        self.emu = emu
        self.seed = seed
        self.t0 = time.monotonic()
        self.hist: Dict[str, List[inv.Rec]] = {}
        self.stages: List[dict] = []
        self.client_errors = 0
        # ENGINE_SHARDS values a scenario restarts nodes under, in
        # order (shard_storm appends at each Config.set site)
        self.shard_timeline: List[int] = []
        self._phase = 0
        # last disruptive/heal stage: recovery_s is measured from here
        self.t_heal = self.t0
        self._pairs = [(s, d) for s in emu.addr_map
                       for d in emu.addr_map if s != d]
        # (node, wal-segment) pairs for the STORAGE plane's share of
        # the fingerprint; seg range is a fixed superset (the digest
        # is pure, surplus pairs just fold deterministic words)
        self._spairs = [(n, s) for n in emu.addr_map for s in range(4)]
        # running fold of the plane's schedule fingerprint at every
        # stage boundary: captures the WHOLE evolving fault schedule
        # (rules change mid-scenario; a heal clears partition edges),
        # identical across runs with the same seed
        self._sched_acc = 0
        # storage epilogue expectations (set by storage scenarios):
        # a corrupt-and-restart drill legitimately leaves quarantined
        # segments; an EIO drill must show rotations on its victim
        self.allow_quarantine = False
        self.expect_rotation_on: Optional[int] = None

    def stage(self, event: str, heal: bool = False) -> None:
        t = time.monotonic()
        self.stages.append({"t_s": round(t - self.t0, 3),
                            "event": event})
        if heal:
            self.t_heal = t
        fp = int(ChaosPlane.schedule_fingerprint(self._pairs), 16)
        self._sched_acc = ((self._sched_acc * 0x9E3779B97F4A7C15)
                           ^ fp) & ((1 << 64) - 1)
        # the storage plane's schedule is part of the SAME replay
        # proof: fold its digest at every stage boundary too
        sfp = int(StorageChaos.schedule_fingerprint(self._spairs), 16)
        self._sched_acc = ((self._sched_acc * 0x9E3779B97F4A7C15)
                           ^ sfp) & ((1 << 64) - 1)
        log.info("chaos stage +%.2fs: %s", t - self.t0, event)

    def schedule_fingerprint(self) -> str:
        return f"{self._sched_acc:016x}"

    def peers(self) -> Dict[int, Tuple[str, int]]:
        """Live nodes' stats listeners (recomputed per call — restarts
        re-bind ephemeral ports)."""
        return {i: ("127.0.0.1", nd.stats_http.port)
                for i, nd in self.emu.nodes.items()
                if nd is not None and nd.stats_http is not None}

    def live_servers(self) -> List[int]:
        return sorted(i for i, nd in self.emu.nodes.items()
                      if nd is not None)

    async def drive(self, n_clients: int, per_client: int,
                    servers: Optional[List[int]] = None,
                    zipf_a: float = 0.0,
                    timeout: Optional[float] = None) -> int:
        """Concurrent clients over the scenario's groups; completed ops
        land in :attr:`hist` as ``(inv_ts, resp_ts, req_id, position)``
        (CounterApp's response count IS the linearization position).
        Returns how many ops completed.  Group choice is seeded per
        (scenario seed, phase, client) — the workload replays too."""
        self._phase += 1
        phase = self._phase
        groups = self.emu.groups
        ids = self.live_servers() if servers is None else servers
        addrs = [self.emu.addr_map[i] for i in ids]
        tmo = _scale(10.0) if timeout is None else timeout
        # weights for zipf-skewed group choice (rank-based, determinist)
        weights = [1.0 / (r + 1) ** zipf_a
                   for r in range(len(groups))] if zipf_a else None
        clients = [PaxosClientAsync(
            (1 << 21) + ((self.seed * 131 + phase) % 977) * 64 + c,
            addrs, timeout=tmo) for c in range(n_clients)]
        done = 0

        async def worker(c: int, cli) -> int:
            nonlocal done
            rng = random.Random(self.seed * 10007 + phase * 101 + c)
            for _ in range(per_client):
                g = rng.choices(groups, weights=weights)[0] if weights \
                    else groups[rng.randrange(len(groups))]
                t_inv = time.monotonic()
                try:
                    r = await cli.send_request(g, b"chaos")
                except (TimeoutError, asyncio.TimeoutError):
                    self.client_errors += 1
                    continue
                t_resp = time.monotonic()
                if r.status != 0:
                    self.client_errors += 1
                    continue
                import json as _json
                d = _json.loads(r.payload)
                self.hist.setdefault(g, []).append(
                    (t_inv, t_resp, r.req_id, d["count"]))
                done += 1

        try:
            await asyncio.gather(*(worker(c, cli)
                                   for c, cli in enumerate(clients)))
        finally:
            for cli in clients:
                await cli.close()
        return done

    async def probe_all(self) -> None:
        """One op to EVERY group after the timeline: recovery hydrates
        app state lazily (a restarted replica rebuilds a group's state
        when its next packet arrives), so the invariant epilogue first
        touches each group once — the commit wave forces hydration and
        catch-up on every replica, and the probes are ordinary acked
        ops that join the history under the same invariants."""
        self._phase += 1
        cli = PaxosClientAsync(
            (1 << 21) + ((self.seed * 131 + self._phase) % 977) * 64,
            [self.emu.addr_map[i] for i in self.live_servers()],
            timeout=_scale(10.0))
        try:
            for g in self.emu.groups:
                t_inv = time.monotonic()
                try:
                    r = await cli.send_request(g, b"probe")
                except (TimeoutError, asyncio.TimeoutError):
                    self.client_errors += 1
                    continue
                if r.status != 0:
                    self.client_errors += 1
                    continue
                import json as _json
                self.hist.setdefault(g, []).append(
                    (t_inv, time.monotonic(), r.req_id,
                     _json.loads(r.payload)["count"]))
        finally:
            await cli.close()

    def most_coordinating(self) -> int:
        """The node that boots as coordinator of the most groups —
        the highest-impact crash victim."""
        coords = [self.emu.members_of(g)[group_key(g)
                                         % len(self.emu.members_of(g))]
                  for g in self.emu.groups]
        return max(set(coords), key=coords.count)


# ---------------------------------------------------------------------------
# scenario timelines
# ---------------------------------------------------------------------------


async def _sc_partition_heal(ctx: _Ctx) -> None:
    ChaosPlane.set_link(None, None, delay_s=0.001, jitter_s=0.002)
    ctx.stage("wan: 1ms delay + 2ms jitter on all peer links")
    await ctx.drive(3, 12)
    ChaosPlane.partition([{0, 1}, {2}])
    ctx.stage("partition {0,1} | {2}")
    # the majority side keeps deciding; groups led by node 2 must fail
    # over (its pings are dark past FAILURE_TIMEOUT_S)
    await ctx.drive(3, 12, servers=[0, 1])
    ChaosPlane.heal()
    ctx.stage("heal partition", heal=True)
    await ctx.drive(3, 8)


async def _sc_leader_crash(ctx: _Ctx) -> None:
    victim = ctx.most_coordinating()
    await ctx.drive(3, 10)
    survivors = [i for i in ctx.live_servers() if i != victim]
    load = asyncio.ensure_future(ctx.drive(3, 14))
    await asyncio.sleep(_scale(0.4))
    ctx.emu.kill(victim)
    ctx.stage(f"crash-stop node {victim} (coordinator of the most "
              "groups) mid-load")
    await load
    await ctx.drive(3, 10, servers=survivors)
    ctx.emu.restart(victim)
    ctx.stage(f"restart node {victim} (WAL recovery + catch-up)",
              heal=True)
    await ctx.drive(3, 8)


async def _sc_rolling_restart(ctx: _Ctx) -> None:
    # restarts on a perfect network prove little: light WAN jitter
    # rides under the whole roll
    ChaosPlane.set_link(None, None, delay_s=0.0005, jitter_s=0.001)
    ctx.stage("wan: 0.5ms delay + 1ms jitter on all peer links")
    await ctx.drive(2, 8)
    for i in list(ctx.live_servers()):
        ctx.emu.kill(i)
        ctx.stage(f"rolling: crash-stop node {i}")
        await ctx.drive(2, 6)  # the survivors (drive defaults to live)
        ctx.emu.restart(i)
        ctx.stage(f"rolling: restart node {i}", heal=True)
        await ctx.drive(2, 4)


async def _sc_shard_storm(ctx: _Ctx) -> None:
    # crash-recovery storm across ENGINE_SHARDS changes: recovery must
    # merge whatever wal-<k>.log set the PREVIOUS layout left behind
    # (S=2 -> S=1 -> S=2), with real fsync and 2% frame loss on links
    ChaosPlane.set_link(None, None, drop_p=0.02)
    ctx.stage("2% frame loss on all peer links")
    await ctx.drive(2, 8)
    for new_s in (1, 2):
        ctx.emu.kill(0)
        ctx.stage(f"storm: crash-stop node 0 (ENGINE_SHARDS was "
                  f"{Config.get(PC.ENGINE_SHARDS)})")
        await ctx.drive(2, 6, servers=[1, 2])
        Config.set(PC.ENGINE_SHARDS, new_s)
        ctx.shard_timeline.append(new_s)
        ctx.emu.restart(0)
        ctx.stage(f"storm: restart node 0 with ENGINE_SHARDS={new_s} "
                  "(merges the old layout's WAL segments)", heal=True)
        await ctx.drive(2, 5)


async def _sc_zipf_hot(ctx: _Ctx) -> None:
    ChaosPlane.set_link(None, None, delay_s=0.0005, jitter_s=0.003,
                        drop_p=0.01, reorder_p=0.05)
    ctx.stage("wan: 0.5ms+3ms jitter, 1% loss, 5% reorder; zipf(1.2) "
              "hot-group load")
    await ctx.drive(4, 20, zipf_a=1.2)
    ChaosPlane.heal()  # no partitions to heal; marks the quiet point
    ctx.stage("load drained", heal=True)


async def _sc_mini_partition_heal(ctx: _Ctx) -> None:
    # 2-node cluster: a full partition stalls the 2-quorum entirely —
    # the smoke-gate proof that faults BITE and heal restores service
    await ctx.drive(2, 5)
    ChaosPlane.partition([{0}, {1}])
    ctx.stage("partition {0} | {1} (no quorum possible)")
    before = ctx.client_errors
    await ctx.drive(1, 2, timeout=_scale(1.5))
    if ctx.client_errors <= before:
        raise AssertionError(
            "requests succeeded across a full partition — the fault "
            "plane is not biting")
    ChaosPlane.heal()
    ctx.stage("heal partition", heal=True)
    await ctx.drive(2, 5)


def _flip_one_record(nodedir: str) -> str:
    """Bit-flip one mid-file WAL record under a dead node's log dir
    (the offline half of the storage fault plane: post-crash media
    corruption).  Prefers the fattest segment and a middle record;
    returns a ``file#index@offset`` label for the stage log."""
    from gigapaxos_tpu_torch.paxos.logger import corrupt_wal_record
    paths = sorted(glob.glob(os.path.join(nodedir, "wal-*.log")),
                   key=os.path.getsize, reverse=True)
    for p in paths:
        for idx in (40, 20, 10, 5, 2, 1):
            for field in ("payload", "crc", "header"):
                try:
                    off = corrupt_wal_record(p, idx, field)
                except (IndexError, ValueError):
                    continue
                return f"{os.path.basename(p)}#{idx}@{off}"
    raise AssertionError(f"no WAL record to corrupt under {nodedir}")


async def _sc_disk_storm(ctx: _Ctx) -> None:
    # the storage-plane storm (real fsync on): three acts — fsyncgate,
    # disk full, post-crash corruption — under the SAME invariants as
    # the network storms.  no_lost_acks over act one is the headline:
    # an fsync failure mid-group-commit must never lose an acked op.
    victim, victim2 = 1, 2
    await ctx.drive(3, 8)
    # act 1 — transient fsync EIO mid-load: the failed handle is
    # poisoned (fsyncgate: never retry fsync on the same fd), the lane
    # rotates to a fresh wal-<k>.<gen>.log and re-appends the un-acked
    # group-commit buffer BEFORE acking
    StorageChaos.set_rule(victim, None, fsync_eio_p=0.35)
    ctx.stage(f"storage: 35% transient fsync EIO on node {victim}")
    await ctx.drive(3, 12)
    StorageChaos.set_rule(victim, None)  # all-zero rule = removed
    ctx.stage("storage: fsync EIO cleared", heal=True)
    await ctx.drive(2, 6)
    # act 2 — disk full: every append on the victim ENOSPCs; it sheds
    # new proposals with status 5 (clients rotate away) and arms the
    # emergency compaction, while quorums form on the other two nodes
    StorageChaos.set_rule(victim, None, enospc_p=1.0)
    ctx.stage(f"storage: disk full (ENOSPC) on node {victim}")
    await ctx.drive(2, 6, timeout=_scale(2.5))
    StorageChaos.set_rule(victim, None)
    ctx.stage("storage: space reclaimed", heal=True)
    await ctx.drive(2, 6)
    from gigapaxos_tpu_torch.net.cluster import scrape_cluster
    views = await scrape_cluster({victim: ctx.peers()[victim]},
                                 "/stats", timeout=5.0)
    shed = int(((views.get(victim) or {}).get("counters") or {})
               .get("shed_disk", 0))
    if shed == 0:
        raise AssertionError(
            "disk-full window shed nothing — the status-5 path never "
            "fired on the ENOSPC victim")
    # act 3 — post-crash corruption: kill a node, flip one byte in a
    # mid-file WAL record, restart.  Recovery must quarantine the
    # segment FROM that record (keep the verified prefix), surface it
    # in wal.health, and re-converge via catch-up from the peers.
    ctx.emu.kill(victim2)
    ctx.stage(f"crash-stop node {victim2} for offline corruption")
    flipped = _flip_one_record(f"{ctx.emu.logdir}/n{victim2}")
    ctx.emu.restart(victim2)
    ctx.stage(f"restart node {victim2} with a bit-flipped WAL record "
              f"({flipped}) — quarantine + catch-up", heal=True)
    ctx.allow_quarantine = True
    ctx.expect_rotation_on = victim
    await ctx.drive(2, 8)


async def _sc_mini_disk_fault(ctx: _Ctx) -> None:
    # smoke-gate EIO drill: 100% transient fsync EIO on node 0 under
    # load — every group commit must rotate and re-append before
    # acking.  Proves the fault BITES (rotations observed on the
    # victim, asserted in the storage epilogue) and that no ack is
    # lost, in seconds.
    await ctx.drive(2, 4)
    StorageChaos.set_rule(0, None, fsync_eio_p=1.0)
    ctx.stage("storage: 100% transient fsync EIO on node 0")
    await ctx.drive(2, 5)
    StorageChaos.set_rule(0, None)
    ctx.stage("storage: cleared", heal=True)
    await ctx.drive(2, 4)
    ctx.expect_rotation_on = 0


# name -> (timeline fn, cluster spec)
SCENARIOS: Dict[str, dict] = {
    "partition_heal": {
        "fn": _sc_partition_heal, "n_nodes": 3, "n_groups": 9,
        "backend": "columnar", "sync_wal": False},
    "leader_crash": {
        "fn": _sc_leader_crash, "n_nodes": 3, "n_groups": 9,
        "backend": "columnar", "sync_wal": False},
    "rolling_restart": {
        "fn": _sc_rolling_restart, "n_nodes": 3, "n_groups": 9,
        "backend": "columnar", "sync_wal": False},
    "shard_storm": {
        "fn": _sc_shard_storm, "n_nodes": 3, "n_groups": 8,
        "backend": "columnar", "sync_wal": True, "engine_shards": 2},
    "zipf_hot": {
        "fn": _sc_zipf_hot, "n_nodes": 3, "n_groups": 16,
        "backend": "columnar", "sync_wal": False},
    "mini_partition_heal": {
        "fn": _sc_mini_partition_heal, "n_nodes": 2, "n_groups": 4,
        "backend": "columnar", "sync_wal": False},
    "disk_storm": {
        "fn": _sc_disk_storm, "n_nodes": 3, "n_groups": 9,
        "backend": "columnar", "sync_wal": True},
    "mini_disk_fault": {
        "fn": _sc_mini_disk_fault, "n_nodes": 2, "n_groups": 4,
        "backend": "columnar", "sync_wal": True},
}


def run_scenario(name: str, seed: int = 1,
                 workdir: Optional[str] = None,
                 backend: Optional[str] = None) -> dict:
    """Run one scenario end to end; returns its artifact row.  The
    fault plane and config knobs are restored afterwards."""
    spec = SCENARIOS[name]
    be = backend or spec["backend"]
    workdir = workdir or tempfile.mkdtemp(prefix=f"gp-chaos-{name}-")
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation

    shards0 = spec.get("engine_shards")
    prior_shards = Config.get(PC.ENGINE_SHARDS)
    t_wall = time.monotonic()
    emu = None
    row: dict = {"scenario": name, "seed": seed, "backend": be,
                 "n_nodes": spec["n_nodes"]}
    if shards0:
        row["engine_shards_timeline"] = [shards0]
    # every mutation of process-global state sits INSIDE the try: a
    # boot failure must not leak an enabled plane / STATS_PORT=0 /
    # a foreign ENGINE_SHARDS into the caller's next scenario
    try:
        ChaosPlane.reset()
        ChaosPlane.configure(seed=seed, enabled=True)
        StorageChaos.reset()
        StorageChaos.configure(seed=seed, enabled=True)
        Config.set(PC.STATS_PORT, 0)  # every node scrapeable
        #                 (invariants read /groups + /stats over HTTP)
        if shards0:
            Config.set(PC.ENGINE_SHARDS, shards0)
        emu = PaxosEmulation(
            workdir, n_nodes=spec["n_nodes"], n_groups=spec["n_groups"],
            backend=be, app_cls=CounterApp, capacity=1 << 10, window=16,
            sync_wal=spec["sync_wal"], ping_interval_s=0.15,
            failure_timeout_s=1.0)
        ctx = _Ctx(emu, seed)
        row["groups"] = len(emu.groups)

        async def body() -> dict:
            await spec["fn"](ctx)
            await ctx.probe_all()
            # ---- invariants (read through the operator surfaces) ----
            peers = ctx.peers()
            ok_cur, _conv_s, errs_cur = await inv.wait_cursors_converged(
                peers, deadline_s=_scale(25.0))
            recovery_s = time.monotonic() - ctx.t_heal
            ok_churn, errs_churn = await inv.churn_settled(
                peers, window_s=1.0, deadline_s=_scale(12.0))
            live = {i: nd for i, nd in emu.nodes.items()
                    if nd is not None}
            counts = {i: dict(nd.app.count) for i, nd in live.items()}
            digests = {i: dict(nd.app.digest) for i, nd in live.items()}
            errs_acks = inv.no_lost_acks(
                ctx.hist, counts,
                members={g: emu.members_of(g) for g in emu.groups})
            errs_dig = inv.digests_converged(digests)
            errs_ord: List[str] = []
            for g, recs in sorted(ctx.hist.items()):
                errs_ord += [f"group {g}: {e}"
                             for e in inv.check_single_order(recs)]
            errs_sto = await inv.storage_healthy(
                peers, allow_quarantine=ctx.allow_quarantine,
                expect_rotation_on=ctx.expect_rotation_on)
            return {
                "invariants": {
                    "no_lost_acks": not errs_acks,
                    "digest_linearizable": not (errs_dig or errs_ord),
                    "cursors_converged": ok_cur,
                    "churn_steady": ok_churn,
                    "storage_healthy": not errs_sto,
                },
                "violations": (errs_acks + errs_dig + errs_ord
                               + errs_cur + errs_churn + errs_sto)[:20],
                "recovery_s": round(recovery_s, 3),
                "schedule_fingerprint": ctx.schedule_fingerprint(),
            }

        out = asyncio.run(body())
        row.update(out)
        row["ok"] = all(row["invariants"].values())
        if not row["ok"]:
            # failing rows carry their flight-recorder captures (when
            # PC.BLACKBOX_MB armed the rings) — the offline repro.
            # Inside the try: emu.stop() deregisters the recorders.
            paths = inv.capture_on_violation(row["violations"])
            if paths:
                row["blackbox"] = paths
    finally:
        snap = ChaosPlane.snapshot()
        ssnap = StorageChaos.snapshot()
        try:
            if emu is not None:
                emu.stop()
        finally:
            ChaosPlane.reset()
            StorageChaos.reset()
            Config.unset(PC.STATS_PORT)
            Config.set(PC.ENGINE_SHARDS, prior_shards)
    if shards0:
        row["engine_shards_timeline"] = [shards0] + ctx.shard_timeline
    row["stages"] = ctx.stages
    row["faults"] = snap["injected"]
    row["storage_faults"] = ssnap["injected"]
    row["acked"] = sum(len(v) for v in ctx.hist.values())
    row["client_errors"] = ctx.client_errors
    row["wall_s"] = round(time.monotonic() - t_wall, 3)
    return row
