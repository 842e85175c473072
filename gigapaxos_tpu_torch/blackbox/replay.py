"""Deterministic offline replay of ``.gpbb`` flight-recorder captures.

A capture's F records are the *complete* packet input one node's worker
consumed (raw wire frames plus self-routed protocol objects re-encoded
at their consumption point), in batch order with live batch boundaries.
Replay builds a fresh, never-started :class:`PaxosNode` from the
manifest's knobs (same backend, shard count, capacity, window, wave
fusion), recreates the group table in row order so the engine's
free-list hands out the same rows, then re-feeds every F record
through the real ``_decode_batch`` -> decode-split -> ``_process``
path — no sockets (an unstarted node's ``_route`` drops every
outbound frame), no live timers, one thread.  Time reproduces too:
every batch runs with the engine clock (``PaxosNode._now``) pinned to
the F record's captured decode timestamp, and each captured EFFECTIVE
tick (T record) re-runs at its stream position with its captured
clock — so redrive windows, election backoff, and failure detection
make the same decisions they made live.

Verification is bit-for-bit at three levels:

- **per-wave**: the replaying node carries its own recorder, so every
  engine wave re-records pre/post lane-state digests; these must equal
  the captured W records key-by-key ``(wave, lane)``.
- **final app state**: per-group app digest/count (e.g.
  ``CounterApp``'s order-sensitive fold) vs the manifest.
- **final device state**: per-group ``exec_cursor``/``next_slot``
  gathered from the backend vs the manifest's dump-time gather.

The report marks the capture ``MATCH`` only when all three agree; any
difference renders a per-wave divergence table (first diverging waves
with both digest pairs) plus the per-group deltas.

Known limits (documented, detected, reported — not silent): a node
that crashed and rebooted mid-capture replays only the post-boot
suffix against a pre-crash manifest, and a ring that evicted records
(``n_evicted > 0``) no longer holds the full history; both degrade the
verdict to ``PARTIAL`` context in the report rather than a false
``DIVERGED``/``MATCH``.  Two wave classes are counted informationally
instead of as divergence: waves captured *before* the node's groups
existed (live digests fold an empty row set while replay pre-creates
the manifest's table — state-neutral on both sides, reported as
``waves_baseline_skew``) and waves decoded but not yet processed at
the ring snapshot (``waves_inflight_*`` — their ground truth is the
manifest gather, which runs after the snapshot and therefore normally
includes their effects; the group checks catch any delta).

The port's own copy of ``gigapaxos_tpu/blackbox/replay.py``, reading
the same captures: a ``.gpbb`` written by either package replays here
and there.  The replay node is the port's ``PaxosNode``, so its engine
runs on ``PC.COLUMNAR_DEVICE`` (``"cuda"`` unless the caller asks for
the CPU); a capture of engine lanes (``engine_shards > 1``) replays
through a node of as many lanes, one slab and one CUDA stream each.
What that node does not run yet it refuses rather than replaying
without: a ``mesh`` above one device, from the override or the
manifest, raises ``NotImplementedError``.  ``"off"``, ``"auto"`` and 1
are one device, as the reference resolves them.  Two more departures: the group
table is recreated in row-order runs of one ``create_groups`` call each
(the same rows, checked as before), and the report adds ``create_s`` and
``replay_s``, the seconds spent recreating the table and re-feeding the
records.

Failure detection is part of the replayed history, and the manifest
does not record its settings: a capture that holds a takeover replays
``MATCH`` only under the ``PING_INTERVAL_S`` and ``FAILURE_TIMEOUT_S``
the live node ran with, which the caller sets (in either package).
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.blackbox.capture import CaptureError, read_capture
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.blackbox.replay")

# max per-wave divergence rows rendered into the report
_MAX_WAVE_ROWS = 16
# groups a create_groups call of the replay recreates at most (the
# harness's create chunk)
_CREATE_RUN = 16384


def _make_app(name: str):
    from gigapaxos_tpu_torch.paxos.interfaces import (CounterApp, KVApp,
                                                      NoopApp)
    apps = {"CounterApp": CounterApp, "KVApp": KVApp, "NoopApp": NoopApp}
    if name not in apps:
        raise CaptureError(
            f"manifest app {name!r} unknown to replay (one of "
            f"{sorted(apps)} required)")
    return apps[name]()


def replay_capture(path: str, workdir: Optional[str] = None,
                   keep: bool = False, mesh=None) -> dict:
    """Re-drive one capture through a fresh offline engine and return
    the verification report dict (see module docstring).  ``workdir``
    holds the replay node's WAL/db (a temp dir by default, removed
    unless ``keep``).  ``mesh`` overrides the engine's device-mesh
    knob for the replay ("off"/"auto"/int N) — the per-wave digests
    fold host mirrors, so a capture recorded unsharded must replay
    ``MATCH`` on a mesh-sharded engine and vice versa; this override
    is how that bit-parity proof is driven (``--mesh`` on the CLI)."""
    records, manifest = read_capture(path)
    if "groups" not in manifest:
        raise CaptureError(
            f"{path}: manifest carries no ground truth "
            "(manifest_error dump?) — nothing to verify against")
    owns_workdir = workdir is None
    if owns_workdir:
        workdir = tempfile.mkdtemp(prefix="gpbb-replay-")
    try:
        return _replay_in(path, records, manifest, workdir, mesh)
    finally:
        if owns_workdir and not keep:
            shutil.rmtree(workdir, ignore_errors=True)


def _replay_in(path: str, records: List[dict], manifest: dict,
               workdir: str, mesh=None) -> dict:
    from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
    from gigapaxos_tpu_torch.paxos.manager import PaxosNode
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter

    kn = manifest.get("knobs", {})
    addr_map = {int(k): (v[0], int(v[1]))
                for k, v in manifest.get("addr_map", {}).items()}
    node_id = int(manifest["node"])
    if node_id not in addr_map:
        addr_map[node_id] = ("127.0.0.1", 1)

    # pin the engine shape to the capture's; everything is restored in
    # the finally (Config.unset pops back to the caller's layer)
    pinned = [(PC.ENGINE_SHARDS, int(kn.get("engine_shards", 1))),
              (PC.FUSE_WAVES, str(kn.get("fuse_waves", "off"))),
              (PC.SYNC_WAL, False),   # offline: durability is moot
              (PC.BLACKBOX_MB, 0)]    # we arm our own recorder below
    # device mesh: the caller's override wins (the cross-mesh parity
    # proof replays an unsharded capture sharded and vice versa); else
    # the manifest's recorded shape when present — an int there that
    # exceeds this host's devices degrades to single-device with a
    # warning (resolve_engine_mesh), which bit-parity makes safe.
    if mesh is not None:
        pinned.append((PC.ENGINE_MESH, mesh))
    elif "engine_mesh" in kn:
        pinned.append((PC.ENGINE_MESH, kn["engine_mesh"]))
    for key, val in pinned:
        Config.set(key, val)
    node = None
    rec = None
    try:
        node = PaxosNode(
            node_id, addr_map, _make_app(manifest.get("app", "NoopApp")),
            os.path.join(workdir, "px"),
            backend=str(kn.get("backend", "columnar")),
            capacity=int(kn.get("capacity", 1 << 10)),
            window=int(kn.get("window", 16)))
        node._recover()
        # the live node's engine clock was capture-era; replay re-pins
        # every captured timestamp onto _now() so elapsed-time decisions
        # (redrive windows, election backoff, failure detection)
        # reproduce.  Boot stamp first: failure detection's never-heard
        # fallback is _last_heard.get(peer, _boot_ts).
        if "boot_ts" in manifest:
            node._boot_ts = float(manifest["boot_ts"])
        t0 = min((r["ts"] for r in records), default=0.0)
        node._wtls.now = t0

        # group table in ROW order: creates were library calls on the
        # live node (invisible to the frame stream), so replay reissues
        # them; row-order creation makes the free list hand out the
        # same rows, which the digests depend on.  Runs with the clock
        # pinned to the capture's start, so create-time activity stamps
        # are capture-era (a replay-wall-time stamp would sit in the
        # captured clock's future and suppress every redrive/election
        # on rows no wave touched).
        # The port creates a run of same-version groups in one
        # create_groups call: the table still hands out rows one group at
        # a time in this order, so the rows are the same (and checked
        # below), without one device scatter and two database commits a
        # group (about 2 ms each, minutes at 100,000 groups).
        mans = sorted(manifest.get("groups", []), key=lambda g: g["row"])
        row_mismatches = []
        t_create = time.perf_counter()
        run: List[dict] = []
        for i, g in enumerate(mans):
            run.append(g)
            nxt = mans[i + 1] if i + 1 < len(mans) else None
            if nxt is None or len(run) == _CREATE_RUN or \
                    int(nxt.get("version", 0)) != int(g.get("version", 0)):
                node.create_groups([(r["name"], tuple(r["members"]))
                                    for r in run], int(g.get("version", 0)))
                run = []
        create_s = time.perf_counter() - t_create
        for g in mans:
            meta = node.table.by_name(g["name"])
            if meta is None or meta.row != g["row"]:
                row_mismatches.append(
                    {"group": g["name"], "manifest_row": g["row"],
                     "replay_row": None if meta is None else meta.row})

        # the replay node records its own waves for the per-wave diff;
        # never triggers, never evicts
        rec = BlackboxRecorder(node.id, workdir, max_bytes=1 << 62)
        rec.auto_trigger = False
        node.blackbox = rec
        node.logger.blackbox = rec
        node.transport.blackbox = rec

        def run_tick(trec: dict) -> None:
            # re-run one captured EFFECTIVE tick at its stream position
            # with its captured clock; the rate gate re-passes because
            # _last_ticks evolves from the same T timestamps it did live
            k = int(trec.get("lane", 0))
            RequestInstrumenter.set_wave(trec["wave"])
            node._wtls.now = trec["ts"]
            if node.shards > 1:
                node._wtls.wal_seg = k
                with node._engine_locks[k]:
                    node._tick(k)
                node._wtls.wal_seg = 0
            else:
                with node._engine_lock:
                    node._tick()

        # A tick's `wave` is the LAST wave its lane thread had
        # processed when the tick ran — so T(W) belongs between wave W
        # and wave W+1, regardless of its ring position (the decode
        # thread can append F(W+1), F(W+2)... before lane threads
        # finish W and tick).  F waves are strictly increasing in ring
        # order (one intake thread, monotonic wave ids), so a sorted
        # flush pointer re-times every tick: ticks of earlier (possibly
        # evicted) waves run before F(W), wave-W ticks right after it.
        ticks_by_wave: Dict[int, List[dict]] = {}
        for r in records:
            if r["t"] == "T":
                ticks_by_wave.setdefault(r["wave"], []).append(r)
        tick_waves = sorted(ticks_by_wave)
        tick_pos = [0]  # boxed flush cursor over tick_waves

        def flush_ticks(upto: int, inclusive: bool) -> None:
            i = tick_pos[0]
            while i < len(tick_waves) and (
                    tick_waves[i] < upto
                    or (inclusive and tick_waves[i] == upto)):
                for trec in ticks_by_wave[tick_waves[i]]:
                    run_tick(trec)
                i += 1
            tick_pos[0] = i

        n_frames = 0
        n_bytes = 0
        t_feed = time.perf_counter()
        for r in records:
            if r["t"] != "F":
                continue
            flush_ticks(r["wave"], inclusive=False)
            n_frames += len(r["frames"])
            n_bytes += sum(len(f) for f in r["frames"])
            RequestInstrumenter.set_wave(r["wave"])
            node._wtls.now = r["ts"]
            decoded = node._decode_batch(list(r["frames"]))
            if node.shards > 1:
                lanes = node._split_decoded(decoded)
                for k in range(node.shards):
                    if lanes[k]:
                        node._wtls.wal_seg = k
                        with node._engine_locks[k]:
                            node._process(lanes[k])
                node._wtls.wal_seg = 0
            else:
                with node._engine_lock:
                    node._process(decoded)
            # discard self-requeues: live leftovers re-entered the
            # queue and were captured AGAIN at their consumption batch
            # — re-feeding here would double-process them
            try:
                while True:
                    node._inq.get_nowait()
            except queue_mod.Empty:
                pass
            flush_ticks(r["wave"], inclusive=True)
        # trailing ticks (after the last captured decode) run last
        flush_ticks(1 << 62, inclusive=True)
        replay_s = time.perf_counter() - t_feed

        report = _build_report(path, records, manifest, node, rec,
                               row_mismatches, n_frames, n_bytes)
        report["create_s"] = round(create_s, 3)
        report["replay_s"] = round(replay_s, 3)
    finally:
        if rec is not None:
            rec.close()
        if node is not None:
            node._wtls.now = 0.0
            node.stop()
        for key, _val in pinned:
            Config.unset(key)
    return report


def _wave_key(r: dict) -> Tuple[int, int]:
    return (r["wave"], r["lane"])


def _build_report(path: str, records: List[dict], manifest: dict,
                  node, rec, row_mismatches: list, n_frames: int,
                  n_bytes: int) -> dict:
    import numpy as np

    cap_w = {_wave_key(r): r for r in records if r["t"] == "W"}
    rep_w = {_wave_key(r): r for r in rec.export() if r["t"] == "W"}

    wave_rows = []
    n_div = 0
    baseline_skew = 0
    for key in sorted(cap_w):
        c = cap_w[key]
        p = rep_w.get(key)
        if p is not None and p["pre"] == c["pre"] \
                and p["post"] == c["post"]:
            continue
        if p is not None and c["pre"] == c["post"] \
                and p["pre"] == p["post"]:
            # state-NEUTRAL both live and replayed (pings, empty
            # waves), only the absolute baseline differs: a capture
            # that spans the node's boot holds waves from BEFORE its
            # groups were created, while replay pre-creates the
            # manifest's table.  No transition happened either side —
            # this wave's determinism carries no signal; the baseline
            # itself is verified by every state-changing wave and the
            # final group checks.
            baseline_skew += 1
            continue
        n_div += 1
        if len(wave_rows) < _MAX_WAVE_ROWS:
            wave_rows.append({
                "wave": key[0], "lane": key[1],
                "captured": {"pre": c["pre"], "post": c["post"],
                             "items": c["items"]},
                "replayed": None if p is None else
                {"pre": p["pre"], "post": p["post"],
                 "items": p["items"]},
            })
    # A replay-only wave was decoded (F captured) but not yet
    # processed when the ring was snapshotted.  Not divergence either
    # way: state-neutral ones (pings in flight at the trigger) are
    # noise, and a state-CHANGING one is verified by the manifest
    # group checks — the manifest gather runs after the ring snapshot,
    # so an in-flight wave's effects are normally included and replay
    # must land on them; when the dump races the wave's processing the
    # group check reports the delta explicitly.
    extra = sorted(set(rep_w) - set(cap_w))
    inflight_noop = 0
    inflight_applied = 0
    for key in extra:
        p = rep_w[key]
        if p["pre"] == p["post"]:
            inflight_noop += 1
        else:
            inflight_applied += 1

    # final per-group state vs the manifest's dump-time ground truth
    app_digest = getattr(node.app, "digest", None)
    app_count = getattr(node.app, "count", None)
    mans = sorted(manifest.get("groups", []), key=lambda g: g["row"])
    group_mismatches = []
    metas = [node.table.by_name(g["name"]) for g in mans]
    rows = np.asarray([m.row for m in metas if m is not None], np.int64)
    dev = node._inspect_locked(rows) if len(rows) else {}
    j = 0
    for g, meta in zip(mans, metas):
        bad = {}
        if meta is None:
            group_mismatches.append(
                {"group": g["name"], "missing_in_replay": True})
            continue
        checks = [("exec_cursor_host", int(node._cur[meta.row]))]
        if dev:
            checks += [("exec_cursor", int(dev["exec_cursor"][j])),
                       ("next_slot", int(dev["next_slot"][j]))]
        if isinstance(app_digest, dict) and "app_digest" in g:
            checks.append(("app_digest",
                           app_digest.get(g["name"], 0)))
        if isinstance(app_count, dict) and "app_count" in g:
            checks.append(("app_count", app_count.get(g["name"], 0)))
        for field, got in checks:
            want = g.get(field)
            if want is not None and int(want) != int(got):
                bad[field] = {"manifest": int(want), "replay": int(got)}
        j += 1
        if bad:
            group_mismatches.append({"group": g["name"], **bad})

    n_evicted = int(manifest.get("n_evicted", 0))
    verdict = "MATCH"
    if n_div or group_mismatches or row_mismatches:
        verdict = "DIVERGED"
    ts = [r["ts"] for r in records]
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    return {
        "file": path,
        "node": int(manifest["node"]),
        "reason": manifest.get("reason"),
        "verdict": verdict,
        "partial": n_evicted > 0,
        "evicted": n_evicted,
        "frames": n_frames,
        "bytes": n_bytes,
        "capture_span_s": round(span, 3),
        "capture_overhead_bytes_per_s":
            int(n_bytes / span) if span > 0 else None,
        "waves_captured": len(cap_w),
        "waves_replayed": len(rep_w),
        "waves_diverged": n_div,
        "waves_baseline_skew": baseline_skew,
        "waves_inflight_noop": inflight_noop,
        "waves_inflight_applied": inflight_applied,
        "groups": len(mans),
        "group_mismatches": group_mismatches,
        "row_mismatches": row_mismatches,
        "wave_mismatches": wave_rows,
    }


def render_report(rep: dict) -> str:
    """Human one-screen rendering of one replay report."""
    lines = [
        f"capture  {rep['file']}",
        f"  node {rep['node']}  reason={rep['reason']}  "
        f"frames={rep['frames']} ({rep['bytes']}B over "
        f"{rep['capture_span_s']}s)",
        f"  waves    {rep['waves_captured']} captured / "
        f"{rep['waves_replayed']} replayed / "
        f"{rep['waves_diverged']} diverged",
        f"  groups   {rep['groups']} checked, "
        f"{len(rep['group_mismatches'])} mismatched",
    ]
    notes = []
    if rep.get("waves_baseline_skew"):
        notes.append(f"{rep['waves_baseline_skew']} pre-creation "
                     "(state-neutral, baseline skew)")
    if rep.get("waves_inflight_noop"):
        notes.append(f"{rep['waves_inflight_noop']} in-flight noop")
    if rep.get("waves_inflight_applied"):
        notes.append(f"{rep['waves_inflight_applied']} in-flight "
                     "applied (verified via manifest)")
    if notes:
        lines.append("  notes    " + ", ".join(notes))
    if rep["partial"]:
        lines.append(f"  WARNING  ring evicted {rep['evicted']} "
                     "records — capture is a suffix of the history")
    for w in rep["wave_mismatches"]:
        c, p = w["captured"], w["replayed"]
        lines.append(
            f"  wave {w['wave']} lane {w['lane']}: "
            f"captured {'-' if c is None else '%x/%x' % (c['pre'], c['post'])} "
            f"!= replayed "
            f"{'-' if p is None else '%x/%x' % (p['pre'], p['post'])}")
    for g in rep["group_mismatches"]:
        lines.append(f"  group {g['group']}: " + ", ".join(
            f"{k}={v}" for k, v in g.items() if k != "group"))
    for g in rep["row_mismatches"]:
        lines.append(
            f"  group {g['group']}: manifest row {g['manifest_row']} "
            f"!= replay row {g['replay_row']}")
    lines.append(f"  verdict  {rep['verdict']}")
    return "\n".join(lines)
