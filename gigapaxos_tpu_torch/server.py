"""Server process entry point.

The port's own copy of ``gigapaxos_tpu/server.py`` (pure Python,
unchanged but for its imports).  Its nodes run on ``PC.BACKEND`` and
``PC.COLUMNAR_DEVICE``: the card, unless ``GP_PC_COLUMNAR_DEVICE=cpu``
is in the environment; an option the port has not ported
(``BACKEND=native``, ``ENGINE_MESH`` > 1) raises at node construction.

Reference analog: ``bin/gpServer.sh`` wrapping ``reconfiguration/
ReconfigurableNode.main`` — boots the roles a node id holds per the
properties file and runs until SIGTERM/SIGINT.

Usage::

    python -m gigapaxos_tpu_torch.server \
        --config conf/gigapaxos.properties \
        --id 0 --logdir /var/tmp/gp

Properties file (ref: ``gigapaxos.properties``)::

    # node map
    active.0=127.0.0.1:2000
    active.1=127.0.0.1:2001
    active.2=127.0.0.1:2002
    reconfigurator.100=127.0.0.1:3000
    # app (module:Class implementing Replicable), default KVApp
    APPLICATION=gigapaxos_tpu_torch.examples.chatapp:ChatApp
    # optional knobs mirrored into Config (ref: PaxosConfig PC enum)
    CAPACITY=1048576
    WINDOW=16
"""

from __future__ import annotations

import argparse
import importlib
import signal
import sys
import threading
from typing import Callable, Dict

from gigapaxos_tpu_torch.paxos.interfaces import (CounterApp, KVApp,
                                                  NoopApp, Replicable)
from gigapaxos_tpu_torch.reconfiguration.node import (NodeConfig,
                                                      ReconfigurableNode)
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.server")

_BUILTIN_APPS: Dict[str, Callable[[], Replicable]] = {
    "NoopApp": NoopApp,
    "CounterApp": CounterApp,
    "KVApp": KVApp,
}


def load_app(spec: str) -> Callable[[], Replicable]:
    """Resolve an app factory: a builtin name or ``module:Class``
    (ref: the properties file's ``APPLICATION=`` key)."""
    if spec in _BUILTIN_APPS:
        return _BUILTIN_APPS[spec]
    if ":" not in spec:
        raise SystemExit(
            f"unknown app {spec!r}; builtins: {sorted(_BUILTIN_APPS)} "
            "or module:Class")
    mod, cls = spec.split(":", 1)
    factory = getattr(importlib.import_module(mod), cls)
    if not (isinstance(factory, type) and issubclass(factory, Replicable)):
        raise SystemExit(f"{spec} is not a Replicable subclass")
    return factory


def read_extras(path: str) -> Dict[str, str]:
    """Non-node-map keys from the properties file (APPLICATION, knobs)."""
    extras: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            if not (k.startswith("active.")
                    or k.startswith("reconfigurator.")):
                extras[k] = v
    return extras


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gigapaxos_tpu_torch.server",
        description="Boot one gigapaxos-tpu node (active replica and/or "
                    "reconfigurator roles per the properties file).")
    p.add_argument("--config", required=True,
                   help="properties file with the node map")
    p.add_argument("--id", type=int, required=True, help="this node's id")
    p.add_argument("--logdir", default="/tmp/gigapaxos_tpu_torch",
                   help="WAL/checkpoint directory")
    p.add_argument("--app", default=None,
                   help="override APPLICATION from the properties file")
    p.add_argument("--paxos-only", action="store_true",
                   help="boot a bare PaxosNode with no reconfigurators "
                        "(ref: gigapaxos/PaxosServer deployments): only "
                        "active.* entries are used; groups are created "
                        "by clients (CreateGroup) or the GROUPS= "
                        "properties key (members = all actives)")
    p.add_argument("--engine-shards", type=int, default=None,
                   help="row-sharded engine lanes (columnar backend): "
                        "each lane gets CAPACITY/S device rows, its own "
                        "worker, and WAL segment wal-<k>.log; raise "
                        "toward the host's core count once one lane "
                        "saturates (or ENGINE_SHARDS= in the properties "
                        "file; default 1)")
    p.add_argument("--stats-port", type=int, default=None,
                   help="per-node HTTP stats listener port (GET /metrics"
                        " Prometheus text, /stats JSON snapshot); 0 = "
                        "ephemeral, omit = off (or STATS_PORT= in the "
                        "properties file)")
    p.add_argument("--stats-every", type=float, default=None,
                   help="log a stats line every N seconds (or "
                        "STATS_EVERY_S= in the properties file)")
    p.add_argument("--stats-json", action="store_true",
                   help="with --stats-every, also append full JSON "
                        "metrics snapshots to <logdir>/stats<id>.jsonl")
    p.add_argument("--trace-sample", type=float, default=None,
                   help="cluster tracing plane: fraction of requests "
                        "traced across nodes (0..1; deterministic in "
                        "the req id so all nodes sample the same "
                        "requests; or TRACE_SAMPLE= in the properties "
                        "file; default 0 = off)")
    p.add_argument("--slow-trace-ms", type=float, default=None,
                   help="log sampled requests slower than this many ms "
                        "end-to-end into the bounded slow-trace table "
                        "(or SLOW_TRACE_MS= in the properties file; "
                        "0 = off)")
    p.add_argument("--stats-peers", default=None,
                   help='cluster fan-out map for the gateway\'s '
                        '/cluster/* routes: "id=host:port,..." of every '
                        "node's stats listener (or STATS_PEERS= in the "
                        "properties file)")
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="chaos fault plane PRNG seed (deterministic "
                        "per-peer-pair fault schedules — a failing run "
                        "replays exactly; or CHAOS_SEED= in the "
                        "properties file; runtime control via GET "
                        "/chaos on the stats listener)")
    p.add_argument("--chaos-delay-ms", type=float, default=None,
                   help="inject this one-way delay on every peer link "
                        "(WAN emulation; or CHAOS_DELAY_MS=)")
    p.add_argument("--chaos-jitter-ms", type=float, default=None,
                   help="uniform jitter on top of --chaos-delay-ms "
                        "(or CHAOS_JITTER_MS=)")
    p.add_argument("--chaos-drop", type=float, default=None,
                   help="probabilistic peer-frame loss 0..1, counted "
                        "under the distinct 'chaos' drop cause "
                        "(or CHAOS_DROP=)")
    p.add_argument("--chaos-reorder", type=float, default=None,
                   help="probability 0..1 a peer frame is held one "
                        "beat so later frames overtake it "
                        "(or CHAOS_REORDER=)")
    p.add_argument("--chaos-partition", default=None,
                   help='boot-time partition spec "0,1|2": block both '
                        "directions across the sets (or "
                        "CHAOS_PARTITION=; heal via GET /chaos/heal)")
    p.add_argument("--storage-chaos-seed", type=int, default=None,
                   help="storage fault plane PRNG seed (deterministic "
                        "per (node, segment); or STORAGE_CHAOS_SEED= "
                        "in the config; runtime control via GET "
                        "/storage on the stats listener)")
    p.add_argument("--storage-chaos-fsync-eio", type=float, default=None,
                   help="probability an fsync fails with EIO "
                        "(or STORAGE_CHAOS_FSYNC_EIO=)")
    p.add_argument("--storage-chaos-fsync-persist", action="store_true",
                   help="make an injected fsync EIO latch: the segment "
                        "handle stays poisoned so rotation is forced "
                        "(or STORAGE_CHAOS_FSYNC_PERSIST=)")
    p.add_argument("--storage-chaos-enospc", type=float, default=None,
                   help="probability a WAL append fails with ENOSPC "
                        "(or STORAGE_CHAOS_ENOSPC=)")
    p.add_argument("--storage-chaos-fsync-delay-ms", type=float,
                   default=None,
                   help="added fsync latency in ms (slow-disk "
                        "emulation; or STORAGE_CHAOS_FSYNC_DELAY_MS=)")
    p.add_argument("--storage-chaos-fsync-jitter-ms", type=float,
                   default=None,
                   help="uniform jitter on top of the fsync delay "
                        "(or STORAGE_CHAOS_FSYNC_JITTER_MS=)")
    p.add_argument("--storage-chaos-torn", type=float, default=None,
                   help="probability an append lands only a prefix "
                        "(torn write; or STORAGE_CHAOS_TORN=)")
    p.add_argument("--no-wal-crc", action="store_true",
                   help="write v1 (un-checksummed) WAL frames instead "
                        "of the v2 per-record CRC32 format (or "
                        "WAL_CRC=0; reads auto-detect either way)")
    p.add_argument("--blackbox-mb", type=int, default=None,
                   help="flight-recorder ring byte budget in MB (0 = "
                        "off, the default; or BLACKBOX_MB=); dumps "
                        "blackbox-<node>-<ts>.gpbb on SLO/invariant/"
                        "churn/crash triggers and GET /blackbox/dump")
    p.add_argument("--blackbox-s", type=float, default=None,
                   help="flight-recorder ring age horizon in seconds "
                        "(0 = bytes-only bounding; or BLACKBOX_S=)")
    p.add_argument("--blackbox-on-slow", action="store_true",
                   help="auto-dump the ring when a sampled request "
                        "enters the slow-request log (needs "
                        "--slow-trace-ms; or BLACKBOX_ON_SLOW=)")
    args = p.parse_args(argv)

    extras = read_extras(args.config)
    cfg_kw = {}
    if "ACTIVES_PER_NAME" in extras:
        cfg_kw["actives_per_name"] = int(extras["ACTIVES_PER_NAME"])
    if "RC_GROUP_SIZE" in extras:
        cfg_kw["rc_group_size"] = int(extras["RC_GROUP_SIZE"])
    config = NodeConfig.from_properties(args.config, **cfg_kw)

    node_kw = {}
    if "CAPACITY" in extras:
        node_kw["capacity"] = int(extras["CAPACITY"])
    if "WINDOW" in extras:
        node_kw["window"] = int(extras["WINDOW"])
    if "BACKEND" in extras:  # "columnar" (device) | "scalar" (host numpy)
        node_kw["backend"] = extras["BACKEND"]

    app_spec = args.app or extras.get("APPLICATION", "KVApp")
    app_factory = load_app(app_spec)

    # observability knobs: flags beat properties-file keys; the node
    # reads them from Config at start()
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    shards = args.engine_shards if args.engine_shards is not None \
        else (int(extras["ENGINE_SHARDS"])
              if "ENGINE_SHARDS" in extras else None)
    if shards is not None:
        Config.set(PC.ENGINE_SHARDS, shards)
    stats_port = args.stats_port if args.stats_port is not None \
        else (int(extras["STATS_PORT"]) if "STATS_PORT" in extras
              else None)
    if stats_port is not None:
        Config.set(PC.STATS_PORT, stats_port)
    stats_every = args.stats_every if args.stats_every is not None \
        else (float(extras["STATS_EVERY_S"])
              if "STATS_EVERY_S" in extras else 0.0)
    stats_json = args.stats_json or \
        extras.get("STATS_JSON", "").lower() in ("1", "true", "yes")
    if stats_every > 0:
        Config.set(PC.STATS_DUMP_S, stats_every)
        Config.set(PC.STATS_JSON, stats_json)
    trace_sample = args.trace_sample if args.trace_sample is not None \
        else (float(extras["TRACE_SAMPLE"])
              if "TRACE_SAMPLE" in extras else None)
    if trace_sample is not None:
        Config.set(PC.TRACE_SAMPLE, trace_sample)
    slow_ms = args.slow_trace_ms if args.slow_trace_ms is not None \
        else (float(extras["SLOW_TRACE_MS"])
              if "SLOW_TRACE_MS" in extras else None)
    if slow_ms is not None:
        Config.set(PC.SLOW_TRACE_S, slow_ms / 1e3)
    stats_peers = args.stats_peers if args.stats_peers is not None \
        else extras.get("STATS_PEERS")
    if stats_peers is not None:
        Config.set(PC.STATS_PEERS, stats_peers)
    # chaos fault plane knobs (defaults off; the node mirrors them into
    # ChaosPlane at boot — see chaos/faults.py)
    for flag, key, conv in (
            (args.chaos_seed, PC.CHAOS_SEED, int),
            (args.chaos_delay_ms, PC.CHAOS_DELAY_MS, float),
            (args.chaos_jitter_ms, PC.CHAOS_JITTER_MS, float),
            (args.chaos_drop, PC.CHAOS_DROP, float),
            (args.chaos_reorder, PC.CHAOS_REORDER, float),
            (args.chaos_partition, PC.CHAOS_PARTITION, str)):
        val = flag if flag is not None \
            else (conv(extras[key.name]) if key.name in extras else None)
        if val is not None:
            Config.set(key, val)
    # storage fault plane knobs (defaults off; the node mirrors them
    # into StorageChaos at boot — see chaos/faults.py) + WAL framing
    for flag, key, conv in (
            (args.storage_chaos_seed, PC.STORAGE_CHAOS_SEED, int),
            (args.storage_chaos_fsync_eio,
             PC.STORAGE_CHAOS_FSYNC_EIO, float),
            (args.storage_chaos_enospc, PC.STORAGE_CHAOS_ENOSPC, float),
            (args.storage_chaos_fsync_delay_ms,
             PC.STORAGE_CHAOS_FSYNC_DELAY_MS, float),
            (args.storage_chaos_fsync_jitter_ms,
             PC.STORAGE_CHAOS_FSYNC_JITTER_MS, float),
            (args.storage_chaos_torn, PC.STORAGE_CHAOS_TORN, float)):
        val = flag if flag is not None \
            else (conv(extras[key.name]) if key.name in extras else None)
        if val is not None:
            Config.set(key, val)
    if args.storage_chaos_fsync_persist or \
            extras.get("STORAGE_CHAOS_FSYNC_PERSIST", "").lower() in \
            ("1", "true", "yes"):
        Config.set(PC.STORAGE_CHAOS_FSYNC_PERSIST, True)
    if args.no_wal_crc:
        Config.set(PC.WAL_CRC, False)
    elif "WAL_CRC" in extras:
        Config.set(PC.WAL_CRC, bool(int(extras["WAL_CRC"])))
    # flight-recorder knobs (defaults off; the node arms its capture
    # ring from these at construction — see gigapaxos_tpu_torch/blackbox/)
    for flag, key, conv in (
            (args.blackbox_mb, PC.BLACKBOX_MB, int),
            (args.blackbox_s, PC.BLACKBOX_S, float)):
        val = flag if flag is not None \
            else (conv(extras[key.name]) if key.name in extras else None)
        if val is not None:
            Config.set(key, val)
    if args.blackbox_on_slow or \
            extras.get("BLACKBOX_ON_SLOW", "").lower() in \
            ("1", "true", "yes"):
        Config.set(PC.BLACKBOX_ON_SLOW, True)
    if int(Config.get(PC.BLACKBOX_MB)) > 0:
        # the crash half of the SIGTERM/crash trigger pair: a fatal
        # uncaught exception dumps every live ring before the process
        # dies — the black box survives the incident it describes
        from gigapaxos_tpu_torch.blackbox.recorder import install_crash_hook
        install_crash_hook()

    if args.paxos_only:
        # PaxosServer-style deployment: the engine without the control
        # plane (ref: gigapaxos/PaxosServer.java main)
        import os as _os

        from gigapaxos_tpu_torch.paxos.manager import PaxosNode

        addr_map = dict(config.actives)
        node = PaxosNode(args.id, addr_map, app_factory(),
                         _os.path.join(args.logdir, f"px{args.id}"),
                         **node_kw)
        log.info("node %d starting paxos-only app=%s", args.id, app_spec)
        node.start()
        members = tuple(sorted(addr_map))
        names = [g.strip() for g in extras.get("GROUPS", "").split(",")
                 if g.strip()]
        if names:
            # one batched create (one device scatter + one durable txn)
            # instead of per-name singles — thousands of pre-created
            # bench groups boot in milliseconds, not seconds
            node.create_groups([(g, members) for g in names])
    else:
        node = ReconfigurableNode(args.id, config, app_factory,
                                  args.logdir, **node_kw)
        roles = [r for r, x in (("active", node.active),
                                ("reconfigurator",
                                 node.reconfigurator)) if x]
        log.info("node %d starting roles=%s app=%s", args.id, roles,
                 app_spec)
        node.start()

    dumper = None
    if args.paxos_only and stats_every > 0:
        # the ReconfigurableNode branch starts its own dumper; a bare
        # PaxosNode gets one here (same line + JSONL contract)
        import os as _os

        from gigapaxos_tpu_torch.utils.statsdump import StatsDumper
        jsonl = _os.path.join(args.logdir,
                              f"stats{args.id}.jsonl") \
            if stats_json else None
        dumper = StatsDumper(
            lambda: (f"node {args.id}: {node.stats()}",
                     node.metrics() if jsonl else None),
            stats_every, jsonl, name=f"gp-stats-{args.id}")
        dumper.start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        log.info("node %d stopping", args.id)
        if int(Config.get(PC.BLACKBOX_MB)) > 0:
            # SIGTERM trigger: snapshot before node.stop() deregisters
            # the recorders (the dump manifest needs the live engine)
            from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
            BlackboxRecorder.dump_all("shutdown")
        if dumper is not None:
            dumper.stop()
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
