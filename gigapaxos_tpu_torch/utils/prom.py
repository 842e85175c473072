"""Dependency-free Prometheus text exposition over the metrics dicts.

The port's own copy of ``gigapaxos_tpu/utils/prom.py``.  The families
keep the reference's names, so an exposition of either package has the
same family set; the help text of the ``gp_engine_compile*`` and
``gp_engine_cache_*`` families says what the port counts there: nvcc and
g++ builds of its libraries and their loads (``utils/engineledger.py``).

Renders a node's ``metrics()`` dict (``paxos/manager.py``) — or the
process-global profiler view for processes without a node, like the HTTP
gateway — as Prometheus text format 0.0.4: ``# HELP``/``# TYPE`` once
per metric, one sample per series, histogram tags as summaries with
``quantile`` labels.  Kept deliberately tiny: the format is line-based
and the scrape path must not grow a client-library dependency.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_QUANTILES = (("0.5", "p50_s"), ("0.9", "p90_s"), ("0.99", "p99_s"),
              ("0.999", "p999_s"))


def _tag_labels(tag: str, key: str) -> Dict[str, str]:
    """Profiler tag -> label set.  Sharded engine lanes suffix their hot
    tags with ``@<shard>`` (``eng.submit@2``, ``wal.fsync@0``,
    ``w.process@1``); the suffix becomes a ``shard`` label so per-lane
    series aggregate and filter like any other Prometheus dimension."""
    if "@" in tag:
        base, _, sh = tag.rpartition("@")
        if sh.isdigit():
            return {key: base, "shard": sh}
    return {key: tag}


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return f"{float(v):.9g}"


class _Writer:
    """Accumulates one metric family at a time, guaranteeing the
    HELP/TYPE-once and no-duplicate-series invariants by construction."""

    def __init__(self):
        self.lines: List[str] = []
        self._seen: set = set()

    def family(self, name: str, mtype: str, help_: str,
               samples: List[Tuple[Optional[Dict[str, str]], object]],
               ) -> None:
        rows = []
        for labels, value in samples:
            if value is None:
                continue
            if labels:
                lab = ",".join(f'{k}="{_esc(v)}"'
                               for k, v in sorted(labels.items()))
                series = f"{name}{{{lab}}}"
            else:
                series = name
            if series in self._seen:
                continue
            self._seen.add(series)
            rows.append(f"{series} {_num(value)}")
        if not rows:
            return
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.extend(rows)

    def summary(self, name: str, help_: str, label_key: str,
                hists: Dict[str, dict]) -> None:
        """A summary family (quantile/sum/count) per histogram tag."""
        q_rows, sums, counts = [], [], []
        for tag, h in sorted(hists.items()):
            if not h.get("count"):
                continue
            labels = _tag_labels(tag, label_key)
            for q, key in _QUANTILES:
                q_rows.append((dict(labels, quantile=q), h.get(key)))
            sums.append((labels, h.get("sum_s")))
            counts.append((labels, h.get("count")))
        if not counts:
            return
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} summary")
        for labels, value in q_rows:
            if value is None:
                continue
            lab = ",".join(f'{k}="{_esc(v)}"'
                           for k, v in sorted(labels.items()))
            self.lines.append(f"{name}{{{lab}}} {_num(value)}")
        for suffix, rows in (("_sum", sums), ("_count", counts)):
            for labels, value in rows:
                lab = ",".join(f'{k}="{_esc(v)}"'
                               for k, v in sorted(labels.items()))
                self.lines.append(f"{name}{suffix}{{{lab}}} {_num(value)}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_prometheus(m: dict, prefix: str = "gp") -> str:
    """Metrics dict -> Prometheus text.  Tolerates partial dicts (the
    gateway has no node counters; a bare profiler snapshot renders its
    stages/rates/histograms only)."""
    w = _Writer()
    p = prefix

    c = m.get("counters", {})
    for key, help_ in (
            ("executed", "requests executed by the app"),
            ("decided", "paxos decisions reached"),
            ("paused", "groups paused to the durable pause table"),
            ("unpaused", "groups unpaused on demand"),
            ("redriven", "accept re-drives (lost-Accept recovery)"),
            ("redrive_capped", "re-drive ticks that hit the cap"),
            ("parked", "proposals parked awaiting leadership"),
            ("park_dropped", "parked proposals dropped at cap"),
            ("shed", "requests answered retry by the backlog guard"),
            ("shed_disk", "proposals shed with status 5 while the WAL "
             "was degraded or the disk full"),
            ("wal_nacked", "accept votes withdrawn (nacked) because "
             "the WAL durability barrier failed"),
            ("installs", "coordinator installs won (failover)"),
            ("ballot_changes",
             "ballot/leader churn: new ballots adopted across groups "
             "(elections won, preemptions, higher-ballot promises)")):
        if key in c:
            w.family(f"{p}_{key}_total", "counter", help_,
                     [(None, c[key])])
    if "groups" in c:
        w.family(f"{p}_groups", "gauge", "resident paxos groups",
                 [(None, c["groups"])])
    if "engine_shards" in c:
        w.family(f"{p}_engine_shards", "gauge",
                 "row-sharded engine lanes (PC.ENGINE_SHARDS)",
                 [(None, c["engine_shards"])])
    if "backlog_est" in c:
        w.family(f"{p}_backlog_frames", "gauge",
                 "estimated inbound backlog in frames",
                 [(None, c["backlog_est"])])

    gh = m.get("groups_health")
    if gh:
        # exec lag = accepted-but-unexecuted slots (consensus health:
        # a growing lag means commits are lost or the app is behind)
        w.family(f"{p}_exec_lag_slots", "gauge",
                 "accepted-but-not-yet-executed slots across groups",
                 [({"agg": "max"}, gh.get("exec_lag_max")),
                  ({"agg": "sum"}, gh.get("exec_lag_sum")),
                  ({"agg": "mean"}, gh.get("exec_lag_mean"))])
        w.family(f"{p}_ballot_changes_max", "gauge",
                 "worst per-group ballot churn count",
                 [(None, gh.get("ballot_changes_max"))])
    wal = m.get("wal", {})
    segs = wal.get("segments")
    if segs:
        w.family(f"{p}_wal_segment_bytes", "gauge",
                 "bytes in each WAL segment since its last compaction "
                 "rewrite (segment lag toward the compact threshold)",
                 [({"segment": str(s.get("segment"))}, s.get("bytes"))
                  for s in segs])
    health = wal.get("health")
    if health:
        w.family(f"{p}_wal_degraded", "gauge",
                 "1 while the WAL is degraded (fsync failed AND "
                 "rotation failed: accepts nacked, proposals shed "
                 "status 5, commits still served) — sticky until "
                 "restart",
                 [(None, health.get("degraded"))])
        w.family(f"{p}_wal_disk_full", "gauge",
                 "1 while appends are failing with ENOSPC (sheds new "
                 "proposals, emergency compaction armed)",
                 [(None, health.get("disk_full"))])
        w.family(f"{p}_wal_rotations_total", "counter",
                 "segment handle rotations after a failed fsync or "
                 "torn append (fsyncgate: a failed fsync poisons its "
                 "fd forever)",
                 [(None, health.get("rotations"))])
        w.family(f"{p}_wal_quarantined_total", "counter",
                 "WAL segments quarantined at a CRC-mismatching record "
                 "(replay keeps the verified prefix only)",
                 [(None, len(health.get("quarantined") or ()))])
        w.family(f"{p}_wal_ckpt_corrupt_total", "counter",
                 "checkpoint rows whose stored CRC failed verification "
                 "(recovery fell back to WAL-only replay)",
                 [(None, health.get("ckpt_bad"))])

    eng = m.get("engine")
    if eng is not None:
        w.family(
            f"{p}_engine_seconds_total", "counter",
            "engine wave wall seconds: sub=host launching waves, "
            "blk=host blocked materializing device results, "
            "ovl=submit-to-collect gap won back",
            [({"phase": "sub"}, eng.get("submit_s", 0.0)),
             ({"phase": "blk"}, eng.get("collect_s", 0.0)),
             ({"phase": "ovl"}, eng.get("overlap_s", 0.0))])
        ledger = eng.get("ledger") or {}
        kernels = ledger.get("kernels") or {}
        if isinstance(kernels, dict) and kernels:
            w.family(f"{p}_engine_compiles_total", "counter",
                     "builds per engine library (one nvcc or g++ run "
                     "per library source that was not built yet)",
                     [({"kernel": k}, v.get("compiles"))
                      for k, v in sorted(kernels.items())
                      if isinstance(v, dict)])
            w.family(f"{p}_engine_retraces_total", "counter",
                     "post-warmup re-traces of hot-path kernels "
                     "(always 0: torch does not trace)",
                     [({"kernel": k}, v.get("retraces"))
                      for k, v in sorted(kernels.items())
                      if isinstance(v, dict)])
        if isinstance(ledger, dict) and ledger:
            w.family(f"{p}_engine_compile_seconds_total", "counter",
                     "wall seconds spent building the engine's "
                     "libraries (nvcc, g++)",
                     [(None, ledger.get("compile_s"))])
        cache = eng.get("cache")
        if isinstance(cache, dict) and cache:
            w.family(f"{p}_engine_cache_active", "gauge",
                     "1 when the library build cache is armed (the "
                     "build directories of utils/engineledger.py)",
                     [(None, bool(cache.get("active")))])
            w.family(f"{p}_engine_cache_hits_total", "counter",
                     "library loads that found their build on disk",
                     [(None, cache.get("hits"))])
            w.family(f"{p}_engine_cache_misses_total", "counter",
                     "library loads that had to build first (cold "
                     "builds paid in full)",
                     [(None, cache.get("misses"))])
        mem = eng.get("memory")
        if isinstance(mem, dict) and mem:
            planes = mem.get("planes") or {}
            w.family(f"{p}_engine_slab_bytes", "gauge",
                     "resident device slab bytes per state plane "
                     "(acc/dec/prop slabs, ballots, cursors, votes, "
                     "control mirrors)",
                     [({"plane": k}, v)
                      for k, v in sorted(planes.items())])
            w.family(f"{p}_engine_slab_bytes_total", "gauge",
                     "total resident device slab bytes",
                     [(None, mem.get("total_bytes"))])
            w.family(f"{p}_engine_bytes_per_group", "gauge",
                     "slab bytes per group row (total/capacity)",
                     [(None, mem.get("bytes_per_group"))])
            w.family(f"{p}_engine_capacity_rows", "gauge",
                     "allocated group-row capacity across slabs",
                     [(None, mem.get("capacity"))])
            w.family(f"{p}_engine_device_bytes", "gauge",
                     "device allocator view (torch.cuda): kind=in_use "
                     "live allocations, kind=limit device bytes (absent "
                     "off the card)",
                     [({"kind": "in_use"}, mem.get("device_bytes_in_use")),
                      ({"kind": "limit"}, mem.get("device_bytes_limit"))])
            w.family(f"{p}_engine_max_groups_estimate", "gauge",
                     "estimated group capacity at 90% of the device "
                     "limit (absent off the card)",
                     [(None, mem.get("max_groups_estimate"))])
        bal = eng.get("balance")
        if isinstance(bal, dict) and bal:
            w.family(f"{p}_engine_rows_active", "gauge",
                     "active (live-group) rows resident on the engine",
                     [(None, bal.get("rows_active"))])
            w.family(f"{p}_engine_shard_rows_active", "gauge",
                     "active rows per engine shard (round-robin row "
                     "ownership balance)",
                     [({"shard": str(i)}, v)
                      for i, v in enumerate(bal.get("shards") or [])])
            w.family(f"{p}_engine_mesh_rows_active", "gauge",
                     "active rows per mesh device block (group-space "
                     "sharding balance)",
                     [({"device": str(i)}, v)
                      for i, v in enumerate(bal.get("mesh") or [])])

    net = m.get("net", {})
    for key, name, help_ in (
            ("tx_frames", "net_tx_frames", "frames sent"),
            ("tx_bytes", "net_tx_bytes", "bytes sent"),
            ("rx_frames", "net_rx_frames", "frames received"),
            ("rx_bytes", "net_rx_bytes", "bytes received"),
            ("reconnects", "net_reconnects",
             "peer reconnect attempts after a lost connection"),
            ("connect_failures", "net_connect_failures",
             "failed peer connect attempts"),
            ("tx_writes", "net_tx_writes",
             "writer calls on the send path (syscall proxy)"),
            ("rx_reads", "net_rx_reads",
             "socket reads on the receive path (syscall proxy)"),
            ("tx_frags", "net_tx_frags",
             "FRAG super-frames sent (wire aggregation)"),
            ("tx_frag_members", "net_tx_frag_members",
             "frames that traveled inside sent FRAG super-frames"),
            ("rx_frags", "net_rx_frags",
             "FRAG super-frames received"),
            ("rx_frag_members", "net_rx_frag_members",
             "frames that arrived inside FRAG super-frames")):
        if key in net:
            w.family(f"{p}_{name}_total", "counter", help_,
                     [(None, net[key])])
    for key, name, help_ in (
            ("bytes_per_decision", "net_bytes_per_decision",
             "total wire bytes (tx+rx) amortized per decided slot"),
            ("syscalls_per_decision", "net_syscalls_per_decision",
             "writer/reader calls (tx+rx syscall proxy) amortized "
             "per decided slot")):
        if key in net:
            w.family(f"{p}_{name}", "gauge", help_, [(None, net[key])])
    drops = net.get("drops")
    if drops:
        w.family(f"{p}_net_dropped_frames_total", "counter",
                 "outbound frames dropped, by cause",
                 [({"cause": k}, v) for k, v in sorted(drops.items())])
    rtt = net.get("rtt")
    if rtt:
        w.family(f"{p}_net_rtt_seconds", "gauge",
                 "ping/pong round-trip EWMA per peer (the network-hop "
                 "baseline for cross-node traces)",
                 [({"peer": str(peer)}, v.get("ewma_s"))
                  for peer, v in sorted(rtt.items())])

    prof = m.get("profiler", m if "totals" in m else {})
    totals = prof.get("totals", {})
    if totals:
        w.family(f"{p}_stage_wall_seconds_total", "counter",
                 "wall seconds accumulated per pipeline stage",
                 [(_tag_labels(t, "stage"), v.get("wall_s"))
                  for t, v in sorted(totals.items())])
        w.family(f"{p}_stage_cpu_seconds_total", "counter",
                 "CPU seconds per stage (PC.PROFILE_CPU)",
                 [(_tag_labels(t, "stage"), v.get("cpu_s"))
                  for t, v in sorted(totals.items())])
        w.family(f"{p}_stage_calls_total", "counter",
                 "calls per stage",
                 [(_tag_labels(t, "stage"), v.get("calls"))
                  for t, v in sorted(totals.items())])
        w.family(f"{p}_stage_items_total", "counter",
                 "items per stage",
                 [(_tag_labels(t, "stage"), v.get("items"))
                  for t, v in sorted(totals.items())])
    rates = prof.get("rates", {})
    if rates:
        w.family(f"{p}_rate_per_second", "gauge",
                 "windowed event rate per tag",
                 [(_tag_labels(t, "tag"), v.get("per_sec"))
                  for t, v in sorted(rates.items())])
        w.family(f"{p}_events_total", "counter",
                 "cumulative event count per rate tag",
                 [(_tag_labels(t, "tag"), v.get("count"))
                  for t, v in sorted(rates.items())])
    hists = prof.get("histograms", {})
    if hists:
        w.summary(f"{p}_delay_seconds",
                  "per-stage latency (log-bucketed histogram quantiles)",
                  "stage", hists)

    spans = m.get("spans", {})
    kinds = spans.get("kinds", {})
    if kinds:
        w.family(f"{p}_span_seconds_total", "counter",
                 "pipeline-stage span seconds by kind",
                 [({"kind": k}, v.get("total_s"))
                  for k, v in sorted(kinds.items())])
        w.family(f"{p}_spans_total", "counter",
                 "completed pipeline-stage spans by kind",
                 [({"kind": k}, v.get("count"))
                  for k, v in sorted(kinds.items())])
    if spans:
        w.family(f"{p}_spans_open", "gauge",
                 "spans begun but not yet ended",
                 [(None, spans.get(
                     "open", max(0, spans.get("begun", 0)
                                 - spans.get("ended", 0))))])
        if "orphaned" in spans:
            w.family(f"{p}_spans_orphaned_total", "counter",
                     "spans whose end stamp never arrived within the "
                     "trace age horizon (a stage lost its end)",
                     [(None, spans.get("orphaned"))])

    cluster = m.get("cluster")
    if cluster:
        w.family(f"{p}_node_up", "gauge",
                 "per-node scrape success in the cluster fan-out",
                 [({"node": str(n)}, up)
                  for n, up in sorted(cluster.get("nodes", {}).items())])

    return w.render()


def process_metrics() -> dict:
    """Process-global metrics for node-less processes (the HTTP
    gateway): the profiler snapshot + span aggregates."""
    from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
    return {"profiler": DelayProfiler.snapshot(),
            "spans": RequestInstrumenter.span_stats()}


def metrics_response(path: str, metrics_fn):
    """Shared GET route body for the two observability endpoints (the
    per-node listener and the HTTP gateway serve identical content):
    ``(status, content_type, body)`` for /metrics | /stats, else None."""
    if path == "/metrics":
        return ("200 OK", "text/plain; version=0.0.4",
                render_prometheus(metrics_fn()).encode())
    if path == "/stats":
        import json
        return ("200 OK", "application/json",
                json.dumps(metrics_fn(), default=str).encode())
    return None
