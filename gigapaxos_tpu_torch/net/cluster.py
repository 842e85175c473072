"""Cluster-wide observability aggregation (the gateway's /cluster/*).

The port's own copy of ``gigapaxos_tpu/net/cluster.py`` (pure Python,
unchanged but for its imports).

One scrape point for a whole deployment: the HTTP gateway fans out to
every node's stats listener (``PC.STATS_PEERS`` = ``"id=host:port,..."``),
pulls each ``/stats`` JSON snapshot (or ``/traces/<id>`` export), and
merges them — histograms bucket-wise via
:func:`profiler.merge_hist_snapshots`, counters by summation, trace
rings by :meth:`RequestInstrumenter.cluster_breakdown` stitching.
Everything here is dependency-free asyncio (the gateway and the stats
listeners are asyncio servers; a blocking urllib call would stall the
gateway's event loop mid-scrape).
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.utils.logutil import get_logger
from gigapaxos_tpu_torch.utils.profiler import merge_hist_snapshots

log = get_logger("gp.cluster")


def parse_stats_peers(spec: str) -> Dict[int, Tuple[str, int]]:
    """``"0=127.0.0.1:9100,1=127.0.0.1:9101"`` -> {0: (host, port)}."""
    out: Dict[int, Tuple[str, int]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        nid, _, addr = part.partition("=")
        host, _, port = addr.rpartition(":")
        try:
            out[int(nid)] = (host or "127.0.0.1", int(port))
        except ValueError:
            log.warning("bad STATS_PEERS entry %r (want id=host:port)",
                        part)
    return out


async def afetch_json(host: str, port: int, path: str,
                      timeout: float = 3.0) -> Optional[dict]:
    """Minimal async HTTP/1.0 GET returning parsed JSON (None on any
    failure — a down node must not fail the whole cluster scrape)."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
        try:
            writer.write(f"GET {path} HTTP/1.0\r\n"
                         f"Host: {host}\r\n\r\n".encode())
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), timeout)
        finally:
            writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        status = head.split(None, 2)
        if len(status) < 2 or status[1] != b"200":
            return None
        return json.loads(body)
    except (OSError, asyncio.TimeoutError, ValueError,
            json.JSONDecodeError):
        return None


async def scrape_cluster(peers: Dict[int, Tuple[str, int]], path: str,
                         timeout: float = 3.0) -> Dict[int, Optional[dict]]:
    """Concurrent fan-out of one GET to every peer."""
    items = sorted(peers.items())
    results = await asyncio.gather(
        *(afetch_json(h, p, path, timeout) for _nid, (h, p) in items))
    return {nid: res for (nid, _), res in zip(items, results)}


def _sum_into(dst: dict, src: dict) -> None:
    """Recursively add numeric leaves of ``src`` into ``dst``
    (non-numeric/unknown-shape leaves keep the first value seen)."""
    for k, v in src.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            cur = dst.get(k, 0)
            dst[k] = (cur if isinstance(cur, (int, float)) else 0) + v
        elif isinstance(v, dict):
            d = dst.setdefault(k, {})
            if isinstance(d, dict):
                _sum_into(d, v)


def merge_cluster_stats(per_node: Dict[int, Optional[dict]]) -> dict:
    """Merge per-node ``/stats`` snapshots into ONE metrics dict the
    Prometheus renderer (and ``/cluster/stats``) serves: counters /
    engine / net / spans summed, histogram tags merged bucket-wise
    (cluster-true percentiles, not an average of averages), plus a
    per-node ``up`` map.  Nodes that failed to scrape contribute
    nothing but their ``up=0``."""
    out: dict = {"cluster": {
        "nodes": {nid: int(m is not None)
                  for nid, m in per_node.items()}}}
    counters: dict = {}
    engine: dict = {}
    net: dict = {}
    spans: dict = {}
    gh: dict = {}
    totals: dict = {}
    rates: dict = {}
    hists: dict = {}
    slow: List[dict] = []
    for nid, m in sorted(per_node.items()):
        if not m:
            continue
        _sum_into(counters, m.get("counters", {}))
        _sum_into(engine, m.get("engine", {}))
        nm = dict(m.get("net", {}))
        nm.pop("rtt", None)  # per-peer EWMAs don't sum across nodes
        _sum_into(net, nm)
        sp = dict(m.get("spans", {}))
        kinds = sp.pop("kinds", {})
        _sum_into(spans, sp)
        _sum_into(spans.setdefault("kinds", {}), kinds)
        h = m.get("groups_health", {})
        for k, v in h.items():
            if k.endswith("_max"):
                gh[k] = max(gh.get(k, 0), v)
            elif isinstance(v, (int, float)) and \
                    not isinstance(v, bool):
                gh[k] = gh.get(k, 0) + v
        prof = m.get("profiler", {})
        _sum_into(totals, prof.get("totals", {}))
        _sum_into(rates, prof.get("rates", {}))
        for tag, snap in prof.get("histograms", {}).items():
            if not isinstance(snap, dict) or "buckets" not in snap:
                continue  # bucketless snapshots can't merge exactly
            hists[tag] = merge_hist_snapshots(hists[tag], snap) \
                if tag in hists else snap
        for s in m.get("slow_traces", []) or []:
            s = dict(s)
            s["node"] = nid
            slow.append(s)
    gh.pop("exec_lag_mean", None)  # a sum of means is meaningless
    out["counters"] = counters
    out["engine"] = engine
    out["net"] = net
    out["spans"] = spans
    out["groups_health"] = gh
    out["profiler"] = {"totals": totals, "rates": rates,
                       "histograms": hists}
    if slow:
        slow.sort(key=lambda s: -float(s.get("total_s", 0)))
        out["slow_traces"] = slow[:64]
    return out


def merge_cluster_engine(per_node: Dict[int, Optional[dict]]) -> dict:
    """Merge per-node ``/engine`` snapshots (``/cluster/engine``): one
    fleet view of the device axis.  Ledger counters sum (a retrace
    anywhere is a retrace), slab bytes and row counts sum, and the
    capacity headroom is the fleet SUM of per-node estimates (each node
    hosts distinct groups); per-node detail rides along under
    ``nodes`` so a skewed member is still attributable."""
    merged: dict = {}
    est = 0
    have_est = False
    for nid, m in sorted(per_node.items()):
        if not m:
            continue
        for key in ("ledger", "cache", "memory", "balance", "waves"):
            sub = m.get(key)
            if isinstance(sub, dict):
                d = merged.setdefault(key, {})
                _sum_into(d, sub)
        mem = m.get("memory") or {}
        if isinstance(mem.get("max_groups_estimate"), (int, float)):
            est += int(mem["max_groups_estimate"])
            have_est = True
    if have_est:
        merged.setdefault("memory", {})["max_groups_estimate"] = est
    elif isinstance(merged.get("memory"), dict):
        # summed per-node Nones never set the key; make absence explicit
        merged["memory"].pop("max_groups_estimate", None)
    return {
        "cluster": {"nodes": {nid: int(m is not None)
                              for nid, m in per_node.items()}},
        **merged,
        "nodes": {nid: m for nid, m in sorted(per_node.items()) if m},
    }


async def cluster_trace(peers: Dict[int, Tuple[str, int]],
                        trace_id: int, timeout: float = 3.0) -> dict:
    """``/cluster/traces/<id>``: pull every node's trace export and
    stitch them (plus this process's own share) into one cross-node
    breakdown."""
    from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
    per_node = await scrape_cluster(peers, f"/traces/{trace_id}",
                                    timeout)
    exports = [m for m in per_node.values() if m]
    exports.append(RequestInstrumenter.export_trace(trace_id))
    return {
        "trace_id": int(trace_id),
        "nodes_scraped": {nid: int(m is not None)
                          for nid, m in per_node.items()},
        "breakdown": RequestInstrumenter.cluster_breakdown(
            trace_id, exports),
    }
