"""HTTP front-end for name operations and app requests.

The port's own copy of ``gigapaxos_tpu/reconfiguration/http.py`` (pure
Python, unchanged but for its imports).

Reference analog: ``reconfiguration/http/HttpReconfigurator.java`` +
``http/HttpActiveReplica.java`` (Netty-based HTTP API).  Here: a
dependency-free asyncio HTTP/1.1 gateway wrapping
:class:`ReconfigurableAppClient`, deployable next to any node (or
standalone) so curl/browser clients can drive the cluster without the
binary wire protocol.

Routes::

    POST /create        {"name": ..., "initial_state": ...?}  -> {"ok"...}
    POST /delete        {"name": ...}                         -> {"ok"...}
    GET  /actives/NAME                                        -> {"actives"}
    POST /request/NAME  raw body = app payload     -> raw app response
    GET  /healthz                                             -> ok
    GET  /metrics   Prometheus text exposition (process metrics, or a
                    node's metrics() via the ``metrics_source`` hook)
    GET  /stats     the same metrics as one JSON snapshot
    GET  /groups            per-group consensus health (co-located node)
    GET  /groups/NAME       one group's health detail
    GET  /traces/ID         this process's share of one sampled trace
    GET  /blackbox[/dump]   co-located node's flight-recorder state /
                            snapshot its ring to a .gpbb capture
    GET  /engine            co-located node's device-axis flight deck
                            (compile/retrace ledger, slab memory
                            accounting, per-shard wave timing)
    GET  /engine/kernels    per-kernel ledger rows + HLO cost analysis
    GET  /cluster/metrics   ONE scrape point for the deployment: fan
                            out to every PC.STATS_PEERS node's /stats,
                            merge (histograms bucket-wise), render
    GET  /cluster/stats     the merged snapshot as JSON
    GET  /cluster/traces/ID cross-node stitched trace breakdown
    GET  /cluster/blackbox[/dump]  flight-recorder fan-out: one call
                            snapshots (or dumps) every node's ring
    GET  /cluster/engine    device-axis fan-out: every node's /engine
                            merged (counters summed, capacity totalled)

Run standalone::

    python -m gigapaxos_tpu_torch.reconfiguration.http \
        --config conf/gigapaxos.properties --port 8080
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional, Tuple

from gigapaxos_tpu_torch.reconfiguration.appclient import \
    ReconfigurableAppClient
from gigapaxos_tpu_torch.reconfiguration.node import NodeConfig
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.http")

MAX_BODY = 8 * 1024 * 1024


class HttpFrontend:
    """Minimal HTTP/1.1 server bridging to the cluster."""

    def __init__(self, config: NodeConfig, listen: Tuple[str, int],
                 client_id: int = (1 << 21) + 7, timeout: float = 10.0,
                 metrics_source=None, obs_node=None, stats_peers=None):
        self.config = config
        self.listen = listen
        self.cli = ReconfigurableAppClient(client_id, config,
                                           timeout=timeout)
        # /metrics and /stats source: a co-located node's metrics()
        # when deployed next to one, else the process-global profiler
        self.metrics_source = metrics_source
        # /groups introspection source: a co-located PaxosNode (or any
        # object with groups_info/group_info)
        self.obs_node = obs_node
        # /cluster/* fan-out targets: {node_id: (host, stats_port)};
        # default from PC.STATS_PEERS ("id=host:port,...")
        if stats_peers is None:
            from gigapaxos_tpu_torch.net.cluster import parse_stats_peers
            from gigapaxos_tpu_torch.paxos.paxosconfig import PC
            from gigapaxos_tpu_torch.utils.config import Config
            stats_peers = parse_stats_peers(
                str(Config.get(PC.STATS_PEERS)))
        self.stats_peers = dict(stats_peers)
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.listen[0], self.listen[1])

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.cli.close()

    # -- request handling --------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, path, _ver = line.decode().split(None, 2)
                except ValueError:
                    return
                clen = 0
                keep = True
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    k = k.strip().lower()
                    if k == "content-length":
                        try:
                            clen = int(v.strip())
                        except ValueError:
                            clen = -1
                    elif k == "connection" and \
                            v.strip().lower() == "close":
                        keep = False
                if clen < 0:
                    # malformed / negative Content-Length: a clean 400
                    # beats an unhandled-exception connection kill
                    out = b'{"err":"bad content-length"}'
                    writer.write(
                        f"HTTP/1.1 400 Bad Request\r\n"
                        f"Content-Type: application/json\r\n"
                        f"Content-Length: {len(out)}\r\n"
                        f"Connection: close\r\n\r\n".encode() + out)
                    await writer.drain()
                    return
                if clen > MAX_BODY:
                    # Reject explicitly: clamping would leave the body
                    # remainder in the stream to be parsed as the next
                    # request line on a keep-alive connection (desync).
                    # Drain what the client is mid-sending first, else it
                    # sees a connection reset instead of the 413.
                    left = clen
                    while left > 0:
                        chunk = await reader.read(min(left, 1 << 16))
                        if not chunk:
                            break
                        left -= len(chunk)
                    out = b'{"err":"body too large"}'
                    writer.write(
                        f"HTTP/1.1 413 Payload Too Large\r\n"
                        f"Content-Type: application/json\r\n"
                        f"Content-Length: {len(out)}\r\n"
                        f"Connection: close\r\n\r\n".encode() + out)
                    await writer.drain()
                    return
                body = await reader.readexactly(clen) if clen else b""
                status, ctype, out = await self._route(method, path, body)
                writer.write(
                    f"HTTP/1.1 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(out)}\r\n"
                    f"Connection: {'keep-alive' if keep else 'close'}"
                    f"\r\n\r\n".encode() + out)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _route(self, method: str, path: str, body: bytes
                     ) -> Tuple[str, str, bytes]:
        try:
            if method == "GET" and path == "/healthz":
                return "200 OK", "text/plain", b"ok\n"
            if method == "GET" and path in ("/metrics", "/stats"):
                from gigapaxos_tpu_torch.utils.prom import (metrics_response,
                                                      process_metrics)
                return metrics_response(
                    path, self.metrics_source or process_metrics)
            if method == "GET" and (path.startswith("/groups")
                                    or path.startswith("/traces/")
                                    or path.startswith("/blackbox")
                                    or path.startswith("/engine")):
                from gigapaxos_tpu_torch.net.statshttp import \
                    observability_routes
                node = self.obs_node
                resp = observability_routes(
                    path,
                    groups_fn=node.groups_info if node else None,
                    group_fn=node.group_info if node else None,
                    blackbox=getattr(node, "blackbox", None),
                    engine_fn=getattr(node, "engine_info", None),
                    engine_kernels_fn=getattr(node, "engine_kernels",
                                              None))
                if resp is not None:
                    return resp
            if method == "GET" and path.startswith("/cluster/"):
                resp = await self._route_cluster(path)
                if resp is not None:
                    return resp
            if method == "GET" and path.startswith("/actives/"):
                name = path[len("/actives/"):]
                try:
                    actives = await self.cli.get_actives(name)
                except KeyError:
                    return ("404 Not Found", "application/json",
                            b'{"err":"nonexistent"}')
                return ("200 OK", "application/json",
                        json.dumps({"actives": actives}).encode())
            if method == "POST" and path == "/create":
                d = json.loads(body.decode() or "{}")
                if not isinstance(d, dict) or "name" not in d:
                    return ("400 Bad Request", "application/json",
                            b'{"err":"name required"}')
                ok = await self.cli.create(
                    d["name"],
                    str(d.get("initial_state", "")).encode())
                return ("200 OK", "application/json",
                        json.dumps({"ok": bool(ok)}).encode())
            if method == "POST" and path == "/delete":
                d = json.loads(body.decode() or "{}")
                if not isinstance(d, dict) or "name" not in d:
                    return ("400 Bad Request", "application/json",
                            b'{"err":"name required"}')
                ok = await self.cli.delete(d["name"])
                return ("200 OK", "application/json",
                        json.dumps({"ok": bool(ok)}).encode())
            if method == "POST" and path.startswith("/request/"):
                name = path[len("/request/"):]
                try:
                    resp = await self.cli.send_request(name, body)
                except KeyError:
                    return ("404 Not Found", "application/json",
                            b'{"err":"nonexistent"}')
                return "200 OK", "application/octet-stream", resp
            return "404 Not Found", "text/plain", b"no such route\n"
        except (ValueError, UnicodeDecodeError):
            return ("400 Bad Request", "application/json",
                    b'{"err":"bad request"}')
        except TimeoutError as e:
            return ("504 Gateway Timeout", "application/json",
                    json.dumps({"err": str(e)}).encode())
        except Exception:
            log.exception("http route %s %s failed", method, path)
            return ("500 Internal Server Error", "application/json",
                    b'{"err":"internal"}')

    async def _route_cluster(self, path: str
                             ) -> Optional[Tuple[str, str, bytes]]:
        """The cluster aggregation plane: fan out to every configured
        node's stats listener and merge.  With no peers configured the
        merge degenerates to an empty roster (the local process view
        stays on /metrics — /cluster/* answers for the fleet only)."""
        from gigapaxos_tpu_torch.net.cluster import (cluster_trace,
                                                     merge_cluster_engine,
                                                     merge_cluster_stats,
                                                     scrape_cluster)
        from gigapaxos_tpu_torch.net.statshttp import parse_trace_id
        if path in ("/cluster/metrics", "/cluster/stats"):
            per_node = await scrape_cluster(self.stats_peers, "/stats")
            merged = merge_cluster_stats(per_node)
            if path == "/cluster/stats":
                return ("200 OK", "application/json",
                        json.dumps(merged, default=str).encode())
            from gigapaxos_tpu_torch.utils.prom import render_prometheus
            return ("200 OK", "text/plain; version=0.0.4",
                    render_prometheus(merged).encode())
        if path.startswith("/cluster/traces/"):
            tid = parse_trace_id(path[len("/cluster/traces/"):])
            if tid is None:
                return ("400 Bad Request", "application/json",
                        b'{"err":"bad trace id"}')
            out = await cluster_trace(self.stats_peers, tid)
            return ("200 OK", "application/json",
                    json.dumps(out, default=str).encode())
        if path == "/cluster/engine":
            # device-axis fan-out: every node's compile/retrace ledger,
            # slab accounting and wave timing merged into a fleet view
            per_node = await scrape_cluster(self.stats_peers, "/engine")
            return ("200 OK", "application/json",
                    json.dumps(merge_cluster_engine(per_node),
                               default=str).encode())
        if path in ("/cluster/blackbox", "/cluster/blackbox/dump"):
            # flight-recorder fan-out: one call snapshots (or dumps)
            # every node's ring — a coherent cross-node incident
            sub = path[len("/cluster"):]
            per_node = await scrape_cluster(self.stats_peers, sub)
            return ("200 OK", "application/json",
                    json.dumps({"nodes": per_node},
                               default=str).encode())
        return None


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="gigapaxos_tpu_torch.reconfiguration.http",
        description="HTTP gateway to a gigapaxos-tpu cluster")
    p.add_argument("--config", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)
    config = NodeConfig.from_properties(args.config)

    async def run():
        fe = HttpFrontend(config, (args.host, args.port))
        await fe.start()
        log.info("http front-end on %s:%d", args.host, fe.port)
        try:
            await asyncio.Event().wait()
        finally:
            await fe.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
