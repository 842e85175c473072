"""Tiny per-node stats listener: GET /metrics | /stats | /healthz |
/groups | /groups/<id> | /traces/<trace_id> | /blackbox[/dump] |
/engine | /engine/kernels.

The port's own copy of ``gigapaxos_tpu/net/statshttp.py``; ``/chaos``
and ``/storage`` drive the port's fault planes (``chaos/faults.py``).

Every server process becomes scrapeable without the full HTTP gateway:
a dependency-free asyncio HTTP/1.0-style responder living on the node's
existing event loop (enabled by ``PC.STATS_PORT``; 0 binds an ephemeral
port, exposed via :attr:`port`).  ``/metrics`` is Prometheus text
exposition over the node's ``metrics()`` dict, ``/stats`` the same dict
as JSON — the machine-readable replacement for scraping the one-line
``stats()`` render.  ``/groups`` is the consensus-health introspection
plane (leader, ballot, churn, exec/WAL lag per group) and
``/traces/<id>`` exports this node's share of one sampled request's
trace ring — the per-node source the gateway's ``/cluster/traces/<id>``
stitches into a cross-node breakdown.
"""

from __future__ import annotations

import asyncio
import json
from typing import Callable, Optional, Tuple
from urllib.parse import unquote

from gigapaxos_tpu_torch.utils.logutil import get_logger
from gigapaxos_tpu_torch.utils.prom import metrics_response

log = get_logger("gp.statshttp")


def parse_trace_id(s: str) -> Optional[int]:
    """Trace ids arrive as decimal or 0x-hex (the format slow-trace
    logs and ``format()`` print)."""
    try:
        return int(s, 0)
    except ValueError:
        return None


def _json_resp(obj) -> Tuple[str, str, bytes]:
    return ("200 OK", "application/json",
            json.dumps(obj, default=str).encode())


def observability_routes(path: str, groups_fn: Optional[Callable] = None,
                         group_fn: Optional[Callable] = None,
                         blackbox=None,
                         engine_fn: Optional[Callable] = None,
                         engine_kernels_fn: Optional[Callable] = None):
    """Shared GET route bodies for the introspection endpoints (the
    per-node listener and the HTTP gateway serve identical content):

    - ``/groups[?limit=N]``   -> ``groups_fn(limit)`` summary dict
    - ``/groups/<name|gkey>`` -> ``group_fn(ident)`` detail (404 None)
    - ``/traces/<trace_id>``  -> this process's trace export + its
      local breakdown (the cluster stitch input)
    - ``/blackbox``           -> flight-recorder ring state
      (``{"enabled": false}`` when ``PC.BLACKBOX_MB`` is 0)
    - ``/blackbox/dump``      -> snapshot the ring to a ``.gpbb``
      capture now; answers with its path
    - ``/engine``             -> ``engine_fn()``: the device-axis
      flight deck (compile/retrace ledger, slab memory accounting,
      per-shard wave timing / row balance)
    - ``/engine/kernels``     -> ``engine_kernels_fn()``: per-kernel
      ledger rows + compiled-HLO cost analysis

    Returns ``(status, content_type, body)`` or None (no match).
    """
    path, _, query = path.partition("?")
    if path == "/engine" and engine_fn is not None:
        return _json_resp(engine_fn())
    if path == "/engine/kernels" and engine_kernels_fn is not None:
        return _json_resp(engine_kernels_fn())
    if path == "/groups" and groups_fn is not None:
        limit = 256
        for part in query.split("&"):
            if part.startswith("limit="):
                try:
                    limit = max(1, int(part[len("limit="):]))
                except ValueError:
                    pass
        return _json_resp(groups_fn(limit=limit))
    if path.startswith("/groups/") and group_fn is not None:
        info = group_fn(unquote(path[len("/groups/"):]))
        if info is None:
            return ("404 Not Found", "application/json",
                    b'{"err":"no such group"}')
        return _json_resp(info)
    if path.startswith("/traces/"):
        tid = parse_trace_id(path[len("/traces/"):])
        if tid is None:
            return ("400 Bad Request", "application/json",
                    b'{"err":"bad trace id"}')
        from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
        ex = RequestInstrumenter.export_trace(tid)
        ex["breakdown"] = RequestInstrumenter.cluster_breakdown(tid, [ex])
        return _json_resp(ex)
    if path == "/blackbox":
        if blackbox is None:
            return _json_resp({"enabled": False})
        return _json_resp(blackbox.snapshot())
    if path == "/blackbox/dump":
        if blackbox is None:
            return ("409 Conflict", "application/json",
                    b'{"err":"blackbox disabled (PC.BLACKBOX_MB=0)"}')
        return _json_resp({"dumped": blackbox.dump("http")})
    if path == "/chaos" or path.startswith("/chaos/"):
        # runtime control + state of the fault plane (chaos/faults.py);
        # the original path (with query) is re-joined for the verbs
        from gigapaxos_tpu_torch.chaos.faults import ChaosPlane
        return ChaosPlane.http_route(
            path + (("?" + query) if query else ""))
    if path == "/storage" or path.startswith("/storage/"):
        # the storage fault plane (StorageChaos) — same verb shape as
        # /chaos: /storage, /storage/set?..., /storage/clear, /storage/seed
        from gigapaxos_tpu_torch.chaos.faults import StorageChaos
        return StorageChaos.http_route(
            path + (("?" + query) if query else ""))
    return None


class StatsListener:
    """Serves a ``metrics_fn() -> dict`` over loopback HTTP, plus any
    ``extra_routes(path) -> (status, ctype, body) | None`` hook (the
    node wires its introspection routes through it)."""

    def __init__(self, metrics_fn: Callable[[], dict],
                 listen: Tuple[str, int] = ("127.0.0.1", 0),
                 extra_routes: Optional[Callable] = None,
                 health_fn: Optional[Callable[[], Optional[str]]] = None):
        self.metrics_fn = metrics_fn
        self.listen = listen
        self.extra_routes = extra_routes
        # health_fn() -> None (healthy) | short reason string (impaired);
        # flips /healthz to 503 so orchestrators stop routing new work
        # to a node that can no longer make proposals durable, while
        # /stats and /metrics keep answering (it still serves commits)
        self.health_fn = health_fn
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.listen[0], self.listen[1])

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            try:
                method, path, _ = line.decode().split(None, 2)
            except ValueError:
                return
            while True:  # drain headers; bodies are not accepted
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            status, ctype, out = self._route(method, path)
            writer.write(
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(out)}\r\n"
                f"Connection: close\r\n\r\n".encode() + out)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    def _route(self, method: str, path: str):
        if method != "GET":
            return "405 Method Not Allowed", "text/plain", b"GET only\n"
        if path == "/healthz":
            why = None
            if self.health_fn is not None:
                try:
                    why = self.health_fn()
                except Exception:
                    log.exception("health probe failed")
                    why = "health probe failed"
            if why is not None:
                return ("503 Service Unavailable", "text/plain",
                        f"unhealthy: {why}\n".encode())
            return "200 OK", "text/plain", b"ok\n"
        try:
            resp = metrics_response(path, self.metrics_fn)
            if resp is not None:
                return resp
            if self.extra_routes is not None:
                resp = self.extra_routes(path)
                if resp is not None:
                    return resp
        except Exception:
            log.exception("stats render failed")
            return ("500 Internal Server Error", "text/plain",
                    b"render failed\n")
        return "404 Not Found", "text/plain", b"no such route\n"
