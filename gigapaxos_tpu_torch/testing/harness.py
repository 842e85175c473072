"""In-process multi-node cluster + load generator.

Ref: ``gigapaxos/testing/TESTPaxosMain.java`` (single-JVM multi-node
emulation over REAL loopback sockets — no transport fakes, SURVEY.md
§4.2) + ``TESTPaxosClient`` (throughput/latency measurement) +
``TESTPaxosConfig`` (fault injection: message drops, node crash).
"""

from __future__ import annotations

import asyncio
import os
import socket
import time
from typing import Dict, List, Optional, Tuple, Type

import numpy as np

from gigapaxos_tpu_torch.paxos.client import PaxosClientAsync
from gigapaxos_tpu_torch.paxos.interfaces import NoopApp, Replicable
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.utils.config import Config


# Deadline scaling for slow hosts: generous default on 1-2 core boxes
# (a neighboring JIT compile can starve a node for seconds); set
# GP_TEST_TIMEOUT_SCALE=1 on beefy machines for speed.  THE one copy of
# the policy — tests/conftest.py and the chaos scenario runner share it.
_TSCALE = float(os.environ.get(
    "GP_TEST_TIMEOUT_SCALE", "3" if (os.cpu_count() or 1) <= 2 else "1"))


def tscale(t: float) -> float:
    """Scale a deadline by the slow-host environment factor."""
    return t * _TSCALE


def require_engine(backend: str) -> None:
    """Raise, before any node is built, for an engine the port does not
    have (``backend="native"``: ``NotImplementedError``) or for the
    columnar engine on a CUDA device this machine lacks: the bench and
    chaos CLIs run on ``PC.COLUMNAR_DEVICE`` and never move to the CPU
    on their own (``GP_PC_COLUMNAR_DEVICE=cpu`` asks for it)."""
    import torch

    from gigapaxos_tpu_torch.paxos.manager import _refuse_unported
    _refuse_unported(backend)
    dev = str(Config.get(PC.COLUMNAR_DEVICE))
    if backend == "columnar" and torch.device(dev).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for the columnar engine (PC.COLUMNAR_DEVICE"
            f"={dev!r}); set GP_PC_COLUMNAR_DEVICE=cpu to run it on the "
            "host CPU")


def free_ports(n: int) -> List[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class PaxosEmulation:
    """N paxos nodes in one process; groups pre-created on all members.

    ``group_size`` members per group (first ``group_size`` nodes by
    name-hash rotation), so >3-node emulations exercise overlapping
    quorums like the reference's TESTPaxos defaults.
    """

    def __init__(self, logdir: str, n_nodes: int = 3,
                 n_groups: int = 1000, group_size: int = 3,
                 backend: str = "columnar",
                 app_cls: Type[Replicable] = NoopApp,
                 capacity: int = 1 << 16, window: int = 16,
                 sync_wal: bool = False,
                 ping_interval_s: Optional[float] = None,
                 failure_timeout_s: Optional[float] = None):
        Config.set(PC.SYNC_WAL, sync_wal)
        if ping_interval_s is not None:
            Config.set(PC.PING_INTERVAL_S, ping_interval_s)
        if failure_timeout_s is not None:
            Config.set(PC.FAILURE_TIMEOUT_S, failure_timeout_s)
        self.logdir = logdir
        self.n_nodes = n_nodes
        self.group_size = min(group_size, n_nodes)
        self.backend = backend
        self.app_cls = app_cls
        self.capacity = capacity
        self.window = window
        ports = free_ports(n_nodes)
        self.addr_map: Dict[int, Tuple[str, int]] = {
            i: ("127.0.0.1", ports[i]) for i in range(n_nodes)}
        self.nodes: Dict[int, Optional[PaxosNode]] = {}
        for i in range(n_nodes):
            self._boot(i)
        self.groups: List[str] = []
        if n_groups:
            self.create_groups(n_groups)

    def _boot(self, i: int) -> PaxosNode:
        node = PaxosNode(i, self.addr_map, self.app_cls(),
                         f"{self.logdir}/n{i}", backend=self.backend,
                         capacity=self.capacity, window=self.window)
        node.start()
        self.nodes[i] = node
        return node

    def members_of(self, name: str) -> Tuple[int, ...]:
        if self.n_nodes == self.group_size:
            return tuple(range(self.n_nodes))
        start = hash(name) % self.n_nodes
        return tuple(sorted((start + j) % self.n_nodes
                            for j in range(self.group_size)))

    def create_groups(self, n: int, prefix: str = "g",
                      names: Optional[List[str]] = None) -> List[str]:
        if names is None:
            names = [f"{prefix}{i}" for i in range(n)]
        per_node: Dict[int, List] = {}
        for name in names:
            mem = self.members_of(name)
            for m in mem:
                per_node.setdefault(m, []).append((name, mem))
        # chunked + interleaved across nodes: one giant create_groups
        # call holds a node's engine lock for the whole batch, starving
        # its worker (and at 100K+ groups, starving ping processing past
        # the failure timeout — see the manager's self-stall guard)
        CH = 16384
        at = 0
        while True:
            any_left = False
            for m, items in per_node.items():
                part = items[at:at + CH]
                if part:
                    any_left = True
                    self.nodes[m].create_groups(part)
            if not any_left:
                break
            at += CH
        self.groups.extend(names)
        return names

    # -- fault injection (ref: TESTPaxosConfig) -------------------------

    def set_drop_rate(self, node: int, rate: float) -> None:
        self.nodes[node].transport.test_drop_rate = rate

    def kill(self, node: int) -> None:
        """Crash-stop: pending packets and unfsynced WAL writes are
        dropped, no goodbye (ref: TESTPaxosConfig crash emulation)."""
        self.nodes[node].stop(abort=True)
        self.nodes[node] = None

    def restart(self, node: int) -> PaxosNode:
        """Reboot from the WAL/checkpoint directory (recovery path)."""
        assert self.nodes[node] is None, "kill() first"
        return self._boot(node)

    def stop(self) -> None:
        for nd in self.nodes.values():
            if nd is not None:
                nd.stop()

    # -- load generation (ref: TESTPaxosClient) -------------------------

    def run_load_fast(self, n_requests: int, concurrency: int = 512,
                      payload: bytes = b"x", timeout: float = 30.0,
                      client_id: int = 1 << 20,
                      entry_shift: int = 0) -> Dict:
        """Windowed pipelined load (ref TESTPaxosClient; see
        testing/loadgen.py) — the measurement path for the throughput
        bench; ``run_load`` below is the per-request-client path used by
        correctness tests.  ``entry_shift`` rotates each group's entry
        node away from its coordinator (shift 1 = next member), forcing
        the per-request forwarding path — the wire-bench uses it to
        exercise peer-to-peer proposal traffic."""
        from gigapaxos_tpu_torch.testing.loadgen import run_fast_load_sync
        live = sorted(i for i, nd in self.nodes.items() if nd is not None)
        servers = [self.addr_map[i] for i in live]
        # route each group to its initial coordinator if alive
        route = []
        from gigapaxos_tpu_torch.paxos.packets import group_key
        for g in self.groups:
            mem = self.members_of(g)
            coord = mem[(group_key(g) + entry_shift) % len(mem)]
            route.append(live.index(coord) if coord in live else 0)
        return run_fast_load_sync(
            servers, self.groups, n_requests, concurrency=concurrency,
            payload=payload, client_id=client_id, timeout=timeout,
            route=route)

    def run_load(self, n_requests: int, concurrency: int = 64,
                 payload: bytes = b"x", timeout: float = 15.0,
                 client_id: int = 1 << 20,
                 servers: Optional[List[int]] = None) -> Dict:
        """Round-robin ``n_requests`` over the groups; returns throughput
        + latency aggregates (ref: TESTPaxosClient's DelayProfiler
        output)."""
        groups = self.groups
        live = [i for i, nd in self.nodes.items() if nd is not None] \
            if servers is None else servers

        async def body():
            cli = PaxosClientAsync(
                client_id, [self.addr_map[i] for i in live],
                timeout=timeout)
            lat: List[float] = []
            errs = [0]
            sem = asyncio.Semaphore(concurrency)

            async def one(k: int):
                async with sem:
                    t0 = time.perf_counter()
                    try:
                        r = await cli.send_request(
                            groups[k % len(groups)], payload)
                        if r.status != 0:
                            errs[0] += 1
                            return
                        lat.append(time.perf_counter() - t0)
                    except (TimeoutError, asyncio.TimeoutError):
                        errs[0] += 1
            t0 = time.perf_counter()
            await asyncio.gather(*[one(k) for k in range(n_requests)])
            wall = time.perf_counter() - t0
            await cli.close()
            arr = np.asarray(lat)
            return {
                "requests": n_requests,
                "ok": len(lat),
                "errors": errs[0],
                "wall_s": round(wall, 3),
                "throughput_rps": round(len(lat) / wall, 1),
                # None (not 0.0) when nothing succeeded: an all-failing
                # run must not read as an infinitely fast one
                "lat_p50_ms": round(1e3 * float(np.percentile(arr, 50)),
                                    2) if lat else None,
                "lat_p99_ms": round(1e3 * float(np.percentile(arr, 99)),
                                    2) if lat else None,
            }
        return asyncio.run(body())
