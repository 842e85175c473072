"""Full reconfiguration-aware async client.

The port's own copy of ``gigapaxos_tpu/reconfiguration/appclient.py``
(pure Python, unchanged but for its imports).

Reference analog: ``reconfiguration/ReconfigurableAppClientAsync.java`` —
name create/delete/lookup against reconfigurators plus app requests against
actives, with an active-replica cache refreshed on misses and retries with
failover.  Replica selection (ref: ``E2ELatencyAwareRedirector`` +
``EchoRequest``): stick with the last replica that answered for a name;
otherwise try nearest-first by measured RTT (passive EWMA on every rpc,
seedable with ``probe_latencies()`` ECHO round trips).
"""

from __future__ import annotations

import asyncio
import itertools
import struct
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.reconfiguration import rcpackets as rc
from gigapaxos_tpu_torch.reconfiguration.node import NodeConfig
from gigapaxos_tpu_torch.reconfiguration.rcdb import b64e
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.appclient")

_LEN = struct.Struct("<I")

CLIENT_ID_BASE = 1 << 16  # below this: server node ids (id spaces disjoint)


class AppError(RuntimeError):
    """The request was decided and its execution failed deterministically
    on every replica (Response status 4).  Retrying cannot succeed — the
    servers answer retransmits with this same cached error."""

    def __init__(self, payload: bytes):
        super().__init__(payload.decode("utf-8", "replace"))
        self.payload = payload


class ReconfigurableAppClient:
    """``await`` API: create/delete/actives/move + send_request."""

    def __init__(self, client_id: int, config: NodeConfig,
                 timeout: float = 5.0, retries: int = 3):
        assert CLIENT_ID_BASE <= client_id < (1 << 31)
        self.id = client_id
        self.config = config
        self.timeout = timeout
        self.retries = retries
        self._seq = itertools.count(1)
        self._conns: Dict[int, Tuple[asyncio.StreamReader,
                                     asyncio.StreamWriter]] = {}
        self._conn_locks: Dict[int, asyncio.Lock] = {}
        self._read_tasks: Dict[int, asyncio.Task] = {}
        self._waiting: Dict[int, asyncio.Future] = {}
        self._actives_cache: Dict[str, List[int]] = {}
        self._preferred: Dict[str, int] = {}   # name -> active that answered
        # measured RTT EWMAs per node (ref: E2ELatencyAwareRedirector
        # fed by EchoRequest): updated passively on every rpc and on
        # demand by probe_latencies(); replica failover tries nearest
        # first
        self._rtt: Dict[int, float] = {}
        self._rcs = sorted(config.reconfigurators)

    # -- plumbing ----------------------------------------------------------

    def _rid(self) -> int:
        return (self.id << 32) | next(self._seq)

    async def _conn(self, node: int):
        c = self._conns.get(node)
        if c is not None and not c[1].is_closing():
            return c
        # per-node lock: without it, concurrent first requests each open a
        # connection and all but the last socket/read-task leak
        lock = self._conn_locks.setdefault(node, asyncio.Lock())
        async with lock:
            c = self._conns.get(node)
            if c is not None and not c[1].is_closing():
                return c
            host, port = self.config.addr_map[node]
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(_LEN.pack(4) + struct.pack("<i", self.id))
            self._conns[node] = (reader, writer)
            self._read_tasks[node] = asyncio.get_running_loop().create_task(
                self._read_loop(node, reader))
            return reader, writer

    async def _read_loop(self, node: int, reader: asyncio.StreamReader):
        try:
            while True:
                hdr = await reader.readexactly(4)
                (ln,) = _LEN.unpack(hdr)
                frame = await reader.readexactly(ln)
                obj = pkt.decode(frame)
                rid = None
                if isinstance(obj, pkt.Response):
                    rid = obj.req_id
                elif isinstance(obj, pkt.Control) and \
                        obj.body.get("rc") in (rc.REPLY, rc.ECHO):
                    rid = obj.body.get("rid")
                if rid is not None:
                    fut = self._waiting.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(obj)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            c = self._conns.pop(node, None)
            if c is not None:
                c[1].close()

    async def _rpc(self, node: int, rid: int, frame: bytes):
        _, writer = await self._conn(node)
        fut = asyncio.get_running_loop().create_future()
        self._waiting[rid] = fut
        t0 = asyncio.get_running_loop().time()
        try:
            writer.write(_LEN.pack(len(frame)) + frame)
            await writer.drain()
            out = await asyncio.wait_for(fut, self.timeout)
            # passive RTT EWMA (includes server decide time — the same
            # end-to-end signal the reference's redirector learns from)
            dt = asyncio.get_running_loop().time() - t0
            prev = self._rtt.get(node)
            self._rtt[node] = dt if prev is None else \
                prev + 0.2 * (dt - prev)
            return out
        finally:
            self._waiting.pop(rid, None)

    def _by_latency(self, actives: List[int]) -> List[int]:
        """Actives ordered nearest-first by measured RTT; unmeasured
        nodes keep their cache order after the measured ones are tried
        (they get measured the first time failover reaches them)."""
        if not self._rtt:
            return list(actives)
        inf = float("inf")
        return sorted(actives, key=lambda a: self._rtt.get(a, inf))

    async def probe_latencies(self) -> Dict[int, float]:
        """RTT-probe every active with concurrent ECHO round trips
        (ref: ``EchoRequest`` feeding ``E2ELatencyAwareRedirector``);
        seeds the latency-aware replica ordering before any app
        traffic.  Returns actives only (the passive EWMAs also track
        reconfigurators internally)."""
        async def one(a: int) -> None:
            rid = self._rid()
            try:
                await self._rpc(a, rid, pkt.Control(
                    self.id, {"rc": rc.ECHO, "rid": rid}).encode())
            except (asyncio.TimeoutError, ConnectionError, OSError):
                self._rtt.pop(a, None)  # unreachable: sorts last

        await asyncio.gather(*(one(a) for a in self.config.actives))
        return {a: self._rtt[a] for a in self.config.actives
                if a in self._rtt}

    async def _control(self, body: dict) -> dict:
        """Send a control op to a reconfigurator, retrying across them."""
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            node = self._rcs[attempt % len(self._rcs)]
            try:
                resp = await self._rpc(node, body["rid"],
                                       pkt.Control(self.id, body).encode())
                return resp.body
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = e
        raise TimeoutError(f"control op {body.get('rc')} failed: {last}")

    # -- name ops ----------------------------------------------------------

    async def create(self, name: str, initial_state: bytes = b"") -> bool:
        b = await self._control(rc.create_name(name, b64e(initial_state),
                                               self._rid()))
        if b.get("ok"):
            self._actives_cache[name] = list(b.get("actives") or [])
        return bool(b.get("ok"))

    async def delete(self, name: str) -> bool:
        b = await self._control(rc.delete_name(name, self._rid()))
        self._actives_cache.pop(name, None)
        self._preferred.pop(name, None)
        return bool(b.get("ok"))

    @staticmethod
    def _wire_chunks(names: List[str]) -> List[List[str]]:
        from gigapaxos_tpu_torch.reconfiguration.rcconfig import RC
        from gigapaxos_tpu_torch.utils.config import Config
        cb = int(Config.get(RC.CLIENT_BATCH))
        return [list(names[at:at + cb])
                for at in range(0, len(names), cb)] or [[]]

    async def create_names(self, names: List[str],
                           initial_state: bytes = b"",
                           timeout: Optional[float] = None) -> int:
        """Batched create (ref: batched CreateServiceName).  One control
        round trip per RC.CLIENT_BATCH names; the entry reconfigurator
        buckets each wire batch by owning RC group and aggregates.
        Returns #names now READY."""
        done = 0
        for chunk in self._wire_chunks(list(names)):
            b = rc.create_batch(
                [[n, b64e(initial_state)] for n in chunk], self._rid())
            resp = await self._control_t(b, timeout)
            done += int(resp.get("n_ok", 0))
        return done

    async def delete_names(self, names: List[str],
                           timeout: Optional[float] = None) -> int:
        """Batched delete; returns #names now gone."""
        done = 0
        for chunk in self._wire_chunks(list(names)):
            resp = await self._control_t(
                rc.delete_batch(chunk, self._rid()), timeout)
            done += int(resp.get("n_ok", 0))
        for n in names:
            self._actives_cache.pop(n, None)
            self._preferred.pop(n, None)
        return done

    async def _control_t(self, body: dict, timeout: Optional[float]):
        if timeout is None:
            return await self._control(body)
        saved = self.timeout
        self.timeout = timeout
        try:
            return await self._control(body)
        finally:
            self.timeout = saved

    async def get_actives(self, name: str) -> List[int]:
        b = await self._control(rc.req_actives(name, self._rid()))
        if not b.get("ok"):
            raise KeyError(f"no such service: {name}")
        self._actives_cache[name] = list(b["actives"])
        return self._actives_cache[name]

    async def move(self, name: str, new_actives: List[int]) -> bool:
        b = await self._control(rc.move_name(name, list(new_actives),
                                             self._rid()))
        if b.get("ok"):
            self._actives_cache[name] = list(b.get("actives") or
                                             new_actives)
            self._preferred.pop(name, None)
        return bool(b.get("ok"))

    # -- app requests ------------------------------------------------------

    async def send_request(self, name: str, payload: bytes,
                           flags: int = 0) -> bytes:
        gkey = pkt.group_key(name)
        req_id = self._rid()
        last: Optional[Exception] = None
        tried: set = set()
        for attempt in range(self.retries + 1):
            actives = self._actives_cache.get(name)
            if not actives:
                actives = await self.get_actives(name)
            pref = self._preferred.get(name)
            order = self._by_latency(actives)
            if pref in actives and attempt == 0:
                dst = pref
            else:
                # nearest untried replica first; a node that just
                # failed in THIS call is not retried while an untried
                # one remains
                dst = next((a for a in order if a not in tried),
                           order[attempt % len(order)])
            tried.add(dst)
            try:
                resp = await self._rpc(
                    dst, req_id,
                    pkt.Request(self.id, gkey, req_id, flags,
                                payload).encode())
                if resp.status == 0:
                    self._preferred[name] = dst
                    return resp.payload
                if resp.status == 4:
                    # deterministic app failure: terminal (see AppError)
                    self._preferred[name] = dst
                    raise AppError(resp.payload)
                if resp.status in (2, 3):
                    # 2: replica no longer hosts the group; 3: the group's
                    # epoch stopped under us (reconfiguration in flight) —
                    # refresh the actives cache and retry (ref: active-
                    # replica cache invalidation on miss).  NB: a retried
                    # non-idempotent request that was already decided
                    # before the epoch's stop slot may re-execute in the
                    # next epoch (dedup tables are per-node, matching the
                    # reference); idempotent app ops are recommended across
                    # reconfigurations.
                    self._actives_cache.pop(name, None)
                    self._preferred.pop(name, None)
                    await asyncio.sleep(0.1)
                last = RuntimeError(f"status={resp.status} from {dst}")
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                self._preferred.pop(name, None)
                # a dead node must not keep its stale low RTT and stay
                # ranked first for every later request
                self._rtt.pop(dst, None)
                last = e
        raise TimeoutError(f"request to {name!r} failed: {last}")

    async def close(self) -> None:
        for t in self._read_tasks.values():
            t.cancel()
        for _, w in self._conns.values():
            w.close()
        self._conns.clear()
        self._read_tasks.clear()
