"""Async paxos client (ref: ``gigapaxos/PaxosClientAsync.java``).

Capabilities kept: callback table keyed by request id (the reference's
``GCConcurrentHashMap``), replica selection + failover to the next replica,
retransmit on timeout, and a synchronous convenience wrapper.

The client speaks the same framed wire protocol as servers; replies ride
back over the client's own outbound connection (the transport's inbound
reply path, ref ``ClientMessenger``).
"""

from __future__ import annotations

import asyncio
import itertools
import struct
import threading
from typing import Dict, List, Optional, Tuple

from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.utils.logutil import get_logger

log = get_logger("gp.client")

_LEN = struct.Struct("<I")

_client_seq = itertools.count(1)


class PaxosClientAsync:
    """Asyncio client: ``await send_request(name_or_gkey, payload)``."""

    def __init__(self, client_id: int, servers: List[Tuple[str, int]],
                 timeout: float = 5.0, retries: Optional[int] = None,
                 retransmit_s: float = 1.0):
        assert 0 < client_id < (1 << 31), \
            "client id must fit the transport's signed-32 handshake"
        self.id = client_id
        self.servers = list(servers)
        self.timeout = timeout  # TOTAL budget per request
        # None (default): keep retransmitting until the deadline —
        # liveness across server-side dedupe reaping requires it.  An
        # int bounds the attempts for fail-fast callers (tools/tests
        # that want the first non-ok status surfaced quickly).
        self.retries = retries
        # first retransmit after this long (doubling), NOT after the
        # whole timeout — a request stuck behind a dead coordinator must
        # re-route quickly (ref: client retransmit; dedup is server-side)
        self.retransmit_s = retransmit_s
        self._seq = itertools.count(1)
        self._conns: Dict[int, Tuple[asyncio.StreamReader,
                                     asyncio.StreamWriter]] = {}
        self._read_tasks: Dict[int, asyncio.Task] = {}
        self._conn_locks: Dict[int, asyncio.Lock] = {}
        self._waiting: Dict[int, asyncio.Future] = {}
        self._preferred = 0
        # client-side pushback (ref: the reference's outstanding-
        # request table cap): at most PC.CLIENT_MAX_OUTSTANDING
        # requests in flight per client; excess senders queue on the
        # semaphore instead of piling up retransmit state.  Created
        # lazily inside the running loop (the sync wrapper builds the
        # client on one thread and runs it on another).
        self._max_outstanding = 0
        self._outstanding: Optional[asyncio.Semaphore] = None

    def next_req_id(self) -> int:
        return (self.id << 32) | next(self._seq)

    async def _conn(self, idx: int):
        c = self._conns.get(idx)
        if c is not None and not c[1].is_closing():
            return c
        # per-server lock: a concurrent first burst must not open one
        # connection per request (socket/read-task leak)
        lock = self._conn_locks.setdefault(idx, asyncio.Lock())
        async with lock:
            c = self._conns.get(idx)
            if c is not None and not c[1].is_closing():
                return c
            host, port = self.servers[idx]
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(_LEN.pack(4) + struct.pack("<i", self.id))
            self._conns[idx] = (reader, writer)
            t = asyncio.get_running_loop().create_task(
                self._read_loop(idx, reader))
            self._read_tasks[idx] = t
            return reader, writer

    async def _read_loop(self, idx: int, reader: asyncio.StreamReader):
        try:
            while True:
                hdr = await reader.readexactly(4)
                (ln,) = _LEN.unpack(hdr)
                frame = await reader.readexactly(ln)
                obj = pkt.decode(frame)
                if isinstance(obj, (pkt.Response, pkt.CreateGroupAck)):
                    rid = obj.req_id if isinstance(obj, pkt.Response) \
                        else obj.gkey
                    fut = self._waiting.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(obj)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            self._conns.pop(idx, None)

    async def send_request(self, name: str, payload: bytes,
                           flags: int = 0) -> pkt.Response:
        """Send to the preferred replica; on timeout retransmit (same id —
        dedup is server-side) to the next replica.  In-flight requests
        per client are capped at ``PC.CLIENT_MAX_OUTSTANDING`` (0
        disables): callers past the cap wait their turn here."""
        if self._outstanding is None:
            from gigapaxos_tpu_torch.paxos.paxosconfig import PC
            from gigapaxos_tpu_torch.utils.config import Config
            self._max_outstanding = max(
                0, int(Config.get(PC.CLIENT_MAX_OUTSTANDING)))
            self._outstanding = asyncio.Semaphore(
                self._max_outstanding or 1)
        if self._max_outstanding:
            async with self._outstanding:
                return await self._send_request(name, payload, flags)
        return await self._send_request(name, payload, flags)

    async def _send_request(self, name: str, payload: bytes,
                            flags: int = 0) -> pkt.Response:
        gkey = pkt.group_key(name)
        req_id = self.next_req_id()
        # mint the trace context at the client (the cluster tracing
        # plane's entry point): when this process samples the request
        # — or the caller pre-set FLAG_SAMPLED — stamp the wire bit so
        # every node honors the verdict without recomputing it.  With
        # tracing disabled this is one class-attribute check.
        from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
        if RequestInstrumenter.enabled:
            ctx = RequestInstrumenter.mint(
                req_id, bool(flags & pkt.Request.FLAG_SAMPLED))
            if ctx.sampled:
                flags |= pkt.Request.FLAG_SAMPLED
        last_exc: Optional[Exception] = None
        deadline = asyncio.get_running_loop().time() + self.timeout
        attempt = 0
        while True:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                break
            if self.retries is not None and attempt > self.retries:
                break
            # escalate the retransmit interval up to a CAP and keep
            # retransmitting until the deadline.  Liveness depends on
            # it: the server swallows retransmits of an in-flight
            # proposal (dedupe) and only reaps that entry after ~2
            # minutes — a client that stops retransmitting (the old
            # code let the final attempt silently wait the WHOLE
            # remaining budget) can never get the request re-proposed
            # after the reap, and stalls for its full timeout
            # (observed: 1 request stuck 600s while 15 finished in ms).
            if self.retries is not None and attempt == self.retries:
                # bounded mode keeps its old contract: the final
                # attempt may wait out the whole remaining budget
                wait = remaining
            else:
                wait = min(self.retransmit_s * (1 << min(attempt, 4)),
                           remaining)
            idx = (self._preferred + attempt) % len(self.servers)
            try:
                _, writer = await self._conn(idx)
                fut = asyncio.get_running_loop().create_future()
                self._waiting[req_id] = fut
                frame = pkt.Request(self.id, gkey, req_id, flags,
                                    payload).encode()
                writer.write(_LEN.pack(len(frame)) + frame)
                await writer.drain()
                resp = await asyncio.wait_for(fut, wait)
                if resp.status == 0:
                    self._preferred = idx
                    return resp
                if resp.status == 4:
                    # deterministic app failure: the op was decided and
                    # its execution failed identically on every replica —
                    # retrying cannot succeed (servers answer retransmits
                    # from the response cache), so surface it
                    self._preferred = idx
                    return resp
                if resp.status == 5 and self._preferred == idx:
                    # disk-full / WAL-degraded shed: this server cannot
                    # make anything durable right now.  The per-attempt
                    # rotation below retries elsewhere; ALSO demote it
                    # as the preferred server so the next request
                    # starts elsewhere instead of re-discovering the
                    # shed on its first attempt
                    self._preferred = (idx + 1) % len(self.servers)
                last_exc = RuntimeError(f"status={resp.status}")
                # non-ok statuses are immediate (no wait): back off a
                # beat so a re-electing group isn't hammered
                await asyncio.sleep(
                    min(0.05 * (1 << min(attempt, 4)), remaining))
            except asyncio.TimeoutError as e:
                last_exc = e  # the wait itself consumed the interval
            except (ConnectionError, OSError) as e:
                # connect refused/reset fails instantly: back off so an
                # all-servers-down window is not a tight connect spin
                # pinning the event loop for the whole budget
                last_exc = e
                await asyncio.sleep(min(
                    0.05 * (1 << min(attempt, 4)), remaining))
            finally:
                self._waiting.pop(req_id, None)
            attempt += 1
        raise TimeoutError(
            f"request {req_id:#x} to {name!r} failed: {last_exc}")

    async def create_group(self, name: str, members: Tuple[int, ...],
                           server_ids: List[int],
                           initial_state: bytes = b"") -> bool:
        """Paxos-only-mode create: instruct each listed server (by index
        into ``self.servers``) to create the group locally (the harness /
        reconfiguration path; ref ``PaxosManager.createPaxosInstance``)."""
        oks = 0
        gkey = pkt.group_key(name)
        for idx in server_ids:
            _, writer = await self._conn(idx)
            fut = asyncio.get_running_loop().create_future()
            self._waiting[gkey] = fut
            frame = pkt.CreateGroup(self.id, name, members, 0,
                                    initial_state).encode()
            writer.write(_LEN.pack(len(frame)) + frame)
            await writer.drain()
            try:
                ack = await asyncio.wait_for(fut, self.timeout)
                oks += int(ack.ok)
            except asyncio.TimeoutError:
                pass
            finally:
                self._waiting.pop(gkey, None)
        return oks == len(server_ids)

    async def close(self):
        tasks = list(self._read_tasks.values())
        for t in tasks:
            t.cancel()
        for _, w in self._conns.values():
            w.close()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._conns.clear()
        self._read_tasks.clear()


class PaxosClient:
    """Blocking wrapper running its own event loop thread (test/harness
    convenience; the reference's sync ``PaxosClient`` analog)."""

    def __init__(self, servers: List[Tuple[str, int]],
                 client_id: Optional[int] = None, timeout: float = 5.0,
                 retries: Optional[int] = None,
                 retransmit_s: float = 1.0):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True, name="gp-client")
        self._thread.start()
        cid = client_id or (1000 + next(_client_seq))
        self.async_client = PaxosClientAsync(cid, servers, timeout=timeout,
                                             retries=retries,
                                             retransmit_s=retransmit_s)

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def send_request(self, name: str, payload: bytes,
                     flags: int = 0) -> pkt.Response:
        return self._run(self.async_client.send_request(name, payload,
                                                        flags))

    def create_group(self, name: str, members, server_ids,
                     initial_state: bytes = b"") -> bool:
        return self._run(self.async_client.create_group(
            name, tuple(members), list(server_ids), initial_state))

    def close(self):
        self._run(self.async_client.close())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(5)
