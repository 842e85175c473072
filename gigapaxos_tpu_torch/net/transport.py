"""Asyncio TCP transport with length-prefixed frames.

Reference analog: ``nio/NIOTransport.java`` (single-selector non-blocking
TCP with connection cache, auto-reconnect, per-destination send queues with
byte-budget backpressure and congestion drop) + ``nio/MessageNIOTransport``
(length-prefixed typed frames) + ``nio/MessageExtractor`` (reassembly) —
re-expressed on asyncio: the event loop is the selector; per-destination
writer tasks are the send queues; ``asyncio.StreamReader.readexactly`` is
the extractor.

Capabilities kept from the reference:

- connect-on-demand with retry/backoff, connection cache keyed by node id
- per-destination byte budget; frames beyond it are DROPPED and counted
  (congestion drop — paxos tolerates loss; ref NIOTransport drops too)
- replies to un-mapped senders (clients) ride the inbound connection —
  the analog of the reference's ``ClientMessenger`` reply plumbing
- optional TLS (SERVER_AUTH / MUTUAL_AUTH analog via ssl contexts)
- byte/packet counters (ref: ``NIOInstrumenter``)

Threading model: all methods must be called on the transport's event loop
except :meth:`send_threadsafe`, which marshals onto it — the node runtime's
kernel worker thread uses that.
"""

from __future__ import annotations

import asyncio
import random
import ssl as ssl_mod
import struct
import threading
import time
from collections import deque
from typing import Awaitable, Callable, Dict, Optional, Tuple

import numpy as np

from gigapaxos_tpu_torch import native
from gigapaxos_tpu_torch.chaos.faults import ChaosPlane
from gigapaxos_tpu_torch.paxos import packets as pk
from gigapaxos_tpu_torch.utils.logutil import get_logger
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

log = get_logger("gp.net")

_LEN = struct.Struct("<I")
MAX_FRAME = native.MAX_FRAME  # one limit for scan + send paths
_FRAG_T = int(pk.PacketType.FRAG)
_HELLO_T = int(pk.PacketType.WIRE_HELLO)
# n_items field of the frame header (u32 at offset 5, after type+sender)
_HDR_N = struct.Struct("<I")


class WireChunk:
    """One scan-chunk of received frames as SoA columns (zero-copy
    receive): the consumed region as ONE immutable blob plus int64
    offset/length arrays straight from the native scan, with ``types``
    a single vectorized gather of every frame's type byte.  Consumers
    (the decode-split stage) read columns out of the blob via
    ``np.frombuffer`` views instead of slicing per-frame ``bytes`` —
    a 10K-frame storm chunk is one numpy pass, not 10K allocations."""

    __slots__ = ("blob", "offs", "lens", "types")

    def __init__(self, blob: bytes, offs: np.ndarray,
                 lens: np.ndarray):
        self.blob = blob
        self.offs = offs
        self.lens = lens
        self.types = np.frombuffer(blob, np.uint8)[offs]

    def __len__(self) -> int:
        return len(self.offs)

    def view(self, i: int) -> memoryview:
        o = int(self.offs[i])
        return memoryview(self.blob)[o:o + int(self.lens[i])]


class Demultiplexer:
    """Per-packet-type handler registry.

    Ref: ``nio/AbstractPacketDemultiplexer`` — ``register(type)`` +
    ``handleMessage``.  Handlers run on the event loop; anything heavy must
    hand off to the node's worker (the reference's thread-pool demux
    becomes an explicit hand-off queue in the node runtime).
    """

    def __init__(self):
        self._handlers: Dict[int, Callable] = {}

    def register(self, ptype: int, handler: Callable) -> None:
        self._handlers[int(ptype)] = handler

    def dispatch(self, frame: bytes) -> bool:
        ptype = frame[0]
        h = self._handlers.get(ptype)
        if h is None:
            log.warning("no handler for packet type %d", ptype)
            return False
        h(frame)
        return True


class _Peer:
    __slots__ = ("queue", "bytes_queued", "task", "writer", "wake")

    def __init__(self):
        self.queue: deque = deque()
        self.bytes_queued = 0
        self.task: Optional[asyncio.Task] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.wake = asyncio.Event()


class Transport:
    """One node's transport endpoint."""

    def __init__(self, node_id: int, listen_addr: Tuple[str, int],
                 addr_map: Dict[int, Tuple[str, int]],
                 on_frame: Callable[[bytes], None],
                 max_queue_bytes: int = 32 * 1024 * 1024,
                 ssl_server: Optional[ssl_mod.SSLContext] = None,
                 ssl_client: Optional[ssl_mod.SSLContext] = None,
                 reconnect_base_s: float = 0.05,
                 on_frames: Optional[Callable[[list], None]] = None,
                 wire_coalesce: bool = False, coalesce_min: int = 2,
                 rx_chunks: bool = False):
        self.id = node_id
        self.listen_addr = listen_addr
        self.addr_map = dict(addr_map)
        self.on_frame = on_frame
        # batch delivery: one callback per read chunk instead of one per
        # frame (a queue hand-off per frame measured ~1us + a wakeup each
        # on the 1-core host; a chunk carries tens of frames under load)
        self.on_frames = on_frames
        # steady-state sends go straight into the asyncio transport
        # buffer, skipping the per-peer queue+task hop
        self.direct_write = True
        self.max_queue_bytes = max_queue_bytes
        self.ssl_server = ssl_server
        self.ssl_client = ssl_client
        self.reconnect_base_s = reconnect_base_s

        self._peers: Dict[int, _Peer] = {}
        self._paced_tasks: set = set()
        # inbound connections from ids not in addr_map (clients): replies
        # go back over these writers
        self._inbound: Dict[int, asyncio.StreamWriter] = {}
        self._inbound_tasks: set = set()
        self._server: Optional[asyncio.base_events.Server] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

        # fault injection for the test harness (ref: TESTPaxosConfig
        # message-drop emulation): probability of dropping an outbound
        # payload.  0.0 in production.
        self.test_drop_rate = 0.0
        self._drop_rng = None

        # flight recorder (set by the owning node after construction;
        # single-writer at boot like the drop knobs above): when armed,
        # the scan loop notes per-chunk ingress frame/byte counts
        self.blackbox = None

        # NIOInstrumenter analog.  dropped_frames stays the total;
        # the per-cause split lets the metrics plane tell flaky links
        # (peer_gone/write_error + reconnects) from backpressure
        # (congestion) — indistinguishable in one number.
        self.sent_frames = 0
        self.sent_bytes = 0
        self.rcvd_frames = 0
        self.rcvd_bytes = 0
        self.dropped_frames = 0
        self.drop_congestion = 0   # byte-budget (queue or write buffer)
        self.drop_peer_gone = 0    # no/closing connection to the dest
        self.drop_write_error = 0  # mid-write connection failure
        self.drop_test = 0         # test_drop_rate fault injection
        self.drop_chaos = 0        # chaos-plane injected loss/partition
        self.reconnects = 0        # reconnect attempts after 1st connect
        self.connect_failures = 0  # connect attempts that failed
        # per-peer RTT from the failure-detector ping/pong (the cluster
        # tracing plane's network-hop baseline): peer -> [ewma_s, count].
        # note_rtt runs on the node's worker thread while metrics()
        # scrapes from the event loop — the lock keeps a first-pong
        # insert from blowing up a concurrent scrape's iteration.
        self._rtt: Dict[int, list] = {}
        self._rtt_lock = threading.Lock()

        # wire-plane aggregation: coalesce same-peer frames
        # into FRAG super-frames — but only toward peers that announced
        # a compatible wire version (peer_wire, learned from their
        # WIRE_HELLO; empty until then, so old nodes keep getting the
        # plain per-frame path).  rx_chunks switches the scan loop from
        # per-frame bytes slices to SoA WireChunk delivery.  All state
        # below is event-loop-owned (single-writer, like the counters).
        self.wire_coalesce = bool(wire_coalesce)
        self.coalesce_min = max(2, int(coalesce_min))
        self.rx_chunks = bool(rx_chunks)
        self.peer_wire: Dict[int, int] = {}
        # syscall-proxy + container counters for the wire-efficiency
        # metrics (net.syscalls_per_decision): one tx_write per writer
        # call, one rx_read per non-empty socket read
        self.tx_writes = 0
        self.rx_reads = 0
        self.tx_frags = 0
        self.tx_frag_members = 0
        self.rx_frags = 0
        self.rx_frag_members = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        host, port = self.listen_addr
        self._server = await asyncio.start_server(
            self._handle_inbound, host, port, ssl=self.ssl_server)

    async def stop(self) -> None:
        self._closed = True
        for p in self._peers.values():
            if p.task:
                p.task.cancel()
            if p.writer:
                p.writer.close()
        # cancel inbound handlers BEFORE wait_closed: since py3.12
        # Server.wait_closed() waits for handler coroutines, which would
        # otherwise sit in readexactly() forever
        for t in list(self._inbound_tasks):
            t.cancel()
        for t in list(self._paced_tasks):
            t.cancel()
        for w in list(self._inbound.values()):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await asyncio.sleep(0)

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    # -- sending -----------------------------------------------------------

    def send(self, dst: int, frame: bytes) -> bool:
        """Queue a frame to node ``dst``.  Returns False on congestion drop
        or unknown destination.  Must be called on the loop."""
        return self._enqueue(dst, frame, preframed=False, nframes=1)

    def send_raw(self, dst: int, buf: bytes, nframes: int) -> bool:
        """Queue a PRE-FRAMED buffer (frames already length-prefixed, e.g.
        from ``native.encode_responses``): one writer call for a whole
        response batch."""
        return self._enqueue(dst, buf, preframed=True, nframes=nframes)

    def _drop(self, nframes: int, cause: str) -> None:
        """Count a drop under its cause (congestion keeps feeding the
        net.drop rate the saturation tests watch)."""
        self.dropped_frames += nframes
        if cause == "congestion":
            self.drop_congestion += nframes
            DelayProfiler.update_rate("net.drop")
        elif cause == "peer_gone":
            self.drop_peer_gone += nframes
        elif cause == "write_error":
            self.drop_write_error += nframes
        elif cause == "chaos":
            # injected by the fault plane: its own bucket so chaos runs
            # never masquerade as backpressure or flaky links in the
            # metrics plane (PR 2's per-cause split stays honest)
            self.drop_chaos += nframes
        else:
            self.drop_test += nframes

    def _enqueue(self, dst: int, payload: bytes, preframed: bool,
                 nframes: int) -> bool:
        if self.test_drop_rate > 0.0:
            if self._drop_rng is None:
                import random
                self._drop_rng = random.Random(self.id * 7919 + 13)
            if self._drop_rng.random() < self.test_drop_rate:
                self._drop(nframes, "test")
                return False
        # chaos fault plane (peer links only — client replies ride
        # clean so scenario ack bookkeeping measures the cluster).
        # Disabled costs ONE class-attribute check, the tracing-plane
        # short-circuit discipline.
        if ChaosPlane.enabled and dst in self.addr_map:
            drop, delay = ChaosPlane.on_send(self.id, dst, nframes)
            if drop:
                self._drop(nframes, "chaos")
                return False
            if delay > 0.0:
                # release through the event loop after the injected
                # latency: the frame is genuinely late on the wire,
                # and longer-delayed frames are genuinely overtaken
                self._loop.call_later(delay, self._chaos_release, dst,
                                      payload, preframed, nframes)
                return True
        return self._enqueue_now(dst, payload, preframed, nframes)

    def _chaos_release(self, dst: int, payload: bytes, preframed: bool,
                       nframes: int) -> None:
        """A chaos-delayed frame reaches the real send path (skipping
        the chaos gate — its verdict was already served)."""
        if self._closed:
            return
        self._enqueue_now(dst, payload, preframed, nframes)

    def _enqueue_now(self, dst: int, payload: bytes, preframed: bool,
                     nframes: int) -> bool:
        if dst in self.addr_map:
            peer = self._peers.get(dst)
            if peer is None:
                peer = self._peers[dst] = _Peer()
                peer.task = self._loop.create_task(self._writer_loop(dst))
            if peer.writer is not None and not peer.queue and \
                    self.direct_write and not peer.writer.is_closing():
                # connected steady state: write straight into the asyncio
                # transport buffer (the queue+writer-task hop costs a
                # task wake per batch); backpressure via the transport's
                # own write buffer against the same byte budget.  A
                # closing writer falls through to the queue path, whose
                # wake makes the writer task discover the dead socket
                # and reconnect (direct writes alone would never notice:
                # the write "succeeds" into a dying transport)
                w = peer.writer
                if w.transport.get_write_buffer_size() + len(payload) > \
                        self.max_queue_bytes:
                    self._drop(nframes, "congestion")
                    return False
                self._write(w, payload, preframed, nframes)
                return True
            if peer.bytes_queued + len(payload) > self.max_queue_bytes:
                # a pre-framed batch drops as a unit (paxos tolerates
                # loss; clients retransmit) — account every frame in it
                self._drop(nframes, "congestion")
                return False
            peer.queue.append((payload, preframed, nframes))
            peer.bytes_queued += len(payload)
            peer.wake.set()
            return True
        # reply path over an inbound connection (client or unknown peer)
        w = self._inbound.get(dst)
        if w is None or w.is_closing():
            # a pre-framed response batch drops as nframes, like the
            # congestion path — else client churn undercounts ~batchx
            self._drop(nframes, "peer_gone")
            return False
        # backpressure: a stalled client must not grow server memory —
        # consult the transport's write buffer against the same byte budget
        if w.transport.get_write_buffer_size() + len(payload) > \
                self.max_queue_bytes:
            self._drop(nframes, "congestion")
            return False
        self._write(w, payload, preframed, nframes)
        return True

    def send_threadsafe(self, dst: int, frame: bytes) -> None:
        self._loop.call_soon_threadsafe(self.send, dst, frame)

    def send_many(self, items: list) -> None:
        """Enqueue ``[(dst, payload, preframed, nframes), ...]`` — ONE
        loop hop for a whole worker batch's sends (each
        ``call_soon_threadsafe`` writes the loop's wake pipe; a worker
        batch fans out to several destinations).  With wire coalescing
        on, a destination's plain frames collapse into one FRAG
        super-frame via :meth:`send_frags` — per-destination send order
        is preserved (a non-coalescible item flushes the pending
        group first), and only peers that announced a compatible wire
        version participate."""
        if not self.wire_coalesce:
            for dst, payload, preframed, nframes in items:
                self._enqueue(dst, payload, preframed, nframes)
            return
        groups: Dict[int, list] = {}
        for dst, payload, preframed, nframes in items:
            if not preframed \
                    and self.peer_wire.get(dst, 0) \
                    >= pk.WIRE_GATED["FRAG"] \
                    and dst in self.addr_map:
                g = groups.get(dst)
                if g is None:
                    g = groups[dst] = []
                g.append(payload)
                continue
            pend = groups.pop(dst, None)
            if pend is not None:
                self._flush_group(dst, pend)
            self._enqueue(dst, payload, preframed, nframes)
        for dst, bufs in groups.items():
            self._flush_group(dst, bufs)

    def _flush_group(self, dst: int, bufs: list) -> None:
        # a lone column-packable batch frame still rides a 1-member
        # FRAG when that shrinks it (send_frags falls back otherwise)
        if len(bufs) >= self.coalesce_min or \
                (len(bufs) == 1 and pk.packable(bufs[0])):
            self.send_frags(dst, bufs)
        else:
            for b in bufs:
                self._enqueue(dst, b, False, 1)

    def send_frags(self, dst: int, bufs: list) -> bool:
        """Scatter-gather send: coalesce ``bufs`` (canonical frames all
        bound for peer ``dst``) into ONE super-frame handed to the
        socket as a ``writev``-style buffer list.  The test/chaos fault
        gates are served per MEMBER in send order first — the verdict
        stream is identical to N :meth:`send` calls, so chaos schedule
        fingerprints are stable and drop/delay verdicts split the
        container (the affected member travels alone or not at all)."""
        keep = bufs
        if self.test_drop_rate > 0.0:
            if self._drop_rng is None:
                import random
                self._drop_rng = random.Random(self.id * 7919 + 13)
            keep = []
            for b in bufs:
                if self._drop_rng.random() < self.test_drop_rate:
                    self._drop(1, "test")
                else:
                    keep.append(b)
        if ChaosPlane.enabled and dst in self.addr_map:
            kept = []
            for b in keep:
                drop, delay = ChaosPlane.on_send(self.id, dst, 1)
                if drop:
                    self._drop(1, "chaos")
                elif delay > 0.0:
                    self._loop.call_later(delay, self._chaos_release,
                                          dst, b, False, 1)
                else:
                    kept.append(b)
            keep = kept
        if not keep:
            return True
        if len(keep) == 1 and not pk.packable(keep[0]):
            return self._enqueue_now(dst, keep[0], False, 1)
        parts, total = pk.Frag.encode(self.id, keep)
        if total > MAX_FRAME or \
                (len(keep) == 1 and total >= len(keep[0])):
            ok = True
            for b in keep:
                ok = self._enqueue_now(dst, b, False, 1) and ok
            return ok
        nf = len(keep)
        peer = self._peers.get(dst)
        if peer is None:
            peer = self._peers[dst] = _Peer()
            peer.task = self._loop.create_task(self._writer_loop(dst))
        parts[0] = _LEN.pack(total) + parts[0]
        if peer.writer is not None and not peer.queue and \
                self.direct_write and not peer.writer.is_closing():
            w = peer.writer
            if w.transport.get_write_buffer_size() + total + 4 > \
                    self.max_queue_bytes:
                self._drop(nf, "congestion")
                return False
            w.writelines(parts)
            self.sent_frames += nf
            self.sent_bytes += total + 4
            self.tx_writes += 1
            self.tx_frags += 1
            self.tx_frag_members += nf
            return True
        payload = b"".join(parts)
        if peer.bytes_queued + len(payload) > self.max_queue_bytes:
            self._drop(nf, "congestion")
            return False
        peer.queue.append((payload, True, nf))
        peer.bytes_queued += len(payload)
        peer.wake.set()
        self.tx_frags += 1
        self.tx_frag_members += nf
        return True

    def send_many_threadsafe(self, items: list) -> None:
        self._loop.call_soon_threadsafe(self.send_many, items)

    def _write(self, w: asyncio.StreamWriter, payload: bytes,
               preframed: bool, nframes: int) -> None:
        self.tx_writes += 1
        if preframed:
            w.write(payload)
            self.sent_frames += nframes
            self.sent_bytes += len(payload)
        else:
            w.write(_LEN.pack(len(payload)))
            w.write(payload)
            self.sent_frames += 1
            self.sent_bytes += len(payload) + 4

    # -- per-destination writer task --------------------------------------

    async def _writer_loop(self, dst: int) -> None:
        peer = self._peers[dst]
        backoff = self.reconnect_base_s
        attempts = 0
        while not self._closed:
            # (re)connect; every attempt after the first counts as a
            # reconnect (link-flap visibility for the metrics plane)
            host, port = self.addr_map[dst]
            if attempts:
                self.reconnects += 1
            attempts += 1
            try:
                reader, writer = await asyncio.open_connection(
                    host, port, ssl=self.ssl_client)
            except OSError:
                self.connect_failures += 1
                # jittered exponential backoff: N writers reconnecting
                # to a restarted peer on the bare doubling schedule stay
                # phase-locked (every node lost the link in the same
                # instant), hammering it in synchronized waves — spread
                # each wait uniformly over [0.5x, 1.5x]
                await asyncio.sleep(backoff * (0.5 + random.random()))
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = self.reconnect_base_s
            peer.writer = writer
            # handshake: identify ourselves so the far side can map the
            # connection to our node id (replies to unmapped ids)
            writer.write(_LEN.pack(4) + struct.pack("<i", self.id))
            if self.wire_coalesce:
                # announce our wire version before any payload frame so
                # the far side can start coalescing toward us; sent per
                # connection (the receiver's first-frame intercept is
                # per scan loop), deliberately outside the chaos gates
                # — it is link control, not protocol traffic
                self._write(writer, pk.wire_hello(self.id), False, 1)
            # connections are bidirectional: the far side may send replies
            # back over this link (client reply path), so read it too.
            # The read side reaching EOF is ALSO our only prompt signal
            # that the peer died (direct writes bypass this loop), so
            # its completion kicks the wake event — the drain below then
            # fails fast and we reconnect.
            rtask = self._loop.create_task(self._read_frames(reader))
            rtask.add_done_callback(lambda _t: peer.wake.set())
            try:
                while not self._closed:
                    while peer.queue:
                        payload, preframed, nframes = peer.queue.popleft()
                        peer.bytes_queued -= len(payload)
                        self._write(writer, payload, preframed, nframes)
                    await writer.drain()
                    if writer.is_closing() or (rtask.done()
                                               and not self._closed):
                        break  # peer gone: reconnect
                    if not peer.queue:
                        peer.wake.clear()
                        await peer.wake.wait()
            except asyncio.CancelledError:
                return
            except (ConnectionError, OSError):
                pass  # drop through to reconnect
            finally:
                rtask.cancel()
                peer.writer = None
                writer.close()

    async def _read_frames(self, reader: asyncio.StreamReader) -> None:
        """Frame-read loop for the *outbound* side of a connection."""
        try:
            await self._scan_loop(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError, ValueError):
            pass

    async def _scan_loop(self, reader: asyncio.StreamReader) -> None:
        """Chunked read + native frame scan (ref: MessageExtractor): one
        ``read()`` and one C scan per chunk instead of two ``readexactly``
        awaits per frame.  Raises ValueError on an oversized frame
        (protocol violation -> drop the connection)."""
        buf = bytearray()
        first = True
        while True:
            chunk = await reader.read(1 << 18)
            if not chunk:
                return
            self.rx_reads += 1
            buf += chunk
            offs, lens, consumed = native.scan_frames(buf)
            if len(offs):
                mv = memoryview(buf)
                start = 0
                if first:
                    # a coalescing peer's first frame is its version
                    # hello: record and swallow (never delivered)
                    first = False
                    o0, l0 = int(offs[0]), int(lens[0])
                    if l0 >= 10 and buf[o0] == _HELLO_T:
                        try:
                            s, v = pk.parse_wire_hello(
                                bytes(mv[o0:o0 + l0]))
                        except ValueError:
                            pass
                        else:
                            self.peer_wire[s] = v
                            self.rcvd_frames += 1
                            start = 1
                if self.rx_chunks:
                    ck = self._make_chunk(mv, offs, lens, start,
                                          consumed)
                    if ck is not None:
                        if self.on_frames is not None:
                            try:
                                self.on_frames([ck])
                            except Exception:
                                log.exception("batch handler failed")
                        else:
                            for i in range(len(ck)):
                                self._dispatch(bytes(ck.view(i)))
                else:
                    frames = [bytes(mv[int(o):int(o) + int(ln)])
                              for o, ln in zip(offs[start:],
                                               lens[start:])]
                    n_log = len(frames)
                    if self.wire_coalesce:
                        # count FRAG containers as their member frames
                        # (rx_frames stays the logical-frame counter)
                        for f in frames:
                            if f and f[0] == _FRAG_T:
                                k = _HDR_N.unpack_from(f, 5)[0]
                                self.rx_frags += 1
                                self.rx_frag_members += k
                                n_log += k - 1
                    self.rcvd_frames += n_log
                    self.rcvd_bytes += consumed
                    bb = self.blackbox
                    if bb is not None:
                        bb.note_ingress(n_log, consumed)
                    if frames:
                        if self.on_frames is not None:
                            try:
                                self.on_frames(frames)
                            except Exception:
                                log.exception("batch handler failed")
                        else:
                            for f in frames:
                                self._dispatch(f)
                del mv
            if consumed:
                del buf[:consumed]

    def _make_chunk(self, mv: memoryview, offs: np.ndarray,
                    lens: np.ndarray, start: int,
                    consumed: int) -> Optional[WireChunk]:
        """SoA receive: package the whole consumed region as ONE
        immutable blob + offset columns (no per-frame slicing) and
        account it; delivery stays in the scan loop."""
        if start:
            offs = offs[start:]
            lens = lens[start:]
        if len(lens) and int(lens.min()) == 0:
            keep = lens > 0
            offs = offs[keep]
            lens = lens[keep]
        self.rcvd_bytes += consumed
        if not len(offs):
            return None
        blob = bytes(mv[:consumed])
        ck = WireChunk(blob, offs, lens)
        n_log = len(offs)
        for i in np.flatnonzero(ck.types == _FRAG_T).tolist():
            k = _HDR_N.unpack_from(blob, int(offs[i]) + 5)[0]
            self.rx_frags += 1
            self.rx_frag_members += k
            n_log += k - 1
        self.rcvd_frames += n_log
        bb = self.blackbox
        if bb is not None:
            bb.note_ingress(n_log, consumed)
        return ck

    def _dispatch(self, frame: bytes) -> None:
        """on_frame with a crash guard: one malformed/unknown frame must
        not kill the connection's read loop (version skew, corruption)."""
        try:
            self.on_frame(frame)
        except Exception:
            log.exception("handler failed for frame type %d",
                          frame[0] if frame else -1)

    # -- inbound -----------------------------------------------------------

    async def _handle_inbound(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        peer_id: Optional[int] = None
        task = asyncio.current_task()
        self._inbound_tasks.add(task)
        try:
            # first frame = 4-byte id handshake
            hdr = await reader.readexactly(4)
            (ln,) = _LEN.unpack(hdr)
            if ln != 4:
                writer.close()
                return
            (peer_id,) = struct.unpack("<i", await reader.readexactly(4))
            self._inbound[peer_id] = writer
            await self._scan_loop(reader)
        except ValueError:
            log.error("oversized frame from %s", peer_id)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass
        finally:
            self._inbound_tasks.discard(task)
            if peer_id is not None and self._inbound.get(peer_id) is writer:
                del self._inbound[peer_id]
            writer.close()

    def send_paced_threadsafe(self, dst: int, frames: list) -> None:
        """Send a LARGE multi-frame transfer paced by the socket's own
        flow control (``await drain()`` per frame) so it never
        congestion-drops its own tail or head-of-line-blocks the peer
        queue — the chunked-checkpoint path (LargeCheckpointer analog)."""
        def _spawn():
            t = self._loop.create_task(self._send_paced(dst, frames))
            # retain the task: a referenced-nowhere asyncio task can be
            # garbage-collected mid-await, truncating the transfer
            self._paced_tasks.add(t)
            t.add_done_callback(self._paced_tasks.discard)
        self._loop.call_soon_threadsafe(_spawn)

    async def _send_paced(self, dst: int, frames: list) -> None:
        if dst in self.addr_map:
            peer = self._peers.get(dst)
            if peer is None:
                peer = self._peers[dst] = _Peer()
                peer.task = self._loop.create_task(self._writer_loop(dst))
            for f in frames:
                while peer.writer is None and not self._closed:
                    await asyncio.sleep(0.05)
                if self._closed:
                    return
                if ChaosPlane.enabled and \
                        ChaosPlane.is_blocked(self.id, dst):
                    # a partition starves bulk checkpoint transfers
                    # too; the higher level re-requests after heal
                    self._drop(1, "chaos")
                    continue
                w = peer.writer
                try:
                    self._write(w, f, False, 1)
                    await w.drain()
                except (ConnectionError, OSError):
                    # reconnect in flight; this frame is lost — the
                    # higher level (checkpoint catch-up) re-requests
                    self._drop(1, "write_error")
        else:
            w = self._inbound.get(dst)
            if w is None or w.is_closing():
                self._drop(len(frames), "peer_gone")
                return
            for f in frames:
                try:
                    self._write(w, f, False, 1)
                    await w.drain()
                except (ConnectionError, OSError):
                    self._drop(1, "write_error")
                    return

    def note_rtt(self, peer: int, rtt_s: float) -> None:
        """Record one ping/pong round trip to ``peer`` (called by the
        node's FailureDetect pong handler).  Feeds the per-peer EWMA in
        :meth:`metrics` and the node-wide ``net.rtt`` histogram, so
        /metrics carries link-latency quantiles per node — the
        network-hop baseline a cross-node trace is read against."""
        with self._rtt_lock:
            e = self._rtt.get(peer)
            if e is None:
                self._rtt[peer] = [rtt_s, 1]
            else:
                e[0] += 0.1 * (rtt_s - e[0])
                e[1] += 1
        DelayProfiler.update_delay("net.rtt",
                                   time.monotonic() - rtt_s)

    def metrics(self) -> dict:
        """Structured counters (the machine face; :meth:`stats` is the
        one-line render over this)."""
        with self._rtt_lock:
            rtt = {p: {"ewma_s": e[0], "count": e[1]}
                   for p, e in sorted(self._rtt.items())}
        return {
            "rtt": rtt,
            "tx_frames": self.sent_frames,
            "tx_bytes": self.sent_bytes,
            "rx_frames": self.rcvd_frames,
            "rx_bytes": self.rcvd_bytes,
            "dropped_frames": self.dropped_frames,
            "drops": {
                "congestion": self.drop_congestion,
                "peer_gone": self.drop_peer_gone,
                "write_error": self.drop_write_error,
                "test": self.drop_test,
                "chaos": self.drop_chaos,
            },
            "reconnects": self.reconnects,
            "connect_failures": self.connect_failures,
            "tx_writes": self.tx_writes,
            "rx_reads": self.rx_reads,
            "tx_frags": self.tx_frags,
            "tx_frag_members": self.tx_frag_members,
            "rx_frags": self.rx_frags,
            "rx_frag_members": self.rx_frag_members,
            "peer_wire": dict(self.peer_wire),
        }

    def stats(self) -> str:
        m = self.metrics()
        return (f"tx={m['tx_frames']}f/{m['tx_bytes']}B "
                f"rx={m['rx_frames']}f/{m['rx_bytes']}B "
                f"drop={m['dropped_frames']} recon={m['reconnects']}")


def make_ssl_contexts(certfile: str, keyfile: str, cafile: str,
                      mutual: bool = False
                      ) -> Tuple[ssl_mod.SSLContext, ssl_mod.SSLContext]:
    """(server_ctx, client_ctx) — SERVER_AUTH by default, MUTUAL_AUTH when
    ``mutual`` (ref: ``SSLDataProcessingWorker.SSL_MODES``)."""
    server = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(certfile, keyfile)
    client = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
    client.load_verify_locations(cafile)
    client.check_hostname = False
    if mutual:
        server.verify_mode = ssl_mod.CERT_REQUIRED
        server.load_verify_locations(cafile)
        client.load_cert_chain(certfile, keyfile)
    return server, client
