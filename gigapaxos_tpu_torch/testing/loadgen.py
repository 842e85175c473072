"""High-rate load generator (ref: ``gigapaxos/testing/TESTPaxosClient``).

The per-request ``PaxosClientAsync`` path costs an asyncio task + future +
``wait_for`` timer per request — fine for correctness tests, but at 20K+
req/s on one core the *load generator* becomes the bottleneck and the
measurement lies.  This generator is the reference's TESTPaxosClient in
spirit: a fixed window of outstanding requests per connection, bursts of
pre-encoded frames per socket write, and ONE native C scan+parse per read
chunk (``native.scan_frames`` + ``native.parse_requests`` — Response
frames share the Request layout, status in the flags byte).

Latency bookkeeping is array-indexed by sequence number (req_id =
client_id << 32 | seq), so recording a send/receive is one numpy store —
no dict per request.

Requests are routed to each group's initial coordinator (``gkey % n`` —
the deterministic boot assignment): the analog of the reference's
preferred-replica redirector (``E2ELatencyAwareRedirector``), which skips
the entry-replica forward hop for 2/3 of traffic.
"""

from __future__ import annotations

import asyncio
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gigapaxos_tpu_torch import native
from gigapaxos_tpu_torch.paxos import packets as pkt

_LEN = struct.Struct("<I")
_REQ = struct.Struct("<IBII QQB")  # len | type | sender | n | gkey req flags

# every load run MUST use a fresh client id: req_id = client_id<<32 | seq,
# and the servers keep an at-most-once dedup cache — a reused id answers
# the whole "run" from the response cache without any consensus at all
# (discovered the hard way: repeat runs measured 5x the true throughput)
_next_client = None


def _fresh_client_id(base: int) -> int:
    global _next_client
    if _next_client is None or _next_client < base:
        _next_client = base
    _next_client += 1
    return _next_client


def _frame(sender: int, gkey: int, req_id: int, payload: bytes) -> bytes:
    body_len = 9 + 17 + len(payload)
    return _REQ.pack(body_len, int(pkt.PacketType.REQUEST), sender, 1,
                     gkey, req_id, 0) + payload


def _frames_vec(sender: int, gkeys: np.ndarray, req_ids: np.ndarray,
                payload: bytes) -> bytes:
    """k equal-length REQUEST frames in one numpy pass (a struct.pack
    per frame costs ~1.5us; at 20K+ req/s the generator's encode becomes
    a measurable slice of the single core)."""
    k = len(gkeys)
    tmpl = np.frombuffer(_frame(sender, 0, 0, payload), np.uint8)
    arr = np.broadcast_to(tmpl, (k, len(tmpl))).copy()
    arr[:, 13:21] = np.ascontiguousarray(gkeys, "<u8").view(
        np.uint8).reshape(k, 8)
    arr[:, 21:29] = np.ascontiguousarray(req_ids, "<u8").view(
        np.uint8).reshape(k, 8)
    return arr.tobytes()


async def run_fast_load(servers: Sequence[Tuple[str, int]],
                        group_names: Sequence[str], n_requests: int,
                        concurrency: int = 512, payload: bytes = b"x",
                        client_id: int = 1 << 20, timeout: float = 30.0,
                        route: Optional[Sequence[int]] = None,
                        burst: int = 64) -> Dict:
    """Drive ``n_requests`` round-robin over ``group_names`` with a global
    window of ``concurrency`` outstanding; returns the same stats dict as
    ``PaxosEmulation.run_load``.

    ``route[k]``: server index for group k (default ``gkey % len(servers)``
    = the initial coordinator).  Stragglers are retransmitted (same
    req_id — dedup is server-side) once a second until ``timeout``.
    """
    client_id = _fresh_client_id(client_id)
    gkeys = np.asarray([pkt.group_key(g) for g in group_names], np.uint64)
    n_groups = len(gkeys)
    route_arr = (gkeys % np.uint64(len(servers))).astype(np.int64) \
        if route is None else np.asarray(route, np.int64)
    t_send = np.zeros(n_requests, np.float64)
    t_recv = np.full(n_requests, -1.0, np.float64)
    status = np.full(n_requests, -1, np.int16)
    req_base = np.uint64(client_id << 32)
    loop = asyncio.get_running_loop()

    conns: List[Tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []
    for host, port in servers:
        r, w = await asyncio.open_connection(host, port)
        w.write(_LEN.pack(4) + struct.pack("<i", client_id))
        conns.append((r, w))

    done = asyncio.Event()
    space = asyncio.Event()
    space.set()
    n_done = 0
    outstanding = 0

    async def reader(idx: int):
        nonlocal n_done, outstanding
        rd = conns[idx][0]
        buf = bytearray()
        while n_done < n_requests:
            chunk = await rd.read(1 << 18)
            if not chunk:
                return
            buf += chunk
            offs, lens, consumed = native.scan_frames(buf)
            if not len(offs):
                continue
            # RESPONSE frames share the REQUEST layout (status = flags)
            is_resp = np.asarray(
                [buf[int(o)] == int(pkt.PacketType.RESPONSE)
                 for o in offs])
            now = time.perf_counter()
            if is_resp.any():
                _s, _gk, req_id, st, _po, _pay = native.parse_requests(
                    bytes(buf[:consumed]), offs[is_resp], lens[is_resp])
                seqs = (req_id & np.uint64(0xFFFFFFFF)).astype(np.int64)
                ok = (seqs >= 0) & (seqs < n_requests)
                # dedupe within the chunk: an execute-time response and a
                # cache-answered retransmit can land in one parse batch,
                # and the vectorized fresh-check would count both
                seqs, first_idx = np.unique(seqs[ok], return_index=True)
                ok = np.flatnonzero(ok)[first_idx]
                fresh = t_recv[seqs] < 0
                t_recv[seqs[fresh]] = now
                status[seqs[fresh]] = st[ok][fresh]
                k = int(fresh.sum())
                n_done += k
                outstanding -= k
                space.set()
            del buf[:consumed]
        done.set()

    readers = [loop.create_task(reader(i)) for i in range(len(conns))]

    t0 = time.perf_counter()

    async def writer():
        # vectorized bursts: take as much window as is free (<= burst),
        # build all frames for a destination in one numpy pass, one
        # write per destination per burst
        nonlocal outstanding
        k = 0
        while k < n_requests:
            await space.wait()
            free = concurrency - outstanding
            if free <= 0:
                space.clear()
                continue
            take = min(free, burst, n_requests - k)
            ks = np.arange(k, k + take, dtype=np.int64)
            gs = ks % n_groups
            t_send[k:k + take] = time.perf_counter()
            outstanding += take
            rts = route_arr[gs]
            for dst in np.unique(rts):
                m = rts == dst
                conns[int(dst)][1].write(_frames_vec(
                    client_id, gkeys[gs[m]],
                    req_base | ks[m].astype(np.uint64), payload))
            k += take
            await asyncio.sleep(0)  # let readers run
        for _, w in conns:
            await w.drain()

    wtask = loop.create_task(writer())
    deadline = t0 + timeout
    while n_done < n_requests and time.perf_counter() < deadline:
        try:
            await asyncio.wait_for(done.wait(), timeout=1.0)
            break
        except asyncio.TimeoutError:
            # retransmit stragglers sent >1s ago (same ids; server dedups)
            now = time.perf_counter()
            late = np.flatnonzero((t_recv < 0) & (t_send > 0)
                                  & (now - t_send > 1.0))
            if wtask.done() and len(late):
                for k in late[:2048]:
                    g = int(k) % n_groups
                    conns[int(route_arr[g])][1].write(_frame(
                        client_id, int(gkeys[g]),
                        (client_id << 32) | int(k), payload))
    wall = time.perf_counter() - t0
    for t in readers + [wtask]:
        t.cancel()
    for _, w in conns:
        w.close()
    await asyncio.gather(*readers, wtask, return_exceptions=True)

    got = (t_recv > 0) & (status == 0)
    lat = (t_recv - t_send)[got]
    errs = int((status > 0).sum() + (t_recv < 0).sum())
    return {
        "requests": n_requests,
        "ok": int(got.sum()),
        "errors": errs,
        "wall_s": round(wall, 3),
        "throughput_rps": round(float(got.sum()) / wall, 1),
        "lat_p50_ms": round(1e3 * float(np.percentile(lat, 50)), 2)
        if len(lat) else None,
        "lat_p99_ms": round(1e3 * float(np.percentile(lat, 99)), 2)
        if len(lat) else None,
    }


def run_fast_load_sync(*args, **kw) -> Dict:
    return asyncio.run(run_fast_load(*args, **kw))


def main(argv=None) -> int:
    """Standalone load-generator process (ref: ``TESTPaxosClient`` run
    as its own process against remote ``TESTPaxosServer``s — SURVEY
    §4.3's across-machines benchmark mode).  Point it at any servers::

        python -m gigapaxos_tpu_torch.testing.loadgen \\
            --servers hostA:2000,hostB:2000,hostC:2000 \\
            --groups 1000 --requests 100000 --concurrency 2048

    Groups are addressed by name (``g0..gN-1`` by default — matching
    ``server.py --paxos-only`` with ``GROUPS=``); prints the same ONE
    json line as the harness modes."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="gigapaxos_tpu_torch.testing.loadgen")
    p.add_argument("--servers", required=True,
                   help="comma-separated host:port list")
    p.add_argument("--groups", type=int, default=1000,
                   help="number of groups (names g0..gN-1)")
    p.add_argument("--group-prefix", default="g")
    p.add_argument("--requests", type=int, default=100000)
    p.add_argument("--concurrency", type=int, default=2048)
    p.add_argument("--payload-bytes", type=int, default=1)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--client-id", type=int, default=None,
                   help="base client id (default: derived from pid+time"
                        " — two CLI runs within the servers' dedup-"
                        "cache window must NOT reuse ids, or the second"
                        " run is answered from the response cache "
                        "without any consensus)")
    args = p.parse_args(argv)

    import os
    cid = args.client_id
    if cid is None:
        cid = (1 << 20) + (((os.getpid() << 12) ^ int(time.time()))
                           % ((1 << 30) - (1 << 20)))
    if not (0 < cid < (1 << 31) - (1 << 22)):
        p.error(f"--client-id {cid} outside the 31-bit id space")

    servers = []
    for part in args.servers.split(","):
        host, colon, port = part.strip().rpartition(":")
        if not colon or not host or not port.isdigit():
            p.error(f"--servers entry {part!r} is not host:port")
        servers.append((host, int(port)))
    names = [f"{args.group_prefix}{i}" for i in range(args.groups)]
    stats = run_fast_load_sync(
        servers, names, args.requests, concurrency=args.concurrency,
        payload=b"x" * args.payload_bytes, client_id=cid,
        timeout=args.timeout)
    print(json.dumps({
        "metric": f"e2e decided req/s against {len(servers)} servers, "
                  f"{args.groups} groups, depth {args.concurrency}",
        "value": stats["throughput_rps"], "unit": "req/s",
        "info": stats,
    }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
