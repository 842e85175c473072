"""Failover and recovery on the port's node (``gigapaxos_tpu_torch``,
``backend="columnar"`` on the CPU), held to the JAX package's own tests
of the same behaviour: coordinator failover, crash recovery from the WAL
and from the checkpoint cut, the batched mass takeover and its re-drive
of a lost prepare wave, pause and unpause through
``snapshot_rows``/``restore_row``, app-failure retry and caching, and
the large-checkpoint chunk stream.  Each test mirrors the reference test
named in its docstring, on the columnar engine where the reference runs
several.  That the takeover decides what the JAX package decides is
shown by the replays of ``tests/test_torch_blackbox.py``; these tests
show liveness and agreement."""

import socket
import struct
import time

import numpy as np
import pytest

from gigapaxos_tpu_torch import native
from gigapaxos_tpu_torch.chaos.faults import ChaosPlane
from gigapaxos_tpu_torch.ops.types import unpack_ballot
from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.paxos.interfaces import (CounterApp, Replicable)
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.paxos.packets import group_key
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.testing.harness import PaxosEmulation, free_ports
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from tests.conftest import tscale

_LEN = struct.Struct("<I")


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    """Every node of these tests runs its engine on the CPU; the port's
    singletons are reset after each test (the suite's conftest resets
    the JAX package's)."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()
    ChaosPlane.reset()


def make_cluster(tmp_path, n=3, app_cls=CounterApp, capacity=1 << 10):
    """``tests/test_e2e.py:make_cluster`` on the port's node."""
    Config.set(PC.SYNC_WAL, False)
    ports = free_ports(n)
    addr_map = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    nodes = []
    for i in range(n):
        node = PaxosNode(i, addr_map, app_cls(), str(tmp_path / f"n{i}"),
                         backend="columnar", capacity=capacity, window=16)
        node.start()
        nodes.append(node)
    return nodes, addr_map


def shutdown(nodes):
    for nd in nodes:
        if not nd._stopping:
            nd.stop()


def _wait(pred, deadline_s):
    end = time.time() + tscale(deadline_s)
    while time.time() < end and not pred():
        time.sleep(0.05)
    return pred()


# -- coordinator failover and crash recovery (tests/test_failover.py) -----


def test_coordinator_failover(tmp_path):
    """``test_coordinator_failover``: the coordinator of one group stops;
    the survivors elect a new one and keep deciding, in agreement."""
    Config.set(PC.PING_INTERVAL_S, 0.15)
    Config.set(PC.FAILURE_TIMEOUT_S, 1.0)
    nodes, addr_map = make_cluster(tmp_path)
    cli = None
    try:
        name = "fo-group"
        for nd in nodes:
            assert nd.create_group(name, (0, 1, 2))
        dead = group_key(name) % 3  # the deterministic initial coordinator
        cli = PaxosClient([addr_map[i] for i in range(3) if i != dead],
                          timeout=tscale(4))
        for k in range(5):
            assert cli.send_request(name, f"pre-{k}".encode()).status == 0
        time.sleep(0.5)  # pings give the survivors last_heard entries
        nodes[dead].stop()
        ok = 0
        for k in range(10):
            try:
                ok += int(cli.send_request(
                    name, f"post-{k}".encode()).status == 0)
            except TimeoutError:
                pass
        assert ok >= 8, f"only {ok}/10 requests survived failover"
        live = [nd for i, nd in enumerate(nodes) if i != dead]
        row = live[0].table.by_name(name).row
        num, coord = unpack_ballot(int(live[0]._bal[row]))
        assert coord != dead and num >= 1
        assert _wait(lambda: len({nd.app.digest.get(name)
                                  for nd in live}) == 1, 10)
        counts = {nd.app.count.get(name) for nd in live}
        assert len(counts) == 1 and counts.pop() >= 5 + ok
    finally:
        if cli:
            cli.close()
        shutdown(nodes)


def _solo(tmp_path):
    addr_map = {0: ("127.0.0.1", free_ports(1)[0])}
    node = PaxosNode(0, addr_map, CounterApp(), str(tmp_path / "n0"),
                     capacity=1 << 8, window=16)
    node.start()
    return node, PaxosClient([addr_map[0]], timeout=tscale(5))


def test_crash_recovery_single_node(tmp_path):
    """``test_crash_recovery_single_node``: the WAL rolls a restarted
    node forward, and it re-elects itself and serves again."""
    Config.set(PC.SYNC_WAL, False)
    node, cli = _solo(tmp_path)
    try:
        assert node.create_group("solo", (0,))
        for k in range(12):
            assert cli.send_request("solo", f"r{k}".encode()).status == 0
        assert node.app.count["solo"] == 12
    finally:
        cli.close()
        node.stop()
    node2, cli2 = _solo(tmp_path)
    try:
        assert node2.app.count.get("solo") == 12
        got = False
        end = time.time() + 10
        while time.time() < end and not got:
            try:
                got = cli2.send_request("solo", b"after").status == 0
            except TimeoutError:
                pass
        assert got, "recovered node never accepted new requests"
        assert node2.app.count["solo"] == 13
    finally:
        cli2.close()
        node2.stop()


def test_recovery_preserves_checkpoint_cut(tmp_path):
    """``test_recovery_preserves_checkpoint_cut``: a checkpoint every 5
    slots; recovery restores it and rolls only the tail forward."""
    Config.set(PC.SYNC_WAL, False)
    Config.set(PC.CHECKPOINT_INTERVAL, 5)
    node, cli = _solo(tmp_path)
    try:
        assert node.create_group("ck", (0,))
        for k in range(17):
            assert cli.send_request("ck", f"r{k}".encode()).status == 0
        digest = node.app.digest["ck"]
    finally:
        cli.close()
        node.stop()
    node2, cli2 = _solo(tmp_path)
    try:
        assert node2.app.count.get("ck") == 17
        assert node2.app.digest.get("ck") == digest
    finally:
        cli2.close()
        node2.stop()


# -- the batched mass takeover (tests/test_mass_failover.py) --------------


def _led_by(victim, n, prefix):
    names = []
    i = 0
    while len(names) < n:
        nm = f"{prefix}{i}"
        i += 1
        if group_key(nm) % 3 == victim:
            names.append(nm)
    return names


def test_mass_takeover_batched(tmp_path):
    """``test_mass_takeover_batched`` (columnar): 192 groups led by one
    node, past the 64-row batch threshold; it dies and the successor
    installs itself for every one through the PrepareBatch path."""
    victim = 0
    names = _led_by(victim, 192, "mf")
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=0,
                         capacity=2048, ping_interval_s=0.15,
                         failure_timeout_s=1.0)
    try:
        emu.create_groups(len(names), names=names)
        assert emu.run_load(60, concurrency=16,
                            timeout=tscale(10))["ok"] == 60
        time.sleep(0.5)
        successor = (victim + 1) % 3
        node = emu.nodes[successor]
        assert node.n_installs == 0, "spurious elections before the kill"
        emu.kill(victim)
        assert _wait(lambda: node.n_installs >= len(names)
                     and not node.open_elections, 45), (
            f"only {node.n_installs}/{len(names)} groups taken over "
            f"(elections left: {node.open_elections})")
        post = emu.run_load(60, concurrency=16, timeout=tscale(30),
                            client_id=1 << 21)
        assert post["ok"] == 60, f"post-takeover load failed: {post}"
        row = node.table.by_name(names[0]).row
        num, coord = unpack_ballot(int(node._bal[row]))
        assert coord == successor and num >= 1
    finally:
        emu.stop()


def test_mass_takeover_redrives_lost_wave(tmp_path):
    """``test_mass_takeover_redrives_lost_wave`` (columnar; the port has
    no native engine): the successor's first prepare wave is lost and
    the stalled-election re-drive in ``_tick`` completes the takeover."""
    victim = 0
    names = _led_by(victim, 128, "rd")
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=0,
                         capacity=1024, ping_interval_s=0.15,
                         failure_timeout_s=1.0)
    try:
        emu.create_groups(len(names), names=names)
        assert emu.run_load(30, concurrency=8,
                            timeout=tscale(10))["ok"] == 30
        time.sleep(0.5)
        node = emu.nodes[(victim + 1) % 3]
        node.transport.test_drop_rate = 1.0  # eat the first wave
        emu.kill(victim)
        assert _wait(lambda: node.open_elections, 15), \
            "election never started"
        node.transport.test_drop_rate = 0.0
        assert _wait(lambda: node.n_installs >= len(names)
                     and not node.open_elections, 20), (
            f"re-drive never completed: {node.n_installs}/{len(names)} "
            f"installed, {node.open_elections} elections open")
        post = emu.run_load(30, concurrency=8, timeout=tscale(30),
                            client_id=1 << 21)
        assert post["ok"] == 30, f"post-takeover load failed: {post}"
    finally:
        emu.stop()


# -- pause and unpause (tests/test_pause.py) -------------------------------


def test_pause_and_unpause_on_demand(tmp_path):
    """``test_pause_and_unpause_on_demand`` (columnar): idle groups leave
    the slab through ``snapshot_rows`` and come back on first touch
    through ``restore_row``, state intact on every replica."""
    Config.set(PC.PING_INTERVAL_S, 0.1)
    Config.set(PC.PAUSE_IDLE_S, 0.5)
    nodes, addr_map = make_cluster(tmp_path)
    cli = PaxosClient([addr_map[i] for i in range(3)], timeout=tscale(10))
    try:
        names = [f"pz{i}" for i in range(8)]
        for nd in nodes:
            nd.create_groups([(n, (0, 1, 2)) for n in names])
        for n in names:
            assert cli.send_request(n, b"one").status == 0
        assert _wait(lambda: all(len(nd.table) == 0
                                 and len(nd._paused) >= len(names)
                                 for nd in nodes), 10)
        for nd in nodes:
            assert nd.table.by_name(names[0]) is None
        assert cli.send_request(names[0], b"two").status == 0
        assert _wait(lambda: all(nd.app.count.get(names[0], 0) == 2
                                 for nd in nodes), 10)
        assert len({nd.app.digest.get(names[0]) for nd in nodes}) == 1
        assert all(nd.n_unpaused >= 1 for nd in nodes)
        # a paused group exists: a create is refused, and it answers
        for nd in nodes:
            assert not nd.create_group(names[1], (0, 1, 2))
        assert cli.send_request(names[1], b"two").status == 0
    finally:
        cli.close()
        shutdown(nodes)


def test_pause_survives_restart(tmp_path):
    """``test_pause_survives_restart`` (columnar): paused groups stay
    cold across a restart of every node and hydrate on first touch."""
    Config.set(PC.PING_INTERVAL_S, 0.1)
    Config.set(PC.PAUSE_IDLE_S, 0.4)
    nodes, addr_map = make_cluster(tmp_path)
    cli = PaxosClient([addr_map[i] for i in range(3)], timeout=tscale(10))
    try:
        for nd in nodes:
            nd.create_group("cold", (0, 1, 2))
        assert cli.send_request("cold", b"x").status == 0
        assert _wait(lambda: all(nd.n_paused >= 1 for nd in nodes), 10)
    finally:
        cli.close()
        shutdown(nodes)
    nodes2 = []
    for i in range(3):
        nd = PaxosNode(i, addr_map, CounterApp(), str(tmp_path / f"n{i}"),
                       capacity=1 << 10, window=16)
        nd.start()
        nodes2.append(nd)
    cli = PaxosClient([addr_map[i] for i in range(3)], timeout=tscale(10))
    try:
        assert all(nd.table.by_name("cold") is None for nd in nodes2)
        assert cli.send_request("cold", b"y").status == 0
        assert _wait(lambda: all(nd.app.count.get("cold", 0) == 2
                                 for nd in nodes2), 10)
    finally:
        cli.close()
        shutdown(nodes2)


def test_unpause_after_coordinator_death_elects(tmp_path):
    """``test_unpause_after_coordinator_death_elects`` (columnar): the
    coordinator dies while its group is paused on the survivors; the
    first touch after hydration elects a new one."""
    Config.set(PC.PING_INTERVAL_S, 0.1)
    Config.set(PC.FAILURE_TIMEOUT_S, 0.8)
    Config.set(PC.PAUSE_IDLE_S, 0.4)
    nodes, addr_map = make_cluster(tmp_path)
    cli = None
    try:
        name = "pzfo"
        for nd in nodes:
            nd.create_group(name, (0, 1, 2))
        dead = group_key(name) % 3
        cli = PaxosClient([addr_map[i] for i in range(3) if i != dead],
                          timeout=tscale(6))
        assert cli.send_request(name, b"a").status == 0
        assert _wait(lambda: all(nd.n_paused >= 1 for nd in nodes), 10)
        time.sleep(0.3)  # the survivors have last_heard for everyone
        nodes[dead].stop(abort=True)
        time.sleep(1.2)  # past the failure timeout
        ok = 0
        for k in range(8):
            try:
                ok += int(cli.send_request(
                    name, f"b{k}".encode()).status == 0)
            except TimeoutError:
                pass
        assert ok >= 6, f"only {ok}/8 after unpause+failover"
    finally:
        if cli:
            cli.close()
        shutdown(nodes)


# -- app failures (tests/test_app_failure.py, columnar) --------------------


class FlakyApp(CounterApp):
    """b"boom*" payloads raise every time (deterministic failure);
    b"flaky*" payloads raise on the first attempt only (transient)."""

    def __init__(self):
        super().__init__()
        self.attempts = {}

    def execute(self, name, req_id, payload, is_stop=False):
        n = self.attempts[req_id] = self.attempts.get(req_id, 0) + 1
        if payload.startswith(b"boom"):
            raise RuntimeError("deterministic app failure")
        if payload.startswith(b"flaky") and n == 1:
            raise RuntimeError("transient app failure")
        return super().execute(name, req_id, payload, is_stop)


def test_transient_failure_retried_in_place(tmp_path):
    """``test_transient_failure_retried_in_place``: one retry on every
    replica, none diverged."""
    nodes, addr_map = make_cluster(tmp_path, app_cls=FlakyApp)
    cli = PaxosClient([addr_map[i] for i in range(3)], timeout=tscale(10))
    try:
        for nd in nodes:
            nd.create_group("fl", (0, 1, 2))
        assert cli.send_request("fl", b"flaky-1").status == 0
        assert _wait(lambda: all(nd.app.count.get("fl", 0) == 1
                                 for nd in nodes), 10)
        assert len({nd.app.digest.get("fl") for nd in nodes}) == 1
        for nd in nodes:
            rid = next(i for i, n in nd.app.attempts.items() if n > 1)
            assert nd.app.attempts[rid] == 2
    finally:
        cli.close()
        shutdown(nodes)


def test_deterministic_failure_advances_and_caches(tmp_path):
    """``test_deterministic_failure_advances_and_caches``: status 4 after
    three tries on every replica, and the group is not wedged."""
    nodes, addr_map = make_cluster(tmp_path, app_cls=FlakyApp)
    cli = PaxosClient([addr_map[i] for i in range(3)], timeout=tscale(10))
    try:
        for nd in nodes:
            nd.create_group("bm", (0, 1, 2))
        assert cli.send_request("bm", b"ok-1").status == 0
        assert cli.send_request("bm", b"boom-1").status == 4
        assert cli.send_request("bm", b"ok-2").status == 0
        assert _wait(lambda: all(nd.app.count.get("bm", 0) == 2
                                 for nd in nodes), 10)
        for nd in nodes:
            rid = next(i for i, n in nd.app.attempts.items() if n >= 3)
            assert nd.app.attempts[rid] == 3
    finally:
        cli.close()
        shutdown(nodes)


def test_failed_request_retransmit_answered_from_cache(tmp_path):
    """``test_failed_request_retransmit_answered_from_cache``: a raw
    retransmit with the same request id is answered status 4 from the
    response cache, executed nowhere again."""
    nodes, addr_map = make_cluster(tmp_path, app_cls=FlakyApp)
    try:
        for nd in nodes:
            nd.create_group("rt", (0, 1, 2))
        gkey = pkt.group_key("rt")
        client_id = 7777
        req_id = (client_id << 32) | 1
        with socket.create_connection(addr_map[gkey % 3],
                                      timeout=tscale(10)) as s:
            s.sendall(_LEN.pack(4) + struct.pack("<i", client_id))
            frame = pkt.Request(client_id, gkey, req_id, 0,
                                b"boom-rt").encode()

            def roundtrip():
                s.sendall(_LEN.pack(len(frame)) + frame)
                buf = b""
                while True:
                    while len(buf) < 4:
                        buf += s.recv(65536)
                    (ln,) = _LEN.unpack(buf[:4])
                    while len(buf) < 4 + ln:
                        buf += s.recv(65536)
                    obj = pkt.decode(buf[4:4 + ln])
                    buf = buf[4 + ln:]
                    if isinstance(obj, pkt.Response) and \
                            obj.req_id == req_id:
                        return obj

            r1 = roundtrip()
            assert r1.status == 4, r1
            assert _wait(lambda: all(nd.app.attempts.get(req_id, 0) >= 3
                                     for nd in nodes), 10)
            before = [dict(nd.app.attempts) for nd in nodes]
            assert all(a.get(req_id) == 3 for a in before)
            r2 = roundtrip()
            assert r2.status == 4 and r2.payload == r1.payload
            for nd, b in zip(nodes, before):
                assert nd.app.attempts == b
    finally:
        shutdown(nodes)


# -- large checkpoints (tests/test_large_checkpoint.py) --------------------


class BlobApp(Replicable):
    """App whose whole state is one opaque blob."""

    def __init__(self):
        self.state = {}

    def execute(self, name, req_id, payload, is_stop=False):
        self.state[name] = self.state.get(name, b"") + payload
        return b"ok"

    def checkpoint(self, name):
        return self.state.get(name, b"")

    def restore(self, name, state):
        if state:
            self.state[name] = state
        else:
            self.state.pop(name, None)
        return True


def test_chunk_frame_roundtrip():
    """``test_chunk_frame_roundtrip``: a frame above the chunk threshold
    slices into CHUNK frames that reassemble over the wire codec."""
    frame = bytes(np.random.default_rng(0).integers(
        0, 256, 3 * pkt.CHUNK_BYTES + 17, dtype=np.uint8))
    chunks = pkt.chunk_frame(5, 99, frame)
    assert len(chunks) == 4
    back = [pkt.decode(c.encode()) for c in chunks]
    assert all(c.xfer_id == 99 and c.nchunks == 4 for c in back)
    assert b"".join(c.data for c in sorted(back, key=lambda c: c.seq)) \
        == frame


def test_large_checkpoint_streams_over_chunks(tmp_path):
    """``test_large_checkpoint_streams_over_chunks`` (columnar): a ~100 MB
    checkpoint, above the frame ceiling, reaches a lagging replica as
    paced chunks and restores it (the CheckpointReply catch-up path)."""
    nodes, addr_map = make_cluster(tmp_path, n=2, app_cls=BlobApp)
    try:
        for nd in nodes:
            assert nd.create_group("big", (0, 1))
        big = bytes(np.random.default_rng(1).integers(
            0, 256, 100 * 1024 * 1024, dtype=np.uint8))
        nodes[0].app.state["big"] = big
        # node 0 believes slot 41 is checkpointed; node 1 lags at cursor 0
        reply = pkt.CheckpointReply(0, pkt.group_key("big"), 41, big)
        assert len(reply.encode()) > native.MAX_FRAME \
            or len(reply.encode()) > pkt.CHUNK_THRESHOLD
        nodes[0]._route(1, reply)
        assert _wait(lambda: nodes[1].app.state.get("big") == big, 60), \
            "chunked checkpoint never reassembled"
        row = nodes[1].table.by_name("big").row
        assert int(nodes[1]._cur[row]) == 42  # frontier advanced
    finally:
        shutdown(nodes)
