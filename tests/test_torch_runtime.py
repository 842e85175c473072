"""The port's node runtime (``PaxosNode`` over the port's
``ColumnarBackend`` on the CPU) against the JAX package's
(``backend="columnar"``): three nodes on loopback each, the same fixed
client load, and per replica the same executed (group, request id,
payload) order, the same ``CounterApp`` counts and digests and the same
device cursors (``inspect_rows``), with fused waves on, with them off,
and on the pipelined worker.  Also: a port node restarts from a logdir
(its own, or one a JAX node wrote) and serves again, and every option
whose module is not ported raises instead of running without it,
``BLACKBOX_MB > 0`` arms the flight recorder, and a retransmit in the
same intake batch as its original takes no second slot.  Exact
equality throughout."""

import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

from gigapaxos_tpu.paxos import interfaces as ji
from gigapaxos_tpu.paxos.client import PaxosClient as JaxClient
from gigapaxos_tpu.paxos.manager import PaxosNode as JaxNode
from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
from gigapaxos_tpu.testing.harness import PaxosEmulation as JaxEmulation
from gigapaxos_tpu.testing.harness import free_ports
from gigapaxos_tpu.utils.config import Config as JConfig
from gigapaxos_tpu_torch.paxos import interfaces as ti
from gigapaxos_tpu_torch.paxos import packets as pkt
from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.paxos.packets import group_key
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from tests.conftest import tscale

CAP, W, GROUPS = 1 << 10, 16, 8
LOADS = ((64, 16, 0, 1 << 20), (48, 8, 1, 1 << 21))  # n, depth, shift, id


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's config, profiler and
    instrumenter; the port keeps its own, reset here."""
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()


def _recording(base):
    """``base``'s ``CounterApp`` that also records every execution."""

    class Recording(base.CounterApp):
        def __init__(self):
            super().__init__()
            self.log = []

        def execute(self, name, req_id, payload, is_stop=False):
            with self._lock:
                self.log.append((name, req_id, payload))
            return super().execute(name, req_id, payload, is_stop)

    return Recording


def _drive(emu, nodes):
    """The fixed load: windowed loads routed to each group's coordinator
    and, forwarded, to the next member; then wait for every replica."""
    total = 0
    for n, depth, shift, cid in LOADS:
        r = emu.run_load_fast(n, concurrency=depth, timeout=tscale(30),
                              client_id=cid, entry_shift=shift)
        assert (r["ok"], r["errors"]) == (n, 0), r
        total += n
    deadline = time.time() + tscale(20)
    while time.time() < deadline and not all(
            sum(nd.app.count.values()) == total for nd in nodes):
        time.sleep(0.02)
    assert [sum(nd.app.count.values()) for nd in nodes] == [total] * 3


def _observe(nodes, groups):
    out = []
    for nd in nodes:
        rows = np.asarray([nd.table.by_name(g).row for g in groups])
        dev = nd.backend.inspect_rows(rows)
        out.append({
            "order": {g: [e for e in nd.app.log if e[0] == g]
                      for g in groups},
            "count": dict(nd.app.count),
            "digest": dict(nd.app.digest),
            "groups": list(groups),
            "rows": rows.tolist(),
            "inspect": {k: np.asarray(v).tolist() for k, v in dev.items()},
        })
    return out


def _run_cluster(port, fuse, pipeline):
    cfg, pc = (Config, PC) if port else (JConfig, JPC)
    cfg.set(pc.FUSE_WAVES, fuse)
    cfg.set(pc.PIPELINE_WORKER, pipeline)
    if port:
        cfg.set(pc.COLUMNAR_DEVICE, "cpu")
    else:
        cfg.set(pc.ENGINE_MESH, "off")  # one device, as the port runs
    d = tempfile.mkdtemp(prefix="gp_torch_rt_")
    emu = None
    try:
        # no peer is suspected within the run: an election (after a
        # compile or a loaded box stalls a worker) would move ballots
        emu = (PaxosEmulation if port else JaxEmulation)(
            d, n_nodes=3, n_groups=GROUPS, backend="columnar",
            app_cls=_recording(ti if port else ji), capacity=CAP, window=W,
            failure_timeout_s=300.0)
        nodes = [emu.nodes[i] for i in range(3)]
        assert all(nd._fuse_waves == (fuse == "on") for nd in nodes)
        _drive(emu, nodes)
        assert sum(nd.n_installs for nd in nodes) == 0
        return _observe(nodes, emu.groups)
    finally:
        if emu is not None:
            emu.stop()
        cfg.clear()
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module", params=[("on", False), ("off", False),
                                        ("on", True)],
                ids=["fused", "unfused", "fused-pipelined"])
def both(request):
    fuse, pipeline = request.param
    return (_run_cluster(True, fuse, pipeline),
            _run_cluster(False, fuse, pipeline))


def test_runtime_execution_order_matches(both):
    port, ref = both
    for i in range(3):
        assert port[i]["order"] == ref[i]["order"], f"replica {i}"
        assert sum(len(v) for v in port[i]["order"].values()) == \
            sum(n for n, *_ in LOADS)


def test_runtime_counts_and_digests_match(both):
    port, ref = both
    for i in range(3):
        assert port[i]["count"] == ref[i]["count"], f"replica {i}"
        assert port[i]["digest"] == ref[i]["digest"], f"replica {i}"
    assert len({tuple(sorted(p["digest"].items())) for p in port}) == 1


def test_runtime_device_cursors_match(both):
    port, ref = both
    for i in range(3):
        assert port[i]["rows"] == ref[i]["rows"]
        assert port[i]["inspect"] == ref[i]["inspect"], f"replica {i}"
        assert port[i]["inspect"]["exec_cursor"] == [
            port[i]["count"][g] for g in port[i]["groups"]]


# -- restart -------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_port_node_restarts_from_logdir(tmp_path, writer):
    """A single-member group's node crashes after 12 requests; a port
    node over the same logdir rolls the WAL forward to the same count and
    digest and serves the next request."""
    addr = {0: ("127.0.0.1", free_ports(1)[0])}
    logdir = str(tmp_path / "n0")
    if writer == "port":
        Config.set(PC.COLUMNAR_DEVICE, "cpu")
        Config.set(PC.SYNC_WAL, False)
        node = PaxosNode(0, addr, ti.CounterApp(), logdir, capacity=1 << 8)
        cli = PaxosClient([addr[0]], timeout=tscale(5))
    else:
        JConfig.set(JPC.SYNC_WAL, False)
        node = JaxNode(0, addr, ji.CounterApp(), logdir, backend="scalar",
                       capacity=1 << 8)
        cli = JaxClient([addr[0]], timeout=tscale(5))
    node.start()
    try:
        assert node.create_group("solo", (0,))
        for k in range(12):
            assert cli.send_request("solo", f"r{k}".encode()).status == 0
        digest = node.app.digest["solo"]
    finally:
        cli.close()
        node.stop(abort=True)

    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.SYNC_WAL, False)
    node2 = PaxosNode(0, addr, ti.CounterApp(), logdir, capacity=1 << 8)
    node2.start()
    cli2 = PaxosClient([addr[0]], timeout=tscale(5))
    try:
        assert node2.app.count.get("solo") == 12
        assert node2.app.digest.get("solo") == digest
        deadline = time.time() + tscale(10)
        got = False
        while time.time() < deadline and not got:
            try:
                got = cli2.send_request("solo", b"after").status == 0
            except TimeoutError:
                pass
        assert got, "the restarted node never served again"
        assert node2.app.count["solo"] == 13
        assert node2.backend.inspect_rows(np.asarray(
            [node2.table.by_name("solo").row]))["exec_cursor"][0] == 13
    finally:
        cli2.close()
        node2.stop()


def _runtime_threads():
    import threading
    return {t for t in threading.enumerate()
            if t.name.startswith("gp-") and t.is_alive()}


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["worker", "pipelined"])
def test_stop_ends_every_runtime_thread(tmp_path, pipeline):
    """After a drained load, ``stop`` leaves no thread of the nodes
    running: a daemon thread still inside a torch call when the
    interpreter exits aborts the process (``std::terminate``)."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.PIPELINE_WORKER, pipeline)
    before = _runtime_threads()
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=4,
                         backend="columnar", capacity=64, window=W,
                         failure_timeout_s=300.0)
    try:
        r = emu.run_load_fast(24, concurrency=8, timeout=tscale(30))
        assert (r["ok"], r["errors"]) == (24, 0), r
        assert _runtime_threads() - before, "the nodes started no thread"
    finally:
        emu.stop()
    deadline = time.time() + tscale(10)
    while time.time() < deadline and _runtime_threads() - before:
        time.sleep(0.02)
    assert not {t.name for t in _runtime_threads() - before}


def test_retransmit_in_one_batch_takes_one_slot(tmp_path):
    """A request and its retransmit that reach the coordinator in one
    read are proposed once: the group's replicas execute it once, their
    host and device cursors agree, and the group goes on executing.
    (The JAX package proposes both, into two slots; the second finds the
    payload gone with the first and wedges the group on every replica:
    ROADMAP §3.)"""
    import socket
    import struct
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    from gigapaxos_tpu_torch.paxos.packets import group_key
    from gigapaxos_tpu_torch.testing.loadgen import _frame
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=4,
                         backend="columnar", app_cls=ti.CounterApp,
                         capacity=64, window=W, failure_timeout_s=300.0)
    try:
        g = emu.groups[0]
        gk = group_key(g)
        nodes = [emu.nodes[i] for i in emu.members_of(g)]
        cid = 77
        with socket.create_connection(
                emu.addr_map[emu.members_of(g)[gk % 3]]) as s:
            s.sendall(struct.pack("<Ii", 4, cid))
            first = _frame(cid, gk, (cid << 32) | 1, b"a")
            s.sendall(first + first)  # one write: one intake batch
            s.sendall(_frame(cid, gk, (cid << 32) | 2, b"b"))
            deadline = time.time() + tscale(20)
            while time.time() < deadline and not all(
                    n.app.count.get(g) == 2 for n in nodes):
                time.sleep(0.02)
        for n in nodes:
            row = n.table.by_name(g).row
            dev = int(state_to_numpy(n.backend.state)["exec_cursor"][row])
            assert (n.app.count.get(g), int(n._cur[row]), dev) == (2, 2, 2)
    finally:
        emu.stop()


# -- guards --------------------------------------------------------------


@pytest.mark.parametrize("knob,value,backend", [
    (None, None, "native"),
    (PC.ENGINE_MESH, 2, "columnar"),
    (PC.ENGINE_MESH, "2", "columnar"),
    (PC.LOCK_WITNESS, True, "columnar"),
])
def test_unported_options_raise(tmp_path, knob, value, backend):
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    if knob is not None:
        Config.set(knob, value)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                  str(tmp_path / "n0"), backend=backend, capacity=64)
    # refused before the node touched its logdir
    assert not os.path.exists(tmp_path / "n0")


def test_blackbox_mb_arms_the_recorder(tmp_path):
    """``BLACKBOX_MB > 0`` arms the flight recorder on the node, its
    transport and its WAL logger, with the configured byte budget."""
    from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.BLACKBOX_MB, 1)
    node = PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                     str(tmp_path / "n0"), capacity=64)
    try:
        assert isinstance(node.blackbox, BlackboxRecorder)
        assert node.transport.blackbox is node.blackbox
        assert node.logger.blackbox is node.blackbox
        assert node.blackbox.snapshot()["budget_bytes"] == 1 << 20
    finally:
        node.blackbox.close()
        node.logger.close()


def test_one_device_mesh_settings_run(tmp_path):
    """"off", "auto" and 1 are one device, as in the reference."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    for i, mesh in enumerate(("off", "auto", 1)):
        Config.set(PC.ENGINE_MESH, mesh)
        node = PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                         str(tmp_path / f"n{i}"), capacity=64)
        assert node.backend.engine_platform == "cpu"
        node.logger.close()


def test_node_defaults_to_the_card(tmp_path):
    """The default ``COLUMNAR_DEVICE`` is the card: with none present the
    node raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PC.COLUMNAR_DEVICE.default == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                  str(tmp_path / "n0"), capacity=64)


# -- the runtime's wave driver (breakdown --paths wave) ------------------


def test_runtime_wave_driver_on_cpu():
    """The ``wave`` path's acceptor drive, rehearsed on the CPU: every
    wave's accepts are acked and the previous wave's commits applied, so
    each wave advances the cursors of the rows it commits by one."""
    from gigapaxos_tpu_torch import breakdown as bd
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    b, wave = bd._acceptor(0, 4, device="cpu")
    for _ in range(4):
        wave()
    assert int(state_to_numpy(b.state)["exec_cursor"].sum()) == \
        3 * bd.RT_LANES


# -- the control plane's load on the runtime (ROADMAP §3) ---------------


def test_local_requests_pass_the_backlog_guard(tmp_path):
    """Requests a node puts on its own queue (the control plane's record
    ops and epoch stops) are never shed by the congestion guard: a burst
    of them behind a tiny backlog limit is decided and executed on every
    replica, with nothing shed."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.INTAKE_BACKLOG_LIMIT, 8)
    Config.set(PC.BATCH_SIZE, 16)  # the queue stays deep between batches
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=0,
                         app_cls=ti.CounterApp, capacity=CAP, window=W,
                         sync_wal=False)
    try:
        nodes = [emu.nodes[i] for i in range(3)]
        names = [f"loc{i}" for i in range(300)]
        for n in nodes:
            n.create_groups([(g, (0, 1, 2)) for g in names])
        for i, g in enumerate(names):
            coord = nodes[group_key(g) % 3]
            coord._inq.put(pkt.Request(coord.id, group_key(g),
                                       (1 << 62) | i, 0, b"x"))
        deadline = time.time() + tscale(20)
        while time.time() < deadline and not all(
                sum(n.app.count.values()) == len(names) for n in nodes):
            time.sleep(0.05)
        assert [sum(n.app.count.values()) for n in nodes] == [300] * 3
        assert sum(n.n_shed for n in nodes) == 0
    finally:
        emu.stop()


def test_tick_sends_leave_in_one_hop(tmp_path):
    """A tick's sends (here the catch-up sync requests of rows that acked
    an accept and saw no decision) reach the event loop as one batch, not
    one loop hop a packet."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    node = PaxosNode(0, {0: ("127.0.0.1", 1), 1: ("127.0.0.1", 2),
                         2: ("127.0.0.1", 3)}, ti.CounterApp(),
                     str(tmp_path / "n0"), capacity=CAP, window=W)
    try:
        names = [f"lag{i}" for i in range(40)]
        node.create_groups([(g, (1, 2, 0)) for g in names])
        rows = np.asarray([node.table.by_name(g).row for g in names])
        node._acc_hi[rows] = 0
        node._acc_ts[rows] = 0.0  # acked long ago, nothing decided

        class Loop:
            def call_soon_threadsafe(self, fn, *args):
                hops.append((fn.__name__, args))

        hops = []
        node._loop = Loop()
        node.transport._loop = node._loop
        node._tick()
        many = [a[0] for f, a in hops if f == "send_many"]
        assert [f for f, _ in hops] == ["send_many"], hops
        sync = [it for it in many[0]
                if pkt.decode(it[1]).__class__ is pkt.SyncRequest]
        assert len(sync) == len(names)
    finally:
        node._loop = None
        node.logger.close()
