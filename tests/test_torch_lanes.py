"""The port's engine lanes (``PC.ENGINE_SHARDS``; its
``ShardedColumnarBackend`` and the manager's per-lane workers and WAL
segments) against the JAX package's, on the CPU.

The port's counterpart of ``tests/test_sharded_engine.py``:

- at the SPI, the port's 4-slab ``ShardedColumnarBackend``, the JAX
  package's and the port's single ``ColumnarBackend`` take the same
  randomized multi-type stream (mixed-shard batches, blocking calls,
  submit/collect, both fused dual-input waves, ``propose_self`` and
  ``accept_reply_commit_self``) and give the same outputs and the same
  state in every row;
- at the node, 3 port nodes and 3 JAX nodes at S = 4 take the same
  client load: per replica the same execution order, counts, digests and
  ``inspect_rows``;
- the segmented WAL (``wal-<k>.log``): a set written by either package
  recovers on a node of the other, a single ``wal.log`` migrates to
  segments, and a crashed 4-lane node recovers from its segments;
- ``capacity % S != 0`` runs one lane with a warning, as the reference.

Every comparison is exact."""

import logging
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

from gigapaxos_tpu.paxos import interfaces as ji
from gigapaxos_tpu.paxos.backend import \
    ShardedColumnarBackend as JaxSharded
from gigapaxos_tpu.paxos.client import PaxosClient as JaxClient
from gigapaxos_tpu.paxos.manager import PaxosNode as JaxNode
from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
from gigapaxos_tpu.testing.harness import PaxosEmulation as JaxEmulation
from gigapaxos_tpu.testing.harness import free_ports
from gigapaxos_tpu.utils.config import Config as JConfig
from gigapaxos_tpu_torch.paxos import interfaces as ti
from gigapaxos_tpu_torch.paxos.backend import (ColumnarBackend,
                                               ShardedColumnarBackend)
from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from tests.conftest import tscale

SH = 4


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's singletons; the
    port keeps its own, reset here."""
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()


# -- the SPI ---------------------------------------------------------------


def _engines(cap, W):
    """The JAX 4-slab facade, the port's and the port's single slab,
    every row created with 3 members and this node as coordinator."""
    JConfig.set(JPC.ENGINE_MESH, "off")
    engines = [JaxSharded(cap, W, shards=SH),
               ShardedColumnarBackend(cap, W, SH, device="cpu"),
               ColumnarBackend(cap, W, device="cpu")]
    rows = np.arange(cap, dtype=np.int32)
    for bk in engines:
        bk.create(rows, np.full(cap, 3, np.int32), np.zeros(cap, np.int32),
                  np.zeros(cap, np.int32), np.ones(cap, bool))
    return engines


def _flat(res):
    """A result (nested tuples / NamedTuples of arrays) as a flat list of
    numpy arrays."""
    if isinstance(res, tuple):
        return [a for r in res for a in _flat(r)]
    return [np.asarray(res)]


def _all(engines, what, call):
    """``call(engine)`` on every engine; every output must be equal to the
    JAX facade's.  Returns the JAX facade's result."""
    outs = [call(bk) for bk in engines]
    want = _flat(outs[0])
    for name, got in zip(("port sharded", "port single"), outs[1:]):
        got = _flat(got)
        assert len(got) == len(want), f"{what}: {name}"
        for i, (a, b) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(
                a, b, err_msg=f"{what}[{i}]: {name} != jax sharded")
    return outs[0]


def _same_rows(engines, cap):
    snaps = [bk.snapshot_rows(np.arange(cap)) for bk in engines]
    for name, other in zip(("port sharded", "port single"), snaps[1:]):
        for r, (a, b) in enumerate(zip(snaps[0], other)):
            for f in a:
                np.testing.assert_array_equal(
                    np.asarray(a[f]), np.asarray(b[f]),
                    err_msg=f"{name}: state row {r} field {f}")


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_backend_parity_random_multitype(seed):
    """The reference test's randomized multi-type stream: blocking,
    submit/collect and fused acceptor waves on mixed-shard batches, then
    the fused coordinator waves and a prepare; outputs and every state
    row equal across the three engines."""
    W, cap, n = 8, 128, 64
    rng = np.random.default_rng(seed)
    engines = _engines(cap, W)
    prev = None  # (rows, slots, reqs) decided in the prior round
    for round_ in range(4):
        rows = rng.integers(0, cap, n).astype(np.int32)
        reqs = ((np.uint64(round_ + 1) << np.uint64(40))
                | rng.integers(1, 1 << 31, n).astype(np.uint64))
        pr = _all(engines, f"r{round_}.propose",
                  lambda bk: bk.propose(rows, reqs))
        slots, cbal = np.asarray(pr.slot), np.asarray(pr.cbal)
        mode = rng.choice(["blocking", "submit", "fused"])
        if mode == "fused" and prev is not None:
            ares, _ = _all(engines, f"r{round_}.accept_commit",
                           lambda bk: bk.accept_commit(rows, slots, cbal,
                                                       reqs, *prev))
        elif mode == "submit":
            ares = _all(engines, f"r{round_}.accept_submit",
                        lambda bk: bk.accept_submit(rows, slots, cbal,
                                                    reqs).collect())
            if prev is not None:
                _all(engines, f"r{round_}.commit_submit",
                     lambda bk: bk.commit_submit(*prev).collect())
        else:
            ares = _all(engines, f"r{round_}.accept",
                        lambda bk: bk.accept(rows, slots, cbal, reqs))
            if prev is not None:
                _all(engines, f"r{round_}.commit",
                     lambda bk: bk.commit(*prev))
        newly = np.zeros(n, bool)
        for s in range(2):
            sid = np.full(n, s, np.int32)
            rr = _all(engines, f"r{round_}.reply{s}",
                      lambda bk: bk.accept_reply(rows, slots, cbal, sid,
                                                 ares.acked))
            newly |= np.asarray(rr.newly_decided)
        keep = np.flatnonzero(newly & np.asarray(pr.granted))
        prev = (rows[keep], slots[keep], reqs[keep])
    # the coordinator's fused waves on mixed-shard batches
    rows = rng.integers(0, cap, n).astype(np.int32)
    reqs = rng.integers(1, 1 << 62, n).astype(np.uint64)
    midx = np.zeros(n, np.int32)
    ps = _all(engines, "propose_self",
              lambda bk: bk.propose_self(rows, reqs, midx))
    gi = np.flatnonzero(np.asarray(ps[0].granted))
    slots, cbal = np.asarray(ps[0].slot)[gi], np.asarray(ps[0].cbal)[gi]
    ones = np.ones(len(gi), np.int32)
    _all(engines, "accept_reply_commit_self",
         lambda bk: bk.accept_reply_commit_self(
             rows[gi], slots, cbal, ones, np.ones(len(gi), bool)))
    rows2 = rng.integers(0, cap, n).astype(np.int32)
    reqs2 = rng.integers(1, 1 << 62, n).astype(np.uint64)
    _all(engines, "propose_self_reply_submit",
         lambda bk: bk.propose_self_reply_submit(
             rows2, reqs2, midx, rows[gi], slots, cbal, 2 * ones,
             np.ones(len(gi), bool)).collect())
    # prepare exercises the [B, W] window merge across shards
    pr_rows = rng.permutation(cap)[:32].astype(np.int32)
    _all(engines, "prepare",
         lambda bk: bk.prepare(pr_rows, np.full(32, 1 << 10, np.int32)))
    _all(engines, "inspect_rows",
         lambda bk: tuple(bk.inspect_rows(np.arange(cap)).values()))
    _same_rows(engines, cap)
    assert engines[1].row_ownership() == engines[0].row_ownership()


def test_sharded_slabs_and_accounting():
    """Global row r lives in slab r % S at local row r // S; on the CPU
    no slab has a stream; memory and ownership aggregate the slabs, and
    a lane-pure batch reaches one slab only."""
    W, cap = 8, 64
    sh = ShardedColumnarBackend(cap, W, SH, device="cpu")
    assert [s.capacity for s in sh.slabs] == [cap // SH] * SH
    assert all(s.stream is None for s in sh.slabs)
    sh.create(np.asarray([1, 5, 6], np.int32), np.full(3, 3, np.int32),
              np.zeros(3, np.int32), np.zeros(3, np.int32),
              np.ones(3, bool))
    assert sh.row_ownership() == {"rows_active": 3, "shards": [0, 2, 1, 0],
                                  "mesh": [0]}
    assert sh.slabs[1].cursor_of(1) == 0 and \
        bool(sh.slabs[1].state.active[1]) and \
        bool(sh.slabs[2].state.active[1])
    single = ColumnarBackend(cap, W, device="cpu").memory_info()
    mem = sh.memory_info()
    assert mem["total_bytes"] == single["total_bytes"] == \
        sum(mem["planes"].values())
    assert mem["planes"] == single["planes"]
    assert [p["capacity"] for p in mem["per_shard"]] == [cap // SH] * SH
    assert mem["engine_shards"] == SH
    assert sh.kernel_costs() == sh.slabs[0].kernel_costs()
    # every lane's slab launches under the one process-wide lane lock; a
    # node's single slab launches unlocked
    from gigapaxos_tpu_torch.paxos import backend as tb
    assert all(s._launch_lock is tb._LANE_LAUNCH_LOCK for s in sh.slabs)
    assert ColumnarBackend(cap, W, device="cpu")._launch_lock \
        is not tb._LANE_LAUNCH_LOCK
    calls = []
    for k, slab in enumerate(sh.slabs):
        orig = slab.propose

        def spy(rows, reqs, _k=k, _orig=orig):
            calls.append(_k)
            return _orig(rows, reqs)
        slab.propose = spy
    sh.propose(np.asarray([1, 5], np.int32), np.asarray([7, 8], np.uint64))
    assert calls == [1]


# -- the node --------------------------------------------------------------


GROUPS, CAP, W = 12, 1 << 8, 16
LOADS = ((48, 8, 0, 1 << 20), (32, 8, 1, 1 << 21))  # n, depth, shift, id


def _recording(base):
    class Recording(base.CounterApp):
        def __init__(self):
            super().__init__()
            self.log = []

        def execute(self, name, req_id, payload, is_stop=False):
            with self._lock:
                self.log.append((name, req_id, payload))
            return super().execute(name, req_id, payload, is_stop)

    return Recording


def _lanes_cluster(port):
    """3 nodes of one package at S = 4 take the fixed load; returns per
    replica the execution order, counts, digests and device cursors."""
    cfg, pc = (Config, PC) if port else (JConfig, JPC)
    cfg.set(pc.ENGINE_SHARDS, SH)
    cfg.set(pc.FUSE_WAVES, "on")
    if port:
        cfg.set(pc.COLUMNAR_DEVICE, "cpu")
    else:
        cfg.set(pc.ENGINE_MESH, "off")  # one device, as the port runs
    d = tempfile.mkdtemp(prefix="gp_torch_lanes_")
    emu = None
    try:
        emu = (PaxosEmulation if port else JaxEmulation)(
            d, n_nodes=3, n_groups=GROUPS, backend="columnar",
            app_cls=_recording(ti if port else ji), capacity=CAP, window=W,
            failure_timeout_s=300.0)
        nodes = [emu.nodes[i] for i in range(3)]
        assert all(nd.shards == SH for nd in nodes)
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
        assert sum(nd.n_installs for nd in nodes) == 0
        out = []
        for i, nd in enumerate(nodes):
            rows = np.asarray([nd.table.by_name(g).row for g in emu.groups])
            dev = nd.backend.inspect_rows(rows)
            out.append({
                "order": {g: [e for e in nd.app.log if e[0] == g]
                          for g in emu.groups},
                "count": dict(nd.app.count),
                "digest": dict(nd.app.digest),
                "rows": rows.tolist(),
                "inspect": {k: np.asarray(v).tolist()
                            for k, v in dev.items()},
                "groups": list(emu.groups),
                "segments": sorted(f for f in os.listdir(
                    os.path.join(d, f"n{i}")) if f.startswith("wal")),
            })
        return out, total
    finally:
        if emu is not None:
            emu.stop()
        cfg.clear()
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def lanes_both():
    return _lanes_cluster(True), _lanes_cluster(False)


def test_lanes_execution_order_matches(lanes_both):
    (port, total), (ref, _) = lanes_both
    for i in range(3):
        assert port[i]["order"] == ref[i]["order"], f"replica {i}"
        assert sum(len(v) for v in port[i]["order"].values()) == total


def test_lanes_counts_digests_and_cursors_match(lanes_both):
    (port, _), (ref, _) = lanes_both
    for i in range(3):
        for key in ("count", "digest", "rows", "inspect"):
            assert port[i][key] == ref[i][key], f"replica {i}: {key}"
        assert port[i]["inspect"]["exec_cursor"] == [
            port[i]["count"][g] for g in port[i]["groups"]]
        assert port[i]["segments"] == [f"wal-{k}.log" for k in range(SH)]
    assert len({tuple(sorted(p["digest"].items())) for p in port}) == 1


# -- the segmented WAL -----------------------------------------------------


def _solo(pkg, logdir, addr, shards, n_groups, n_requests, abort=True):
    """A one-member node of ``pkg`` at ``shards`` lanes: serves
    ``n_requests`` round-robin over ``n_groups`` fresh groups, then stops
    (crash-stops with ``abort``).  Returns the digests."""
    port = pkg == "port"
    cfg, pc = (Config, PC) if port else (JConfig, JPC)
    cfg.set(pc.ENGINE_SHARDS, shards)
    cfg.set(pc.SYNC_WAL, False)
    cfg.set(pc.CHECKPOINT_INTERVAL, 5)
    if port:
        cfg.set(pc.COLUMNAR_DEVICE, "cpu")
    else:
        cfg.set(pc.ENGINE_MESH, "off")
    names = [f"s{i}" for i in range(n_groups)]
    node = (PaxosNode if port else JaxNode)(
        0, addr, (ti if port else ji).CounterApp(), logdir,
        backend="columnar", capacity=CAP, window=W)
    node.start()
    cli = (PaxosClient if port else JaxClient)([addr[0]],
                                               timeout=tscale(20))
    try:
        assert node.create_groups([(n, (0,)) for n in names]) == n_groups
        for k in range(n_requests):
            assert cli.send_request(names[k % n_groups], b"p").status == 0
        return dict(node.app.digest)
    finally:
        cli.close()
        node.stop(abort=abort)
        cfg.clear()


def _recovered(pkg, logdir, addr, shards):
    """Boot a node of ``pkg`` at ``shards`` lanes over ``logdir``; returns
    its counts and digests after recovery."""
    port = pkg == "port"
    cfg, pc = (Config, PC) if port else (JConfig, JPC)
    cfg.set(pc.ENGINE_SHARDS, shards)
    if port:
        cfg.set(pc.COLUMNAR_DEVICE, "cpu")
    else:
        cfg.set(pc.ENGINE_MESH, "off")
    node = (PaxosNode if port else JaxNode)(
        0, addr, (ti if port else ji).CounterApp(), logdir,
        backend="columnar", capacity=CAP, window=W)
    node.start()
    try:
        return dict(node.app.count), dict(node.app.digest), node.shards
    finally:
        node.stop()
        cfg.clear()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")],
                         ids=["jax-to-port", "port-to-jax", "port-crash"])
def test_segmented_wal_recovers(tmp_path, writer, reader):
    """A 4-lane node crash-stops after 64 requests over 16 groups; a
    4-lane node (of the other package, or the port again) recovers every
    request from ``wal-0.log`` to ``wal-3.log``, exactly once."""
    addr = {0: ("127.0.0.1", free_ports(1)[0])}
    d = str(tmp_path / "n0")
    digests = _solo(writer, d, addr, SH, 16, 64)
    assert sorted(f for f in os.listdir(d) if f.startswith("wal")) == \
        [f"wal-{k}.log" for k in range(SH)]
    counts, got, shards = _recovered(reader, d, addr, SH)
    assert shards == SH
    assert counts == {f"s{i}": 4 for i in range(16)}
    assert got == digests


def test_wal_migration_single_to_segmented(tmp_path):
    """A one-lane node's single ``wal.log`` is adopted as segment 0 on the
    first 4-lane boot: the state recovers and the old file is gone."""
    addr = {0: ("127.0.0.1", free_ports(1)[0])}
    d = str(tmp_path / "n0")
    digests = _solo("port", d, addr, 1, 8, 32, abort=False)
    os.replace(os.path.join(d, "wal-0.log"), os.path.join(d, "wal.log"))
    counts, got, shards = _recovered("port", d, addr, SH)
    assert shards == SH
    assert not os.path.exists(os.path.join(d, "wal.log"))
    assert os.path.exists(os.path.join(d, "wal-0.log"))
    assert counts == {f"s{i}": 4 for i in range(8)}
    assert got == digests


def test_capacity_not_divisible_runs_one_lane(tmp_path, caplog):
    """``capacity % S != 0`` warns and runs one lane, as the reference."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.ENGINE_SHARDS, SH)
    with caplog.at_level(logging.WARNING):
        node = PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                         str(tmp_path / "n0"), capacity=66)
    try:
        assert node.shards == 1
        assert isinstance(node.backend, ColumnarBackend)
        assert "running single-lane" in caplog.text
    finally:
        node.logger.close()


def test_four_lanes_on_the_columnar_backend(tmp_path):
    """``ENGINE_SHARDS=4`` at capacity 2^10: four lanes, four 2^8-row
    slabs, and the fused waves on the sharded facade."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.ENGINE_SHARDS, SH)
    Config.set(PC.FUSE_WAVES, "on")
    node = PaxosNode(0, {0: ("127.0.0.1", 1)}, ti.CounterApp(),
                     str(tmp_path / "n0"), capacity=1 << 10)
    try:
        assert node.shards == SH
        assert isinstance(node.backend, ShardedColumnarBackend)
        assert [s.capacity for s in node.backend.slabs] == [1 << 8] * SH
        assert node._col_self is node.backend and node._fuse_waves
    finally:
        node.logger.close()


def test_lanes_wave_drive_on_cpu():
    """``breakdown --paths lanes``, rehearsed on the CPU: plain and lane
    slabs driven from three threads, and one lane slab alone."""
    from gigapaxos_tpu_torch import breakdown as bd
    r = bd.lanes_breakdown(waves=2, device="cpu", threads=3)
    for key in ("plain", "lane", "alone"):
        assert r[f"{key}_waves_per_s"] > 0 and r[f"{key}_wave_ms_median"] > 0
    assert (r["capacity"], r["threads"]) == (bd.LN_G, 3)
