"""The port's reconfiguration control plane
(``gigapaxos_tpu_torch/reconfiguration/``, ``examples/``) against the JAX
package's, on the CPU, and the port's counterparts of
``tests/test_reconfiguration.py``, ``tests/test_http.py`` and the gateway
and ballot-churn cases of ``tests/test_groups_api.py``.

Parity, exact equality, the same inputs made from a seed:

- ``ConsistentHashing`` puts 10,000 names on the same reconfigurator and
  the same actives;
- every ``rcpackets`` packet function gives the same dict;
- ``ReconfiguratorDB`` runs one scripted command sequence (single and
  batched ops: create, start ack, move, stop, drop) to the same records,
  replies, side-effect calls and checkpoint bytes, and a checkpoint
  written by either package restores in the other to the same records;
- ``ChatApp`` answers the same requests alike and reaches the same state;
- one scripted cluster run (create, requests, move, delete on 4 actives
  and 3 reconfigurators, the scalar backend in both packages) gives the
  same replies, records and final app state.

The port-only cases run every node on the port's columnar engine on the
CPU (``PC.COLUMNAR_DEVICE = "cpu"``)."""

import asyncio
import base64
import dataclasses
import inspect
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gigapaxos_tpu.examples import chatapp as j_chat
from gigapaxos_tpu.paxos import interfaces as j_if
from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
from gigapaxos_tpu.reconfiguration import consistenthash as j_ch
from gigapaxos_tpu.reconfiguration import rcdb as j_rcdb
from gigapaxos_tpu.reconfiguration import rcpackets as j_rcp
from gigapaxos_tpu.reconfiguration.appclient import \
    ReconfigurableAppClient as JaxClient
from gigapaxos_tpu.reconfiguration.node import NodeConfig as JaxNodeConfig
from gigapaxos_tpu.reconfiguration.node import \
    ReconfigurableNode as JaxRNode
from gigapaxos_tpu.utils.config import Config as JConfig
from gigapaxos_tpu_torch.examples import chatapp as t_chat
from gigapaxos_tpu_torch.ops.types import unpack_ballot
from gigapaxos_tpu_torch.paxos import interfaces as t_if
from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.paxos.packets import group_key
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.reconfiguration import (ConsistentHashing,
                                                 ReconfigurableAppClient,
                                                 ReconfigurableNode)
from gigapaxos_tpu_torch.reconfiguration import consistenthash as t_ch
from gigapaxos_tpu_torch.reconfiguration import rcdb as t_rcdb
from gigapaxos_tpu_torch.reconfiguration import rcpackets as t_rcp
from gigapaxos_tpu_torch.reconfiguration.demand import (
    LoadBalancingDemandProfile, LocalityDemandProfile)
from gigapaxos_tpu_torch.reconfiguration.http import MAX_BODY, HttpFrontend
from gigapaxos_tpu_torch.reconfiguration.node import NodeConfig
from gigapaxos_tpu_torch.reconfiguration.rcdb import (READY, WAIT_ACK_START,
                                                      ReconfiguratorDB)
from gigapaxos_tpu_torch.testing.harness import free_ports
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from tests.conftest import tscale
from tests.test_metrics_format import _validate_exposition

CAP, W = 1 << 10, 16
SEED = 9


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's singletons; the
    port keeps its own, reset here."""
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _names(n, seed=SEED):
    rng = np.random.default_rng(seed)
    return [f"svc-{int(x):x}-{i}" for i, x in
            enumerate(rng.integers(0, 1 << 40, n))]


@pytest.mark.parametrize("nodes", [(100, 101, 102), (0, 1, 2, 3, 4),
                                   tuple(range(7, 70, 9))])
def test_consistent_hashing_parity(nodes):
    """10,000 names on the same owner and the same k successors."""
    jc, tc = j_ch.ConsistentHashing(nodes), t_ch.ConsistentHashing(nodes)
    k = min(3, len(nodes))
    for nm in _names(10_000):
        assert tc.server(nm) == jc.server(nm)
        assert tc.replicated_servers(nm, k) == jc.replicated_servers(nm, k)


def _packet_args(fn, rng):
    """Seeded arguments for one ``rcpackets`` function, by parameter name."""
    nm = f"n{int(rng.integers(1 << 30))}"
    ids = [int(x) for x in rng.integers(0, 50, 3)]
    items = {
        "create_batch": [[f"{nm}{j}", "aW5pdA=="] for j in range(3)],
        "start_epoch_batch": [[f"{nm}{j}", j, ids, ""] for j in range(3)],
        "ack_stop_batch": [[f"{nm}{j}", j, "ZmluYWw="] for j in range(3)],
    }.get(fn.__name__, [[f"{nm}{j}", j] for j in range(3)])
    by_param = {
        "name": nm, "rid": int(rng.integers(1 << 62)), "epoch": 2,
        "init_b64": "aW5pdA==", "final_b64": "ZmluYWw=",
        "new_actives": ids, "actives": ids, "ok": bool(rng.integers(2)),
        "err": "nonexistent", "reports": {nm: 7, nm + "x": 3},
        "items": items, "names": [f"{nm}{j}" for j in range(4)],
        "n_ok": 5, "n_total": 6,
    }
    return [by_param[p] for p in inspect.signature(fn).parameters]


def _packet_fns(mod):
    return {n: f for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__}


def test_rcpackets_parity():
    """Every packet function, with the same seeded arguments, gives equal
    dicts; the two modules define the same functions and type tags."""
    jb, tb = _packet_fns(j_rcp), _packet_fns(t_rcp)
    assert sorted(jb) == sorted(tb) and len(jb) == 20
    assert {k: v for k, v in vars(j_rcp).items() if k.isupper()} == \
        {k: v for k, v in vars(t_rcp).items() if k.isupper()}
    rng = np.random.default_rng(SEED)
    for name in sorted(jb):
        for _ in range(3):
            args = _packet_args(jb[name], rng)
            assert tb[name](*args) == jb[name](*args), name


# one scripted command sequence over two RC groups: single and batched
# ops, every FSM edge, and stale ones that must be no-ops
RCDB_SCRIPT = [
    ("_RC_100", {"op": "create", "name": "svc", "actives": [1, 2, 3]}),
    ("_RC_100", {"op": "create", "name": "svc", "actives": [4, 5]}),
    ("_RC_100", {"op": "ready", "name": "svc", "epoch": 1}),
    ("_RC_100", {"op": "ready", "name": "svc", "epoch": 0}),
    ("_RC_100", {"op": "move", "name": "svc", "new_actives": [2, 3, 4]}),
    ("_RC_100", {"op": "start_next", "name": "svc", "init": "c3RhdGU="}),
    ("_RC_100", {"op": "ready", "name": "svc", "epoch": 1}),
    ("_RC_101", {"op": "create_batch", "items": [
        ["b0", [0, 1, 2], ""], ["b1", [1, 2, 3], "aQ=="],
        ["b2", [2, 3, 4], ""]]}),
    ("_RC_101", {"op": "create_batch", "items": [["b1", [9], ""]]}),
    ("_RC_101", {"op": "ready_batch", "items": [["b0", 0], ["b1", 0],
                                                ["b2", 1]]}),
    ("_RC_101", {"op": "delete_batch", "names": ["b0", "b2", "nope"]}),
    ("_RC_101", {"op": "dropped_batch", "names": ["b0", "b1"]}),
    ("_RC_100", {"op": "delete", "name": "svc"}),
    ("_RC_100", {"op": "start_next", "name": "svc"}),
    ("_RC_100", {"op": "dropped", "name": "svc"}),
    ("_RC_100", {"op": "create", "name": "svc2", "actives": [1, 2],
                 "init": "eA=="}),
    ("_RC_100", {"op": "dropped", "name": "svc2"}),
]


def _run_db(mod):
    """``RCDB_SCRIPT`` through ``mod``'s ``ReconfiguratorDB``: its
    replies, the ``on_commit`` calls (records as dicts) and the DB."""
    db = mod.ReconfiguratorDB()
    calls = []

    def as_dicts(rec):
        if rec is None:
            return None
        if isinstance(rec, list):
            return [r.to_json() for r in rec]
        return rec.to_json()

    db.on_commit = lambda g, c, r: calls.append((g, c["op"], as_dicts(r)))
    replies = [db.execute(g, i, json.dumps(cmd).encode())
               for i, (g, cmd) in enumerate(RCDB_SCRIPT)]
    replies.append(db.execute("_RC_102", 99, b""))
    return db, replies, calls


def _records(db):
    return {g: {n: dataclasses.asdict(r) for n, r in recs.items()}
            for g, recs in db.groups.items()}


def test_rcdb_script_parity():
    jdb, jrep, jcalls = _run_db(j_rcdb)
    tdb, trep, tcalls = _run_db(t_rcdb)
    assert trep == jrep and tcalls == jcalls
    assert _records(tdb) == _records(jdb)
    rec = tdb.lookup("_RC_101", "b1")
    assert (rec.state, rec.epoch, rec.actives) == (READY, 0, [1, 2, 3])
    assert tdb.lookup("_RC_100", "svc2").state == WAIT_ACK_START
    for g in ("_RC_100", "_RC_101", "_RC_102"):
        assert tdb.checkpoint(g) == jdb.checkpoint(g)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rcdb_checkpoint_crosses_packages(direction):
    """A checkpoint written by one package restores in the other to the
    same records, and checkpoints again to the same bytes."""
    src, dst = (j_rcdb, t_rcdb) if direction == "jax_to_port" \
        else (t_rcdb, j_rcdb)
    db = src.ReconfiguratorDB()
    rng = np.random.default_rng(SEED)
    states = (src.READY, src.WAIT_ACK_START, src.WAIT_ACK_STOP)
    for i, nm in enumerate(_names(200)):
        ids = [int(x) for x in rng.choice(9, 3, replace=False)]
        db.groups.setdefault(f"_RC_{100 + i % 3}", {})[nm] = src.RCRecord(
            nm, int(rng.integers(5)), states[i % 3], ids, ids[::-1],
            ids[:i % 3], src.b64e(bytes(rng.integers(0, 256, i % 7)
                                        .astype(np.uint8))),
            bool(i % 2))
    other = dst.ReconfiguratorDB()
    for g in sorted(db.groups):
        blob = db.checkpoint(g)
        assert other.restore(g, blob)
        assert other.checkpoint(g) == blob
    assert _records(other) == _records(db)
    assert other.restore("_RC_100", b"") and other.groups["_RC_100"] == {}


def test_chatapp_parity():
    """The same requests, replies and checkpoints; a checkpoint restores
    across packages."""
    rng = np.random.default_rng(SEED)
    ja, ta = j_chat.ChatApp(), t_chat.ChatApp()
    reqs = []
    for i in range(300):
        room = f"room{int(rng.integers(4))}"
        k = int(rng.integers(6))
        body = [json.dumps({"op": "post", "who": f"u{i % 5}",
                            "msg": f"m{i}"}).encode(),
                json.dumps({"op": "read", "n": int(rng.integers(0, 9))}
                           ).encode(),
                b'{"op":"read","n":"x"}', b"not json", b"[1]",
                b'{"op":"nope"}'][k]
        reqs.append((room, body))
    for i, (room, body) in enumerate(reqs):
        assert ta.execute(room, i, body) == ja.execute(room, i, body)
    for room in ("room0", "room1", "room2", "room3", "empty"):
        assert ta.checkpoint(room) == ja.checkpoint(room)
    tb = t_chat.ChatApp()
    assert tb.restore("room1", ja.checkpoint("room1"))
    assert tb.checkpoint("room1") == ja.checkpoint("room1")
    assert tb.restore("room1", b"") and tb.checkpoint("room1") == \
        ja.checkpoint("empty")


def _scripted_run(pkg, tmp_path):
    """Create, requests, move and delete on 4 actives + 3 reconfigurators
    of ``pkg`` on the scalar backend: the replies, the records and every
    active's app state once the epochs have settled."""
    port = pkg == "port"
    cfg_cls, node_cls, cli_cls = (NodeConfig, ReconfigurableNode,
                                  ReconfigurableAppClient) if port else \
        (JaxNodeConfig, JaxRNode, JaxClient)
    conf, pc, app = (Config, PC, t_if.KVApp) if port else \
        (JConfig, JPC, j_if.KVApp)
    conf.set(pc.SYNC_WAL, False)
    conf.set(pc.PING_INTERVAL_S, 0.05)
    ports = free_ports(7)
    cfg = cfg_cls(actives={i: ("127.0.0.1", ports[i]) for i in range(4)},
                  reconfigurators={100 + i: ("127.0.0.1", ports[4 + i])
                                   for i in range(3)},
                  actives_per_name=3)
    nodes = [node_cls(i, cfg, app, str(tmp_path / pkg), backend="scalar",
                      capacity=CAP, window=W)
             for i in list(cfg.actives) + list(cfg.reconfigurators)]
    for nd in nodes:
        nd.start()
    actives = {nd.id: nd.active for nd in nodes if nd.active}
    rcs = [nd.reconfigurator for nd in nodes if nd.reconfigurator]
    out = []
    try:
        async def body():
            cli = cli_cls(1 << 16, cfg, timeout=tscale(15))
            try:
                out.append(await cli.create("alpha", b""))
                out.append(await cli.create_names(["beta", "gamma"]))
                old = sorted(await cli.get_actives("alpha"))
                out.append(old)
                for i in range(4):
                    out.append(await cli.send_request(
                        "alpha", f'{{"op":"put","k":"k{i}","v":"{i}"}}'
                        .encode()))
                    out.append(await cli.send_request(
                        "beta", f'{{"op":"put","k":"b","v":"{i}"}}'
                        .encode()))
                new = sorted(set(actives) - set(old)) + old[:2]
                out.append(await cli.move("alpha", new))
                out.append(sorted(await cli.get_actives("alpha")))
                for i in (0, 3):
                    out.append(await cli.send_request(
                        "alpha", f'{{"op":"get","k":"k{i}"}}'.encode()))
                out.append(await cli.delete("gamma"))
                out.append(await cli.delete_names(["beta"]))
                try:
                    await cli.get_actives("beta")
                    out.append("beta resolves")
                except KeyError:
                    out.append("beta gone")
                return set(new), set(old)
            finally:
                await cli.close()
        new, old = run(body())

        def hosted(name):
            return {i for i, a in actives.items()
                    if a.node.table.by_name(name) is not None}

        def settled():
            # a replica drops the table row before it clears the app
            return hosted("alpha") == new and not hosted("beta") and \
                not hosted("gamma") and all(
                    a.coordinator.app.checkpoint(nm) == b"{}"
                    for i, a in actives.items()
                    for nm in ("alpha", "beta", "gamma")
                    if i not in hosted(nm))

        deadline = time.time() + tscale(15)
        while time.time() < deadline and not settled():
            time.sleep(0.05)
        records = {}
        for rc in rcs:
            for g, recs in rc.db.groups.items():
                for nm, r in recs.items():
                    records.setdefault(nm, dataclasses.asdict(r))
        apps = {i: {nm: a.coordinator.app.checkpoint(nm)
                    for nm in ("alpha", "beta", "gamma")}
                for i, a in actives.items()}
        hosts = {nm: hosted(nm) for nm in ("alpha", "beta", "gamma")}
        return out, records, apps, hosts
    finally:
        for nd in nodes:
            nd.stop()


def test_scripted_cluster_run_parity(tmp_path):
    """The same replies, records and final app state from either
    package's control plane over the same script."""
    jout = _scripted_run("jax", tmp_path)
    tout = _scripted_run("port", tmp_path)
    assert tout[0] == jout[0]
    assert tout[1:] == jout[1:]
    out, records, apps, hosts = tout
    assert out[0] is True and out[1] == 2
    assert b'"0"' in out[-5] and b'"3"' in out[-4]
    assert out[-1] == "beta gone"
    assert set(records) == {"alpha"} and records["alpha"]["epoch"] == 1
    assert hosts["alpha"] == set(records["alpha"]["actives"])
    assert all(apps[i]["alpha"] == b'{"k0": "0", "k1": "1", "k2": "2", '
               b'"k3": "3"}' for i in hosts["alpha"])


# ---------------------------------------------------------------------------
# the port on its columnar engine on the CPU: tests/test_reconfiguration.py
# ---------------------------------------------------------------------------


def make_cluster(tmp_path, n_active=3, n_rc=3, **kw):
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.SYNC_WAL, False)
    Config.set(PC.PING_INTERVAL_S, 0.05)
    ports = free_ports(n_active + n_rc)
    cfg = NodeConfig(
        actives={i: ("127.0.0.1", ports[i]) for i in range(n_active)},
        reconfigurators={100 + i: ("127.0.0.1", ports[n_active + i])
                         for i in range(n_rc)},
        actives_per_name=min(3, n_active),
        rc_group_size=kw.pop("rc_group_size", None))
    nodes = [ReconfigurableNode(i, cfg, t_if.KVApp, str(tmp_path),
                                capacity=CAP, window=W, **kw)
             for i in list(cfg.actives) + list(cfg.reconfigurators)]
    for nd in nodes:
        nd.start()
    return nodes, cfg


def shutdown(nodes):
    for nd in nodes:
        nd.stop()


def _revive(node_id, cfg, tmp_path):
    nd = ReconfigurableNode(node_id, cfg, t_if.KVApp, str(tmp_path),
                            capacity=CAP, window=W)
    nd.start()
    return nd


def test_consistent_hashing_balance_and_stability():
    ch = ConsistentHashing([1, 2, 3, 4, 5])
    names = [f"name{i}" for i in range(2000)]
    owners = {n: ch.server(n) for n in names}
    counts = {}
    for o in owners.values():
        counts[o] = counts.get(o, 0) + 1
    assert set(counts) == {1, 2, 3, 4, 5}
    assert min(counts.values()) > 100
    for n in names[:50]:
        ks = ch.replicated_servers(n, 3)
        assert len(ks) == len(set(ks)) == 3
    ch2 = ConsistentHashing([1, 2, 3, 4])
    moved = sum(1 for n in names
                if owners[n] != 5 and ch2.server(n) != owners[n])
    assert moved < len(names) * 0.05


def test_rcdb_fsm():
    db = ReconfiguratorDB()
    ops = []
    db.on_commit = lambda g, c, r: ops.append((c["op"], r))
    g = "_RC_1"

    def do(cmd):
        return db.execute(g, 0, json.dumps(cmd).encode())

    do({"op": "create", "name": "svc", "actives": [1, 2, 3]})
    rec = db.lookup(g, "svc")
    assert rec.state == WAIT_ACK_START and rec.epoch == 0
    do({"op": "create", "name": "svc", "actives": [4, 5]})
    assert ops[-1][1] is None
    do({"op": "ready", "name": "svc", "epoch": 0})
    assert db.lookup(g, "svc").state == READY
    do({"op": "move", "name": "svc", "new_actives": [2, 3, 4]})
    do({"op": "start_next", "name": "svc", "init": ""})
    rec = db.lookup(g, "svc")
    assert rec.epoch == 1 and rec.state == WAIT_ACK_START
    assert rec.prev_actives == [1, 2, 3]
    do({"op": "ready", "name": "svc", "epoch": 1})
    assert db.lookup(g, "svc").actives == [2, 3, 4]
    do({"op": "delete", "name": "svc"})
    do({"op": "dropped", "name": "svc"})
    assert db.lookup(g, "svc") is None
    do({"op": "create", "name": "svc2", "actives": [1, 2]})
    db2 = ReconfiguratorDB()
    db2.restore(g, db.checkpoint(g))
    assert db2.lookup(g, "svc2").actives == [1, 2]


def test_demand_profiles_unit():
    """LocalityDemandProfile (the reference's unit case) and the
    load-balancing profile's decay and move bookkeeping, each against
    the JAX package's profile fed the same reports."""
    from gigapaxos_tpu.reconfiguration import demand as j_demand

    p = LocalityDemandProfile(threshold=10)
    for _ in range(4):
        p.register("svc", 3, 2)
    p.register("svc", 1, 1)
    assert p.should_reconfigure("svc", [0, 1, 2], [0, 1, 2, 3]) is None
    p.register("svc", 3, 2)
    new = p.should_reconfigure("svc", [0, 1, 2], [0, 1, 2, 3])
    assert new is not None and 3 in new and len(new) == 3
    p.clear("svc")
    assert p.should_reconfigure("svc", [0, 1, 2], [0, 1, 2, 3]) is None
    for _ in range(11):
        p.register("svc2", 0, 1)
    assert p.should_reconfigure("svc2", [0, 1], [0, 1, 2]) is None
    rng = np.random.default_rng(SEED)
    for jcls, tcls in ((j_demand.LocalityDemandProfile,
                        LocalityDemandProfile),
                       (j_demand.LoadBalancingDemandProfile,
                        LoadBalancingDemandProfile)):
        jp, tp = jcls(threshold=25), tcls(threshold=25)
        for _ in range(400):
            nm = f"s{int(rng.integers(3))}"
            a, c = int(rng.integers(5)), int(rng.integers(1, 6))
            jp.register(nm, a, c)
            tp.register(nm, a, c)
            cur = sorted(int(x) for x in rng.choice(5, 3, replace=False))
            got = tp.should_reconfigure(nm, list(cur), list(range(5)))
            assert got == jp.should_reconfigure(nm, list(cur),
                                                list(range(5)))
            if got:
                jp.on_moved(nm)
                tp.on_moved(nm)


def test_create_request_delete(tmp_path):
    nodes, cfg = make_cluster(tmp_path)
    try:
        assert all(nd.active.node.backend.device.type == "cpu"
                   for nd in nodes if nd.active)

        async def body():
            cli = ReconfigurableAppClient(1 << 16, cfg, timeout=tscale(10))
            try:
                assert await cli.create("svcA", b"")
                assert len(await cli.get_actives("svcA")) == 3
                r = await cli.send_request(
                    "svcA", b'{"op":"put","k":"x","v":"1"}')
                assert b"ok" in r
                r = await cli.send_request("svcA", b'{"op":"get","k":"x"}')
                assert b'"1"' in r
                assert await cli.create("svcA", b"")
                assert await cli.delete("svcA")
                with pytest.raises(KeyError):
                    await cli.get_actives("svcA")
                assert not await cli.delete("svcA")
                assert await cli.create("svcA", b"")
                r = await cli.send_request("svcA", b'{"op":"get","k":"x"}')
                assert b"null" in r
                # test_many_creates: 20 concurrent single creates
                names = [f"svc{i}" for i in range(20)]
                assert all(await asyncio.gather(
                    *[cli.create(n, b"") for n in names]))
                outs = await asyncio.gather(*[
                    cli.send_request(n, b'{"op":"put","k":"k","v":"v"}')
                    for n in names])
                assert all(b"ok" in o for o in outs)
            finally:
                await cli.close()
        run(body())
    finally:
        shutdown(nodes)


def test_move_preserves_state(tmp_path):
    nodes, cfg = make_cluster(tmp_path, n_active=4)
    try:
        async def body():
            cli = ReconfigurableAppClient(1 << 16, cfg, timeout=tscale(15))
            try:
                assert await cli.create("mv", b"")
                old = sorted(await cli.get_actives("mv"))
                for i in range(5):
                    await cli.send_request(
                        "mv", f'{{"op":"put","k":"k{i}","v":"{i}"}}'
                        .encode())
                new = sorted(set(range(4)) - set(old)) + old[:2]
                assert await cli.move("mv", new)
                assert sorted(await cli.get_actives("mv")) == sorted(new)
                for i in range(5):
                    r = await cli.send_request(
                        "mv", f'{{"op":"get","k":"k{i}"}}'.encode())
                    assert f'"{i}"'.encode() in r, r
                r = await cli.send_request(
                    "mv", b'{"op":"put","k":"post","v":"yes"}')
                assert b"ok" in r
                dropped = set(old) - set(new)
                deadline = time.time() + tscale(10)
                while time.time() < deadline and not all(
                        nodes[d].active.node.table.by_name("mv") is None
                        for d in dropped):
                    await asyncio.sleep(0.1)
                for d in dropped:
                    assert nodes[d].active.node.table.by_name("mv") is None
            finally:
                await cli.close()
        run(body())
    finally:
        shutdown(nodes)


def test_concurrent_create_then_immediate_delete(tmp_path):
    """A DELETE landing while the CREATE's epoch is still WAIT_ACK_START
    is pended and re-driven at READY, not dropped."""
    nodes, cfg = make_cluster(tmp_path)
    try:
        async def body():
            cli = ReconfigurableAppClient(1 << 16, cfg, timeout=tscale(15))
            try:
                created, deleted = await asyncio.gather(
                    asyncio.create_task(cli.create("svcX", b"")),
                    asyncio.create_task(cli.delete("svcX")),
                    return_exceptions=True)
                assert created is True, created
                assert isinstance(deleted, bool), deleted
                if deleted:
                    with pytest.raises(KeyError):
                        await cli.get_actives("svcX")
                    assert await cli.create("svcX", b"")
            finally:
                await cli.close()
        run(body())
    finally:
        shutdown(nodes)


def test_demand_driven_move(tmp_path):
    """With a LoadBalancingDemandProfile, demand reports move a hot name
    (an epoch bump) and it keeps serving its state."""
    nodes, cfg = make_cluster(
        tmp_path, n_active=4, n_rc=1, rc_group_size=1,
        demand_policy=LoadBalancingDemandProfile(threshold=10),
        demand_report_every=5)
    try:
        async def body():
            cli = ReconfigurableAppClient(1 << 16, cfg, timeout=tscale(15))
            try:
                assert await cli.create("hotname", b"")
                rcn = nodes[-1].reconfigurator
                ep0 = rcn.db.lookup(rcn.group_of("hotname"),
                                    "hotname").epoch
                for k in range(20):
                    await cli.send_request(
                        "hotname",
                        f'{{"op":"put","k":"x","v":"{k}"}}'.encode())
                deadline = time.time() + tscale(20)
                moved = False
                while time.time() < deadline:
                    rec = rcn.db.lookup(rcn.group_of("hotname"),
                                        "hotname")
                    if rec is not None and rec.epoch > ep0 and \
                            rec.state == READY:
                        moved = True
                        break
                    await asyncio.sleep(0.1)
                assert moved, f"epoch never advanced past {ep0}"
                cli._actives_cache.pop("hotname", None)
                r = await cli.send_request("hotname",
                                           b'{"op":"get","k":"x"}')
                assert b'"19"' in r
            finally:
                await cli.close()
        run(body())
    finally:
        shutdown(nodes)


def test_batched_create_delete_via_control_plane(tmp_path):
    """Batched create_names/delete_names through the epoch FSM: every
    name READY and serving, idempotent, gone after the deletes (a paxos
    stop decision, then a batched drop on every active) and recreatable;
    the RC records' commits and the stops went through the columnar
    engine."""
    nodes, cfg = make_cluster(tmp_path)
    try:
        actives = [nd.active for nd in nodes if nd.active]

        async def body():
            cli = ReconfigurableAppClient((1 << 16) + 5, cfg,
                                          timeout=tscale(30))
            try:
                names = [f"batch{i}" for i in range(60)]
                assert await cli.create_names(names) == 60
                for nm in names[::20]:
                    assert await cli.send_request(
                        nm, b'{"op":"put","k":"k","v":"v"}') == b'{"ok":true}'
                assert await cli.create_names(names) == 60
                assert await cli.delete_names(names) == 60
                with pytest.raises(KeyError):
                    await cli.get_actives(names[0])
                deadline = time.time() + tscale(10)
                while time.time() < deadline and any(
                        a.node.table.by_name(nm) is not None
                        for a in actives for nm in names):
                    await asyncio.sleep(0.05)
                assert not any(a.node.table.by_name(nm) is not None
                               for a in actives for nm in names)
                assert all(a.coordinator.stopped_state(nm) is None
                           for a in actives for nm in names)
                assert await cli.create_names(names[:10]) == 10
                assert await cli.send_request(
                    names[0], b'{"op":"get","k":"k"}') == \
                    b'{"ok": true, "v": null}'
            finally:
                await cli.close()
        run(body())
        totals = DelayProfiler.totals()
        assert totals["w.rc.create_batch"][1] >= 1
        assert totals["w.ar.start_epoch_b"][1] >= 1
        assert totals["w.ar.stop_epoch_b"][1] >= 1
    finally:
        shutdown(nodes)


def test_delete_of_paused_groups(tmp_path):
    """Groups the deactivator paused on every active are still stopped
    and dropped by a delete, and the reconfigurators never pause their
    record groups (ROADMAP §3: the reference acknowledges such a delete
    and leaves every paused group in place)."""
    Config.set(PC.PAUSE_IDLE_S, 0.5)
    nodes, cfg = make_cluster(tmp_path)
    try:
        actives = [nd.active for nd in nodes if nd.active]
        rcs = [nd.reconfigurator for nd in nodes if nd.reconfigurator]
        names = [f"idle{i}" for i in range(40)]
        keys = {group_key(nm) for nm in names}

        def hosted():
            return [sum(a.node.table.by_key(k) is not None
                        or k in a.node._paused for k in keys)
                    for a in actives]

        async def body():
            cli = ReconfigurableAppClient((1 << 16) + 9, cfg,
                                          timeout=tscale(15))
            try:
                assert await cli.create_names(names) == 40
                deadline = time.time() + tscale(10)
                while time.time() < deadline and not all(
                        keys <= a.node._paused for a in actives):
                    await asyncio.sleep(0.05)
                assert all(keys <= a.node._paused for a in actives)
                assert await cli.delete_names(names) == 40
                deadline = time.time() + tscale(10)
                while time.time() < deadline and any(hosted()):
                    await asyncio.sleep(0.05)
                assert hosted() == [0, 0, 0]
                with pytest.raises(KeyError):
                    await cli.get_actives(names[0])
            finally:
                await cli.close()
        run(body())
        assert all(rc.node.pause_idle_s == 0 and not rc.node._paused
                   for rc in rcs)
    finally:
        shutdown(nodes)


def test_reconfigurator_crash_restart_recovers_records(tmp_path):
    """A reconfigurator's crash and restart: its records recover from its
    own RC groups' WAL, and the control plane serves throughout."""
    Config.set(PC.PAUSE_IDLE_S, 0)
    nodes, cfg = make_cluster(tmp_path)
    dead = []
    try:
        async def phase1():
            cli = ReconfigurableAppClient(1 << 16, cfg, timeout=tscale(15))
            try:
                names = [f"rcrec{i}" for i in range(20)]
                assert await cli.create_names(names) == 20
                return names
            finally:
                await cli.close()
        names = run(phase1())
        victim_id = sorted(cfg.reconfigurators)[0]
        victim = next(nd for nd in nodes if nd.id == victim_id)
        victim.stop()
        dead.append(victim)

        async def phase2():
            cli = ReconfigurableAppClient((1 << 16) + 1, cfg,
                                          timeout=tscale(20), retries=5)
            try:
                assert len(await cli.get_actives(names[0])) == 3
                assert await cli.create_names(["post-crash-1"]) == 1
            finally:
                await cli.close()
        run(phase2())
        revived = _revive(victim_id, cfg, tmp_path)
        nodes.append(revived)
        rcr = revived.reconfigurator
        want = set(names) | {"post-crash-1"}
        mine = {n for n in want
                if victim_id in rcr.group_members(rcr.group_of(n))}
        deadline = time.time() + tscale(20)
        got = set()
        while time.time() < deadline:
            got = {n for recs in rcr.db.groups.values() for n in recs}
            if mine <= got:
                break
            time.sleep(0.1)
        assert mine <= got, f"missing after restart: {mine - got}"

        # the revived reconfigurator, the client's first pick, leaves the
        # first create after its restart unanswered in either package (a
        # 20 s client timeout before the retry to the next one succeeds;
        # ROADMAP §3): a shorter timeout reaches the retry sooner
        async def phase3():
            cli = ReconfigurableAppClient((1 << 16) + 2, cfg,
                                          timeout=tscale(2), retries=5)
            try:
                deadline2 = time.time() + tscale(15)
                while True:
                    try:
                        assert len(await cli.get_actives(names[3])) == 3
                        assert len(await cli.get_actives(names[0])) == 3
                        break
                    except KeyError:
                        if time.time() > deadline2:
                            raise
                        await asyncio.sleep(0.1)
                assert await cli.create_names(["post-restart-1"]) == 1
                r = await cli.send_request(
                    names[0], b'{"op":"put","k":"a","v":"b"}')
                assert b"ok" in r
            finally:
                await cli.close()
        run(phase3())
    finally:
        shutdown([nd for nd in nodes if nd not in dead])


def test_active_crash_during_creates_epochs_complete(tmp_path):
    """An active down during batched creates: epochs reach READY on a
    majority of AckStarts, and the revived active serves again."""
    Config.set(PC.PAUSE_IDLE_S, 0)
    nodes, cfg = make_cluster(tmp_path)
    dead = []
    try:
        victim_id = sorted(cfg.actives)[0]
        victim = next(nd for nd in nodes if nd.id == victim_id)
        victim.stop()
        dead.append(victim)

        async def create_phase():
            cli = ReconfigurableAppClient(1 << 16, cfg,
                                          timeout=tscale(20), retries=5)
            try:
                names = [f"acr{i}" for i in range(12)]
                assert await cli.create_names(names) == 12
                r = await cli.send_request(
                    names[0], b'{"op":"put","k":"k","v":"1"}')
                assert b"ok" in r
                return names
            finally:
                await cli.close()
        names = run(create_phase())
        nodes.append(_revive(victim_id, cfg, tmp_path))

        async def after_phase():
            cli = ReconfigurableAppClient((1 << 16) + 3, cfg,
                                          timeout=tscale(20), retries=5)
            try:
                for nm in names[:4]:
                    r = await cli.send_request(
                        nm, b'{"op":"put","k":"k2","v":"2"}')
                    assert b"ok" in r
                assert await cli.create_names(["acr-post"]) == 1
            finally:
                await cli.close()
        deadline = time.time() + tscale(75)
        while True:
            try:
                run(after_phase())
                break
            except (TimeoutError, AssertionError):
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
    finally:
        shutdown([nd for nd in nodes if nd not in dead])


def test_delete_with_boot_coordinator_down(tmp_path):
    """Deletes complete with a group's boot coordinator dead: the
    survivors' deferred stop injection and the engine's re-election carry
    the stop round."""
    Config.set(PC.FAILURE_TIMEOUT_S, 1.0)
    nodes, cfg = make_cluster(tmp_path)
    dead = []
    try:
        names = [f"dcd{i}" for i in range(8)]

        async def create_phase():
            cli = ReconfigurableAppClient((1 << 17) + 1, cfg,
                                          timeout=tscale(20), retries=5)
            try:
                assert await cli.create_names(names) == 8
            finally:
                await cli.close()
        run(create_phase())
        victim_id = sorted(cfg.actives)[0]
        victim = next(nd for nd in nodes if nd.id == victim_id)
        victim.stop()
        dead.append(victim)
        time.sleep(tscale(1.5))

        async def delete_phase():
            cli = ReconfigurableAppClient((1 << 17) + 2, cfg,
                                          timeout=tscale(40), retries=8)
            try:
                assert await cli.delete_names(names) == 8
                with pytest.raises(KeyError):
                    await cli.get_actives(names[0])
            finally:
                await cli.close()
        run(delete_phase())
    finally:
        shutdown([nd for nd in nodes if nd not in dead])


def test_latency_aware_redirector(tmp_path):
    """Echo probes measure every active, the failover order is
    nearest-first with unmeasured nodes last, and app traffic updates
    the estimates passively."""
    nodes, cfg = make_cluster(tmp_path)
    try:
        async def body():
            cli = ReconfigurableAppClient((1 << 18) + 1, cfg,
                                          timeout=tscale(20), retries=5)
            try:
                rtts = await cli.probe_latencies()
                assert set(rtts) == set(cfg.actives)
                assert all(0 < v < tscale(20) for v in rtts.values())
                cli._rtt = {0: 0.005, 1: 0.001}
                assert cli._by_latency([0, 1, 2]) == [1, 0, 2]
                cli._rtt.clear()
                assert await cli.create_names(["lat0"]) == 1
                await cli.send_request("lat0",
                                       b'{"op":"put","k":"a","v":"1"}')
                assert cli._rtt
            finally:
                await cli.close()
        run(body())
    finally:
        shutdown(nodes)


# ---------------------------------------------------------------------------
# the HTTP front end and the gateway (tests/test_http.py, test_groups_api.py)
# ---------------------------------------------------------------------------


def _req(url, data=None):
    r = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(r, timeout=20) as resp:
        return resp.status, resp.read()


def test_http_lifecycle_and_gateway(tmp_path):
    """The HTTP front end's name and request routes over the port's
    cluster, then the gateway's ``/cluster/*`` fan-out over every node's
    stats listener (a dead peer reads as down), merged exactly."""
    Config.set(PC.STATS_PORT, 0)
    Config.set(PC.TRACE_SAMPLE, 1.0)
    nodes, cfg = make_cluster(tmp_path)
    try:
        peers = {nd.id: ("127.0.0.1", (nd.active or nd.reconfigurator)
                         .node.stats_http.port) for nd in nodes}
        peers[9] = ("127.0.0.1", 1)

        async def body():
            fe = HttpFrontend(cfg, ("127.0.0.1", 0), timeout=tscale(15),
                              stats_peers=peers)
            await fe.start()
            base = f"http://127.0.0.1:{fe.port}"
            loop = asyncio.get_running_loop()

            def call(*a):
                return loop.run_in_executor(None, lambda: _req(*a))

            try:
                assert await call(f"{base}/healthz") == (200, b"ok\n")
                st, out = await call(f"{base}/metrics")
                assert st == 200 and b"# TYPE " in out
                st, out = await call(f"{base}/stats")
                assert st == 200 and "profiler" in json.loads(out)
                st, out = await call(f"{base}/create",
                                     json.dumps({"name": "web1"}).encode())
                assert st == 200 and json.loads(out)["ok"]
                st, out = await call(f"{base}/actives/web1")
                assert st == 200 and len(json.loads(out)["actives"]) == 3
                st, out = await call(f"{base}/request/web1",
                                     b'{"op":"put","k":"a","v":"b"}')
                assert st == 200 and b"ok" in out
                st, out = await call(f"{base}/request/web1",
                                     b'{"op":"get","k":"a"}')
                assert st == 200 and b'"b"' in out

                # the gateway: one scrape point for the deployment
                st, out = await call(f"{base}/cluster/stats")
                merged = json.loads(out)
                assert merged["cluster"]["nodes"]["9"] == 0
                assert all(merged["cluster"]["nodes"][str(i)] == 1
                           for i in list(cfg.actives)
                           + list(cfg.reconfigurators))
                per_node = [(nd.active or nd.reconfigurator).node
                            for nd in nodes]
                assert merged["counters"]["decided"] >= 2 * 3
                hist = merged["profiler"]["histograms"]["node.batch"]
                assert hist["count"] >= len(per_node)
                st, out = await call(f"{base}/cluster/metrics")
                series = _validate_exposition(out.decode())
                assert series['gp_node_up{node="9"}'] == 0
                assert series['gp_node_up{node="0"}'] == 1
                st, out = await call(f"{base}/cluster/engine")
                eng = json.loads(out)["cluster"]["nodes"]
                assert eng["9"] == 0 and sum(eng.values()) == len(nodes)

                st, out = await call(f"{base}/delete",
                                     json.dumps({"name": "web1"}).encode())
                assert st == 200 and json.loads(out)["ok"]
                with pytest.raises(urllib.error.HTTPError) as e:
                    await call(f"{base}/actives/web1")
                assert e.value.code == 404
                with pytest.raises(urllib.error.HTTPError) as e:
                    await call(f"{base}/create", b"[]")
                assert e.value.code == 400
                with pytest.raises(urllib.error.HTTPError) as e:
                    await call(f"{base}/create", b"x" * (MAX_BODY + 1))
                assert e.value.code == 413
            finally:
                await fe.stop()
        run(body())
    finally:
        shutdown(nodes)


def test_ballot_churn_counter_on_leader_change(tmp_path):
    """Killing a group's coordinator forces an election on the port's
    columnar nodes: the survivors' ballot-churn counters rise and
    ``group_info`` names the new leader."""
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.PING_INTERVAL_S, 0.15)
    Config.set(PC.FAILURE_TIMEOUT_S, 1.0)
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=0,
                         app_cls=t_if.NoopApp, capacity=64, window=4,
                         sync_wal=False)
    nodes = [emu.nodes[i] for i in range(3)]
    cli = None
    try:
        name = "churn-g"
        for nd in nodes:
            assert nd.create_group(name, (0, 1, 2))
        dead = group_key(name) % 3
        live = [nd for i, nd in enumerate(nodes) if i != dead]
        assert all(nd.n_ballot_changes == 0 for nd in nodes)
        cli = PaxosClient([emu.addr_map[i] for i in range(3) if i != dead],
                          timeout=tscale(4))
        assert cli.send_request(name, b"pre").status == 0
        time.sleep(0.5)
        emu.kill(dead)
        ok = 0
        for k in range(10):
            try:
                ok += int(cli.send_request(
                    name, f"post-{k}".encode()).status == 0)
            except TimeoutError:
                pass
        assert ok >= 8, f"only {ok}/10 survived failover"
        deadline = time.time() + tscale(10)
        while time.time() < deadline:
            row = live[0].table.by_name(name).row
            _num, coord = unpack_ballot(int(live[0]._bal[row]))
            if coord != dead and sum(nd.n_ballot_changes
                                     for nd in live) > 0:
                break
            time.sleep(0.05)
        assert coord != dead
        assert sum(nd.n_ballot_changes for nd in live) > 0
        info = live[0].group_info(name)
        assert info["leader"] == coord != dead
        assert sum(nd.group_info(name)["ballot_changes"]
                   for nd in live) > 0
        m = live[0].metrics()
        assert m["counters"]["ballot_changes"] == live[0].n_ballot_changes
        assert m["groups_health"]["ballot_changes_max"] >= 0
    finally:
        if cli is not None:
            cli.close()
        emu.stop()


def test_b64_helpers_parity():
    """The epoch-state codec both packages put on the wire."""
    rng = np.random.default_rng(SEED)
    for n in (0, 1, 7, 300):
        raw = bytes(rng.integers(0, 256, n).astype(np.uint8))
        assert t_rcdb.b64e(raw) == j_rcdb.b64e(raw) == \
            base64.b64encode(raw).decode()
        assert t_rcdb.b64d(t_rcdb.b64e(raw)) == raw
