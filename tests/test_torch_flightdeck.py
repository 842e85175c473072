"""The port's flight deck and metrics (``utils/prom.py``,
``net/statshttp.py``, ``net/cluster.py``, ``utils/statsdump.py`` and the
node's stats listener, ``PC.STATS_PORT``) against the JAX package's, on
the CPU.

The port's counterparts of ``tests/test_engine_flightdeck.py``
(``test_engine_endpoints_schema``, ``test_cluster_engine_fanout``, here
over columnar nodes), ``tests/test_metrics_format.py`` and the route
cases of ``tests/test_groups_api.py``, over a port node with
``STATS_PORT=0``:

- ``GET /engine`` carries the reference's keys with exact slab math, at
  one engine lane and at four;
- ``GET /engine/kernels`` has the six cost rows, ``bytes_accessed`` as
  the shape formula gives it, worked by hand here;
- ``GET /metrics`` is a valid Prometheus exposition whose family names
  are a JAX node's under the same load;
- ``GET /groups`` and ``/groups/<name>`` answer as the JAX node's do;
- the ``/engine`` scrapes of three nodes merge into one cluster view;
- the ``StatsDumper`` writes its JSON lines.

The reference's retrace tests (``test_forced_retrace_fires_ledger_and_
trigger``, ``test_retrace_trigger_knob_off``) have no counterpart: torch
does not trace, so the port's ledger counts library builds and loads and
its retrace count stays 0."""

import asyncio
import json
import time
import urllib.error

import pytest

from gigapaxos_tpu.paxos import interfaces as ji
from gigapaxos_tpu.paxos.client import PaxosClient as JaxClient
from gigapaxos_tpu.paxos.manager import PaxosNode as JaxNode
from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
from gigapaxos_tpu.testing.harness import free_ports
from gigapaxos_tpu.utils.config import Config as JConfig
from gigapaxos_tpu_torch.net.cluster import (merge_cluster_engine,
                                             merge_cluster_stats,
                                             scrape_cluster)
from gigapaxos_tpu_torch.paxos import interfaces as ti
from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.paxos.manager import PaxosNode
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from gigapaxos_tpu_torch.utils.statsdump import StatsDumper
from tests.conftest import tscale
from tests.test_metrics_format import _get, _validate_exposition

ENGINE_KEYS = {"node", "platform", "engine_shards", "engine_mesh",
               "ledger", "cache", "memory", "balance", "waves"}
LEDGER_KEYS = {"kernels", "compiles", "retraces", "compile_s",
               "cache_hits", "cache_misses", "monitoring", "warmed"}
PLANE_KEYS = {"control", "ballots", "acc", "dec", "cursors", "votes",
              "prop"}
COSTS = {"propose_p", "accept_p", "accept_reply_p", "commit_p",
         "accept_commit_p", "request_reply_p"}
CAP, W, GROUPS, REQUESTS = 64, 4, 8, 24


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's singletons; the
    port keeps its own, reset here."""
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()


def _served_node(pkg, tmp_path, shards):
    """A one-member node of ``pkg`` with its stats listener on an
    ephemeral port, ``shards`` engine lanes, ``GROUPS`` groups and
    ``REQUESTS`` requests answered round-robin, one at a time."""
    port = pkg == "port"
    cfg, pc = (Config, PC) if port else (JConfig, JPC)
    cfg.set(pc.STATS_PORT, 0)
    cfg.set(pc.ENGINE_SHARDS, shards)
    cfg.set(pc.SYNC_WAL, False)
    cfg.set(pc.FUSE_WAVES, "on")
    if port:
        cfg.set(pc.COLUMNAR_DEVICE, "cpu")
    else:
        cfg.set(pc.ENGINE_MESH, "off")  # one device, as the port runs
    addr = {0: ("127.0.0.1", free_ports(1)[0])}
    node = (PaxosNode if port else JaxNode)(
        0, addr, (ti if port else ji).NoopApp(), str(tmp_path / pkg),
        backend="columnar", capacity=CAP, window=W)
    node.start()
    cli = (PaxosClient if port else JaxClient)([addr[0]],
                                               timeout=tscale(10))
    try:
        names = [f"fd{i}" for i in range(GROUPS)]
        assert node.create_groups([(n, (0,)) for n in names]) == GROUPS
        for k in range(REQUESTS):
            assert cli.send_request(names[k % GROUPS],
                                    f"x{k}".encode()).status == 0
    finally:
        cli.close()
    return node


@pytest.fixture(params=[1, 4], ids=["S1", "S4"])
def served(request, tmp_path):
    """The port's node and the JAX package's, under the same load."""
    nodes = []
    try:
        for pkg in ("port", "jax"):
            nodes.append(_served_node(pkg, tmp_path, request.param))
        yield request.param, nodes[0], nodes[1]
    finally:
        for nd in nodes:
            nd.stop()
        JConfig.clear()


def _json(port, path):
    st, body = _get(port, path)
    assert st == 200, path
    return json.loads(body)


def test_engine_endpoint_schema_and_slab_math(served):
    shards, node, _ = served
    d = _json(node.stats_http.port, "/engine")
    assert ENGINE_KEYS <= set(d), set(d)
    assert d["engine_shards"] == shards and d["platform"] == "cpu"
    led = d["ledger"]
    assert LEDGER_KEYS <= set(led), set(led)
    assert led["retraces"] == 0 and led["warmed"] is True
    assert isinstance(d["cache"], dict) and d["cache"]["active"] is True
    mem = d["memory"]
    assert set(mem["planes"]) == PLANE_KEYS
    # exact: the planes sum to the total, and a row holds the acc and
    # prop windows (16 B a slot each), the dec window (12 B a slot), and
    # 35 B of ballots (8), cursors (12), votes (4) and control (11)
    assert sum(mem["planes"].values()) == mem["total_bytes"]
    assert mem["bytes_per_group"] == 35 + 44 * W
    assert mem["total_bytes"] == CAP * (35 + 44 * W)
    assert mem["planes"]["acc"] == mem["planes"]["prop"] == CAP * W * 16
    assert mem["planes"]["dec"] == CAP * W * 12
    assert (mem["capacity"], mem["window"]) == (CAP, W)
    bal = d["balance"]
    assert bal["rows_active"] == GROUPS
    waves = d["waves"]
    assert {"submit_s", "collect_s", "overlap_s", "per_shard"} <= set(waves)
    assert waves["submit_s"] > 0
    if shards > 1:
        assert [p["capacity"] for p in mem["per_shard"]] == \
            [CAP // shards] * shards
        assert sum(p["total_bytes"] for p in mem["per_shard"]) == \
            mem["total_bytes"]
        assert len(bal["shards"]) == shards
        assert sum(bal["shards"]) == GROUPS
        # every lane served some of the groups, so each has its totals
        lanes = {node.table.shard_of(m.gkey)
                 for m in node.table.snapshot_metas()}
        assert set(waves["per_shard"]) == {str(k) for k in lanes}
        for row in waves["per_shard"].values():
            assert row["submit_s"] > 0
    else:
        assert bal["mesh"] == [GROUPS] and waves["per_shard"] == {}


def test_engine_kernels_costs_by_hand(served):
    """Six cost rows, ``flops`` null, ``bytes_accessed`` at bucket 8:
    4 B for each packed input and output row of each lane, plus each
    body's row traffic (``backend._row_bytes``)."""
    _, node, _ = served
    ks = _json(node.stats_http.port, "/engine/kernels")
    assert ks["node"] == 0
    assert any(k.startswith("native:") for k in ks["kernels"]), ks
    for row in ks["kernels"].values():
        assert {"compiles", "retraces", "compile_s", "loads"} <= set(row)
    assert set(ks["costs"]) == COSTS
    for row in ks["costs"].values():
        assert set(row) == {"flops", "bytes_accessed"}
        assert row["flops"] is None
    b = 8
    accept = 1 + 4 + 4 + 4 + 16       # active, bal, cursor; bal, acc
    commit = 1 + 4 + 4 * W + 12 + 4   # active, cursor, dec slots; dec, cursor
    propose = 1 + 1 + 1 + 4 + 4 + 4 + 4 + 16
    reply = 1 + 1 + 4 + 4 + 16 + 4 + 1 + 1
    want = {
        "accept_p": 4 * b * (6 + 4) + b * accept,
        "commit_p": 4 * b * (5 + 4) + b * commit,
        "propose_p": 4 * b * (4 + 5) + b * propose,
        "accept_reply_p": 4 * b * (6 + 6) + b * reply,
        "accept_commit_p": 4 * b * (6 + 5 + 4 + 4) + b * (accept + commit),
        "request_reply_p": 4 * b * (5 + 6 + 9 + 9)
        + b * (propose + accept + 2 * reply + commit),
    }
    assert {k: v["bytes_accessed"] for k, v in ks["costs"].items()} == want
    assert want["accept_p"] == 552 and want["commit_p"] == 584


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_exposition_matches_the_reference_families(served):
    """Valid exposition (no duplicate series, every sample typed), scraped
    twice; its family names are the JAX node's under the same load, but
    for the device allocator's two families, which the port reports on
    the card only and JAX's CPU runtime reports on the CPU."""
    shards, node, ref = served
    st, body = _get(node.stats_http.port, "/metrics")
    assert st == 200
    series = _validate_exposition(body.decode())
    _validate_exposition(_get(node.stats_http.port, "/metrics")[1].decode())
    ref_text = _get(ref.stats_http.port, "/metrics")[1].decode()
    _validate_exposition(ref_text)
    device_only = {"gp_engine_device_bytes",
                   "gp_engine_max_groups_estimate"}
    assert _families(body.decode()) == _families(ref_text) - device_only
    assert series["gp_executed_total"] == REQUESTS
    assert series["gp_engine_shards"] == shards
    assert series["gp_engine_rows_active"] == GROUPS
    for phase in ("sub", "blk", "ovl"):
        assert f'gp_engine_seconds_total{{phase="{phase}"}}' in series
    mem = _json(node.stats_http.port, "/engine")["memory"]
    assert series["gp_engine_slab_bytes_total"] == mem["total_bytes"]
    assert series['gp_engine_slab_bytes{plane="acc"}'] == \
        mem["planes"]["acc"]
    assert series["gp_engine_capacity_rows"] == CAP
    if shards > 1:
        for k in range(shards):
            assert f'gp_wal_segment_bytes{{segment="{k}"}}' in series
    # chip_smoke.py's own validator (it imports nothing from tests/)
    # reads the same series, and refuses a duplicate one
    import chip_smoke
    assert chip_smoke.exposition_series(body.decode()) == series
    dup = body.decode() + body.decode().splitlines()[-1] + "\n"
    with pytest.raises(AssertionError, match="duplicate series"):
        chip_smoke.exposition_series(dup)
    st, body = _get(node.stats_http.port, "/healthz")
    assert (st, body) == (200, b"ok\n")
    m = _json(node.stats_http.port, "/stats")
    assert {"counters", "engine", "net", "profiler", "spans",
            "groups_health", "wal"} <= set(m)
    assert _json(node.stats_http.port, "/blackbox") == {"enabled": False}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(node.stats_http.port, "/nope")
    assert e.value.code == 404


def test_groups_routes_answer_as_the_reference(served):
    """Once each node's tick has retired its accepted-slot marks (the
    load is fully executed), the routes answer field for field as the
    JAX node's."""
    _, node, ref = served
    deadline = time.time() + tscale(10)
    while time.time() < deadline and any(
            g["acc_hi"] != -1 for nd in (node, ref)
            for g in _json(nd.stats_http.port, "/groups")["groups"]):
        time.sleep(0.05)
    for path in ("/groups", "/groups?limit=3", "/groups/fd0",
                 f"/groups/{_json(ref.stats_http.port, '/groups/fd3')['gkey']}"):
        got = _json(node.stats_http.port, path)
        assert got == _json(ref.stats_http.port, path), path
    g = _json(node.stats_http.port, "/groups/fd0")
    assert g["exec_cursor"] == g["exec_cursor_host"] == REQUESTS // GROUPS
    assert g["leader"] == 0 and g["members"] == [0]
    assert _json(node.stats_http.port, "/groups?limit=3")["truncated"]
    for port in (node.stats_http.port, ref.stats_http.port):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/groups/nope")
        assert e.value.code == 404


def test_cluster_engine_fanout(tmp_path):
    """``/engine`` and ``/stats`` scraped off three port nodes' listeners
    (four lanes each) and merged: a dead peer reads up = 0, the fleet's
    slab bytes and rows sum, per-node detail rides along."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    Config.set(PC.STATS_PORT, 0)
    Config.set(PC.ENGINE_SHARDS, 4)
    emu = PaxosEmulation(str(tmp_path), n_nodes=3, n_groups=8,
                         backend="columnar", capacity=CAP, window=W,
                         failure_timeout_s=300.0)
    try:
        # the per-request client: the windowed load generator draws its
        # client ids from a process-wide counter, which the parity tests
        # of the runtime keep in step between the two packages
        r = emu.run_load(24, concurrency=8, timeout=tscale(30))
        assert (r["ok"], r["errors"]) == (24, 0), r
        peers = {i: ("127.0.0.1", emu.nodes[i].stats_http.port)
                 for i in range(3)}
        peers[9] = ("127.0.0.1", free_ports(1)[0])  # nobody listens

        async def body():
            return (await scrape_cluster(peers, "/engine", tscale(5)),
                    await scrape_cluster(peers, "/stats", tscale(5)))
        per_node, stats = asyncio.run(body())
        merged = merge_cluster_engine(per_node)
        assert merged["cluster"]["nodes"] == {0: 1, 1: 1, 2: 1, 9: 0}
        assert set(merged["nodes"]) == {0, 1, 2}
        assert merged["memory"]["total_bytes"] == \
            3 * per_node[0]["memory"]["total_bytes"]
        assert merged["balance"]["rows_active"] == 3 * 8
        assert merged["ledger"]["retraces"] == 0
        for i in range(3):
            assert per_node[i]["engine_shards"] == 4
            assert LEDGER_KEYS <= set(per_node[i]["ledger"])
        ms = merge_cluster_stats(stats)
        assert ms["cluster"]["nodes"][9] == 0
        assert ms["counters"]["executed"] == 3 * 24
    finally:
        emu.stop()


def test_stats_dumper_writes_json_lines(tmp_path):
    path = tmp_path / "stats.jsonl"
    ticks = []

    def source():
        ticks.append(1)
        return f"tick {len(ticks)}", {"counters": {"n": len(ticks)}}

    d = StatsDumper(source, 0.02, jsonl_path=str(path), slow_fn=list)
    d.start()
    try:
        deadline = time.time() + tscale(10)
        while time.time() < deadline and len(ticks) < 3:
            time.sleep(0.01)
    finally:
        d.stop()
    assert not d.is_alive()
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(recs) >= 3
    assert [r["counters"]["n"] for r in recs] == \
        list(range(1, len(recs) + 1))
    assert all("ts" in r for r in recs)
