"""The port's flight recorder (``gigapaxos_tpu_torch.blackbox``) against
the JAX package's: the ``.gpbb`` bytes either writer produces, each
package reading the other's files, and captures replayed across the
packages — the committed ``reference.gpbb``, ``failover_ref.gpbb`` and
``lanes_ref.gpbb`` (all written by the JAX package, the last with four
engine lanes) on the port, ``record-demo`` output both ways, at one
lane and at four, every node's dump of a 3-node port cluster under chaos delay
and reorder in both packages, and a coordinator takeover recorded live
in each package and replayed in the other.  Every replay must give
``MATCH``: per-wave lane digests, per-group app digests and counts, and
the device cursors, exactly."""

import importlib
import json
import os
import struct
import time

import pytest

from gigapaxos_tpu.blackbox import capture as jcap
from gigapaxos_tpu.blackbox.__main__ import record_demo as jax_record_demo
from gigapaxos_tpu.blackbox.replay import replay_capture as jax_replay
from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
from gigapaxos_tpu.utils.config import Config as JConfig
from gigapaxos_tpu_torch.blackbox import capture as tcap
from gigapaxos_tpu_torch.blackbox.__main__ import main, record_demo
from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
from gigapaxos_tpu_torch.blackbox.replay import replay_capture
from gigapaxos_tpu_torch.chaos.faults import ChaosPlane
from gigapaxos_tpu_torch.paxos.packets import PacketType
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
from tests.conftest import tscale

DATA = os.path.join(os.path.dirname(__file__), "data")
REFERENCE = os.path.join(DATA, "reference.gpbb")
FAILOVER_REF = os.path.join(DATA, "failover_ref.gpbb")
# written by the JAX package with four engine lanes, from the
# repository's root:
#   JAX_PLATFORMS=cpu python -m gigapaxos_tpu.blackbox record-demo \
#       --shards 4 --groups 16 --requests 96 --out tests/data/lanes_ref.gpbb
# (16 groups put traffic on every lane)
LANES_REF = os.path.join(DATA, "lanes_ref.gpbb")
# the takeover: groups all led by node 0, requests before and after its
# death, and the failure detection (ping interval, failure timeout) the
# capture is recorded and replayed under
TAKEOVER_GROUPS, TAKEOVER_REQUESTS, TAKEOVER_DETECTION = 96, 40, (0.15, 1.0)
PKGS = {"port": "gigapaxos_tpu_torch", "jax": "gigapaxos_tpu"}


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's singletons; the
    port keeps its own, reset here."""
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()
    BlackboxRecorder.reset()
    ChaosPlane.reset()


def _pinned(cfg, pairs):
    """Set ``pairs`` on ``cfg`` and return the undo."""
    for key, val in pairs:
        cfg.set(key, val)
    return lambda: [cfg.unset(key) for key, _ in pairs]


def replay(pkg, path, detection=None):
    """Replay ``path`` in package ``pkg`` ("port": on the CPU) under the
    failure detection it was recorded with (None: the defaults)."""
    cfg, pc = (Config, PC) if pkg == "port" else (JConfig, JPC)
    pairs = [] if detection is None else [
        (pc.PING_INTERVAL_S, detection[0]),
        (pc.FAILURE_TIMEOUT_S, detection[1])]
    if pkg == "port":
        pairs.append((PC.COLUMNAR_DEVICE, "cpu"))
    undo = _pinned(cfg, pairs)
    try:
        return (replay_capture if pkg == "port" else jax_replay)(path)
    finally:
        undo()


def assert_match(rep, groups):
    assert rep["verdict"] == "MATCH", rep
    assert not rep["partial"] and not rep["group_mismatches"], rep
    assert rep["waves_replayed"] > 0 and rep["frames"] > 0
    assert rep["groups"] == groups


def _quiesce(nodes, deadline_s=12.0):
    """Wait until the nodes' executed counters hold still."""
    last, stable = None, 0
    end = time.time() + tscale(deadline_s)
    while time.time() < end and stable < 2:
        cur = tuple(nd.n_executed for nd in nodes)
        stable = stable + 1 if cur == last else 0
        last = cur
        time.sleep(tscale(0.3))


def record_takeover(pkg, workdir, out=None):
    """Record a coordinator takeover live in package ``pkg`` ("port" on
    the CPU, or "jax") and return the survivors' dumps ``{node: path}``.

    Three nodes on loopback (``backend="columnar"``, ``CounterApp``,
    capacity 1024, the recorder armed without age eviction) serve
    ``TAKEOVER_GROUPS`` groups that node 0 leads; after
    ``TAKEOVER_REQUESTS`` requests node 0 is killed, node 1 installs
    itself for every group through the batched prepare path, and
    ``TAKEOVER_REQUESTS`` more are answered.  ``out`` also copies node
    1's dump there.  The committed ``tests/data/failover_ref.gpbb`` was
    made by the JAX package this way; to make it again run, from the
    repository's root::

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_blackbox \\
        import record_takeover; record_takeover('jax', '/tmp/takeover', \\
        out='tests/data/failover_ref.gpbb')"
    """
    import shutil

    def mod(name):
        return importlib.import_module(f"{PKGS[pkg]}.{name}")

    cfg = mod("utils.config").Config
    pc = mod("paxos.paxosconfig").PC
    group_key = mod("paxos.packets").group_key
    pairs = [(pc.BLACKBOX_MB, 32), (pc.BLACKBOX_S, 0.0)]
    pairs.append((pc.COLUMNAR_DEVICE, "cpu") if pkg == "port"
                 else (pc.ENGINE_MESH, "off"))  # one device, as the port
    undo = _pinned(cfg, pairs)
    names = [f"tk{i}" for i in range(4 * TAKEOVER_GROUPS)
             if group_key(f"tk{i}") % 3 == 0][:TAKEOVER_GROUPS]
    assert len(names) == TAKEOVER_GROUPS
    emu = mod("testing.harness").PaxosEmulation(
        workdir, n_nodes=3, n_groups=0, backend="columnar",
        app_cls=mod("paxos.interfaces").CounterApp, capacity=1 << 10,
        window=16, ping_interval_s=TAKEOVER_DETECTION[0],
        failure_timeout_s=TAKEOVER_DETECTION[1])
    try:
        emu.create_groups(len(names), names=names)
        pre = emu.run_load(TAKEOVER_REQUESTS, concurrency=16,
                           timeout=tscale(20))
        assert pre["ok"] == TAKEOVER_REQUESTS, pre
        time.sleep(0.5)  # pings establish last_heard
        succ = emu.nodes[1]
        assert succ.n_installs == 0, "spurious election before the kill"
        emu.kill(0)
        deadline = time.time() + tscale(45)
        while time.time() < deadline and (
                succ.n_installs < len(names) or succ.open_elections):
            time.sleep(0.05)
        assert succ.n_installs >= len(names), succ.n_installs
        post = emu.run_load(TAKEOVER_REQUESTS, concurrency=16,
                            timeout=tscale(30), client_id=1 << 21)
        assert post["ok"] == TAKEOVER_REQUESTS, post
        _quiesce([emu.nodes[1], emu.nodes[2]])
        paths = {k: emu.nodes[k].blackbox.dump("takeover") for k in (1, 2)}
        if out is not None:
            shutil.copyfile(paths[1], out)
        return paths
    finally:
        emu.stop()
        undo()


# -- the .gpbb format ------------------------------------------------------


def _sample():
    recs = [
        {"t": "I", "ts": 1.0, "frames": 2, "bytes": 64},
        {"t": "F", "ts": 1.1, "wave": 5, "lane": 0,
         "frames": [b"\x00\x01", b"", b"abc"]},
        {"t": "W", "ts": 1.2, "wave": 5, "lane": 0, "items": 3,
         "pre": 123, "post": 456, "chaos": [1, 0, 2, 0]},
        {"t": "L", "ts": 1.3, "wave": 5, "seg": 0, "off": 4096, "n": 3},
        {"t": "T", "ts": 1.4, "wave": 5, "lane": 0},
    ]
    return recs, {"format": "gpbb1", "node": 2, "reason": "test",
                  "n_evicted": 0, "groups": [{"name": "g", "row": 0}]}


def test_writers_give_identical_bytes_and_read_each_other(tmp_path):
    recs, man = _sample()
    paths = {}
    for name, mod in (("jax", jcap), ("port", tcap)):
        paths[name] = str(tmp_path / f"{name}.gpbb")
        mod.write_capture(paths[name], recs, man)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["jax"] == data["port"]
    assert tcap.read_capture(paths["jax"]) == (recs, man)
    assert jcap.read_capture(paths["port"]) == (recs, man)


def _bad_magic(data):
    return b"NOTGP\0" + data[6:]


def _torn_tail(data):
    return data[:-10]


def _no_manifest(data):
    body = json.dumps({"t": "I", "ts": 0.0, "frames": 1,
                       "bytes": 2}).encode()
    return tcap.MAGIC + struct.pack("<IB", len(body), ord("I")) + body


def _after_manifest(data):
    body = json.dumps({"t": "I", "ts": 0.0, "frames": 1,
                       "bytes": 2}).encode()
    return data + struct.pack("<IB", len(body), ord("I")) + body


@pytest.mark.parametrize("corrupt,match", [
    (_bad_magic, "bad magic"), (_torn_tail, "torn"),
    (_no_manifest, "no manifest"), (_after_manifest, "manifest must be")])
def test_broken_captures_raise(tmp_path, corrupt, match):
    """The reference's structural checks, on a file the JAX package
    wrote: the port's reader raises ``CaptureError`` as the JAX one
    does."""
    recs, man = _sample()
    path = str(tmp_path / "x.gpbb")
    jcap.write_capture(path, recs, man)
    with open(path, "rb") as f:
        data = corrupt(f.read())
    with open(path, "wb") as f:
        f.write(data)
    for mod in (tcap, jcap):
        with pytest.raises(mod.CaptureError, match=match):
            mod.read_capture(path)


def test_recorder_ring_and_dumps(tmp_path):
    """The port's ring: bounded by bytes (oldest first) and by age, an
    asynchronous trigger with its cooldown, and ``dump_all`` over the
    live recorders in node order."""
    BlackboxRecorder.reset()
    rec = BlackboxRecorder(3, str(tmp_path), max_bytes=4096,
                           cooldown_s=60.0)
    for w in range(1, 101):
        rec.note_frames(time.time(), w, 0, [bytes([w]) * 200] * 2)
    snap = rec.snapshot()
    assert snap["bytes"] <= 4096 and snap["evicted"] > 0
    assert rec.export()[-1]["wave"] == 100
    assert rec.trigger("slow_trace") is True
    end = time.time() + tscale(5)
    while time.time() < end and rec.snapshot()["last_dump"] is None:
        time.sleep(0.02)
    assert rec.trigger("slow_trace") is False  # cooldown
    _recs, man = jcap.read_capture(rec.snapshot()["last_dump"])
    assert man["node"] == 3 and man["reason"] == "slow_trace"
    aged = BlackboxRecorder(0, str(tmp_path), max_bytes=1 << 20,
                            max_age_s=0.05)
    aged.note_ingress(1, 10)
    time.sleep(0.12)
    aged.note_ingress(2, 20)
    assert aged.snapshot()["records"] == 1
    paths = BlackboxRecorder.dump_all("test")
    assert [jcap.read_capture(p)[1]["node"] for p in paths] == [0, 3]
    rec.close()
    aged.close()
    assert BlackboxRecorder.dump_all("test") == []


# -- replay across the packages --------------------------------------------


def test_reference_capture_replays_match_on_port():
    assert_match(replay("port", REFERENCE), 4)


def test_failover_reference_replays_match_on_port():
    """The committed JAX-written takeover: every wave of the prepare and
    install path through the port's node, and the same final state."""
    records, manifest = tcap.read_capture(FAILOVER_REF)
    assert manifest["n_evicted"] == 0
    phase1 = (PacketType.PREPARE_BATCH, PacketType.PREPARE_REPLY_BATCH)
    assert any(f and f[0] in phase1 for r in records if r["t"] == "F"
               for f in r["frames"])
    assert_match(replay("port", FAILOVER_REF, TAKEOVER_DETECTION),
                 TAKEOVER_GROUPS)


def test_port_replay_cli_exit_codes_and_artifact(tmp_path):
    """Exit 0 on MATCH with the ``--json-out`` artifact, 2 on a broken
    capture."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    art = str(tmp_path / "replay.json")
    assert main(["replay", REFERENCE, "--json-out", art]) == 0
    with open(art) as f:
        assert json.load(f)["captures"][0]["verdict"] == "MATCH"
    bad = str(tmp_path / "bad.gpbb")
    with open(bad, "wb") as f:
        f.write(b"NOTGP\0nope")
    assert main(["replay", bad]) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_record_demo_replays_in_the_other_package(tmp_path, writer):
    out = str(tmp_path / "demo.gpbb")
    if writer == "port":
        undo = _pinned(Config, [(PC.COLUMNAR_DEVICE, "cpu")])
        try:
            record_demo(out, n_requests=36, n_groups=6)
        finally:
            undo()
        assert_match(replay("jax", out), 6)
    else:
        undo = _pinned(JConfig, [(JPC.ENGINE_MESH, "off")])
        try:
            jax_record_demo(out, n_requests=36, n_groups=6)
        finally:
            undo()
        assert_match(replay("port", out), 6)


@pytest.mark.parametrize("argv", [
    ["replay", REFERENCE, "--mesh", "2"]],
    ids=["replay-mesh-2"])
def test_unported_replay_options_raise(tmp_path, argv):
    """A mesh above one device (module 16) raises instead of running on
    one device."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(argv)


def test_lanes_reference_replays_match_on_port():
    """The committed JAX-written capture of four engine lanes, every lane
    with traffic, replays MATCH through a 4-lane port node."""
    records, manifest = tcap.read_capture(LANES_REF)
    assert manifest["knobs"]["engine_shards"] == 4
    assert {r["lane"] for r in records if r["t"] == "W"} == {0, 1, 2, 3}
    assert_match(replay("port", LANES_REF), 16)


@pytest.mark.parametrize("shards", [2, 4])
def test_port_lane_capture_replays_match_in_jax(tmp_path, shards):
    """``record-demo --shards S`` runs on the port, and its capture
    replays MATCH in the JAX package and in the port."""
    out = str(tmp_path / "lanes.gpbb")
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    assert main(["record-demo", "--out", out, "--shards", str(shards),
                 "--groups", "16", "--requests", "64"]) == 0
    assert tcap.read_capture(out)[1]["knobs"]["engine_shards"] == shards
    undo = _pinned(JConfig, [(JPC.ENGINE_MESH, "off")])
    try:
        assert_match(replay("jax", out), 16)
    finally:
        undo()
    assert_match(replay("port", out), 16)


@pytest.fixture(scope="module")
def drill_dumps(tmp_path_factory):
    """Every node's dump of a 3-node port cluster (6 groups) that served
    a client load under the chaos plane's delay and reorder."""
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    undo = _pinned(Config, [(PC.BLACKBOX_MB, 8), (PC.BLACKBOX_S, 0.0),
                            (PC.COLUMNAR_DEVICE, "cpu")])
    ChaosPlane.reset()
    ChaosPlane.configure(seed=11, enabled=True)
    ChaosPlane.set_link(None, None, delay_s=0.001, jitter_s=0.002,
                        reorder_p=0.2)
    emu = PaxosEmulation(str(tmp_path_factory.mktemp("drill")), n_nodes=3,
                         n_groups=6, app_cls=CounterApp, capacity=1 << 10,
                         window=16)
    try:
        res = emu.run_load(60, concurrency=12, timeout=tscale(20))
        assert res["ok"] > 0, res
        ChaosPlane.clear()
        nodes = [emu.nodes[i] for i in range(3)]
        _quiesce(nodes)
        paths = [nd.blackbox.dump("drill") for nd in nodes]
    finally:
        emu.stop()
        ChaosPlane.reset()
        undo()
    for p in paths:
        recs, man = tcap.read_capture(p)
        assert man["n_evicted"] == 0
        assert any(r["t"] == "W" and r["chaos"] is not None for r in recs)
    return paths


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_chaos_drill_dumps_replay_match(drill_dumps, pkg):
    for path in drill_dumps:
        assert_match(replay(pkg, path), 6)


@pytest.fixture(scope="module", params=["port", "jax"])
def takeover(request, tmp_path_factory):
    """The survivors' dumps of a takeover recorded live in one package."""
    return request.param, record_takeover(
        request.param, str(tmp_path_factory.mktemp(request.param)))


def test_takeover_replays_match_in_the_other_package(takeover):
    writer, paths = takeover
    for path in paths.values():
        assert_match(replay("jax" if writer == "port" else "port", path,
                            TAKEOVER_DETECTION), TAKEOVER_GROUPS)
