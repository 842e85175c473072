"""The port's chaos drill (``gigapaxos_tpu_torch/chaos/``: scenarios,
invariants, CLI) against the JAX package's: the invariant checks give the
reference's exact violation lists on forged histories, the smoke-gate
scenarios hold all five invariants on the port's columnar engine on the
CPU with faults that bite, and the full timelines (``slow``, as the
reference's are) hold them too and replay the reference's fault
schedules."""

import json
import os

import pytest

from gigapaxos_tpu.chaos import invariants as jinv
from gigapaxos_tpu_torch.blackbox.recorder import BlackboxRecorder
from gigapaxos_tpu_torch.chaos import invariants as inv
from gigapaxos_tpu_torch.chaos.faults import ChaosPlane, StorageChaos
from gigapaxos_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIVE = {"no_lost_acks": True, "digest_linearizable": True,
        "cursors_converged": True, "churn_steady": True,
        "storage_healthy": True}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port's engine on the CPU; the port's singletons reset after
    (the suite's conftest resets only the JAX package's)."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()
    ChaosPlane.reset()
    StorageChaos.reset()
    BlackboxRecorder.reset()


# the forged histories of tests/test_chaos.py's checker test, clean and
# broken: (check, args, kwargs)
HIST = {"g": [(0.0, 1.0, 10, 3)]}
CASES = {
    "order-duplicate": ("check_single_order",
                        ([(0.0, 1.0, 1, 5), (2.0, 3.0, 2, 5)],), {}),
    "order-inversion": ("check_single_order",
                        ([(0.0, 1.0, 1, 9), (2.0, 3.0, 2, 4)],), {}),
    "order-clean": ("check_single_order",
                    ([(0.0, 2.0, 1, 2), (1.0, 3.0, 2, 1),
                      (2.5, 4.0, 3, 3)],), {}),
    "order-both": ("check_single_order",
                   ([(0.0, 1.0, 1, 9), (2.0, 3.0, 2, 9),
                     (4.0, 5.0, 3, 4)],), {}),
    "acks-lost": ("no_lost_acks", (HIST, {0: {"g": 3}, 1: {"g": 2}}), {}),
    "acks-clean": ("no_lost_acks", (HIST, {0: {"g": 3}, 1: {"g": 3}}), {}),
    "acks-not-host": ("no_lost_acks", (HIST, {0: {"g": 3}, 1: {}}),
                      {"members": {"g": (0,)}}),
    "acks-lagging-member": ("no_lost_acks",
                            (HIST, {0: {"g": 3}, 1: {"g": 1}}),
                            {"members": {"g": (0, 1)}}),
    "acks-double-grant": ("no_lost_acks",
                          ({"g": [(0.0, 1.0, 1, 2), (0.5, 1.5, 2, 2)]},
                           {0: {"g": 2}}), {}),
    "digests-diverged": ("digests_converged",
                         ({0: {"g": 1}, 1: {"g": 2}},), {}),
    "digests-clean": ("digests_converged", ({0: {"g": 1}, 1: {"g": 1}},),
                      {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_invariant_violations_match_reference(case):
    fn, args, kw = CASES[case]
    got = getattr(inv, fn)(*args, **kw)
    assert got == getattr(jinv, fn)(*args, **kw)
    assert bool(got) == (not case.endswith(("clean", "not-host")))


def test_scenarios_run_the_columnar_engine():
    """Every timeline of the reference runs on the port's columnar
    engine; shard_storm keeps its two engine lanes."""
    from gigapaxos_tpu.chaos.scenarios import SCENARIOS as JSC
    assert set(SCENARIOS) == set(JSC)
    for name, spec in SCENARIOS.items():
        assert spec["backend"] == "columnar", name
        ref = {k: v for k, v in JSC[name].items()
               if k not in ("fn", "backend")}
        assert {k: v for k, v in spec.items()
                if k not in ("fn", "backend")} == ref, name
    assert SCENARIOS["shard_storm"]["engine_shards"] == 2


def test_mini_partition_heal_scenario(tmp_path):
    """A 2-node full partition stalls the quorum (faults bite), heal
    restores service, every invariant holds."""
    row = run_scenario("mini_partition_heal", seed=1,
                       workdir=str(tmp_path))
    assert row["ok"], row.get("violations")
    assert row["invariants"] == FIVE
    assert row["backend"] == "columnar"
    assert row["faults"]["blocked"] > 0  # the partition really bit
    assert row["acked"] > 0
    assert row["schedule_fingerprint"] != "0" * 16


def test_mini_disk_fault_scenario(tmp_path):
    """100% fsync EIO on node 0 under load: every group commit rotates
    and re-appends before acking (``storage_healthy`` needs a rotation
    on the victim), and no ack is lost."""
    row = run_scenario("mini_disk_fault", seed=1, workdir=str(tmp_path))
    assert row["ok"], row.get("violations")
    assert row["invariants"] == FIVE
    assert row["storage_faults"]["per_pair"]["0/0"]["fsync_eio"] > 0
    assert row["acked"] > 0


def _reference_fingerprints():
    with open(os.path.join(REPO, "CHAOS_r02.json")) as f:
        art = json.load(f)
    assert art["seed"] == 1
    return {r["scenario"]: r["schedule_fingerprint"] for r in art["rows"]}


@pytest.mark.slow
@pytest.mark.parametrize("name", ["partition_heal", "leader_crash",
                                  "rolling_restart", "shard_storm"])
def test_full_scenario(tmp_path, name):
    """The full drill on the port: staged faults under load, all
    invariants hold, the injected-fault counters prove the faults fired,
    and the fault schedule is the one the reference recorded for seed 1
    (``CHAOS_r02.json``)."""
    row = run_scenario(name, seed=1, workdir=str(tmp_path))
    assert row["ok"], (name, row.get("violations"))
    assert row["acked"] > 0
    total_injected = (row["faults"]["blocked"] + row["faults"]["dropped"]
                      + row["faults"]["delayed"])
    if name != "leader_crash":  # its fault is the crash, not the links
        assert total_injected > 0, row["faults"]
    assert any("crash" in s["event"] or "partition" in s["event"]
               or "loss" in s["event"] for s in row["stages"])
    if name == "shard_storm":
        assert row["engine_shards_timeline"] == [2, 1, 2]
    assert row["schedule_fingerprint"] == _reference_fingerprints()[name]


@pytest.mark.slow
def test_scenario_replays_identically(tmp_path):
    """The same seed produces the identical fault schedule (fingerprint
    and staged event sequence); a different seed a different one."""
    a = run_scenario("partition_heal", seed=5,
                     workdir=str(tmp_path / "a"))
    b = run_scenario("partition_heal", seed=5,
                     workdir=str(tmp_path / "b"))
    c = run_scenario("partition_heal", seed=6,
                     workdir=str(tmp_path / "c"))
    assert a["schedule_fingerprint"] == b["schedule_fingerprint"]
    assert [s["event"] for s in a["stages"]] == \
        [s["event"] for s in b["stages"]]
    assert a["schedule_fingerprint"] != c["schedule_fingerprint"]
    assert a["ok"] and b["ok"] and c["ok"]
