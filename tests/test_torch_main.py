"""The port's bench and emulation CLI (``gigapaxos_tpu_torch/testing/
main.py``) against the JAX package's (``gigapaxos_tpu/testing/main.py``),
with the port's columnar engine on the CPU (the kernels' plain versions)
and the JAX side on its scalar engine: the stage-budget delta and the
mass-takeover names are equal, each mode's row has the reference's keys
(``engine`` and the port's device fields aside) and is correct (every
request answered, the takeover complete, every group made), replicas as
processes answer every request, and an engine the port lacks, or a card
this machine lacks, raises instead of running without it."""

import argparse
import contextlib
import io
import json

import pytest
import torch

from gigapaxos_tpu.paxos.packets import group_key as jax_group_key
from gigapaxos_tpu.testing import main as jmain
from gigapaxos_tpu_torch.paxos.paxosconfig import PC
from gigapaxos_tpu_torch.testing import main as tmain
from gigapaxos_tpu_torch.utils.config import Config
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

# keys only the port's rows carry: the engine rollup (kernel launches)
# and the device half of scale's bytes per group
PORT_ONLY = {"engine", "host_bytes_per_group", "device_delta_mb",
             "device_bytes_per_group", "device_dispatch_rtt_ms"}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port's engine on the CPU; the port's singletons reset after
    (the suite's conftest resets only the JAX package's)."""
    Config.set(PC.COLUMNAR_DEVICE, "cpu")
    yield
    Config.clear()
    DelayProfiler.clear()
    RequestInstrumenter.reset()


def test_totals_delta_matches_reference():
    before = {"w.process": (1.0, 10, 100, 0.5), "node.tick": (2.0, 4, 4, 1.0),
              "fo.scan": (0.0, 0, 0, 0.0), "other.x": (1.0, 1, 1, 1.0)}
    after = {"w.process": (3.25, 25, 260, 1.75),
             "node.tick": (2.0, 4, 4, 1.0),       # no new calls: left out
             "fo.scan": (0.5, 2, 9, 0.25), "eng.submit": (0.125, 3, 3, 0.1),
             "other.x": (9.0, 9, 9, 9.0)}         # not a budget stage
    got = tmain._totals_delta(before, after)
    assert got == jmain._totals_delta(before, after)
    assert set(got) == {"w.process", "fo.scan", "eng.submit"}


def test_single_coordinator_names_match_reference():
    """``failover --single-coordinator``'s victims: the reference's
    filter (``gigapaxos_tpu/testing/main.py:596-603``) over the JAX
    package's ``group_key``."""
    ref, i = [], 0
    while len(ref) < 64:
        nm = f"f{i}"
        i += 1
        if jax_group_key(nm) % 5 == 0:
            ref.append(nm)
    assert tmain.single_coordinator_names(64, 0) == ref


def _jax_row(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jmain.main(argv + ["--backend", "scalar"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _same_keys(port, ref, what):
    extra = (set(port) ^ set(ref)) - PORT_ONLY
    assert not extra, (what, sorted(extra))


def _check_throughput(row):
    info = row["info"]
    assert (info["ok"], info["errors"]) == (600, 0), info
    assert [r["errors"] for r in info["depth_sweep"]] == \
        [0] * len(info["depth_sweep"])
    assert info["knee_depth"] in [r["depth"] for r in info["depth_sweep"]]
    assert set(info["engine"]["launches"]) == {
        "cuda:accept", "cuda:commit", "cuda:propose", "cuda:accept_reply",
        "cuda:acceptor_wave", "cuda:coordinator_wave"}


def _check_scale(row):
    info = row["info"]
    assert info["groups"] == 2000 and info["tail_request_status"] == 0
    assert info["recovery"]["tail_request_status"] == 0
    assert info["engine"]["device"] == "cpu"
    assert info["bytes_per_group"] == info["host_bytes_per_group"] \
        + info["device_bytes_per_group"]


def _check_failover(row):
    info = row["info"]
    assert info["takeover_complete"], info
    assert info["installed"] >= info["takeover_target"] == 64
    assert info["spurious_pre_kill_installs"] == 0
    for half in ("pre", "post_through_failover"):
        assert (info[half]["ok"], info[half]["errors"]) == (200, 0), half


def _check_churn(row):
    assert row["info"]["ops"] == 400  # creates and deletes, all made


MODES = {
    "throughput": (["throughput", "--groups", "32", "--requests", "600",
                    "--concurrency", "32", "--sweep"], _check_throughput),
    "scale": (["scale", "--requests", "2000", "--restart"], _check_scale),
    "failover": (["failover", "--single-coordinator", "--groups", "64",
                  "--requests", "200"], _check_failover),
    "churn": (["churn", "--requests", "200"], _check_churn),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_row_matches_reference(tmp_path, mode):
    argv, check = MODES[mode]
    row = tmain.run(argv + ["--logdir", str(tmp_path / "port")])
    check(row)
    assert "(columnar" in row["metric"]
    ref = _jax_row(argv + ["--logdir", str(tmp_path / "jax")])
    assert set(row) == set(ref) == {"metric", "value", "unit", "info"}
    assert row["unit"] == ref["unit"]
    assert row["metric"] == ref["metric"].replace("(scalar", "(columnar")
    _same_keys(row["info"], ref["info"], mode)
    for sub in ("latency_point", "recovery", "pre",
                "post_through_failover"):
        if sub in ref["info"]:
            _same_keys(row["info"][sub], ref["info"][sub], sub)
    for got, want in zip(row["info"].get("depth_sweep", []),
                         ref["info"].get("depth_sweep", [])):
        assert set(got) == set(want)


def test_multiproc_throughput_mode(tmp_path):
    """The port's counterpart of ``tests/test_cli.py``'s: replicas as
    ``python -m gigapaxos_tpu_torch.server`` processes on the columnar
    engine on the CPU (this process's ``PC.COLUMNAR_DEVICE``, passed on),
    the windowed load generator driving them, and every replica's
    ``/engine/kernels`` launches read into the row."""
    args = argparse.Namespace(
        nodes=3, groups=32, requests=600, concurrency=64,
        backend="columnar", capacity=256, window=8, sync_wal=False,
        logdir=str(tmp_path))
    out = tmain.throughput_multiproc(args)
    assert out["info"]["ok"] == 600
    assert out["info"]["errors"] == 0
    assert out["value"] > 0
    assert out["info"]["latency_point"]["throughput_rps"] > 0
    eng = out["info"]["engine"]
    assert len(eng["launches_by_server"]) == 3
    assert eng["launches"] == {"cuda:accept": 0, "cuda:commit": 0,
                               "cuda:propose": 0, "cuda:accept_reply": 0,
                               "cuda:acceptor_wave": 0,
                               "cuda:coordinator_wave": 0}  # plain on CPU


def _chaos_main(argv):
    from gigapaxos_tpu_torch.chaos.__main__ import main
    return main(argv)


@pytest.mark.parametrize("cli,argv", [
    (tmain.main, ["throughput", "--backend", "native", "--groups", "4"]),
    (tmain.main, ["throughput", "--backend", "native", "--multiproc"]),
    (_chaos_main, ["--backend", "native", "--scenarios",
                   "mini_partition_heal"])],
    ids=["bench", "bench-multiproc", "chaos"])
def test_native_backend_raises(cli, argv):
    with pytest.raises(NotImplementedError, match="module 6b"):
        cli(argv)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine with no card")
@pytest.mark.parametrize("cli,argv", [
    (tmain.main, ["scale", "--requests", "4"]),
    (_chaos_main, ["--scenarios", "mini_disk_fault"])],
    ids=["bench", "chaos"])
def test_no_card_raises(cli, argv):
    Config.set(PC.COLUMNAR_DEVICE, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(argv)
