"""The port's entry points as processes: ``python -m
gigapaxos_tpu_torch.server`` booted over a properties file and driven
with ``python -m gigapaxos_tpu_torch.client_cli`` — the port's
counterparts of ``tests/test_cli.py``'s chat lifecycle and
``--paxos-only`` cases, with every server on the port's columnar engine
on the CPU (``GP_PC_COLUMNAR_DEVICE=cpu`` in the servers' environment).
An option the port has not ported (``BACKEND=native``) makes the server
exit with ``NotImplementedError`` instead of running without it.

``tests/test_cli.py``'s ``test_multiproc_throughput_mode`` has its
counterpart in ``tests/test_torch_main.py``, over the port's
``testing/main.py``."""

import os
import subprocess
import sys
import time

import pytest

from gigapaxos_tpu_torch.paxos.client import PaxosClient
from gigapaxos_tpu_torch.testing.harness import free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, GP_PC_COLUMNAR_DEVICE="cpu")


def _listening(port):
    import socket
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
        return True
    except OSError:
        return False


def _boot(conf, ids, logdir, *extra):
    """Start one server process a node id; wait until every one listens
    (or fail with their stderr)."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gigapaxos_tpu_torch.server",
         "--config", str(conf), "--id", str(i), "--logdir", str(logdir),
         *extra],
        env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for i in ids]
    ports = [int(ln.rsplit(":", 1)[1]) for ln in conf.read_text().split()
             if ln.startswith(("active.", "reconfigurator."))]
    deadline = time.time() + 60
    for port in ports:
        while not _listening(port):
            if time.time() > deadline or any(p.poll() is not None
                                             for p in procs):
                _stop(procs)
                pytest.fail("server process died or never listened:\n" +
                            "\n---\n".join(_errors(procs)))
            time.sleep(0.1)
    return procs


def _errors(procs):
    out = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        out.append(err.decode(errors="replace")[-2000:])
    return out


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _cli(conf, *args, rc=0):
    out = subprocess.run(
        [sys.executable, "-m", "gigapaxos_tpu_torch.client_cli",
         "--config", str(conf), *args], env=ENV, capture_output=True,
        timeout=60)
    assert out.returncode == rc, out.stderr.decode(errors="replace")
    return out.stdout.decode().strip(), out.stderr.decode()


def test_server_client_chat_lifecycle(tmp_path):
    """3 actives and 1 reconfigurator running the chat app: a room
    created, resolved, posted to, read and deleted from the console
    client, after which it no longer resolves."""
    ports = free_ports(4)
    conf = tmp_path / "gp.properties"
    conf.write_text(
        "".join(f"active.{i}=127.0.0.1:{ports[i]}\n" for i in range(3)) +
        f"reconfigurator.100=127.0.0.1:{ports[3]}\n"
        "APPLICATION=gigapaxos_tpu_torch.examples.chatapp:ChatApp\n"
        "CAPACITY=1024\nWINDOW=8\nBACKEND=columnar\nRC_GROUP_SIZE=1\n")
    procs = _boot(conf, (0, 1, 2, 100), tmp_path / "logs")
    try:
        assert _cli(conf, "create", "room1")[0] == "created"
        assert len(_cli(conf, "actives", "room1")[0].split()) == 3
        r = _cli(conf, "send", "room1",
                 '{"op":"post","who":"alice","msg":"hello port"}')[0]
        assert '"ok": true' in r and '"seq": 1' in r
        assert "hello port" in _cli(conf, "send", "room1",
                                    '{"op":"read","n":5}')[0]
        assert _cli(conf, "delete", "room1")[0] == "deleted"
        assert "no such service" in _cli(conf, "actives", "room1",
                                         rc=1)[1]
        assert all(p.poll() is None for p in procs)
    finally:
        _stop(procs)


@pytest.mark.parametrize("backend", ["columnar", "native"])
def test_paxos_only_server_mode(tmp_path, backend):
    """``--paxos-only`` boots bare port nodes: ``GROUPS=`` pre-creates
    groups over every active and a plain ``PaxosClient`` drives them.
    ``BACKEND=native`` (not ported) stops the server at construction."""
    ports = free_ports(3)
    conf = tmp_path / "px.properties"
    conf.write_text(
        "".join(f"active.{i}=127.0.0.1:{ports[i]}\n" for i in range(3)) +
        "APPLICATION=CounterApp\nCAPACITY=256\nWINDOW=8\n"
        f"BACKEND={backend}\nGROUPS=solo1,solo2\n")
    if backend == "native":
        out = subprocess.run(
            [sys.executable, "-m", "gigapaxos_tpu_torch.server",
             "--config", str(conf), "--id", "0",
             "--logdir", str(tmp_path / "logs"), "--paxos-only"],
            env=ENV, capture_output=True, timeout=60)
        err = out.stderr.decode(errors="replace")
        assert out.returncode != 0
        assert "NotImplementedError" in err and "native" in err, err
        return
    procs = _boot(conf, (0, 1, 2), tmp_path / "logs", "--paxos-only")
    cli = PaxosClient([("127.0.0.1", p) for p in ports], timeout=15)
    try:
        for k in range(5):
            assert cli.send_request("solo1", f"a{k}".encode()).status == 0
        assert cli.send_request("solo2", b"b").status == 0
    finally:
        cli.close()
        _stop(procs)
