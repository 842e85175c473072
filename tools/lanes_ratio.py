"""The engine lanes' rate ratio of both packages on one CPU host.

Config 2's drive (3 replicas on loopback, ``CounterApp``), cut to
``--groups`` groups, pipelined, fused waves, failure detection at 300 s,
the congestion guard and the deactivator off, with the engines on this
host's CPU: decided requests/s at ``ENGINE_SHARDS`` 1 and 4, for the
JAX package and for the PyTorch port, in turns, after one round that
warms both up.  Prints one JSON object with every rate and each
package's S=4/S=1 ratio of the mean rates.

It imports both packages, as the port's parity tests do, so it runs
where JAX is installed; the card's machine has no JAX, so the
reference's ratio is taken on a CPU host.

Run from the repo root::

    JAX_PLATFORMS=cpu python -m tools.lanes_ratio
"""

import argparse
import json
import os
import shutil
import tempfile

import numpy as np

LANES = 4


def lanes_ratio(n_groups=2000, capacity=4096, n_requests=1000, depth=128,
                rounds=3):
    """The rates and ratios, ``rounds`` rounds counted after the warm
    one."""
    from gigapaxos_tpu.paxos.interfaces import CounterApp as JaxCounter
    from gigapaxos_tpu.paxos.paxosconfig import PC as JPC
    from gigapaxos_tpu.testing.harness import PaxosEmulation as JaxEmulation
    from gigapaxos_tpu.utils.config import Config as JConfig
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    from gigapaxos_tpu_torch.utils.config import Config
    rates = {(pkg, s): [] for pkg in ("jax", "port") for s in (1, LANES)}
    for r in range(rounds + 1):
        for (pkg, s), got in rates.items():
            port = pkg == "port"
            cfg, keys = (Config, PC) if port else (JConfig, JPC)
            cfg.set(keys.PIPELINE_WORKER, True)
            cfg.set(keys.FUSE_WAVES, "auto")
            cfg.set(keys.INTAKE_BACKLOG_LIMIT, 0)
            cfg.set(keys.PAUSE_IDLE_S, 0.0)
            cfg.set(keys.ENGINE_SHARDS, s)
            if port:
                cfg.set(keys.COLUMNAR_DEVICE, "cpu")
            else:
                cfg.set(keys.ENGINE_MESH, "off")
            emu_cls = PaxosEmulation if port else JaxEmulation
            logdir = tempfile.mkdtemp(prefix="gp_lanes_ratio_")
            emu = emu_cls(logdir, n_nodes=3, n_groups=0,
                          app_cls=CounterApp if port else JaxCounter,
                          capacity=capacity, window=16, sync_wal=False,
                          failure_timeout_s=300.0)
            try:
                emu.create_groups(n_groups)
                res = emu.run_load_fast(n_requests, concurrency=depth,
                                        timeout=300.0)
                if res["ok"] != n_requests:
                    raise AssertionError(f"{pkg} S={s}: {json.dumps(res)}")
                if r:
                    got.append(res["throughput_rps"])
            finally:
                emu.stop()
                cfg.clear()
                shutil.rmtree(logdir, ignore_errors=True)
    mean = {k: float(np.mean(v)) for k, v in rates.items()}
    return {"rates": {f"{p} S={s}": v for (p, s), v in rates.items()},
            "ratio_s4_over_s1": {p: mean[(p, LANES)] / mean[(p, 1)]
                                 for p in ("jax", "port")},
            "groups": n_groups, "capacity": capacity,
            "requests": n_requests, "depth": depth, "cpus": os.cpu_count()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=2000)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--depth", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args(argv)
    print(json.dumps(lanes_ratio(a.groups, a.capacity, a.requests, a.depth,
                                 a.rounds)))


if __name__ == "__main__":
    main()
