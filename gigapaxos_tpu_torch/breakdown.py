"""Where the device time goes on the port's main path, on one CUDA card.

Runs the port's two main paths at full scale under ``torch.profiler``:

- ``storm``: ``decide_storm_step`` over a ``make_fleet(2**20, 16, R=3)``
  fleet at B = 2^18 lanes a step;
- ``spi``: three ``ColumnarBackend(2**20, 16)`` replicas through the
  propose → accept ×3 → accept_reply ×3 → commit ×3 pipeline at
  B = 16384 lanes a wave.

For each it reports the host wall per step and decisions per second
(profiler off), then, from a profiled window of as many steps, the
device busy share (device-side event time over that window's wall), the
top device kernels by time with their share, and the accept kernel's
share (found by its name, ``accept_cuda.KERNEL_NAME``; a window that
launched it but shows no time for it is an error, not a 0% share).
One warm-up step precedes both windows.

Run: ``python -m gigapaxos_tpu_torch.breakdown [--out FILE.json]`` on a
machine with a CUDA card (it exits non-zero without one).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

G, W, R = 1 << 20, 16, 3
STORM_B, SPI_B = 1 << 18, 16384


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _profile(step, steps: int) -> dict:
    """Time ``steps`` calls of ``step`` (each returns the requests it
    decided, a host value, so each step ends synchronized) with the
    profiler off, then profile as many more.  Device time counts the
    device-side events only (kernels, copies, memsets): the profiler
    also credits a launching operator with its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gigapaxos_tpu_torch.ops.accept_cuda import KERNEL_NAME, accept
    step()  # warm-up, outside both windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = sum(step() for _ in range(steps))
    wall = time.perf_counter() - t0
    launches = accept.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    launches = accept.launches - launches
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    accept_us = sum(us for k, us, _ in rows if KERNEL_NAME in k)
    if launches and not accept_us:
        raise RuntimeError(f"breakdown: the accept kernel launched "
                           f"{launches} times but the profiler shows no "
                           f"device time for {KERNEL_NAME}")
    return {
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "profiled_wall_ms_per_step": prof_wall * 1e3 / steps,
        "device_busy_share": busy_us / (prof_wall * 1e6),
        "device_ms_per_step": busy_us / 1e3 / steps,
        "decisions_per_s": decisions / wall,
        "accept_kernel_share_of_device": accept_us / busy_us if busy_us
        else 0.0,
        "accept_kernel_us_per_step": accept_us / steps,
        "accept_launches_per_step": launches / steps,
        "top_kernels": [
            {"name": k[:96], "device_us_per_step": us / steps,
             "calls_per_step": n / steps, "share_of_device": us / busy_us}
            for k, us, n in rows[:12]],
    }


def storm_breakdown(steps: int = 4) -> dict:
    from gigapaxos_tpu_torch.ops.storm import decide_storm_step, make_fleet
    states = make_fleet(G, W, R)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    dev = torch.device("cuda")

    def step():
        g = torch.randint(0, G, (STORM_B,), generator=gen, device=dev,
                          dtype=torch.int32)
        rlo = torch.randint(1, 1 << 30, (STORM_B,), generator=gen,
                            device=dev, dtype=torch.int32)
        valid = torch.ones(STORM_B, dtype=torch.bool, device=dev)
        _, n = decide_storm_step(states, g, rlo, rlo, valid)
        return int(n)

    out = _profile(step, steps)
    del states
    torch.cuda.empty_cache()
    return out


def spi_breakdown(steps: int = 4) -> dict:
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend
    bks = [ColumnarBackend(G, W) for _ in range(R)]
    rows = np.arange(G, dtype=np.int32)
    for r, b in enumerate(bks):
        b.create(rows, np.full(G, R, np.int32), np.zeros(G, np.int32),
                 np.zeros(G, np.int32), np.full(G, r == 0))
    rng = np.random.default_rng(1)
    it = [0]

    def step():
        it[0] += 1
        g = rng.integers(0, G, SPI_B, dtype=np.int32)
        reqs = np.uint64(it[0] << 40) | rng.integers(
            1, 1 << 31, SPI_B, dtype=np.int64).astype(np.uint64)
        pr = bks[0].propose(g, reqs)
        acks = [b.accept(g, pr.slot, pr.cbal, reqs).acked & pr.granted
                for b in bks]
        decided = 0
        for s in range(R):
            decided += int(bks[0].accept_reply(
                g, pr.slot, pr.cbal, np.full(SPI_B, s, np.int32),
                acks[s]).newly_decided.sum())
        for b in bks:
            b.commit(g, pr.slot, reqs)
        return decided

    out = _profile(step, steps)
    del bks
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    res = {"card": card, "torch": torch.__version__,
           "storm": storm_breakdown(), "spi": spi_breakdown()}
    for path in ("storm", "spi"):
        r = res[path]
        print(f"{path}: {r['wall_ms_per_step']:.3f} ms/step wall, "
              f"{r['device_ms_per_step']:.3f} ms/step device, device busy "
              f"{r['device_busy_share']:.1%} of "
              f"{r['profiled_wall_ms_per_step']:.3f} ms profiled, "
              f"{r['decisions_per_s']:.0f} decisions/s, accept kernel "
              f"{r['accept_kernel_us_per_step']:.1f} us/step in "
              f"{r['accept_launches_per_step']:.0f} launches "
              f"({r['accept_kernel_share_of_device']:.2%} of device time) "
              f"[{card}]")
        for k in r["top_kernels"]:
            print(f"  {k['device_us_per_step']:10.1f} us "
                  f"{k['share_of_device']:6.1%} x{k['calls_per_step']:.0f}"
                  f"  {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"card": card, "storm_decisions_per_s":
                      res["storm"]["decisions_per_s"],
                      "spi_decisions_per_s": res["spi"]["decisions_per_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
