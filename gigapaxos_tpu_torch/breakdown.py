"""Where the device time goes on the port's main path, on one CUDA card.

Runs the port's two main paths at full scale under ``torch.profiler``:

- ``storm``: ``decide_storm_step`` over a ``make_fleet(2**20, 16, R=3)``
  fleet at B = 2^18 lanes a step;
- ``spi``: three ``ColumnarBackend(2**20, 16)`` replicas through the
  propose → accept ×3 → accept_reply ×3 → commit ×3 pipeline at
  B = 16384 lanes a wave;
- ``wave``: the node runtime's acceptor wave at config 2's shape, one
  ``ColumnarBackend(2**17, 16)`` holding 100,000 groups and a fused
  ``accept_commit`` of 64 lanes a wave (this wave's accepts with the
  last wave's commits, as a node's acceptor stage sends them), driven
  from one thread, then from three threads at once, one engine each (the
  three nodes of ``chip_smoke.py`` phase 5 in one process), then from
  one thread beside a thread that runs only Python, at the interpreter's
  switch interval and at a tenth of it;
- ``lanes``: the same acceptor wave on a lane's slab of
  ``chip_smoke.py`` phase 8 (``ColumnarBackend(2**15, 16)`` holding
  25,000 groups, 32 lanes a wave), driven from twelve threads at once
  (three nodes of four lanes), one slab each: first plain slabs on the
  default stream launching freely, then lane slabs (``lane=True``: a
  stream each, launches under the process-wide lane launch lock), and
  one lane slab from one thread alone.

For each it reports the host wall per step and decisions per second
(profiler off), then, from a profiled window of as many steps, the
device busy share (device-side event time over that window's wall), the
top device kernels by time with their share, and the accept, commit,
propose, accept-reply and wave kernels' shares (found by their names,
``accept_cuda.KERNEL_NAME``, ``commit_cuda.KERNEL_NAME``,
``propose_cuda.KERNEL_NAME``, ``accept_reply_cuda.KERNEL_NAMES`` (its
two paths) and each ``wave_cuda`` kernel's ``kernel_name``; a window that launched one
but shows no time for it is an error, not a 0% share).
One warm-up step precedes both windows.  For ``wave`` it reports the
host wall of a wave (median and mean), alone, with three engine threads
and beside a Python-only thread, the
profiled device time and busy share, and the CUDA runtime calls a wave
makes (launches, copies, synchronizations) by name.  For ``lanes`` it
reports each drive's waves a second in all and the median wall of a
wave.

Run: ``python -m gigapaxos_tpu_torch.breakdown [--paths storm,spi,wave,lanes]
[--out FILE.json]`` on a machine with a CUDA card (it exits non-zero
without one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from typing import List

import numpy as np
import torch

G, W, R = 1 << 20, 16, 3
STORM_B, SPI_B = 1 << 18, 16384
# the runtime's acceptor wave at config 2 (chip_smoke.py phase 5)
RT_G, RT_GROUPS, RT_LANES, RT_WAVES = 1 << 17, 100_000, 64, 100
# a lane's slab of the runtime at four lanes (chip_smoke.py phase 8): a
# quarter of the rows and groups, and about 32 lanes a wave
LN_G, LN_GROUPS, LN_LANES, LN_THREADS = 1 << 15, 25_000, 32, 12


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

    from gigapaxos_tpu_torch.ops import (accept_reply_cuda, commit_cuda,
                                         propose_cuda, wave_cuda)
    from gigapaxos_tpu_torch.ops.accept_cuda import KERNEL_NAME, accept
    commit, propose = commit_cuda.commit, propose_cuda.propose
    reply = accept_reply_cuda.accept_reply
    step()  # warm-up, outside both windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = sum(step() for _ in range(steps))
    wall = time.perf_counter() - t0
    launches = accept.launches
    commit_launches = commit.launches
    propose_launches = propose.launches
    reply_launches = reply.launches
    wave_launches = sum(k.launches for k in wave_cuda.KERNELS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    launches = accept.launches - launches
    commit_launches = commit.launches - commit_launches
    propose_launches = propose.launches - propose_launches
    reply_launches = reply.launches - reply_launches
    wave_launches = sum(k.launches for k in wave_cuda.KERNELS) - \
        wave_launches
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
    commit_us = sum(us for k, us, _ in rows
                    if commit_cuda.KERNEL_NAME in k)
    if commit_launches and not commit_us:
        raise RuntimeError(f"breakdown: the commit kernel launched "
                           f"{commit_launches} times but the profiler "
                           f"shows no device time for "
                           f"{commit_cuda.KERNEL_NAME}")
    propose_us = sum(us for k, us, _ in rows
                     if propose_cuda.KERNEL_NAME in k)
    if propose_launches and not propose_us:
        raise RuntimeError(f"breakdown: the propose kernel launched "
                           f"{propose_launches} times but the profiler "
                           f"shows no device time for "
                           f"{propose_cuda.KERNEL_NAME}")
    reply_us = sum(us for k, us, _ in rows
                   if any(n in k for n in accept_reply_cuda.KERNEL_NAMES))
    if reply_launches and not reply_us:
        raise RuntimeError(f"breakdown: the accept-reply kernel launched "
                           f"{reply_launches} times but the profiler "
                           f"shows no device time for "
                           f"{accept_reply_cuda.KERNEL_NAMES}")
    wave_us = sum(us for k, us, _ in rows
                  if any(w.kernel_name in k for w in wave_cuda.KERNELS))
    if wave_launches and not wave_us:
        raise RuntimeError(f"breakdown: the wave kernels launched "
                           f"{wave_launches} times but the profiler shows "
                           "no device time for them")
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
        "commit_kernel_share_of_device": commit_us / busy_us if busy_us
        else 0.0,
        "commit_kernel_us_per_step": commit_us / steps,
        "commit_launches_per_step": commit_launches / steps,
        "propose_kernel_share_of_device": propose_us / busy_us if busy_us
        else 0.0,
        "propose_kernel_us_per_step": propose_us / steps,
        "propose_launches_per_step": propose_launches / steps,
        "accept_reply_kernel_share_of_device": reply_us / busy_us
        if busy_us else 0.0,
        "accept_reply_kernel_us_per_step": reply_us / steps,
        "accept_reply_launches_per_step": reply_launches / steps,
        "wave_kernel_share_of_device": wave_us / busy_us if busy_us
        else 0.0,
        "wave_kernel_us_per_step": wave_us / steps,
        "wave_launches_per_step": wave_launches / steps,
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


def _acceptor(seed: int, waves: int, device="cuda", capacity=RT_G,
              groups=RT_GROUPS, n_lanes=RT_LANES, lane=False):
    """A runtime-shaped acceptor engine and a function that runs its next
    fused wave: ``n_lanes`` accepts on distinct live rows at each row's
    next slot, with the previous wave's lanes committed.  The lanes are
    made before any wave runs, so a wave's wall is the engine's alone.
    ``lane`` builds the slab as an engine lane's.  ``device="cpu"``
    rehearses the drive off the card."""
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend
    b = ColumnarBackend(capacity, W, device=device, lane=lane)
    rows = np.arange(groups, dtype=np.int32)
    zeros = np.zeros(groups, np.int32)
    b.create(rows, np.full(groups, R, np.int32), zeros, zeros,
             np.zeros(groups, bool))
    rng = np.random.default_rng(seed)
    nxt = np.zeros(groups, np.int32)
    lanes = []
    for _ in range(waves + 1):
        g = rng.permutation(groups)[:n_lanes].astype(np.int32)
        lanes.append((g, nxt[g].copy(),
                      rng.integers(1, 1 << 62, n_lanes).astype(np.uint64)))
        nxt[g] += 1
    bal = np.zeros(n_lanes, np.int32)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.uint64))
    at = [0]

    def wave():
        i = at[0]
        at[0] += 1
        g, slot, reqs = lanes[i]
        ares, cres = b.accept_commit(g, slot, bal, reqs,
                                     *(lanes[i - 1] if i else empty))
        if not ares.acked.all() or not cres.applied.all():
            raise RuntimeError("breakdown: a runtime wave was refused")

    return b, wave


def _walls(wave, waves: int) -> List[float]:
    out = []
    for _ in range(waves):
        t0 = time.perf_counter()
        wave()
        out.append(time.perf_counter() - t0)
    return out


def _beside_python(wave, waves: int) -> List[float]:
    """Walls of ``waves`` waves while another thread runs only Python."""
    stop = threading.Event()

    def spin():
        n = 0
        while not stop.is_set():
            n += 1

    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        return _walls(wave, waves)
    finally:
        stop.set()
        spinner.join()


def wave_breakdown(waves: int = RT_WAVES) -> dict:
    """The runtime's acceptor wave alone and three at once (see the
    module docstring); each engine runs a warm-up wave first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engines = [_acceptor(seed, 2 * waves + 24) for seed in range(R)]
    for _, wave in engines:
        wave()
    torch.cuda.synchronize()
    alone = _walls(engines[0][1], waves)
    per_thread: List[List[float]] = [[] for _ in engines]

    def drive(k):
        per_thread[k] = _walls(engines[k][1], waves)

    threads = [threading.Thread(target=drive, args=(k,))
               for k in range(len(engines))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    together_wall = time.perf_counter() - t0
    together = [w for ws in per_thread for w in ws]
    # one engine thread beside a thread that only runs Python, as the
    # runtime's decode, emit, loop and client threads do: every torch
    # call of a wave drops the GIL and must take it back.  At the
    # interpreter's switch interval, then at a tenth of it
    beside_python = _beside_python(engines[1][1], waves)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(interval / 10)
    try:
        beside_python_short = _beside_python(engines[2][1], waves)
    finally:
        sys.setswitchinterval(interval)
    n_prof = min(20, waves)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            engines[0][1]()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    evts = prof.key_averages()
    busy_us = sum(_device_us(e) for e in evts
                  if e.device_type == DeviceType.CUDA)
    kernels = sum(e.count for e in evts
                  if e.device_type == DeviceType.CUDA and _device_us(e) > 0)
    runtime_calls = {e.key: e.count / n_prof for e in evts
                     if e.device_type == DeviceType.CPU
                     and e.key.startswith("cuda")}
    torch_ops = sum(e.count for e in evts
                    if e.device_type == DeviceType.CPU
                    and e.key.startswith("aten::")) / n_prof
    del engines
    torch.cuda.empty_cache()
    ms = [w * 1e3 for w in alone]
    ms3 = [w * 1e3 for w in together]
    msp = [w * 1e3 for w in beside_python]
    msq = [w * 1e3 for w in beside_python_short]
    return {
        "lanes": RT_LANES, "capacity": RT_G, "groups": RT_GROUPS,
        "waves": waves,
        "alone_ms_median": statistics.median(ms),
        "alone_ms_mean": statistics.fmean(ms),
        "threads": len(threads),
        "together_ms_median": statistics.median(ms3),
        "together_ms_mean": statistics.fmean(ms3),
        "together_waves_per_s": len(together) / together_wall,
        "beside_python_ms_median": statistics.median(msp),
        "beside_python_ms_mean": statistics.fmean(msp),
        "switch_interval_s": interval,
        "beside_python_short_interval_ms_median": statistics.median(msq),
        "beside_python_short_interval_ms_mean": statistics.fmean(msq),
        "alone_waves_per_s": len(ms) / (sum(ms) / 1e3),
        "profiled_wall_ms_per_wave": prof_wall * 1e3 / n_prof,
        "device_ms_per_wave": busy_us / 1e3 / n_prof,
        "device_busy_share": busy_us / (prof_wall * 1e6),
        "device_events_per_wave": kernels / n_prof,
        "aten_ops_per_wave": torch_ops,
        "cuda_runtime_calls_per_wave": runtime_calls,
    }


def _threaded(waves_fns, waves: int):
    """Each function of ``waves_fns`` driven ``waves`` times from its own
    thread, all at once: (waves a second in all, median wall ms)."""
    walls: List[List[float]] = [[] for _ in waves_fns]

    def drive(k):
        walls[k] = _walls(waves_fns[k], waves)

    threads = [threading.Thread(target=drive, args=(k,))
               for k in range(len(waves_fns))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return (len(waves_fns) * waves / wall,
            1e3 * statistics.median(w for ws in walls for w in ws))


def lanes_breakdown(waves: int = RT_WAVES, device="cuda",
                    threads: int = LN_THREADS) -> dict:
    """The acceptor wave on lane-sized slabs from ``threads`` threads at
    once, plain slabs and then lane slabs, and one lane slab alone
    (module docstring).  ``device="cpu"`` rehearses it off the card."""
    out = {"capacity": LN_G, "groups": LN_GROUPS, "lanes": LN_LANES,
           "threads": threads, "waves": waves}
    for key, lane in (("plain", False), ("lane", True)):
        fns = [_acceptor(s, 2 * waves + 1, device, LN_G, LN_GROUPS, LN_LANES,
                         lane)[1] for s in range(threads)]
        for fn in fns:
            fn()
        if device == "cuda":
            torch.cuda.synchronize()
        rate, median = _threaded(fns, waves)
        out[f"{key}_waves_per_s"] = rate
        out[f"{key}_wave_ms_median"] = median
        if lane:
            ms = [1e3 * w for w in _walls(fns[0], waves)]
            out["alone_waves_per_s"] = len(ms) / (sum(ms) / 1e3)
            out["alone_wave_ms_median"] = statistics.median(ms)
        del fns
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="storm,spi,wave,lanes",
                    help="comma-separated paths to run (default: all)")
    ap.add_argument("--out", help="also write the result as JSON here")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    runs = {"storm": storm_breakdown, "spi": spi_breakdown,
            "wave": wave_breakdown, "lanes": lanes_breakdown}
    if any(p not in runs for p in paths):
        ap.error(f"--paths takes {','.join(runs)}")
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    res = {"card": card, "torch": torch.__version__}
    for path in paths:
        res[path] = runs[path]()
    for path in [p for p in ("storm", "spi") if p in res]:
        r = res[path]
        print(f"{path}: {r['wall_ms_per_step']:.3f} ms/step wall, "
              f"{r['device_ms_per_step']:.3f} ms/step device, device busy "
              f"{r['device_busy_share']:.1%} of "
              f"{r['profiled_wall_ms_per_step']:.3f} ms profiled, "
              f"{r['decisions_per_s']:.0f} decisions/s, accept kernel "
              f"{r['accept_kernel_us_per_step']:.1f} us/step in "
              f"{r['accept_launches_per_step']:.0f} launches "
              f"({r['accept_kernel_share_of_device']:.2%} of device time), "
              f"commit kernel {r['commit_kernel_us_per_step']:.1f} us/step "
              f"in {r['commit_launches_per_step']:.0f} launches "
              f"({r['commit_kernel_share_of_device']:.2%}), propose kernel "
              f"{r['propose_kernel_us_per_step']:.1f} us/step in "
              f"{r['propose_launches_per_step']:.0f} launches "
              f"({r['propose_kernel_share_of_device']:.2%}), accept-reply "
              f"kernel {r['accept_reply_kernel_us_per_step']:.1f} us/step in "
              f"{r['accept_reply_launches_per_step']:.0f} launches "
              f"({r['accept_reply_kernel_share_of_device']:.2%}), "
              f"wave kernels {r['wave_kernel_us_per_step']:.1f} us/step in "
              f"{r['wave_launches_per_step']:.0f} launches "
              f"({r['wave_kernel_share_of_device']:.2%}) [{card}]")
        for k in r["top_kernels"]:
            print(f"  {k['device_us_per_step']:10.1f} us "
                  f"{k['share_of_device']:6.1%} x{k['calls_per_step']:.0f}"
                  f"  {k['name']}")
    if "wave" in res:
        r = res["wave"]
        print(f"wave: {r['lanes']} lanes on a {r['capacity']}-row slab: "
              f"{r['alone_ms_median']:.3f} ms median wall alone, "
              f"{r['together_ms_median']:.3f} ms with {r['threads']} "
              f"engine threads, {r['beside_python_ms_median']:.3f} ms "
              f"beside one Python-only thread "
              f"({r['beside_python_short_interval_ms_median']:.3f} ms at a "
              f"tenth of the {r['switch_interval_s']} s switch interval); "
              f"device {r['device_ms_per_wave']:.3f} ms a wave, "
              f"busy {r['device_busy_share']:.1%} of "
              f"{r['profiled_wall_ms_per_wave']:.3f} ms profiled; "
              f"{r['aten_ops_per_wave']:.0f} aten ops and "
              f"{r['device_events_per_wave']:.0f} device events a wave "
              f"[{card}]")
        for k, n in sorted(r["cuda_runtime_calls_per_wave"].items()):
            print(f"  {n:8.2f} a wave  {k}")
    if "lanes" in res:
        r = res["lanes"]
        print(f"lanes: {r['lanes']} lanes a wave on {r['capacity']}-row "
              f"slabs from {r['threads']} threads: plain slabs "
              f"{r['plain_waves_per_s']:.1f} waves/s in all "
              f"({r['plain_wave_ms_median']:.3f} ms median wall), lane "
              f"slabs {r['lane_waves_per_s']:.1f} waves/s "
              f"({r['lane_wave_ms_median']:.3f} ms); one lane slab alone "
              f"{r['alone_waves_per_s']:.1f} waves/s "
              f"({r['alone_wave_ms_median']:.3f} ms) [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"card": card, **{
        f"{p}_decisions_per_s": res[p]["decisions_per_s"]
        for p in ("storm", "spi") if p in res}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
