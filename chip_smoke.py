#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gigapaxos_tpu_torch``).

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain torch version on the card, then drives the
port's main path at the scale users run it — 1,048,576 groups, window 16,
3 replicas — through the two entry points the repo uses:

1. device and build: the card's name and power limit, one ``nvcc`` per
   kernel source (all started together), the ptxas report;
2. kernel vs plain version on the card: the accept kernel and
   ``accept_reference`` on identical clones of a G=2^20, W=16 state with
   inactive rows, advanced cursors and promised ballots, at B = 1, 8, 64,
   512, 4096, 4099 and 2^18 lanes over several seeds, at B = 2^21 (more
   lanes than the co-resident grid holds), on 4096 lanes crowded onto 64
   rows (the whole-batch ballot max decides), on phase 5's G=2^17 slab
   and on phase 8's G=2^15 lane slab at each bucket of the runtime's
   ladder {8, 64, 512, 4096} with live lanes padded as
   ``ColumnarBackend`` pads a wave, and on the storm's lanes —
   ``bal``, ``acc`` and all four output rows must be bit-identical;
   times per call (the storm's lanes also with L2 cold) and the byte
   bound; the storm's commit kernel (``commit.cu``) and
   ``commit_reference`` on identical clones of a G=2^20, W=16 state with
   inactive rows, advanced cursors and decided slots behind a gap at
   each cursor, at B = 1, 8, 4096, 4099 and 2^18 over several seeds
   (past 8 also half live and padded as the backend pads), at B = 2^21,
   on 4096 lanes crowded onto 64 rows (gaps closed out of lane order
   across CTAs), on the storm's lanes and with cursors near INT32_MAX
   (the window wraps) — ``dec``, ``exec_cursor`` and all four output
   rows on every lane bit-identical — with times (L2 warm and cold),
   the plain version's time, the byte bound and the launch floor (an
   empty kernel launched as it is); the propose kernel (``propose.cu``,
   its run rank hand-written, no sort) and ``propose_reference`` on
   identical clones of a G=2^20, W=16 state with inactive,
   non-coordinator and phase-1-pending rows and ``next_slot`` up to W
   past each cursor, at B = 1, 8, 64, 512, 4096, 4099 and 2^18 over
   several seeds (past 8 also half live and padded), at B = 2^21, on
   4096 lanes on one row and 2^18 lanes on 64 rows (ranks past the
   window, a row's list walked across the grid), across the run rank's
   epoch wrap, on the storm's lanes, with slots near INT32_MAX and on
   phase 5's slab at every bucket, padded — ``next_slot``, ``prop`` and
   all five output rows on every lane bit-identical — with the same
   times, bound and floor; the accept-reply kernel (``accept_reply.cu``,
   one grid barrier, the propose's run rank by (row, slot)) and
   ``accept_reply_reference`` on identical clones of a G=2^20, W=16
   coordinator state with rows not coordinators or with phase 1
   pending, columns holding other slots or already emitted, partial
   vote bitmaps and members 1, 3 and 5, at B = 1, 8, 64, 512, 4096, 4099
   and 2^18 over several seeds (past 8 also half live, padded and
   packed), at B = 2^21, on 4096 lanes on 64 rows (acks beside
   preempting nacks of their rows), on keys whose three lanes lie in
   three tiles (the first not matching, quorum crossed by the third),
   across the shared workspace's epoch wrap in a propose between two
   accept-replies, on the storm's lanes, with slots near INT32_MAX and
   on phase 5's slab at every bucket, padded and packed — ``prop``,
   ``is_coord``, ``coord_active`` and all six output rows on every lane
   bit-identical — with the same times, bound and floor; the runtime's
   two wave kernels
   (``wave.cu``: the acceptor wave, accept then commit; the coordinator
   wave, propose, own accept and own vote, then the replies' votes and
   own commit) against their torch
   bodies on phase 5's and phase 8's slabs at every bucket over several
   seeds, with both halves and with each half alone, and, each half
   alone too, at the seams of their launch geometry (one CTA up to 512
   lanes, one cluster of 8 CTAs above): 4096 lanes on 64 rows, on one
   row, on 8 rows (a key repeats across the cluster's CTAs) and on rows
   of their own (no key repeats), 512 live lanes in the last CTA's range
   of 4096, and 512 of 512 lanes live — every state plane and every
   live output lane bit-identical — with device times, a byte bound
   counted from each wave's own data and the launch floor (an empty
   kernel at the same geometry), and one fused wave of each submitted under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); then
   storm steps and SPI waves at a small size on the card against the
   same calls on the CPU (the plain path the CPU tests hold against the
   JAX package) — every result and state plane equal; and
   ``prepare`` and ``install_coordinator`` (torch-op bodies, the
   takeover's phase 1) on the card against the CPU on phase 5's slab at
   every bucket, then one ``ColumnarBackend.prepare`` of 33,334 rows
   (chunked), the install of its acked rows and the pause path's row
   snapshots and restores — bit-identical;
3. the decide storm: ``make_fleet(2**20, 16, R=3)`` and several
   ``decide_storm_step`` calls at B = 2^18, each step's propose (the
   propose kernel), three accept-replies (the accept-reply kernel) and
   three commits (the commit kernel) under
   ``torch.cuda.set_sync_debug_mode("error")``
   — every step decides every granted lane, the replicas' ``dec`` planes
   agree, and ``exec_cursor`` matches a recount from the lanes;
4. the SPI engine: three ``ColumnarBackend(2**20, 16)`` run the
   propose → accept ×3 → accept_reply ×3 → commit ×3 pipeline at
   B = 16384 lanes a wave (four 4096-lane chunks), plus fused
   ``accept_commit_submit``/``collect`` waves — every granted request is
   decided exactly once;
5. the node runtime, every fused wave one wave-kernel launch a chunk,
   the repo's config 2 (``bench.py``: ``throughput
   --backend columnar --groups 100000 --capacity 131072 --requests 4000
   --concurrency 448 --pipeline``): three ``PaxosNode``s in this process
   on loopback sockets, each on its own ``ColumnarBackend(2**17, 16)``
   on the card, 100,000 groups of 3 members, ``CounterApp``, the
   pipelined worker and fused waves, failure detection (3 s) and the
   congestion guard at the package defaults, the deactivator off; 4000
   client requests through
   ``PaxosEmulation.run_load_fast`` at depth 448 — every request answered
   with status 0, the replicas' counts, digests and ``exec_cursor`` in
   agreement, the host C++ hot path loaded (never its Python fallback),
   every node thread ended after ``stop`` and no JAX in the process;
6. failover at config 2: the same three nodes and 100,000 groups with
   the flight recorder armed on every node (no age eviction), failure
   detection at the defaults, the deactivator off (the phase reads every
   group off the slab), 2000 requests at depth 64 (no coordinator
   installed before the kill), node 0 killed, node 1 installs itself
   for every group node 0 led (about 33,000) through prepare and install
   on the card within 120 s, then 2000 more requests through the
   survivors — every request answered with status 0, the survivors'
   counts, digests and ``exec_cursor`` in agreement, the sampled takeover
   rows led by node 1, a wave kernel launched after the kill;
7. replay on the card: ``tests/data/reference.gpbb``,
   ``tests/data/failover_ref.gpbb`` and ``tests/data/lanes_ref.gpbb``
   (all written by the JAX package, the second a takeover, the third
   four engine lanes) and node 1's capture from phase 6 (100,000
   groups, nothing evicted, the takeover's prepare waves verified) each
   replay ``MATCH`` through the port's node, with a wave kernel
   launched in each;
8. config 2 at four engine lanes (``ENGINE_SHARDS=4``, ``bench.py``'s
   ``min(4, cpus)``): phase 5's cluster and load, failure detection at
   300 s and the congestion guard off, with every node's
   2^17 rows in four 2^15-row slabs, each on a CUDA stream of its own,
   and every node's stats listener on (``STATS_PORT=0``) — every request
   answered with status 0, the replicas in agreement, four WAL segments
   a node, every lane's slab submitting waves on its own non-default
   stream; then each node's ``/engine``, ``/engine/kernels`` and
   ``/metrics`` scraped live (four lanes, exact slab bytes equal to
   phase 5's, a valid exposition) and their cluster merge (every node
   up);
9. config 4 through the control plane (``bench.py:747-750`` →
   ``gigapaxos_tpu/testing/main.py:369-447``): 3 actives and 3
   reconfigurators (``ReconfigurableNode``s in this process on loopback),
   each on a ``ColumnarBackend(2**16, 16)`` on the card, ``NoopApp``,
   failure detection and the guard at the defaults; 10,000 names
   created through ``ReconfigurableAppClient.create_names`` in chunks of
   2048, 4 in flight, then deleted through ``delete_names`` — every
   create and delete acknowledged within the client's 120 s, 256 sampled
   names with a row on each of their 3 actives after the creates (and a
   request to 64 of them decided and answered) and on none after the
   deletes (the epoch FSM's stop decisions and batched drops); it prints
   ops/s, each half apart, the ``w.*`` stage totals, elections, sheds and
   re-driven accepts;
9b. the port's entry points as processes: ``python -m
   gigapaxos_tpu_torch.server`` for 3 actives and 1 reconfigurator (the
   chat app on the columnar backend on the card, each with a stats
   listener), a room created, posted to, read and deleted through
   ``python -m gigapaxos_tpu_torch.client_cli``, and each server's
   ``/engine/kernels`` scraped: one server at least reports accept
   kernel launches (``cuda:accept``); every server is stopped on the way
   out, and one that dies fails the phase with its stderr;
10. the bench CLI (``python -m gigapaxos_tpu_torch.testing.main``, run
   in this process through ``run(argv)``, each mode from the package
   defaults) with the reference bench's own arguments: ``scale
   --requests 1000000`` (one node holds 1,000,000 groups and answers the
   last one), config 5b (``failover --single-coordinator --groups 100000
   --requests 1000``: 5 nodes, node 0 leads every group and is killed),
   config 2's knee sweep (``throughput --backend columnar --groups 100000
   --capacity 131072 --requests 4000 --concurrency 448 --pipeline
   --sweep``) and the same with ``--multiproc`` (three server processes
   on the card) — every request answered with status 0, the takeover
   complete, every group made, the tail status 0, kernel launches in each
   row's engine rollup, every node thread ended;
11. the chaos drill (``python -m gigapaxos_tpu_torch.chaos --seed 1``, in
   this process, the default six scenarios on the columnar engine on the
   card) — every row holds all five invariants with the fault schedule
   the reference recorded for seed 1 (``CHAOS_r02.json``).

The kernels' launch counters, reset just before each of phases 3 to 11
(each mode of phase 10) and read just after, must show that those paths
went through their kernels: exact counts of the propose, accept,
accept-reply and commit kernels and of no wave kernel in the storm, of
the propose kernel (plain propose waves), the accept kernel (plain
accept waves), the accept-reply kernel (plain accept_reply waves), the
acceptor wave kernel (commits and fused acceptor waves) and no commit
kernel in the SPI phase, no accept-reply launch in phases 5 to 11 (the
runtime's replies ride the coordinator wave), each wave kernel at
least once
in phases 5, 8 and 11, one of them at least after the kill and in each
replay, the accept kernel and the acceptor wave kernel in phase 9, and a
launch in every mode of phase 10; phases 5, 8 and 9 also print each wave
kernel's launches by bucket.

It prints one JSON line listing every kernel (route, source, the TPU
kernel it replaces, launches on the main path, error against the plain
version, times, bound), the ``nvidia-smi`` name/power-limit line, and as
its last line ``{"ok": true, "device": {...}}``.  Any failed phase ends
the run with a non-zero exit and no result; so does a machine with no
CUDA device or a directory without the port beside this script.

Run: ``python3 chip_smoke.py`` from the root of the repo, on one card.
``--runtime-only cuda|cpu`` runs phase 5 alone, with the engines on the
card or on its host's CPU (the same drive, no kernel), to tell the host's
share of the runtime's time from the card's.  ``--failover-only`` runs
phases 6 and 7 alone; ``--lanes-only`` runs phases 5 and 8 alone, one
lane against four.  ``--defaults`` runs phases 5 and 8 with failure
detection and the congestion guard at the package defaults (phase 8
pins them otherwise; the deactivator stays off) and reports what they
did (answers, elections, sheds, agreement) rather than failing on it.
``--churn-only`` runs phases 9 and 9b alone.  ``--main-only`` runs phase
10 alone, with ``scale --requests 1000000 --restart`` (recovery at 1M)
in place of its scale run and configs 5 and 6 besides (``bench.py:752``,
``:776-780``), which the whole run leaves out for its time;
``--chaos-only`` runs phase 11 alone, after the kernels are built and
one fused wave of each kind has run; ``--out FILE`` writes their rows
whole.
``--wave-ab DIR [--out FILE]`` times the wave kernels of an older
checkout unpacked in DIR (``git archive <rev> gigapaxos_tpu_torch``)
against this tree's in one process, in turns (parent, this, this,
parent), on phase 2's timed chunks and each half alone, both held
bit-exact first.  ``--storm-ab DIR [--out FILE]`` runs phase 3 of an
older checkout unpacked in DIR (``git archive <rev>``, its
``chip_smoke.py`` included) and of this tree in turns (parent, this,
this, parent), a process a run, and prints each run's decisions/s.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

G_FULL, W_FULL, R_FULL = 1 << 20, 16, 3
STORM_B, STORM_STEPS = 1 << 18, 4
SPI_B, SPI_ITERS, SPI_FUSED_ITERS = 16384, 10, 2
# phase 5: bench.py's config 2 (3 replicas, 100K groups, capacity 2^17)
RT_NODES, RT_GROUPS, RT_CAPACITY, RT_WINDOW = 3, 100_000, 1 << 17, 16
# the load's time limit, about two minutes; every request must be
# answered within it.  Failure detection (3 s) and the congestion guard
# (PC.INTAKE_BACKLOG_LIMIT, 2048) run at the package defaults: a live
# peer suspected, or a request shed ("retry", which the load generator
# counts as an error), fails the phase
RT_REQUESTS, RT_DEPTH, RT_TIMEOUT_S = 4000, 448, 120.0
# the deactivator (PC.PAUSE_IDLE_S, 60 s) pauses a group idle that long:
# its state leaves the slab and the app (CounterApp.restore(name, b""))
# for the pause table.  On a slow host a group answered early in the
# load is idle for a minute before the followers have executed the last
# requests, and its count then leaves the tally the phase waits on and
# checks.  Off for the phase, as in phase 6: the phase reads every
# group's count, digest and exec_cursor off the app and the slab
RT_PAUSE_IDLE_S = 0.0
# phase 6: config 2 loses its coordinator.  Failure detection runs at
# the defaults, the congestion guard is off (the survivors take the dead
# node's clients' retransmits; the phase holds every request to an
# answer with status 0, as the reference's pipelined e2e test sets the
# guard).  The deactivator is off: a group idle for PAUSE_IDLE_S
# leaves the slab (its state then lives in the pause table, held by
# tests/test_torch_failover.py and phase 2's row checks), and the phase
# reads every group's state off the slab.  These tick-driven settings
# decide what the replay of the phase's capture does, and the manifest
# does not hold them, so phase 7 replays under the same values
FO_REQUESTS, FO_DEPTH, FO_TIMEOUT_S = 2000, 64, 120.0
FO_KNOBS = {"PING_INTERVAL_S": 0.5, "FAILURE_TIMEOUT_S": 3.0,
            "PAUSE_IDLE_S": 0.0}
FO_VICTIM, FO_SUCCESSOR = 0, 1
FO_BACKLOG_LIMIT = 0
# phase 8: config 2 at four engine lanes (bench.py measures ENGINE_SHARDS
# at min(4, cpus); README "Scaling out a node"): each node's 2^17 rows in
# four 2^15-row slabs, with phase 5's load and limits.  Failure detection
# at 300 s and the congestion guard off: at four lanes the runtime can
# still fall into a re-drive storm whose catch-up sync requests flood
# each node's loop until the load's time limit (PERF.md §5, lanes;
# ROADMAP F2); the phase measures the lanes' decide path, and no peer is
# suspected and no request shed within it.  --defaults runs it at the
# package defaults
LANES_FAILURE_TIMEOUT_S, LANES_BACKLOG_LIMIT = 300.0, 0
LANES = 4
LANE_CAPACITY = RT_CAPACITY // LANES
FO_BLACKBOX_MB = 256  # every node's ring holds the whole phase
# phase 2: one backend.prepare of about node 0's share of config 2's
# groups, which the backend splits into 4096-lane chunks
FO_PREPARE_ROWS = 33_334
PAUSED_ROWS = 64  # rows phase 2 snapshots and restores, as a pause does
# phase 7: the committed captures the JAX package wrote, with the failure
# detection each was recorded under (the defaults where none is given)
REPLAY_REFS = (("tests/data/reference.gpbb", {}),
               ("tests/data/failover_ref.gpbb",
                {"PING_INTERVAL_S": 0.15, "FAILURE_TIMEOUT_S": 1.0}),
               ("tests/data/lanes_ref.gpbb", {}))
# phase 9: config 4 (bench.py:747-750 -> testing/main.py:369-447, its
# defaults :713-724): 3 actives and 3 reconfigurators (ids 100-102) in
# this process on loopback, each a ColumnarBackend(2^16, 16); NoopApp,
# SYNC_WAL off, pings every 0.05 s, failure detection and the guard at
# the defaults; 10,000 names created, then deleted, through the control
# plane in chunks of 2048, 4 in flight, within the client's 120 s
CHURN_ACTIVES, CHURN_RCS, CHURN_CAPACITY = 3, 3, 1 << 16
CHURN_NAMES, CHURN_CHUNK, CHURN_INFLIGHT = 10_000, 2048, 4
CHURN_TIMEOUT_S = 120.0
# names checked for rows on their actives, and the ones sent a request
CHURN_SAMPLE, CHURN_PROBE, CHURN_SEED = 256, 64, 9
# phase 9b: the server processes' time to listen (each reaches the card
# and loads the built libraries) and the client's timeout
CLI_BOOT_S, CLI_TIMEOUT_S = 120.0, 30.0
# phase 10: the bench CLI (gigapaxos_tpu_torch/testing/main.py) with the
# reference bench's own arguments at full width, in this process but for
# the replicas as processes: the "giga" capability, 1,000,000 groups live
# in one node (BASELINE.json config 3 in the runtime); config 5b, 100,000
# groups all led by node 0 of 5, node 0 killed (bench.py:755-758);
# config 2's knee over the depth ladder under p99 <= 500 ms
# (bench.py:725-729; the ladder stops at --concurrency, 448); config 2
# with each replica a `python -m gigapaxos_tpu_torch.server` process
MAIN_SCALE = ("scale", "--requests", "1000000")
MAIN_KNEE = ("throughput", "--backend", "columnar", "--groups", "100000",
             "--capacity", "131072", "--requests", "4000", "--concurrency",
             "448", "--pipeline")
MAIN_MODES = (
    ("scale", MAIN_SCALE),
    ("5b", ("failover", "--single-coordinator", "--groups", "100000",
            "--requests", "1000")),
    ("knee", MAIN_KNEE + ("--sweep",)),
    ("multiproc", MAIN_KNEE + ("--multiproc",)))
# --main-only also runs what the whole run's time limit leaves out:
# recovery at 1M groups (scale --restart, in place of the plain scale),
# config 5 (bench.py:752) and config 6 on the columnar engine
# (bench.py:776-780, without --trials)
MAIN_ONLY_MODES = (("scale", MAIN_SCALE + ("--restart",)),) + \
    MAIN_MODES[1:] + (
        ("5", ("failover", "--requests", "5000")),
        ("6", ("throughput", "--groups", "1", "--requests", "6000",
               "--concurrency", "128", "--sweep", "--pipeline")))
# phase 11: the chaos drill's fault schedules for seed 1, as the
# reference recorded them
CHAOS_REFERENCE = "CHAOS_r02.json"
PARITY_BS = (1, 8, 64, 512, 4096, 4099, 1 << 18)
# the runtime's waves: ColumnarBackend pads n live lanes to the least
# bucket of this ladder that holds them, on phase 5's 2^17-row slab and
# phase 8's 2^15-row lane slabs
RT_BUCKETS = (8, 64, 512, 4096)
PARITY_SEEDS = (0, 1, 2)
BIG_B = 1 << 21  # beyond the co-resident grid: grid-stride rounds
CONTENDED = (4096, 64)  # lanes, rows
TIMING_REPS = 30
# device_ms's head start, in the card's clock cycles: long enough for
# the host to enqueue a state restore of eight copies and a wave call
SLEEP_CYCLES = 1_000_000
FLUSH_BYTES = 128 << 20  # > 2x the H100's 50 MB L2
# device-memory rate of the card for the byte bound (H100 SXM data
# sheet; the PCIe part is slower)
HBM_BYTES_PER_S = {"pcie": 2.0e12, "default": 3.35e12}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def info(msg: str) -> None:
    print(msg, flush=True)


KERNEL_NAMES = ("accept", "commit", "propose", "accept_reply",
                "acceptor_wave", "coordinator_wave")


def _wrappers():
    from gigapaxos_tpu_torch.ops import wave_cuda
    from gigapaxos_tpu_torch.ops.accept_cuda import accept
    from gigapaxos_tpu_torch.ops.accept_reply_cuda import accept_reply
    from gigapaxos_tpu_torch.ops.commit_cuda import commit
    from gigapaxos_tpu_torch.ops.propose_cuda import propose
    return (accept, commit, propose, accept_reply) + wave_cuda.KERNELS


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0, and the wave kernels'
    counts by bucket."""
    from gigapaxos_tpu_torch.ops import wave_cuda
    for k in _wrappers():
        k.launches = 0
    for k in wave_cuda.KERNELS:
        k.by_bucket = {}


def launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {k.name: k.launches for k in _wrappers()}


def bucket_launches() -> dict:
    """The wave kernels' launches by the chunk's lane count (the
    runtime's bucket), by kernel name."""
    from gigapaxos_tpu_torch.ops import wave_cuda
    return {k.name: dict(sorted(k.by_bucket.items()))
            for k in wave_cuda.KERNELS}


def require_waves(counts: dict, what: str, each: bool) -> None:
    """The wave kernels were launched on a path: each of them (``each``)
    or one of them at least."""
    got = [counts["acceptor_wave"], counts["coordinator_wave"]]
    if (min(got) if each else sum(got)) < 1:
        raise AssertionError(f"{what}: wave kernel launches {got} (acceptor,"
                             f" coordinator): the path did not run "
                             f"{'each' if each else 'either'} of them")


# -- phase 1 -----------------------------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` says."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 2 -----------------------------------------------------------------


def parity_state(G, W, gen, active_share=0.9):
    """A state with inactive rows, advanced cursors, promised ballots and
    a filled accepted window."""
    from gigapaxos_tpu_torch.ops.types import make_state
    dev = gen.device  # the card's, or the CPU's in a rehearsal
    st = make_state(G, W, dev)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    st.active = torch.rand(G, generator=gen, device=dev) < active_share
    st.exec_cursor = ri(0, 1000, (G,))
    st.bal = ri(0, 1 << 16, (G,))
    st.acc = ri(-1, 1 << 20, (G, W, 4))
    return st


def clone_state(st):
    """The state with its two planes the accept writes copied."""
    return dataclasses.replace(st, bal=st.bal.clone(), acc=st.acc.clone())


def _req_ids(B, gen, dev):
    return (torch.randint(-(1 << 31), (1 << 31) - 1, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
            for _ in range(2))


def parity_lanes(st, B, gen):
    """B lanes with distinct (row, slot) pairs (the kernel's
    precondition): stale, in-window and out-of-window slots, ballots
    below, at and above the promise, ~10% invalid lanes."""
    dev = st.device
    G = st.G
    span = 64  # slot offsets: [-8, 0) stale, [0, W) window, rest beyond
    keys = torch.randint(0, G * span, (2 * B + 64,), generator=gen,
                         device=dev, dtype=torch.int64).unique()
    keys = keys[torch.randperm(keys.numel(), generator=gen,
                               device=dev)[:B]]
    assert keys.numel() == B
    g = (keys // span).to(torch.int32)
    slot = st.exec_cursor[g.long()] + (keys % span).to(torch.int32) - 8
    bal = st.bal[g.long()] + torch.randint(-2, 3, (B,), generator=gen,
                                           device=dev, dtype=torch.int32)
    rlo, rhi = _req_ids(B, gen, dev)
    valid = torch.rand(B, generator=gen, device=dev) < 0.9
    return g, slot, bal, rlo, rhi, valid


def padded_lanes(st, n, B, gen):
    """n live lanes (``parity_lanes``' mix of slots and ballots, every one
    valid) padded to B as ``ColumnarBackend`` pads a wave: row 0,
    ``NO_SLOT``, ``NO_BALLOT``, request id 0, invalid."""
    from gigapaxos_tpu_torch.ops.types import NO_BALLOT, NO_SLOT
    g, slot, bal, rlo, rhi, _ = parity_lanes(st, n, gen)

    def pad(t, fill):
        return torch.cat([t, torch.full((B - n,), fill, dtype=t.dtype,
                                        device=t.device)])

    valid = torch.arange(B, device=st.device) < n
    return (pad(g, 0), pad(slot, NO_SLOT), pad(bal, NO_BALLOT), pad(rlo, 0),
            pad(rhi, 0), valid)


def contended_lanes(st, B, rows, gen):
    """B lanes on only ``rows`` rows (B / rows lanes a row, distinct
    slots), ballots spread around the promise: the whole-batch ballot
    max, not each lane's own ballot, decides most lanes."""
    dev = st.device
    per = B // rows
    assert per * rows == B
    r = torch.randperm(st.G, generator=gen, device=dev)[:rows]
    g = r.repeat_interleave(per).to(torch.int32)
    offs = torch.argsort(torch.rand(rows, per, generator=gen, device=dev),
                         dim=1).reshape(-1).to(torch.int32)
    slot = st.exec_cursor[g.long()] + offs - 8
    bal = st.bal[g.long()] + torch.randint(-32, 33, (B,), generator=gen,
                                           device=dev, dtype=torch.int32)
    rlo, rhi = _req_ids(B, gen, dev)
    valid = torch.rand(B, generator=gen, device=dev) < 0.9
    perm = torch.randperm(B, generator=gen, device=dev)
    return tuple(t[perm] for t in (g, slot, bal, rlo, rhi, valid))


def storm_lanes(st, B, gen):
    """The storm's steady state on an all-active state: B distinct random
    rows, every lane valid, in the window and at the promise, so every
    lane stores."""
    dev = st.device
    g = torch.randperm(st.G, generator=gen, device=dev)[:B].to(torch.int32)
    slot = st.exec_cursor[g.long()] + torch.randint(
        0, st.W, (B,), generator=gen, device=dev, dtype=torch.int32)
    bal = st.bal[g.long()]
    rlo, rhi = _req_ids(B, gen, dev)
    return g, slot, bal, rlo, rhi, torch.ones(B, dtype=torch.bool,
                                              device=dev)


def l2_flusher():
    """A callable that writes ``FLUSH_BYTES`` on the card, evicting L2."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    return buf.zero_


def device_ms(fn, reps=TIMING_REPS, before=None) -> float:
    """Median device time of one call, from CUDA events around it, with
    the stream kept busy ahead of the call (``torch.cuda._sleep``, long
    enough for the host to enqueue ``before``, the events and the call)
    so the host's launch overhead is not counted as device time.
    ``before`` (say, an L2 flush) runs ahead of each timed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if before is not None:
            before()
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def accept_bytes(st0, lanes, out, bal_after) -> int:
    """Bytes the accept function must move for these lanes: each lane
    input read once, each output written once, each touched row's
    active/bal/exec_cursor read once, each raised ballot and each stored
    pvalue written once."""
    g, slot, bal, rlo, rhi, valid = lanes
    B = g.numel()
    gi = torch.where(valid, g, 0).long()
    rows = gi.unique()
    raised = int((bal_after[rows] != st0.bal[rows]).sum())
    stored = int(((out[0] != 0) & (out[1] == 0)).sum())
    return B * (5 * 4 + 1) + B * 4 * 4 + rows.numel() * (1 + 4 + 4) + \
        raised * 4 + stored * 16


def check_accept(base, lanes, what):
    """The kernel and ``accept_reference`` on identical clones of
    ``base``: ``out``, ``bal`` and ``acc`` must be bit-identical.
    Returns the max abs error (0) and the kernel's output and state."""
    from gigapaxos_tpu_torch.ops.accept_cuda import accept, accept_reference
    st_k, st_r = clone_state(base), clone_state(base)
    out_k = accept(st_k, *lanes)
    out_r = accept_reference(st_r, *lanes)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in (("out", out_k, out_r), ("bal", st_k.bal, st_r.bal),
                       ("acc", st_k.acc, st_r.acc)):
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"accept kernel != accept_reference: "
                                 f"{name} ({what}, max abs err {err})")
    return max_err, out_k, st_k


def time_accept(base, lanes, out, st, hbm, before=None):
    """Kernel and plain times of one call, and the byte bound of the
    call that gave ``out`` and ``st`` from ``base``."""
    from gigapaxos_tpu_torch.ops.accept_cuda import accept, accept_reference
    nbytes = accept_bytes(base, lanes, out, st.bal)
    st_t = clone_state(base)
    ms = device_ms(lambda: accept(st_t, *lanes), before=before)
    plain_ms = device_ms(lambda: accept_reference(st_t, *lanes),
                         before=before)
    n_store = int(((out[0] != 0) & (out[1] == 0)).sum())
    return {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / hbm * 1e3, "stores": n_store}


def phase_parity(name_line):
    hbm = HBM_BYTES_PER_S["pcie" if "PCIe" in name_line else "default"]
    rows = {}
    max_err = 0
    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = parity_state(G_FULL, W_FULL, gen)
        for B in PARITY_BS:
            lanes = parity_lanes(base, B, gen)
            err, out, st = check_accept(base, lanes, f"seed {seed}, B={B}")
            max_err = max(max_err, err)
            if seed == PARITY_SEEDS[0]:
                rows[str(B)] = time_accept(base, lanes, out, st, hbm)
        if seed == PARITY_SEEDS[0]:
            # past the co-resident grid: the grid-stride rounds
            lanes = parity_lanes(base, BIG_B, gen)
            max_err = max(max_err, check_accept(
                base, lanes, f"seed {seed}, B={BIG_B}")[0])
            B, n_rows = CONTENDED
            lanes = contended_lanes(base, B, n_rows, gen)
            max_err = max(max_err, check_accept(
                base, lanes, f"contended, {B} lanes on {n_rows} rows")[0])
        del base
    # the runtime's shapes: phase 5's slab and phase 8's lane slab at
    # every bucket of the ladder, with a live share drawn anew per wave
    for G, key in ((RT_CAPACITY, "rt"), (LANE_CAPACITY, "lane")):
        for seed in PARITY_SEEDS:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            base = parity_state(G, RT_WINDOW, gen)
            for B in RT_BUCKETS:
                n = int(torch.randint(B // 8 + 1, B + 1, (1,),
                                      generator=gen, device="cuda"))
                lanes = padded_lanes(base, n, B, gen)
                err, out, st = check_accept(
                    base, lanes, f"{key} slab (G={G}), seed {seed}, {n} "
                    f"of B={B}")
                max_err = max(max_err, err)
                if seed == PARITY_SEEDS[0]:
                    rows[f"{key}_{B}"] = dict(
                        time_accept(base, lanes, out, st, hbm), live=n)
            del base
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARITY_SEEDS[0])
    base = parity_state(G_FULL, W_FULL, gen, active_share=1.0)
    lanes = storm_lanes(base, STORM_B, gen)
    err, out, st = check_accept(base, lanes, "storm lanes")
    max_err = max(max_err, err)
    rows[f"storm_{STORM_B}"] = dict(
        time_accept(base, lanes, out, st, hbm, before=l2_flusher()),
        cold_l2=True)
    for k, r in rows.items():
        info(f"accept {k}: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
             f"({r['bytes']} B at {hbm / 1e12:.2f} TB/s), {r['stores']} "
             f"stores, bit-exact [{name_line}]")
    del base, lanes, out, st
    torch.cuda.empty_cache()
    return rows, max_err


# -- phase 2: the storm's commit kernel -------------------------------------

# the widths of PERF.md's commit row, and the seams of the accept-reply's
# paths
COMMIT_BS = (1, 8, 64, 512, 513, 4096, 4097, 4099, 1 << 18)
INT32_MAX = (1 << 31) - 1


def commit_state(G, W, gen, active_share=0.9, near_max=False):
    """``parity_state`` with decided slots ahead of each cursor behind a
    gap at it (each other column holds the slot a window earlier); with
    ``near_max`` the cursors lie in [INT32_MAX - 2W, INT32_MAX], where
    the window and the scan wrap."""
    st = parity_state(G, W, gen, active_share)
    dev = st.device
    if near_max:
        st.exec_cursor = INT32_MAX - torch.randint(
            0, 2 * W + 1, (G,), generator=gen, device=dev,
            dtype=torch.int32)
    k = torch.arange(W, dtype=torch.int32, device=dev)
    slots = st.exec_cursor[:, None] + k[None, :]  # wraps as int32
    decided = (torch.rand((G, W), generator=gen, device=dev) < 0.5) & \
        (k[None, :] >= 1)
    cols = (slots % W).long()
    st.dec[:, :, 0].scatter_(1, cols, torch.where(decided, slots, slots - W))
    for c in (1, 2):
        st.dec[:, :, c] = torch.randint(-(1 << 31), (1 << 31) - 1, (G, W),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
    return st


def commit_lanes(st, B, gen, lo=-4, hi=None):
    """B lanes with distinct (row, slot) pairs (the kernel's
    precondition) on random rows: offsets from the row's cursor in
    [lo, hi) (stale, in the window, beyond it), a third of them at 0
    (each closes its row's gap), ~10% invalid lanes."""
    dev = st.device
    hi = st.W + 4 if hi is None else hi
    span = hi - lo
    m = 2 * B + 64
    off = torch.where(torch.rand(m, generator=gen, device=dev) < 0.3, -lo,
                      torch.randint(0, span, (m,), generator=gen,
                                    device=dev))
    keys = (torch.randint(0, st.G, (m,), generator=gen, device=dev,
                          dtype=torch.int64) * span + off).unique()
    keys = keys[torch.randperm(keys.numel(), generator=gen,
                               device=dev)[:B]]
    assert keys.numel() == B
    g = (keys // span).to(torch.int32)
    slot = st.exec_cursor[g.long()] + (keys % span + lo).to(torch.int32)
    rlo, rhi = _req_ids(B, gen, dev)
    valid = torch.rand(B, generator=gen, device=dev) < 0.9
    return g, slot, rlo, rhi, valid


def padded_commit_lanes(st, n, B, gen):
    """n lanes of ``commit_lanes``, every one valid, padded to B as
    ``ColumnarBackend`` pads a wave: row 0, ``NO_SLOT``, request id 0,
    invalid."""
    from gigapaxos_tpu_torch.ops.types import NO_SLOT
    g, slot, rlo, rhi, _ = commit_lanes(st, n, gen)

    def pad(t, fill):
        return torch.cat([t, torch.full((B - n,), fill, dtype=t.dtype,
                                        device=t.device)])

    valid = torch.arange(B, device=st.device) < n
    return pad(g, 0), pad(slot, NO_SLOT), pad(rlo, 0), pad(rhi, 0), valid


def storm_commit_lanes(st, B, gen):
    """The storm's commits: B lanes on random rows (repeated), the lanes
    of a row on consecutive slots from its cursor in lane order (the
    proposer's run rank), those within the window valid, so the run of
    each row's stores closes from the cursor on."""
    dev = st.device
    g = torch.randint(0, st.G, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    gs, order = torch.sort(g.long(), stable=True)
    idx = torch.arange(B, device=dev)
    first = torch.ones(B, dtype=torch.bool, device=dev)
    first[1:] = gs[1:] != gs[:-1]
    start = torch.where(first, idx, 0).cummax(0).values
    rank = torch.empty(B, dtype=torch.int64, device=dev)
    rank[order] = idx - start
    slot = st.exec_cursor[g.long()] + rank.to(torch.int32)
    rlo, rhi = _req_ids(B, gen, dev)
    return g, slot, rlo, rhi, rank < st.W


def contended_commit_lanes(st, B, rows, gen):
    """``contended_lanes``' B lanes on ``rows`` rows (each row's slots
    from 8 below its cursor up, every window slot among them, lanes
    shuffled): each row's gap closes out of lane order, and its scan
    advances over slots other CTAs stored."""
    g, slot, _bal, rlo, rhi, valid = contended_lanes(st, B, rows, gen)
    return g, slot, rlo, rhi, valid


def clone_commit(st):
    """The state with its two planes the commit writes copied."""
    return dataclasses.replace(st, dec=st.dec.clone(),
                               exec_cursor=st.exec_cursor.clone())


def check_commit(base, lanes, what, kern=None):
    """The kernel (``kern``, else this tree's wrapper) and
    ``commit_reference`` on identical clones of ``base``: all four
    output rows on every lane (padding lanes read row 0's new cursor in
    both), ``dec`` and ``exec_cursor`` must be bit-identical.  Returns
    the max abs error (0), the reference's output and state."""
    from gigapaxos_tpu_torch.ops.commit_cuda import commit, commit_reference
    st_k, st_r = clone_commit(base), clone_commit(base)
    out_k = (kern or commit)(st_k, *lanes)
    out_r = commit_reference(st_r, *lanes)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in (("out", out_k, out_r), ("dec", st_k.dec, st_r.dec),
                       ("exec_cursor", st_k.exec_cursor,
                        st_r.exec_cursor)):
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"commit kernel != commit_reference: "
                                 f"{name} ({what}, max abs err {err})")
    return max_err, out_r, st_r


def commit_bytes(base, lanes, out, after) -> int:
    """Bytes the commit must move for these lanes, ``after`` being the
    state it left from ``base``: each lane input read once and each
    output written once; each touched row's ``active`` and
    ``exec_cursor`` read once; each stored decision written once (12 B);
    on each row that stored, the ``dec`` slot words its scan reads (the
    advance and the word that ends it, at most W); each raised cursor
    written once."""
    g, slot, rlo, rhi, valid = lanes
    B, W = g.numel(), base.W
    gi = torch.where(valid, g, 0).long()
    rows = gi.unique()
    stored = out[0] != 0
    scanned = gi[stored].unique()
    adv = after.exec_cursor[scanned].long() - base.exec_cursor[scanned].long()
    raised = int((after.exec_cursor != base.exec_cursor).sum())
    return B * (4 * 4 + 1) + B * 4 * 4 + rows.numel() * (1 + 4) + \
        int(stored.sum()) * 12 + 4 * int(torch.clamp(adv + 1, max=W).sum()) \
        + raised * 4


def time_commit(base, lanes, out, after, hbm):
    """Kernel times with L2 warm (the touched rows just restored) and
    cold (flushed after the restore), the plain version's time (warm),
    the launch floor (an empty kernel launched as the kernel is), each
    on ``base``'s rows restored before every timed call, and the byte
    bound of the call that gave ``out`` and ``after``."""
    from gigapaxos_tpu_torch.ops.commit_cuda import commit, commit_reference
    g, _slot, _rlo, _rhi, valid = lanes
    rows = torch.where(valid, g, 0).long().unique()
    saved_dec, saved_cur = base.dec[rows], base.exec_cursor[rows]
    st = clone_commit(base)

    def restore():
        st.dec.index_copy_(0, rows, saved_dec)
        st.exec_cursor.index_copy_(0, rows, saved_cur)

    flush = l2_flusher()

    def cold():
        restore()
        flush()

    nbytes = commit_bytes(base, lanes, out, after)
    return {"ms": device_ms(lambda: commit(st, *lanes), before=restore),
            "ms_cold": device_ms(lambda: commit(st, *lanes), before=cold),
            "plain_ms": device_ms(lambda: commit_reference(st, *lanes),
                                  before=restore),
            "floor_ms": device_ms(lambda: commit.floor(g.numel()),
                                  before=restore),
            "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
            "stores": int((out[0] != 0).sum())}


def phase_commit_parity(name_line):
    """The commit kernel against ``commit_reference`` on the card, on
    identical clones of a G=2^20, W=16 state with inactive rows,
    advanced cursors and decided slots behind a gap at each cursor: at
    ``COMMIT_BS`` over ``PARITY_SEEDS``, with lanes padded as the
    backend pads, at ``BIG_B`` (past the co-resident grid), on the
    contended lanes (4096 and 2^18 lanes on 64 rows), on the storm's
    lanes at 2^18 and ``BIG_B`` (an all-active state: every lane stores,
    so the second barrier never runs) and with cursors near INT32_MAX.
    Times at each width (seed 0), on the contended lanes and on the
    storm's lanes."""
    hbm = HBM_BYTES_PER_S["pcie" if "PCIe" in name_line else "default"]
    rows = {}
    max_err = 0
    checked = 0

    def held(base, lanes, what, key=None):
        nonlocal max_err, checked
        err, out, after = check_commit(base, lanes, what)
        max_err = max(max_err, err)
        checked += 1
        if key is not None:
            rows[key] = time_commit(base, lanes, out, after, hbm)

    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = commit_state(G_FULL, W_FULL, gen)
        first = seed == PARITY_SEEDS[0]
        for B in COMMIT_BS:
            held(base, commit_lanes(base, B, gen), f"seed {seed}, B={B}",
                 str(B) if first else None)
            if B > 8:
                held(base, padded_commit_lanes(base, B // 2, B, gen),
                     f"seed {seed}, {B // 2} of B={B} padded")
        if first:
            held(base, commit_lanes(base, BIG_B, gen),
                 f"seed {seed}, B={BIG_B}", str(BIG_B))
            B, n_rows = CONTENDED
            held(base, contended_commit_lanes(base, B, n_rows, gen),
                 f"contended, {B} lanes on {n_rows} rows",
                 f"contended_{B}")
            held(base, contended_commit_lanes(base, STORM_B, n_rows, gen),
                 f"contended, {STORM_B} lanes on {n_rows} rows",
                 f"{STORM_B}_on_{n_rows}")
        del base
        base = commit_state(G_FULL, W_FULL, gen, near_max=True)
        held(base, commit_lanes(base, STORM_B, gen, lo=-2,
                                hi=W_FULL + 2),
             f"seed {seed}, cursors near INT32_MAX, B={STORM_B}")
        del base
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARITY_SEEDS[0])
    base = commit_state(G_FULL, W_FULL, gen, active_share=1.0)
    for B in (STORM_B, BIG_B):  # every lane stores: no second barrier
        held(base, storm_commit_lanes(base, B, gen), f"storm lanes, B={B}",
             f"storm_{B}")
        if rows[f"storm_{B}"]["stores"] != B:
            raise AssertionError(f"commit storm lanes, B={B}: "
                                 f"{rows[f'storm_{B}']['stores']} stores")
    del base
    torch.cuda.empty_cache()
    for k, r in rows.items():
        info(f"commit {k}: kernel {r['ms']:.4f} ms (L2 warm), "
             f"{r['ms_cold']:.4f} ms (cold), plain {r['plain_ms']:.4f} ms, "
             f"bound {r['bound_ms']:.6f} ms ({r['bytes']} B at "
             f"{hbm / 1e12:.2f} TB/s), floor {r['floor_ms']:.4f} ms (an "
             f"empty kernel launched as it is), {r['stores']} stores, "
             f"bit-exact [{name_line}]")
    return rows, max_err, checked


# -- phase 2: the propose kernel --------------------------------------------

PROPOSE_BS = (1, 8, 64, 512, 4096, 4099, 1 << 18)
# many lanes on few rows: ranks past the window (throttled lanes) and a
# row's lanes in many tiles (its list walked across the grid)
PROPOSE_CROWDS = ((4096, 1), (1 << 18, 64))


def propose_state(G, W, gen, active_share=0.9, near_max=False):
    """``parity_state`` with coordinators (80% of rows, 85% of them with
    phase 1 complete), random ballots, ``next_slot`` in ``[exec_cursor,
    exec_cursor + W]`` (as the runtime keeps it: at most one lane writes
    a column a batch) and a filled proposal plane; with ``near_max`` the
    cursors lie in [INT32_MAX - 2W, INT32_MAX], where slots wrap."""
    st = parity_state(G, W, gen, active_share)
    dev = st.device
    if near_max:
        st.exec_cursor = INT32_MAX - torch.randint(
            0, 2 * W + 1, (G,), generator=gen, device=dev,
            dtype=torch.int32)
    st.is_coord = torch.rand(G, generator=gen, device=dev) < 0.8
    st.coord_active = st.is_coord & (
        torch.rand(G, generator=gen, device=dev) < 0.85)
    st.cbal = torch.randint(0, 1 << 20, (G,), generator=gen, device=dev,
                            dtype=torch.int32)
    st.next_slot = st.exec_cursor + torch.randint(
        0, W + 1, (G,), generator=gen, device=dev, dtype=torch.int32)
    st.prop = torch.randint(-(1 << 31), (1 << 31) - 1, (G, W, 4),
                            generator=gen, device=dev, dtype=torch.int32)
    return st


def propose_lanes(st, B, gen, rows=None, valid_share=0.9):
    """B lanes on random rows (or on ``rows``), repeated, random request
    ids, a share valid."""
    dev = st.device
    if rows is None:
        g = torch.randint(0, st.G, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    else:
        g = rows[torch.randint(0, rows.numel(), (B,), generator=gen,
                               device=dev)].to(torch.int32)
    rlo, rhi = _req_ids(B, gen, dev)
    return g, rlo, rhi, torch.rand(B, generator=gen, device=dev) < \
        valid_share


def padded_propose_lanes(st, n, B, gen):
    """n lanes of ``propose_lanes``, every one valid, padded to B as
    ``ColumnarBackend`` pads a wave: row 0, request id 0, invalid."""
    g, rlo, rhi, _ = propose_lanes(st, n, gen)

    def pad(t):
        return torch.cat([t, torch.zeros(B - n, dtype=t.dtype,
                                          device=t.device)])

    return pad(g), pad(rlo), pad(rhi), torch.arange(B, device=st.device) < n


def clone_propose(st):
    """The state with its two planes the propose writes copied."""
    return dataclasses.replace(st, next_slot=st.next_slot.clone(),
                               prop=st.prop.clone())


def check_propose(base, lanes, what):
    """The kernel and ``propose_reference`` on identical clones of
    ``base``: all five output rows on every lane (padding lanes read row
    0 in both), ``next_slot`` and ``prop`` must be bit-identical.
    Returns the max abs error (0), the reference's output and state."""
    from gigapaxos_tpu_torch.ops.propose_cuda import (propose,
                                                      propose_reference)
    st_k, st_r = clone_propose(base), clone_propose(base)
    out_k = propose(st_k, *lanes)
    out_r = propose_reference(st_r, *lanes)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in (("out", out_k, out_r),
                       ("next_slot", st_k.next_slot, st_r.next_slot),
                       ("prop", st_k.prop, st_r.prop)):
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"propose kernel != propose_reference: "
                                 f"{name} ({what}, max abs err {err})")
    return max_err, out_r, st_r


def propose_bytes(base, lanes, out) -> int:
    """Bytes the propose must move for these lanes: each lane input read
    once and each output written once; each touched row's ``active``,
    ``is_coord``, ``coord_active``, ``next_slot``, ``exec_cursor`` and
    ``cbal`` read once; each granted lane's ``prop`` column written once
    (16 B) and each row that granted its ``next_slot`` written once."""
    g, rlo, rhi, valid = lanes
    B = g.numel()
    gi = torch.where(valid, g, 0).long()
    granted = out[0] != 0
    return B * (3 * 4 + 1) + B * 5 * 4 + gi.unique().numel() * 15 + \
        int(granted.sum()) * 16 + gi[granted].unique().numel() * 4


def propose_ws_bytes(base, lanes, out) -> int:
    """The run rank's workspace traffic for these lanes (not in the
    bound: the function needs none of it): one list entry a (tile, row)
    of the lanes that can be granted (an 8 B head exchange, read and
    written, and a 16 B entry), its walk (8 B of head and 16 B an entry
    of its row's list) and its 4 B sum, and each such lane's 4 B read of
    the sum."""
    from gigapaxos_tpu_torch.ops.propose_cuda import THREADS
    g, rlo, rhi, valid = lanes
    can = out[0].bool() | out[2].bool()  # granted or throttled
    lane = torch.arange(g.numel(), device=g.device)
    rows = g.long()[can]
    ent = torch.unique((lane[can] // THREADS) * base.G + rows)
    per_row = torch.bincount(ent % base.G)
    walk = int((per_row.long() ** 2).sum())
    return ent.numel() * (16 + 16 + 8 + 4) + walk * 16 + int(can.sum()) * 4


def time_propose(base, lanes, out, hbm):
    """Kernel times with L2 warm (the touched rows just restored) and
    cold (flushed after the restore), the plain version's time (warm),
    the launch floor (an empty kernel launched as the kernel is), each
    on ``base``'s rows restored before every timed call, and the byte
    bound of the call that gave ``out``."""
    from gigapaxos_tpu_torch.ops.propose_cuda import (propose,
                                                      propose_reference)
    g, _rlo, _rhi, valid = lanes
    rows = torch.where(valid, g, 0).long().unique()
    saved_ns, saved_prop = base.next_slot[rows], base.prop[rows]
    st = clone_propose(base)

    def restore():
        st.next_slot.index_copy_(0, rows, saved_ns)
        st.prop.index_copy_(0, rows, saved_prop)

    flush = l2_flusher()

    def cold():
        restore()
        flush()

    nbytes = propose_bytes(base, lanes, out)
    return {"ms": device_ms(lambda: propose(st, *lanes), before=restore),
            "ms_cold": device_ms(lambda: propose(st, *lanes), before=cold),
            "plain_ms": device_ms(lambda: propose_reference(st, *lanes),
                                  before=restore),
            "floor_ms": device_ms(lambda: propose.floor(g.numel()),
                                  before=restore),
            "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
            "ws_bytes": propose_ws_bytes(base, lanes, out),
            "granted": int((out[0] != 0).sum()),
            "throttled": int((out[2] != 0).sum())}


def phase_propose_parity(name_line):
    """The propose kernel against ``propose_reference`` on the card, on
    identical clones of a G=2^20, W=16 state with inactive rows,
    non-coordinator rows, rows with phase 1 pending and ``next_slot``
    up to W past each cursor: at ``PROPOSE_BS`` over ``PARITY_SEEDS``
    (past 8 also half live and padded as the backend pads), at
    ``BIG_B`` (tiles past the co-resident grid), on ``PROPOSE_CROWDS``,
    on the storm's lanes (an all-active, all-coordinator state), with
    slots near INT32_MAX, once across the workspace's epoch wrap, and
    on the runtime's slab at every bucket with live lanes padded.
    Times at each width (seed 0), on the crowds, the storm's lanes and
    the slab's buckets."""
    from gigapaxos_tpu_torch.ops import rank_cuda
    hbm = HBM_BYTES_PER_S["pcie" if "PCIe" in name_line else "default"]
    rows = {}
    max_err = 0
    checked = 0

    def held(base, lanes, what, key=None):
        nonlocal max_err, checked
        err, out, _after = check_propose(base, lanes, what)
        max_err = max(max_err, err)
        checked += 1
        if key is not None:
            rows[key] = time_propose(base, lanes, out, hbm)

    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = propose_state(G_FULL, W_FULL, gen)
        first = seed == PARITY_SEEDS[0]
        for B in PROPOSE_BS:
            held(base, propose_lanes(base, B, gen), f"seed {seed}, B={B}",
                 str(B) if first else None)
            if B > 8:
                held(base, padded_propose_lanes(base, B // 2, B, gen),
                     f"seed {seed}, {B // 2} of B={B} padded")
        if first:
            held(base, propose_lanes(base, BIG_B, gen),
                 f"seed {seed}, B={BIG_B}", str(BIG_B))
            for B, n_rows in PROPOSE_CROWDS:
                on = torch.nonzero(base.active & base.coord_active)[:, 0]
                crowd = on[torch.randperm(on.numel(), generator=gen,
                                          device="cuda")[:n_rows]]
                held(base, propose_lanes(base, B, gen, rows=crowd),
                     f"{B} lanes on {n_rows} rows", f"{B}_on_{n_rows}")
            # the workspace's epoch wraps: every list head is cleared
            ws = rank_cuda.workspace(base.device, base.G)
            ws.epoch.fill_(-1)
            held(base, propose_lanes(base, 4099, gen),
                 f"seed {seed}, the epoch wrapping")
            if int(ws.epoch) != 1:
                raise AssertionError(f"propose: epoch {int(ws.epoch)} "
                                     "after the wrap, not 1")
        del base
        base = propose_state(G_FULL, W_FULL, gen, near_max=True)
        held(base, propose_lanes(base, STORM_B, gen),
             f"seed {seed}, slots near INT32_MAX, B={STORM_B}")
        del base
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARITY_SEEDS[0])
    base = propose_state(G_FULL, W_FULL, gen, active_share=1.0)
    base.is_coord.fill_(True)
    base.coord_active.fill_(True)
    base.next_slot.copy_(base.exec_cursor)
    held(base, propose_lanes(base, STORM_B, gen, valid_share=1.0),
         "storm lanes", f"storm_{STORM_B}")
    del base
    # the runtime's slab at every bucket, live lanes padded as
    # ColumnarBackend pads them
    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = propose_state(RT_CAPACITY, RT_WINDOW, gen)
        for B in RT_BUCKETS:
            n = int(torch.randint(B // 8 + 1, B + 1, (1,), generator=gen,
                                  device="cuda"))
            held(base, padded_propose_lanes(base, n, B, gen),
                 f"rt slab (G={RT_CAPACITY}), seed {seed}, {n} of B={B}",
                 f"rt_{B}" if seed == PARITY_SEEDS[0] else None)
        del base
    torch.cuda.empty_cache()
    for k, r in rows.items():
        info(f"propose {k}: kernel {r['ms']:.4f} ms (L2 warm), "
             f"{r['ms_cold']:.4f} ms (cold), plain {r['plain_ms']:.4f} ms, "
             f"bound {r['bound_ms']:.6f} ms ({r['bytes']} B at "
             f"{hbm / 1e12:.2f} TB/s; the run rank's workspace "
             f"{r['ws_bytes']} B more), floor {r['floor_ms']:.4f} ms (an "
             f"empty kernel launched as it is), {r['granted']} granted, "
             f"{r['throttled']} throttled, bit-exact [{name_line}]")
    return rows, max_err, checked


# -- phase 2: the accept-reply kernel ---------------------------------------

# both paths and their seams: one CTA up to 512 lanes, one cluster up to
# 4096, the cooperative grid above
REPLY_BS = (1, 8, 64, 512, 513, 4096, 4097, 4099, 1 << 18)
REPLY_SENDERS = 5  # sender member indexes 0..4 (members 1, 3 and 5)
# many lanes on few rows: each row's acks beside its preempting nacks
# (the small path's widest chunk, and a grid's)
REPLY_CROWDS = ((4096, 64), (8192, 64))
# keys whose three lanes lie in three of the batch's SPLIT_SEG-lane
# segments (a cluster's CTAs; the grid's blocks): keys, lanes
REPLY_SPLITS = ((256, 4096), (512, 1 << 18))
SPLIT_SEG = 512


def _wrap32(x):
    """int64 values as int32 wraps them."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def reply_state(G, W, gen, near_max=False):
    """``propose_state`` (rows not coordinators, or with phase 1
    pending) with members 1, 3 and 5 and each ``prop`` column holding
    the slot of its window position (10% the one a window earlier, 5%
    none), a partial vote bitmap of senders 0..4, 15% of the columns
    already emitted; with ``near_max`` the cursors lie in
    [INT32_MAX - 2W, INT32_MAX], where slots wrap negative."""
    from gigapaxos_tpu_torch.ops.types import EMITTED_BIT, NO_SLOT
    st = propose_state(G, W, gen, near_max=near_max)
    dev = st.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    st.members = torch.tensor([1, 3, 5], dtype=torch.int32,
                              device=dev)[ri(3, G)]
    cur = st.exec_cursor.long()[:, None]
    slot = cur + (torch.arange(W, device=dev)[None, :] - cur) % W
    kind = rand(G, W)
    slot = _wrap32(torch.where(kind < 0.1, slot - W, slot))
    st.prop[..., 0] = torch.where(kind > 0.95, NO_SLOT, slot)
    votes = (ri(1 << REPLY_SENDERS, G, W) &
             ri(1 << REPLY_SENDERS, G, W)).to(torch.int32)
    st.prop[..., 3] = torch.where(rand(G, W) < 0.15, votes | EMITTED_BIT,
                                  votes)
    return st


def reply_lanes(st, B, gen, rows=None, valid_share=0.9):
    """B lanes with distinct (row, slot, sender) (the kernel's
    precondition), on random rows (or on ``rows``): a column's own slot
    (which may match), the slot a window later or earlier (which does
    not), ballots at, below and above ``cbal``, 15% nacks (those above
    ``cbal`` preempt), a share valid."""
    dev = st.device
    W = st.W
    per = W * 3 * REPLY_SENDERS
    n_rows = st.G if rows is None else rows.numel()
    keys = torch.randint(0, n_rows * per, (2 * B + 64,), generator=gen,
                         device=dev, dtype=torch.int64).unique()
    keys = keys[torch.randperm(keys.numel(), generator=gen, device=dev)]
    r = keys // per if rows is None else rows.long()[keys // per]
    c = keys // (3 * REPLY_SENDERS) % W
    shift = torch.tensor([0, W, -W], device=dev)[keys // REPLY_SENDERS % 3]
    slot = _wrap32(st.prop[r, c, 0].long() + shift)
    # one lane a (row, slot, sender): a column of no slot shifted a window
    # may name another column's slot
    _, inv = torch.unique(r * (1 << 36) + (slot.long() + (1 << 31)) * 8 +
                          keys % REPLY_SENDERS, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), keys.numel(), device=dev,
                       dtype=torch.int64).scatter_reduce_(
        0, inv, torch.arange(keys.numel(), device=dev), reduce="amin")
    pick = first.sort().values[:B]
    assert pick.numel() == B
    keys, r, slot = keys[pick], r[pick], slot[pick]
    step = torch.tensor([0, 0, 0, 0, -1, 1, 3], device=dev)[torch.randint(
        0, 7, (B,), generator=gen, device=dev)]
    bal = _wrap32(st.cbal[r].long() + step)
    sender = (keys % REPLY_SENDERS).to(torch.int32)
    acked = torch.rand(B, generator=gen, device=dev) < 0.85
    valid = torch.rand(B, generator=gen, device=dev) < valid_share
    return r.to(torch.int32), slot, bal, sender, acked, valid


def padded_reply_lanes(st, n, B, gen):
    """n lanes of ``reply_lanes``, every one valid, padded to B and
    packed as ``ColumnarBackend`` pads and packs a wave: row 0,
    ``NO_SLOT``, ``NO_BALLOT``, sender 0, nack, invalid; the flags as
    int32 rows of the packed batch."""
    from gigapaxos_tpu_torch.ops.types import NO_BALLOT, NO_SLOT
    lanes = reply_lanes(st, n, gen, valid_share=1.0)
    fills = (0, NO_SLOT, NO_BALLOT, 0, 0, 0)
    return tuple(torch.cat([t.to(torch.int32), torch.full(
        (B - n,), f, dtype=torch.int32, device=st.device)])
        for t, f in zip(lanes, fills))


def storm_reply_state_lanes(G, W, B, gen):
    """The storm's second reply on an all-active, all-coordinator state
    of members 3: B lanes on distinct rows (past G lanes, each row takes
    as many lanes as it must, on distinct columns), each lane on a
    column that holds its slot with sender 0's vote, from sender 1 at
    ``cbal``, acked, valid: every lane crosses quorum and is newly
    decided."""
    st = reply_state(G, W, gen)
    dev = st.device
    st.active.fill_(True)
    st.is_coord.fill_(True)
    st.coord_active.fill_(True)
    st.members.fill_(3)
    assert B <= G * W
    j = torch.arange(B, device=dev)
    r = torch.randperm(G, generator=gen, device=dev)[j % G]
    c = (torch.randint(0, W, (G,), generator=gen, device=dev)[r] +
         j // G) % W
    cur = st.exec_cursor.long()[r]
    slot = (cur + (c - cur) % W).to(torch.int32)
    st.prop[r, c, 0] = slot
    st.prop[r, c, 3] = 1
    one = torch.ones(B, dtype=torch.bool, device=dev)
    return st, (r.to(torch.int32), slot, st.cbal[r],
                torch.ones(B, dtype=torch.int32, device=dev), one, one)


def split_reply_lanes(st, gen, K, B, seg=SPLIT_SEG):
    """K keys (row, slot) whose three lanes lie in three ``seg``-lane
    segments of the B lanes, in order — the first a non-matching lane (a
    ballot below ``cbal``), the second and third matching — on a column
    with sender 0's vote and members 5 (quorum 3: only the third lane's
    vote crosses it); the other lanes random on other rows.  The kernel
    must decide each key at its second lane.  Returns the lanes and the
    keys' lane indices ``[keys, 3]``."""
    dev = st.device
    perm = torch.randperm(st.G, generator=gen, device=dev)
    rows, others = perm[:K], perm[K:K + 4 * B]
    st.members[rows] = 5
    st.is_coord[rows] = True
    st.coord_active[rows] = True
    c = torch.randint(0, st.W, (K,), generator=gen, device=dev)
    cur = st.exec_cursor.long()[rows]
    slot = (cur + (c - cur) % st.W).to(torch.int32)
    st.prop[rows, c, 0] = slot
    st.prop[rows, c, 3] = 1
    segs = B // seg
    assert K <= seg
    pick = torch.rand((K, segs), generator=gen, device=dev).argsort(
        dim=1)[:, :3].sort(dim=1).values
    at = pick * seg + torch.arange(K, device=dev)[:, None]
    lanes = [t.clone() for t in reply_lanes(st, B, gen, rows=others)]
    cb = st.cbal[rows]
    for j in range(3):
        vals = (rows.to(torch.int32), slot, cb - int(j == 0),
                torch.full((K,), 1 + j, dtype=torch.int32, device=dev),
                True, True)
        for f in range(6):
            lanes[f][at[:, j]] = vals[f]
    return tuple(lanes), at


def clone_reply(st):
    """The state with the three planes the accept-reply writes copied."""
    return dataclasses.replace(st, prop=st.prop.clone(),
                               is_coord=st.is_coord.clone(),
                               coord_active=st.coord_active.clone())


def check_reply(base, lanes, what, kern=None):
    """The kernel (``kern``, else this tree's wrapper) and
    ``accept_reply_reference`` on identical clones of ``base``: all six
    output rows on every lane (padding lanes read row 0 in both),
    ``prop``, ``is_coord`` and ``coord_active`` must be bit-identical.
    Int32 flag lanes (a packed batch) go to the kernel as they are.
    Returns the max abs error (0), the reference's output and state."""
    from gigapaxos_tpu_torch.ops.accept_reply_cuda import (
        accept_reply, accept_reply_reference)
    st_k, st_r = clone_reply(base), clone_reply(base)
    out_k = (kern or accept_reply)(st_k, *lanes)
    out_r = accept_reply_reference(st_r, *lanes[:4], lanes[4] != 0,
                                   lanes[5] != 0)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in (("out", out_k, out_r), ("prop", st_k.prop, st_r.prop),
                       ("is_coord", st_k.is_coord, st_r.is_coord),
                       ("coord_active", st_k.coord_active,
                        st_r.coord_active)):
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"accept-reply kernel != "
                                 f"accept_reply_reference: {name} ({what}, "
                                 f"max abs err {err})")
    return max_err, out_r, st_r


def reply_bytes(base, lanes, out, after) -> int:
    """Bytes the accept-reply must move for these lanes: each lane input
    read once and each output written once; each touched row's
    ``is_coord``, ``coord_active``, ``cbal`` and ``members`` read once;
    each touched ``prop`` column read once (16 B); each vote word the
    batch changed written once (4 B); each resigned row's two flags
    written once."""
    g, slot, bal, sender, acked, valid = lanes
    B = g.numel()
    v = valid != 0
    gi = torch.where(v, g, 0).long()
    w = torch.where(v, slot % base.W, 0).long()
    rows = gi.unique()
    cols = (gi * base.W + w).unique()
    before = base.prop.view(-1, 4)[cols, 3]
    changed = int((after.prop.view(-1, 4)[cols, 3] != before).sum())
    resigned = int((after.is_coord[rows] != base.is_coord[rows]).sum() +
                   (after.coord_active[rows] !=
                    base.coord_active[rows]).sum())
    return B * (4 * 4 + 2 * acked.element_size()) + B * 6 * 4 + \
        rows.numel() * 10 + cols.numel() * 16 + changed * 4 + resigned


def time_reply(base, lanes, out, after, hbm):
    """Kernel times with L2 warm (the touched rows just restored) and
    cold (flushed after the restore), the plain version's time (warm),
    the launch floor, each on ``base``'s rows restored before every
    timed call, and the byte bound of the call that gave ``out`` and
    ``after``."""
    from gigapaxos_tpu_torch.ops.accept_reply_cuda import (
        accept_reply, accept_reply_reference)
    g, slot, bal, sender, acked, valid = lanes
    rows = torch.where(valid != 0, g, 0).long().unique()
    saved = [(f, getattr(base, f)[rows])
             for f in ("prop", "is_coord", "coord_active")]
    st = clone_reply(base)

    def restore():
        for f, t in saved:
            getattr(st, f).index_copy_(0, rows, t)

    flush = l2_flusher()

    def cold():
        restore()
        flush()

    ab, vb = acked != 0, valid != 0
    nbytes = reply_bytes(base, lanes, out, after)
    return {"ms": device_ms(lambda: accept_reply(st, *lanes),
                            before=restore),
            "ms_cold": device_ms(lambda: accept_reply(st, *lanes),
                                 before=cold),
            "plain_ms": device_ms(lambda: accept_reply_reference(
                st, g, slot, bal, sender, ab, vb), before=restore),
            "floor_ms": device_ms(lambda: accept_reply.floor(g.numel()),
                                  before=restore),
            "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
            "newly": int((out[0] != 0).sum()),
            "preempted": int((out[1] != 0).sum())}


def phase_reply_parity(name_line):
    """The accept-reply kernel against ``accept_reply_reference`` on the
    card, on identical clones of a G=2^20, W=16 coordinator state
    (``reply_state``): at ``REPLY_BS`` over ``PARITY_SEEDS`` (both paths
    and their seams; past 8 also half live, padded and packed as the
    backend pads), at ``BIG_B`` (rounds past the co-resident grid), on
    ``REPLY_CROWDS`` (acks beside preempting nacks of their rows, on the
    small path and the grid), on ``REPLY_SPLITS``' keys across a
    cluster's CTAs and across the grid's blocks, on the storm's lanes at
    4096 (a chunk of the SPI's: every lane a candidate), 2^18 and
    ``BIG_B``, with slots near INT32_MAX, across the wide
    path's epoch wrap, and on the runtime's slab at every bucket, padded
    and packed.  Times at each width (seed 0; each path's floor with
    it), on the crowds, the split keys, the storm's lanes and the slab's
    buckets."""
    from gigapaxos_tpu_torch.ops import accept_reply_cuda
    hbm = HBM_BYTES_PER_S["pcie" if "PCIe" in name_line else "default"]
    rows = {}
    max_err = 0
    checked = 0

    def held(base, lanes, what, key=None):
        nonlocal max_err, checked
        err, out, after = check_reply(base, lanes, what)
        max_err = max(max_err, err)
        checked += 1
        if key is not None:
            rows[key] = time_reply(base, lanes, out, after, hbm)
        return out

    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = reply_state(G_FULL, W_FULL, gen)
        first = seed == PARITY_SEEDS[0]
        for B in REPLY_BS:
            held(base, reply_lanes(base, B, gen), f"seed {seed}, B={B}",
                 str(B) if first else None)
            if B > 8:
                held(base, padded_reply_lanes(base, B // 2, B, gen),
                     f"seed {seed}, {B // 2} of B={B} padded, packed")
        if first:
            held(base, reply_lanes(base, BIG_B, gen),
                 f"seed {seed}, B={BIG_B}", str(BIG_B))
            for B, n_rows in REPLY_CROWDS:
                on = torch.nonzero(base.is_coord & base.coord_active)[:, 0]
                crowd = on[torch.randperm(on.numel(), generator=gen,
                                          device="cuda")[:n_rows]]
                out = held(base, reply_lanes(base, B, gen, rows=crowd),
                           f"{B} lanes on {n_rows} rows",
                           f"{B}_on_{n_rows}")
                if not (out[0].any() and out[1].any()):
                    raise AssertionError(f"accept-reply crowd of {B}: no "
                                         "lane decided or none preempted")
            for K, B in REPLY_SPLITS:
                lanes, at = split_reply_lanes(base, gen, K, B)
                out = held(base, lanes, f"{K} keys across {B // SPLIT_SEG} "
                           f"segments of {B} lanes", f"split_{B}")
                if not (bool(out[0][at[:, 1]].all()) and
                        not out[0][at[:, 0]].any() and
                        not out[0][at[:, 2]].any()):
                    raise AssertionError(f"accept-reply split keys in {B} "
                                         "lanes: not decided at each key's "
                                         "second lane")
            # the wide path's epoch wraps in the second of three calls on
            # the same stream: the contested columns' table is cleared
            ws = accept_reply_cuda.workspace(base.device, base.G, base.W)
            ws.epoch.fill_(-2)
            for k in range(3):
                held(base, reply_lanes(base, 4099, gen),
                     f"seed {seed}, the epoch wrapping, call {k}")
            if int(ws.epoch) != 2:
                raise AssertionError(f"accept-reply: epoch {int(ws.epoch)} "
                                     "after the wrap, not 2")
        del base
        base = reply_state(G_FULL, W_FULL, gen, near_max=True)
        held(base, reply_lanes(base, STORM_B, gen),
             f"seed {seed}, slots near INT32_MAX, B={STORM_B}")
        del base
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARITY_SEEDS[0])
    for B in (4096, STORM_B, BIG_B):  # the SPI's chunks, the storm's
        base, lanes = storm_reply_state_lanes(G_FULL, W_FULL, B, gen)
        out = held(base, lanes, f"storm lanes, B={B}", f"storm_{B}")
        if not bool(out[0].all()):
            raise AssertionError(f"accept-reply storm lanes, B={B}: not "
                                 "every lane newly decided")
        del base, lanes
    # the runtime's slab at every bucket, live lanes padded and packed as
    # ColumnarBackend pads and packs them
    for seed in PARITY_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        base = reply_state(RT_CAPACITY, RT_WINDOW, gen)
        for B in RT_BUCKETS:
            n = int(torch.randint(B // 8 + 1, B + 1, (1,), generator=gen,
                                  device="cuda"))
            held(base, padded_reply_lanes(base, n, B, gen),
                 f"rt slab (G={RT_CAPACITY}), seed {seed}, {n} of B={B}",
                 f"rt_{B}" if seed == PARITY_SEEDS[0] else None)
        del base
    torch.cuda.empty_cache()
    for k, r in rows.items():
        info(f"accept_reply {k}: kernel {r['ms']:.4f} ms (L2 warm), "
             f"{r['ms_cold']:.4f} ms (cold), plain {r['plain_ms']:.4f} ms, "
             f"bound {r['bound_ms']:.6f} ms ({r['bytes']} B at "
             f"{hbm / 1e12:.2f} TB/s), floor {r['floor_ms']:.4f} ms (an "
             f"empty kernel launched as it is), {r['newly']} newly "
             f"decided, {r['preempted']} preempted, bit-exact "
             f"[{name_line}]")
    return rows, max_err, checked


# -- phase 2: the runtime's wave kernels ------------------------------------

# the packed column fills of each half of a wave as ColumnarBackend pads
# them (-1: types.NO_SLOT for a slot, types.NO_BALLOT for a ballot)
WAVE_FILLS = {
    "accept": (0, -1, -1, 0, 0),
    "commit": (0, -1, 0, 0),
    "request": (0, 0, 0, 0),
    "reply": (0, -1, -1, 0, 0),
}
# which halves each kernel takes, its output rows per half, and the
# packed waves' names (the JAX package's jits, the backend's waves) of
# (both halves, first alone, second alone)
WAVE_KERNELS = {
    "acceptor_wave": (("accept", "commit"), (4, 4),
                      ("accept_commit_p", "accept_p", "commit_p")),
    "coordinator_wave": (("request", "reply"), (9, 9),
                         ("request_reply_p", "propose_accept_self_p",
                          "accept_reply_commit_self_p")),
}


def wave_host_state(G, W, rng):
    """A numpy state in the JAX layout for the wave kernels: inactive
    rows, members 1, 3 or 5, coordinators (some not active, some with a
    ballot below the promise, so their own accept nacks), next_slot up
    to the window edge, proposals with votes (some emitted) in the
    columns of [exec_cursor, next_slot), and decided slots ahead of the
    cursor behind a gap at it."""
    from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT, NO_SLOT,
                                               make_state, state_to_numpy)
    host = state_to_numpy(make_state(G, W, "cpu"))
    host["active"][:] = rng.random(G) < 0.9
    members = rng.choice([1, 3, 3, 5], G).astype(np.int32)
    host["members"][:] = members
    cur = rng.integers(0, 1000, G).astype(np.int32)
    host["exec_cursor"][:] = cur
    bal = ((rng.integers(0, 8, G) << 12) | rng.integers(0, 3, G)).astype(
        np.int32)
    host["bal"][:] = bal
    coord = rng.random(G) < 0.8
    host["is_coord"][:] = coord
    host["coord_active"][:] = coord & (rng.random(G) < 0.95)
    host["cbal"][:] = np.where(rng.random(G) < 0.9, bal, bal - 4096)
    nxt = (cur + rng.integers(0, W + 1, G)).astype(np.int32)
    host["next_slot"][:] = nxt
    k = np.arange(W)
    slots = cur[:, None] + k[None, :]
    rows = np.repeat(np.arange(G), W)
    cols = (slots % W).ravel()
    live = slots < nxt[:, None]
    votes = rng.integers(0, 1 << 5, (G, W)) & ((1 << members[:, None]) - 1)
    votes |= np.where(rng.random((G, W)) < 0.05, EMITTED_BIT, 0)
    prop = host["prop"]
    prop[rows, cols, 0] = np.where(live, slots, NO_SLOT).ravel()
    prop[rows, cols, 1] = rng.integers(-(1 << 31), 1 << 31, G * W)
    prop[rows, cols, 2] = rng.integers(-(1 << 31), 1 << 31, G * W)
    prop[rows, cols, 3] = np.where(live, votes, 0).ravel()
    decided = (rng.random((G, W)) < 0.5) & (k[None, :] >= 1)
    dec = host["dec"]
    dec[rows, cols, 0] = np.where(decided, slots, slots - W).ravel()
    dec[rows, cols, 1] = rng.integers(-(1 << 31), 1 << 31, G * W)
    dec[rows, cols, 2] = rng.integers(-(1 << 31), 1 << 31, G * W)
    acc = host["acc"]
    acc[...] = rng.integers(-1, 1 << 20, acc.shape)
    return host


def _distinct_pairs(rng, pool, span, n, lo, zero_share=0.0):
    """n distinct (row, offset) pairs, rows from ``pool``, offsets from
    [lo, lo + span), a share of the draws at offset 0."""
    pool = np.asarray(pool)
    if len(pool) * span <= 8 * n:  # few rows: every pair, then a sample
        keys = (pool[:, None].astype(np.int64) * span
                + np.arange(span)[None, :]).ravel()
    else:
        m = 4 * n + 64
        off = np.where(rng.random(m) < zero_share, -lo,
                       rng.integers(0, span, m))
        keys = np.unique(rng.choice(pool, m).astype(np.int64) * span + off)
    if len(keys) < n:
        raise AssertionError(f"wave lanes: {len(keys)} distinct pairs of "
                             f"{n}")
    keys = rng.permutation(keys)[:n]
    return (keys // span).astype(np.int32), (keys % span + lo).astype(
        np.int32)


def _ids(rng, n):
    return (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
            for _ in range(2))


def wave_half(half, host, n, rng, rows=None, unique=False):
    """The columns of ``n`` live lanes of one half of a wave, drawn on
    ``rows`` (a contended chunk) or on every row (a runtime chunk); with
    ``unique``, each lane on a row of its own, so that no key of a run
    rank repeats."""
    from gigapaxos_tpu_torch.ops.types import NO_SLOT
    G, W = host["bal"].shape[0], host["acc"].shape[1]
    cur, members = host["exec_cursor"], host["members"]
    pool = np.arange(G) if rows is None else rows
    if unique:
        return _unique_half(half, host, rng.choice(pool, n, replace=False),
                            rng)
    per_row = W if rows is None else -(-n // len(pool))
    if half == "accept":  # stale, in-window and beyond; ballots around
        g, off = _distinct_pairs(rng, pool, per_row + 8, n, -4)
        bal = host["bal"][g] + rng.choice([-4096, 0, 0, 4096], n)
        return [g, (cur[g] + off).astype(np.int32), bal.astype(np.int32),
                *_ids(rng, n)]
    if half == "commit":  # around the cursor, many closing its gap
        g, off = _distinct_pairs(rng, pool, per_row + 4, n, -2, 0.3)
        return [g, (cur[g] + off).astype(np.int32), *_ids(rng, n)]
    if half == "request":  # few groups, many proposals each
        few = rng.choice(pool, max(1, min(len(pool), n // 8)),
                         replace=False)
        g = np.where(rng.random(n) < 0.9, rng.choice(few, n),
                     rng.choice(pool, n)).astype(np.int32)
        smidx = (rng.integers(0, 1 << 10, n) % members[g]).astype(np.int32)
        return [g, *_ids(rng, n), smidx]
    # replies: the proposed columns of [cursor, next_slot), one lane a
    # (row, slot, sender), mostly acks at cbal, some nacks, a few above
    # cbal (preemptions), some on slots never proposed
    nxt = host["next_slot"]
    cand = [(r, s, m) for r in rng.choice(pool, min(len(pool), n),
                                          replace=False).tolist()
            for s in range(int(cur[r]), int(nxt[r]))
            for m in range(int(members[r]))]
    if len(cand) < n:
        cand += [(int(r), int(cur[r]) + W + i, 0) for i, r in
                 enumerate(rng.choice(pool, n - len(cand)))]
    pick = rng.permutation(len(cand))[:n]
    g, slot, sender = (np.asarray(c, np.int32) for c in
                       zip(*[cand[i] for i in pick]))
    cb = host["cbal"][g]
    acked = rng.random(n) < 0.85
    bal = np.where(acked | (rng.random(n) < 0.7), cb,
                   cb + 4096).astype(np.int32)
    slot = np.where(rng.random(n) < 0.05, NO_SLOT, slot).astype(np.int32)
    return [g, slot, bal, sender, acked.astype(np.int32)]


def _unique_half(half, host, g, rng):
    """``wave_half``'s mix with one lane a row of ``g``."""
    from gigapaxos_tpu_torch.ops.types import NO_SLOT
    n, W = len(g), host["acc"].shape[1]
    g = g.astype(np.int32)
    cur, members = host["exec_cursor"][g], host["members"][g]
    if half == "accept":
        bal = host["bal"][g] + rng.choice([-4096, 0, 0, 4096], n)
        return [g, (cur + rng.integers(-4, W + 4, n)).astype(np.int32),
                bal.astype(np.int32), *_ids(rng, n)]
    if half == "commit":
        off = np.where(rng.random(n) < 0.3, 0, rng.integers(-2, W + 2, n))
        return [g, (cur + off).astype(np.int32), *_ids(rng, n)]
    if half == "request":
        smidx = (rng.integers(0, 1 << 10, n) % members).astype(np.int32)
        return [g, *_ids(rng, n), smidx]
    span = np.maximum(host["next_slot"][g] - cur, 1)  # a proposed column
    slot = np.where(rng.random(n) < 0.05, NO_SLOT,
                    cur + rng.integers(0, 1 << 20, n) % span)
    sender = rng.integers(0, 1 << 10, n) % members
    cb = host["cbal"][g]
    acked = rng.random(n) < 0.85
    bal = np.where(acked | (rng.random(n) < 0.7), cb, cb + 4096)
    return [g, slot.astype(np.int32), bal.astype(np.int32),
            sender.astype(np.int32), acked.astype(np.int32)]


def wave_packed(half, cols, n, B, dev):
    """One half's packed [k+1, B] input on ``dev``, padded as
    ``ColumnarBackend`` pads a wave."""
    fills = WAVE_FILLS[half]
    out = np.empty((len(fills) + 1, B), np.int32)
    for i, (c, f) in enumerate(zip(cols, fills)):
        out[i, :n] = c
        out[i, n:] = f
    out[-1] = np.arange(B) < n
    return torch.from_numpy(out).to(dev)


# phase 2's chunks at the seams of the wave kernels' geometry: (what,
# live lanes, bucket, how the lanes are drawn).  The contended chunk;
# 4096 lanes on one row and on 8 rows (a key repeats across the
# cluster's CTAs); 4096 lanes on rows of their own (no key of a run rank
# repeats); live lanes only in the last CTA's range; bucket 512 (one CTA
# of 512 threads) with every lane live.
WAVE_SEAMS = (
    (f"{CONTENDED[0]} lanes on {CONTENDED[1]} rows", CONTENDED[0],
     CONTENDED[0], {"rows": CONTENDED[1]}),
    ("4096 lanes on one row", 4096, 4096, {"rows": 1}),
    ("4096 lanes on 8 rows", 4096, 4096, {"rows": 8}),
    ("4096 lanes, no key repeated", 4096, 4096, {"unique": True}),
    ("512 live lanes in the last CTA's range of 4096", 512, 4096,
     {"last": True}),
    ("512 of 512 lanes live", 512, 512, {}),
)


def seam_rows(host, rng, how):
    """The rows a seam chunk's lanes are drawn on (active coordinators),
    or None for every row."""
    if "rows" not in how:
        return None
    return rng.choice(np.flatnonzero(host["active"] & host["coord_active"]),
                      how["rows"], replace=False)


def seam_halves(kinds, host, rng, n, B, how, rows, dev):
    """The packed halves of a seam chunk (``WAVE_SEAMS``), and its live
    lanes: the first ``n``, or a slice of the last ``n`` (``last``)."""
    halves = [wave_packed(h, wave_half(h, host, n, rng, rows=rows,
                                       unique=how.get("unique", False)),
                          n, B, dev) for h in kinds]
    if how.get("last"):
        return ([torch.roll(h, B - n, dims=1).contiguous() for h in halves],
                slice(B - n, B))
    return halves, n


def clone_all(st):
    """The state with every plane copied."""
    return dataclasses.replace(st, **{f: t.clone() for f, t in st.items()})


def check_wave(name, base, halves, n, what, kern=None):
    """The wave kernel (``kern``, else the wrapper of this tree's) and
    its torch bodies (``kernels.*_wave_plain``) on identical clones of
    ``base``: every state plane and the live lanes of every output row
    (the first ``n``, or the lanes an index ``n`` selects) must be
    bit-identical.  Returns the max abs error (0)."""
    from gigapaxos_tpu_torch.ops import kernels, wave_cuda
    kern = kern or getattr(wave_cuda, name.split("_")[0])
    plain = getattr(kernels, f"{name}_plain")
    st_k, st_p = clone_all(base), clone_all(base)
    out_k = kern(st_k, *halves)
    out_p = plain(st_p, *halves)
    torch.cuda.synchronize()
    rows = WAVE_KERNELS[name][1]
    lanes = slice(0, n) if isinstance(n, int) else n
    live = []
    at = 0
    for h, r in zip(halves, rows):
        if h is not None:
            live.append((out_k[at:at + r, lanes], out_p[at:at + r, lanes]))
            at += r
    max_err = 0
    pairs = [(f"out[{i}]", a, b) for i, (a, b) in enumerate(live)] + \
        [(f, getattr(st_k, f), getattr(st_p, f)) for f, _ in base.items()]
    for what_f, a, b in pairs:
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"{name} kernel != its torch bodies: "
                                 f"{what_f} ({what}, max abs err {err})")
    return max_err


# the row words each half of a wave reads on the rows of its live lanes
# (the propose, own accept and own vote of a request; the vote and own
# commit of a reply)
WAVE_ROW_READS = {
    "accept": ("active", "bal", "exec_cursor"),
    "commit": ("active", "exec_cursor"),
    "request": ("active", "is_coord", "coord_active", "cbal", "next_slot",
                "exec_cursor", "bal", "members"),
    "reply": ("is_coord", "coord_active", "cbal", "members", "active",
              "exec_cursor"),
}


def wave_bound_bytes(name, base, halves, after) -> int:
    """Bytes the wave must move for this run's data, ``after`` being the
    state its torch bodies left from ``base``: each packed input and
    output row over the whole bucket, read or written once; each row
    word a half reads (``WAVE_ROW_READS``) once for each distinct row of
    its live lanes; the ``prop`` column of each distinct (row, slot) of
    the live reply lanes; on each row that stored a decision, the ``dec``
    slot words its contiguity scan reads (the cursor's advance and the
    gap past it, at most W); and each state word the wave changed,
    written once.  Padding lanes and lanes that store nothing add no
    row traffic."""
    kinds, outs, _ = WAVE_KERNELS[name]
    W = base.W
    nbytes = 0
    rows = {}
    for kind, h, r in zip(kinds, halves, outs):
        if h is None:
            continue
        nbytes += 4 * (h.shape[0] + r) * h.shape[1]
        lv = h[:, h[-1] != 0]
        g = lv[0].long()
        for f in WAVE_ROW_READS[kind]:
            rows[f] = torch.cat([rows.get(f, g[:0]), g])
        if kind == "reply":
            slot = lv[1].long()
            ok = slot >= 0
            nbytes += 16 * (g[ok] * W + slot[ok] % W).unique().numel()
    nbytes += sum(g.unique().numel() * getattr(base, f).element_size()
                  for f, g in rows.items())
    scanned = (after.dec != base.dec).flatten(1).any(dim=1)
    adv = (after.exec_cursor - base.exec_cursor)[scanned].long()
    nbytes += 4 * int(torch.clamp(adv + 1, max=W).sum())
    nbytes += sum(int((getattr(after, f) != t).sum()) * t.element_size()
                  for f, t in base.items())
    return nbytes


def restorer(st, base):
    """A callable that copies back into ``st`` every plane of ``base`` a
    wave writes."""
    written = ("bal", "acc", "dec", "exec_cursor", "is_coord",
               "coord_active", "next_slot", "prop")

    def restore():
        for f in written:
            getattr(st, f).copy_(getattr(base, f))
    return restore


def time_wave(name, base, halves, hbm):
    """Kernel and plain device times of one call on ``base``'s state,
    restored before each timed call, the byte bound of the wave on these
    inputs (:func:`wave_bound_bytes`), and the launch floor: an empty
    kernel at the call's geometry and shared memory
    (``WaveKernel.floor``), timed the same way."""
    from gigapaxos_tpu_torch.ops import kernels, wave_cuda
    kern = getattr(wave_cuda, name.split("_")[0])
    plain = getattr(kernels, f"{name}_plain")
    st = clone_all(base)
    after = clone_all(base)
    plain(after, *halves)
    nbytes = wave_bound_bytes(name, base, halves, after)
    del after
    restore = restorer(st, base)
    B = next(h.shape[1] for h in halves if h is not None)
    return {"ms": device_ms(lambda: kern(st, *halves), before=restore),
            "plain_ms": device_ms(lambda: plain(st, *halves),
                                  before=restore),
            "floor_ms": device_ms(lambda: kern.floor(B), before=restore),
            "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3}


def phase_wave_parity(name_line):
    """The two wave kernels against their torch bodies on the card, on
    phase 5's 2^17-row slab and phase 8's 2^15-row lane slab, at every
    bucket of the runtime's ladder over ``PARITY_SEEDS``, with both
    halves live and with each half empty, and on the runtime's slab in
    the chunks at the seams of the kernels' geometry (``WAVE_SEAMS``,
    the contended chunk first); times at every bucket on both slabs
    (seed 0, both halves) beside the launch floor.  Every state plane
    and every live output lane must be bit-identical."""
    from gigapaxos_tpu_torch.ops.types import state_from_numpy
    hbm = HBM_BYTES_PER_S["pcie" if "PCIe" in name_line else "default"]
    dev = torch.device("cuda")
    rows = {}
    max_err = 0
    checked = 0
    for G, key in ((RT_CAPACITY, "rt"), (LANE_CAPACITY, "lane")):
        for seed in PARITY_SEEDS:
            rng = np.random.default_rng(100 + seed)
            host = wave_host_state(G, RT_WINDOW, rng)
            base = state_from_numpy(host, dev)
            for name, (kinds, _, _) in WAVE_KERNELS.items():
                for B in RT_BUCKETS:
                    n = int(rng.integers(B // 8 + 1, B + 1))
                    both = [wave_packed(h, wave_half(h, host, n, rng), n, B,
                                        dev) for h in kinds]
                    for variant, halves in enumerate(
                            (both, [both[0], None], [None, both[1]])):
                        max_err = max(max_err, check_wave(
                            name, base, halves, n,
                            f"{key} slab (G={G}), seed {seed}, {n} of "
                            f"B={B}, halves {[h is not None for h in halves]}"
                        ))
                        checked += 1
                    if seed == PARITY_SEEDS[0]:
                        rows[f"{name}_{key}_{B}"] = dict(
                            time_wave(name, base, both, hbm), live=n)
            del base
    # the seams of the kernels' geometry, on the runtime's slab
    rng = np.random.default_rng(7)
    host = wave_host_state(RT_CAPACITY, RT_WINDOW, rng)
    base = state_from_numpy(host, dev)
    for what, n, B, how in WAVE_SEAMS:
        few = seam_rows(host, rng, how)
        for name, (kinds, _, _) in WAVE_KERNELS.items():
            both, live = seam_halves(kinds, host, rng, n, B, how, few, dev)
            for halves in (both, [both[0], None], [None, both[1]]):
                max_err = max(max_err, check_wave(
                    name, base, halves, live, f"{what}, halves "
                    f"{[h is not None for h in halves]}"))
                checked += 1
    del base
    torch.cuda.empty_cache()
    for k, r in rows.items():
        info(f"wave {k}: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
             f"({r['bytes']} B at {hbm / 1e12:.2f} TB/s), floor_ms "
             f"{r['floor_ms']:.4f} (an empty kernel at its geometry), "
             f"{r['live']} live lanes, bit-exact [{name_line}]")
    return rows, max_err, checked


def phase_wave_ab(parent, name_line, out_path=None):
    """This tree's wave kernels against an older checkout's (``parent``:
    a directory holding its ``gigapaxos_tpu_torch``, say one unpacked by
    ``git archive``), built from its ``csrc/wave.cu`` with this tree's
    flags and launched through this tree's wrappers (the C interface is
    the same), in one process on one card.  On phase 2's timed chunks
    (seed 0, every bucket, both slabs) and on each half alone, both
    kernels must be bit-identical to the torch bodies; then each is timed
    in turns, parent, this, this, parent (``device_ms``, the state
    restored before each call).  Prints a line a chunk; writes the rows
    as JSON to ``out_path`` if given."""
    from gigapaxos_tpu_torch.ops import _build, wave_cuda
    from gigapaxos_tpu_torch.ops.types import state_from_numpy
    src = Path(parent) / "gigapaxos_tpu_torch" / "ops" / "csrc" / "wave.cu"
    so = _build.BUILD_DIR / "parent" / "wave.so"
    log = _build.build_source(src, so)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln:
            info(f"ptxas parent wave: {ln.strip()}")
    lib = wave_cuda.bind(ctypes.CDLL(str(so)))
    dev = torch.device("cuda")
    rows = []
    for G, key in ((RT_CAPACITY, "rt"), (LANE_CAPACITY, "lane")):
        rng = np.random.default_rng(100 + PARITY_SEEDS[0])
        host = wave_host_state(G, RT_WINDOW, rng)
        base = state_from_numpy(host, dev)
        for name, (kinds, _, _) in WAVE_KERNELS.items():
            new = getattr(wave_cuda, name.split("_")[0])
            old = wave_cuda.WaveKernel(new.name, new._symbol, new.in_rows,
                                       new.out_rows, new.tables, lib=lib)
            for B in RT_BUCKETS:
                n = int(rng.integers(B // 8 + 1, B + 1))
                both = [wave_packed(h, wave_half(h, host, n, rng), n, B,
                                    dev) for h in kinds]
                for halves, which in ((both, "both"),
                                      ([both[0], None], kinds[0]),
                                      ([None, both[1]], kinds[1])):
                    what = f"{key} slab, B={B}, {n} live, {which}"
                    for k in (old, new):
                        check_wave(name, base, halves, n, what, kern=k)
                    st = clone_all(base)
                    restore = restorer(st, base)
                    ms = [device_ms(lambda: k(st, *halves), before=restore)
                          for k in (old, new, new, old)]
                    row = {"kernel": name, "slab": key, "B": B, "live": n,
                           "halves": which, "parent_ms": [ms[0], ms[3]],
                           "this_ms": [ms[1], ms[2]],
                           "ratio": (ms[0] + ms[3]) / (ms[1] + ms[2])}
                    rows.append(row)
                    info(f"wave ab {name} {what}: parent {ms[0]:.4f}, this "
                         f"{ms[1]:.4f}, this {ms[2]:.4f}, parent "
                         f"{ms[3]:.4f} ms; parent/this {row['ratio']:.2f} "
                         f"[{name_line}]")
        del base
    torch.cuda.empty_cache()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"card": name_line, "rows": rows}, indent=1))
    return rows


# Variants timed beside this tree's build in phase_kernel_ab: a tag, the
# lanes a thread the variant's wrapper expects, the text replacements made
# in this tree's source, and whether the variant computes what the kernel
# computes (each is held bit-exact on every case) or is an ablation that
# leaves a step out to time it (timed on the storm's lanes only, where
# nothing is checked).
COMMIT_LANES = "constexpr int kLanes = 2;"
REPLY_LANES = "constexpr int kLanes = 4;"
AB_VARIANTS = {
    "commit": [
        ("lanes=1", 1, [(COMMIT_LANES, "constexpr int kLanes = 1;")], True),
        ("lanes=4", 4, [(COMMIT_LANES, "constexpr int kLanes = 4;")], True),
        ("a 4-word scan", 2, [("constexpr int kScan = 2;",
                               "constexpr int kScan = 4;")], True),
        ("no prefetch", 2, [
            ('  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));',
             "  (void)p;")], True),
        ("ablation: no scan", 2, [
            ("got[k][adv] == gp::add_wrap(l[k].cur, adv))",
             "adv < 1)")], False),
    ],
    "accept_reply": [
        ("lanes=1", 1, [(REPLY_LANES, "constexpr int kLanes = 1;")], True),
        ("lanes=2", 2, [(REPLY_LANES, "constexpr int kLanes = 2;")], True),
        ("ablation: no vote or claim", 4, [
            ("      was[k] = atomicOr(vote, fresh | kClaim);",
             "      was[k] = 0;")], False),
        ("ablation: no phase B", 4, [
            ("  reply_b(a, base0, epoch, first);", "")], False),
    ],
}


def _bound(wrapper, so):
    """``wrapper`` (a fresh instance) bound to the library at ``so``: its
    ``load()`` declares its entry points on that library instead of
    building this tree's source."""
    from gigapaxos_tpu_torch.ops import _build
    lib = ctypes.CDLL(str(so))
    real = _build.load
    _build.load = lambda name: lib
    try:
        wrapper.load()
    finally:
        _build.load = real
    return wrapper


def _parent_module(parent, name):
    """An older checkout's ``gigapaxos_tpu_torch/ops/<name>.py``, loaded
    under a name of its own (its imports resolve to this tree's
    package)."""
    import importlib.util
    path = Path(parent) / "gigapaxos_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ab_kernels(parent, name, cls):
    """The kernels to time for ``name``: the parent's source and wrapper,
    this tree's, and each of ``AB_VARIANTS``' (this tree's source,
    patched); each as (tag, wrapper, exact), with its ptxas lines
    printed."""
    from gigapaxos_tpu_torch.ops import _build
    mine = getattr(sys.modules[cls.__module__], name)
    src = Path(parent) / "gigapaxos_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
    so = _build.BUILD_DIR / "parent" / f"{name}.so"
    old = getattr(_parent_module(parent, f"{name}_cuda"),
                  cls.__name__)()
    log = _build.build_source(src, so)
    kerns = [("parent", _bound(old, so), True, log)]
    kerns.append(("this", mine, True, _build.ptxas_report(name)))
    text = _build.sources()[name].read_text()
    for n, (tag, lanes, patches, exact) in enumerate(AB_VARIANTS[name]):
        v = text
        for old_text, new_text in patches:
            if v.count(old_text) != 1:
                raise AssertionError(f"kernel ab {name} {tag}: the patch "
                                     f"does not match: {old_text!r}")
            v = v.replace(old_text, new_text)
        vsrc = _build.BUILD_DIR / "variants" / f"{name}-{n}.cu"
        vsrc.parent.mkdir(parents=True, exist_ok=True)
        vsrc.write_text(v)
        vso = vsrc.with_suffix(".so")
        log = _build.build_source(vsrc, vso, ("-I", str(_build.CSRC)))
        kerns.append((tag, _bound(cls(lanes=lanes), vso), exact, log))
    for tag, _k, _exact, log in kerns:
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                info(f"ptxas {name} {tag}: {ln.strip()}")
    return [k[:3] for k in kerns]


def _ab_rows(name, cases, kerns, check, restorer_of, name_line, rows):
    """Each case held bit-exact under every exact kernel, then timed in
    turns: the kernels in order, then in reverse (``device_ms``, the
    touched rows restored before each call).  The ablations run on the
    storm's lanes only; the variants only on the grid's widths."""
    for case, base, lanes, wide in cases:
        ks = [k for k in kerns if (wide or k[0] in ("parent", "this")) and
              (k[2] or case == "storm lanes")]
        for tag, k, exact in ks:
            if exact:
                check(base, lanes, f"{name} ab {case}, {tag}", kern=k)
        st, restore = restorer_of(base, lanes)
        order = ks + ks[::-1]
        ms = [device_ms(lambda: k(st, *lanes), before=restore)
              for _tag, k, _exact in order]
        floors = {tag: device_ms(lambda: k.floor(lanes[0].numel()),
                                 before=restore)
                  for tag, k, _exact in ks[:2]}  # the parent's and this
        row = {"kernel": name, "case": case, "B": lanes[0].numel(),
               "ms": {tag: [ms[i], ms[len(order) - 1 - i]]
                      for i, (tag, _k, _e) in enumerate(ks)},
               "floor_ms": floors}
        rows.append(row)
        info(f"kernel ab {name} {case} (B={row['B']}): " + ", ".join(
            f"{tag} {a:.4f}/{b:.4f}" for tag, (a, b) in row["ms"].items())
            + " ms (first and second turn); floors " + ", ".join(
            f"{tag} {v:.4f}" for tag, v in floors.items())
            + f" ms [{name_line}]")


def phase_kernel_ab(parent, name_line, out_path=None):
    """The accept-reply and commit kernels of this tree against an older
    checkout's (``parent``: a directory holding its
    ``gigapaxos_tpu_torch``, say one unpacked by ``git archive``), each
    built from its own source with this tree's flags and launched
    through its own wrapper, and against ``AB_VARIANTS`` (this tree's
    source patched), in one process on one card.
    Cases: the storm's lanes and random lanes at 2^18, random lanes at
    ``BIG_B``, and for the accept-reply chunks of 4096 and 512 random
    lanes and of 4096 of the storm's lanes (every lane a candidate, as the
    SPI's replies are; this tree's small path).  Each kernel is held bit-exact on each case first; then
    all are timed in turns.  Prints a line a case; writes the rows as
    JSON to ``out_path`` if given."""
    from gigapaxos_tpu_torch.ops import accept_reply_cuda, commit_cuda
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARITY_SEEDS[0])

    def commit_restorer(base, lanes):
        g, _slot, _rlo, _rhi, valid = lanes
        touched = torch.where(valid, g, 0).long().unique()
        saved = (base.dec[touched], base.exec_cursor[touched])
        st = clone_commit(base)

        def restore():
            st.dec.index_copy_(0, touched, saved[0])
            st.exec_cursor.index_copy_(0, touched, saved[1])
        return st, restore

    def reply_restorer(base, lanes):
        g, valid = lanes[0], lanes[5]
        touched = torch.where(valid != 0, g, 0).long().unique()
        saved = [(f, getattr(base, f)[touched])
                 for f in ("prop", "is_coord", "coord_active")]
        st = clone_reply(base)

        def restore():
            for f, t in saved:
                getattr(st, f).index_copy_(0, touched, t)
        return st, restore

    kerns = _ab_kernels(parent, "commit", commit_cuda.CommitKernel)
    storm = commit_state(G_FULL, W_FULL, gen, active_share=1.0)
    rand = commit_state(G_FULL, W_FULL, gen)
    cases = [("storm lanes", storm, storm_commit_lanes(storm, STORM_B, gen),
              True),
             ("random lanes", rand, commit_lanes(rand, STORM_B, gen), True),
             ("random lanes", rand, commit_lanes(rand, BIG_B, gen), True)]
    _ab_rows("commit", cases, kerns, check_commit, commit_restorer,
             name_line, rows)
    del storm, rand, cases
    torch.cuda.empty_cache()
    kerns = _ab_kernels(parent, "accept_reply",
                        accept_reply_cuda.AcceptReplyKernel)
    storm, storm_lanes_ = storm_reply_state_lanes(G_FULL, W_FULL, STORM_B,
                                                  gen)
    chunk, chunk_lanes = storm_reply_state_lanes(G_FULL, W_FULL, 4096, gen)
    rand = reply_state(G_FULL, W_FULL, gen)
    cases = [("storm lanes", storm, storm_lanes_, True),
             ("random lanes", rand, reply_lanes(rand, STORM_B, gen), True),
             ("random lanes", rand, reply_lanes(rand, BIG_B, gen), True),
             ("a chunk", rand, reply_lanes(rand, 4096, gen), False),
             ("a chunk", rand, reply_lanes(rand, 512, gen), False),
             ("a chunk of the storm's lanes", chunk, chunk_lanes, False)]
    _ab_rows("accept_reply", cases, kerns, check_reply, reply_restorer,
             name_line, rows)
    del storm, rand, chunk, cases
    torch.cuda.empty_cache()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"card": name_line, "rows": rows}, indent=1))
    return rows


# run in each tree's root: STORM_AB_RUNS storms, the first loading the
# kernels
STORM_AB_RUNS = 6
STORM_AB_CODE = (
    "import json; import chip_smoke as c; "
    "from gigapaxos_tpu_torch.ops import _build; _build.build_all(); "
    f"runs = [c.phase_storm() for _ in range({STORM_AB_RUNS})]; "
    "print('storm-ab ' + json.dumps([r['decisions_per_s'] for r in runs]))")


def phase_storm_ab(parent, name_line, out_path=None):
    """The decide storm's decisions/s (phase 3) of this tree against an
    older checkout's (``parent``: a directory holding its
    ``chip_smoke.py`` and ``gigapaxos_tpu_torch``, say one unpacked by
    ``git archive``) on one card, in turns, parent, this, this, parent:
    each run a process of its own in its tree's root, building that
    tree's kernels and running phase 3 ``STORM_AB_RUNS`` times (the
    median of all but the first, which loads the kernels, is compared).
    Each tree's phase 3 checks its own decisions and launches.  Writes
    the rows as JSON to ``out_path`` if given."""
    trees = {"parent": Path(parent).resolve(),
             "this": Path(__file__).resolve().parent}
    rows = []
    for tag in ("parent", "this", "this", "parent"):
        proc = subprocess.run([sys.executable, "-c", STORM_AB_CODE],
                              cwd=trees[tag], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"storm-ab: the {tag} tree failed:\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        got = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("storm-ab ")]
        runs = json.loads(got[-1][len("storm-ab "):])
        med = statistics.median(runs[1:])
        rows.append({"tree": tag, "decisions_per_s": med, "runs": runs})
        info(f"storm-ab {tag}: {med:.0f} decisions/s, the median of "
             f"{', '.join(f'{r:.0f}' for r in runs[1:])} (the process's "
             f"first storm {runs[0]:.0f}) [{name_line}]")
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(
            {"card": name_line, "rows": rows}, indent=1))
    return rows


def wave_submit_no_sync():
    """One fused acceptor and one fused coordinator wave submitted on a
    runtime-sized ``ColumnarBackend`` under
    ``torch.cuda.set_sync_debug_mode("error")``: the submit must not
    synchronize the host with the card (a warm-up wave of each first)."""
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend
    G, n = RT_CAPACITY, 64
    bk = ColumnarBackend(G, RT_WINDOW)
    rows = np.arange(1000, dtype=np.int32)
    bk.create(rows, np.full(1000, 3, np.int32), np.zeros(1000, np.int32),
              np.zeros(1000, np.int32), np.ones(1000, bool))
    rng = np.random.default_rng(3)

    def submits(it):
        g = rng.permutation(1000)[:n].astype(np.int32)
        slot = np.full(n, it, np.int32)
        reqs = rng.integers(1, 1 << 62, n).astype(np.uint64)
        zero = np.zeros(n, np.int32)
        return (bk.accept_commit_submit(g, slot, zero, reqs, g, slot, reqs),
                bk.propose_self_reply_submit(g, reqs, zero, g, slot, zero,
                                             np.ones(n, np.int32),
                                             np.ones(n, bool)))

    for w in submits(0):
        w.collect()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        waves = submits(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for w in waves:
        w.collect()
    del bk
    torch.cuda.empty_cache()


def _same(a, b, what):
    """Equal results (nested tuples / dicts of arrays), or raise."""
    if isinstance(a, dict):
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError(f"card != cpu: {what}")


def phase_cpu_parity():
    """The main path on the card against the same calls on the CPU,
    where every wrapper runs its plain version (the path the CPU tests
    hold against the JAX package): storm steps and SPI waves at a small
    size, with duplicate groups, nacks and a preemption; every result
    and every state plane must be equal."""
    from gigapaxos_tpu_torch.ops.storm import decide_storm_step, make_fleet
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend
    devs = ("cuda", "cpu")
    G, W, R, B = 4096, 16, 3, 4096
    rng = np.random.default_rng(11)
    fleets = [make_fleet(G, W, R, device=d) for d in devs]
    for step in range(4):
        lanes = (rng.integers(0, G // 2, B).astype(np.int32),
                 rng.integers(1, 1 << 30, B).astype(np.int32),
                 rng.integers(-(1 << 30), 1 << 30, B).astype(np.int32),
                 rng.random(B) < 0.9)
        ns = [int(decide_storm_step(f, *(torch.from_numpy(a).to(d)
                                         for a in lanes))[1])
              for f, d in zip(fleets, devs)]
        _same(ns[0], ns[1], f"storm step {step} decided")
    for r in range(R):
        _same(state_to_numpy(fleets[0][r]), state_to_numpy(fleets[1][r]),
              f"storm replica {r}")

    G, W, n = 512, 8, 400
    bks = [ColumnarBackend(G, W, device=d) for d in devs]
    rows = np.arange(n, dtype=np.int32)
    members = rng.choice([1, 3, 5], n).astype(np.int32)
    for b in bks:
        b.create(rows, members, np.zeros(n, np.int32),
                 np.zeros(n, np.int32), np.ones(n, bool))
    for it in range(4):
        g = rng.integers(0, G, 600, dtype=np.int32)  # inactive rows too
        reqs = rng.integers(1, 1 << 62, 600).astype(np.uint64)
        midx = np.zeros(600, np.int32)
        ps = [b.propose_self(g, reqs, midx) for b in bks]
        _same(ps[0], ps[1], f"spi {it} propose_self")
        pr = ps[0][0]
        sl = np.flatnonzero(pr.granted)
        k = len(sl)
        acked = rng.random(k) < 0.9
        bal = np.where(acked | (rng.random(k) < 0.8), pr.cbal[sl],
                       pr.cbal[sl] + (1 << 12))  # a few preempting nacks
        rs = [b.accept_reply_commit_self(g[sl], pr.slot[sl], bal,
                                         np.ones(k, np.int32), acked)
              for b in bks]
        _same(rs[0], rs[1], f"spi {it} reply_commit_self")
        dec = rs[0][0].newly_decided
        acs = [b.accept_commit(g[sl], pr.slot[sl], pr.cbal[sl], reqs[sl],
                               g[sl][dec], pr.slot[sl][dec],
                               reqs[sl][dec]) for b in bks]
        _same(acs[0], acs[1], f"spi {it} accept_commit")
        prr = [b.propose_self_reply(g, reqs ^ np.uint64(7), midx, g[sl],
                                    pr.slot[sl], pr.cbal[sl],
                                    np.full(k, 2, np.int32),
                                    np.ones(k, bool)) for b in bks]
        _same(prr[0], prr[1], f"spi {it} propose_self_reply")
        pps = [b.propose(g, reqs ^ np.uint64(11)) for b in bks]
        _same(pps[0], pps[1], f"spi {it} propose")
    sel = np.arange(0, 64, dtype=np.int32)
    bals = np.full(64, (2 << 12) | 1, np.int32)
    preps = [b.prepare(sel, bals) for b in bks]
    _same(preps[0], preps[1], "spi prepare")
    p = preps[0]
    carry = (p.win_req_lo.view(np.uint32).astype(np.uint64) |
             (p.win_req_hi.view(np.uint32).astype(np.uint64) << 32))
    for b in bks:
        b.install_coordinator(sel, bals, p.exec_cursor + 2, p.win_slot,
                              carry)
        b.set_cursor(sel[:8], np.full(8, 3, np.int32),
                     np.full(8, 5, np.int32))
        b.gc(sel, sel - 1)
        b.delete(sel[60:])
    _same(state_to_numpy(bks[0].state), state_to_numpy(bks[1].state),
          "spi final state")
    del fleets, bks
    torch.cuda.empty_cache()


def phase1_host_state(G, W, rng):
    """A numpy state with inactive rows, advanced cursors, promised
    ballots and an accepted window whose slots sit in their own columns
    (``slot % W``), some stale, some empty: what prepare gathers and
    install_coordinator carries over."""
    from gigapaxos_tpu_torch.ops.types import (NO_BALLOT, NO_SLOT,
                                               make_state, state_to_numpy)
    host = state_to_numpy(make_state(G, W, "cpu"))
    host["active"][:] = rng.random(G) < 0.9
    host["members"][:] = 3
    cur = rng.integers(0, 1000, G).astype(np.int32)
    host["exec_cursor"][:] = cur
    host["bal"][:] = (rng.integers(0, 8, G) << 12) | rng.integers(0, 3, G)
    base = cur[:, None].astype(np.int64) - 4  # four stale columns
    slot = base + (np.arange(W)[None, :] - base) % W
    empty = rng.random((G, W)) < 0.3
    acc = host["acc"]
    acc[..., 0] = np.where(empty, NO_SLOT, slot)
    acc[..., 1] = np.where(empty, NO_BALLOT, host["bal"][:, None]
                           - (rng.random((G, W)) < 0.5) * 4096)
    acc[..., 2] = rng.integers(-(1 << 31), 1 << 31, (G, W))
    acc[..., 3] = rng.integers(-(1 << 31), 1 << 31, (G, W))
    return host


def _raise_ballots(bal, rng):
    """New ballots for an election: most a round above the promise, a
    few at or below it (refused)."""
    return (bal + (rng.integers(-1, 3, len(bal)) << 12)).astype(np.int32) \
        | 1


def phase_phase1_parity(device="cuda"):
    """prepare and install_coordinator (torch-op bodies; the JAX package
    computes them with XLA, outside Pallas) on the card against the same
    calls on the CPU, where ``tests/test_torch_kernels.py`` holds them
    against the JAX package: on phase 5's 2^17-row slab at each bucket of
    the ladder, padded as the backend pads, then one
    ``ColumnarBackend.prepare`` of ``FO_PREPARE_ROWS`` rows (chunked)
    and the install of its acked rows, and last the pause path's
    ``snapshot_rows``/``restore_row`` on some of those rows.  Every plane
    and every live-lane output must be bit-identical.  Returns the wall
    seconds of the chunked prepare and install on each side.
    (``device="cpu"`` rehearses the comparison off the card.)"""
    from gigapaxos_tpu_torch.ops import kernels
    from gigapaxos_tpu_torch.ops.types import (NO_BALLOT, NO_SLOT,
                                               state_from_numpy,
                                               state_to_numpy)
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend, _bucket
    G, W = RT_CAPACITY, RT_WINDOW
    devs = (device, "cpu")  # the card's side first, the plain side second
    rng = np.random.default_rng(5)
    host = phase1_host_state(G, W, rng)
    sts = [state_from_numpy(host, d) for d in devs]

    def padded(n, b, *cols):
        out = []
        for col, fill in cols:
            a = np.full((b,) + col.shape[1:], fill, col.dtype)
            a[:n] = col
            out.append(a)
        return out

    def run(name, *arrays):
        return [getattr(kernels, name)(
            st, *(torch.from_numpy(np.ascontiguousarray(a)).to(d)
                  for a in arrays))[1] for st, d in zip(sts, devs)]

    def same_planes(a, b, what):
        _same(state_to_numpy(a), state_to_numpy(b), f"state after {what}")

    for B in RT_BUCKETS:
        n = int(rng.integers(B // 8 + 1, B + 1))
        rows = rng.choice(G, n, replace=False).astype(np.int32)
        bals = _raise_ballots(host["bal"][rows], rng)
        outs = run("prepare", *padded(n, B, (rows, 0), (bals, NO_BALLOT)),
                   np.arange(B) < n)
        live = [tuple(x.cpu().numpy()[:n] for x in o) for o in outs]
        _same(live[0], live[1], f"prepare, {n} of B={B}")
        same_planes(*sts, f"prepare, {n} of B={B}")
        acked, _cb, cursor, wslot, _wb, wlo, whi = live[1]
        sel = np.flatnonzero(acked)
        k = len(sel)
        b = _bucket(k)
        carry = np.where(wslot[sel] >= cursor[sel, None], wslot[sel],
                         NO_SLOT).astype(np.int32)
        run("install_coordinator",
            *padded(k, b, (rows[sel], 0), (bals[sel], NO_BALLOT),
                    ((cursor[sel] + W // 2).astype(np.int32), 0),
                    (carry, NO_SLOT), (wlo[sel], 0), (whi[sel], 0)),
            np.arange(b) < k)
        same_planes(*sts, f"install_coordinator, {k} of B={b}")
    del sts

    # the takeover's shape: one prepare of node 0's share, chunked
    bks = []
    for d in devs:
        bk = ColumnarBackend(G, W, device=d)
        bk.state = state_from_numpy(host, d)
        bks.append(bk)
    rows = rng.choice(G, FO_PREPARE_ROWS, replace=False).astype(np.int32)
    bals = _raise_ballots(host["bal"][rows], rng)
    secs = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    res = [timed(f"prepare_{side}", lambda bk=bk: bk.prepare(rows, bals))
           for side, bk in zip(("card", "cpu"), bks)]
    _same(tuple(res[0]), tuple(res[1]),
          f"ColumnarBackend.prepare of {FO_PREPARE_ROWS} rows")
    p = res[1]
    sel = np.flatnonzero(p.acked)
    carry = (p.win_req_lo[sel].view(np.uint32).astype(np.uint64)
             | (p.win_req_hi[sel].view(np.uint32).astype(np.uint64) << 32))
    for side, bk in zip(("card", "cpu"), bks):
        timed(f"install_{side}", lambda bk=bk: bk.install_coordinator(
            rows[sel], bals[sel], p.exec_cursor[sel] + 1, p.win_slot[sel],
            carry))
    same_planes(bks[0].state, bks[1].state,
                f"installing {len(sel)} of {FO_PREPARE_ROWS} rows")
    # pause and unpause: rows out of the slab (snapshot_rows) and back
    # into free rows (restore_row), as the deactivator moves them
    moved = rows[sel][:PAUSED_ROWS]
    snaps = [bk.snapshot_rows(moved) for bk in bks]
    for i, (a, b) in enumerate(zip(*snaps)):
        _same(a, b, f"snapshot_rows, row {moved[i]}")
    free = rng.choice(np.setdiff1d(np.arange(G), rows), len(moved),
                      replace=False)
    for bk, sn in zip(bks, snaps):
        for r, snap in zip(free.tolist(), sn):
            bk.restore_row(r, snap)
    same_planes(bks[0].state, bks[1].state,
                f"restoring {len(moved)} snapshots into free rows")
    del bks
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"rows": FO_PREPARE_ROWS, "acked": len(sel), **secs}


# -- phase 3 -----------------------------------------------------------------


def phase_storm():
    """``STORM_STEPS`` decide-storm steps at full width, each step's
    propose (one launch of the propose kernel), accept-replies and
    commits (three launches each of the accept-reply and commit kernels)
    under ``torch.cuda.set_sync_debug_mode("error")``: they must not
    synchronize the host with the card."""
    from gigapaxos_tpu_torch.ops import kernels
    from gigapaxos_tpu_torch.ops.storm import decide_storm_step, make_fleet
    G, W, R, B = G_FULL, W_FULL, R_FULL, STORM_B
    states = make_fleet(G, W, R)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    dev = torch.device("cuda")
    cursor_want = torch.zeros(G, dtype=torch.int64, device=dev)
    steps = []
    for _ in range(STORM_STEPS):
        g = torch.randint(0, G, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
        rlo = torch.randint(1, 1 << 30, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        rhi = torch.randint(1, 1 << 30, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        steps.append((g, rlo, rhi, valid))
    commit_batch, propose_batch = kernels.commit_batch, kernels.propose_batch
    accept_reply_batch = kernels.accept_reply_batch

    def no_sync(fn):
        def call(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    torch.cuda.synchronize()
    reset_launches()
    decided_total = 0
    wall = 0.0
    # the storm calls them by name
    kernels.commit_batch = no_sync(commit_batch)
    kernels.propose_batch = no_sync(propose_batch)
    kernels.accept_reply_batch = no_sync(accept_reply_batch)
    try:
        for i, (g, rlo, rhi, valid) in enumerate(steps):
            t0 = time.perf_counter()
            states, n = decide_storm_step(states, g, rlo, rhi, valid)
            decided = int(n)  # synchronizes
            wall += time.perf_counter() - t0
            # granted == per group min(lanes, W): every earlier slot decided
            per_group = torch.bincount(g.long(), minlength=G).clamp(max=W)
            granted = int(per_group.sum())
            cursor_want += per_group
            if decided != granted:
                raise AssertionError(f"storm step {i}: decided {decided} "
                                     f"!= granted {granted}")
            decided_total += decided
    finally:
        kernels.commit_batch = commit_batch
        kernels.propose_batch = propose_batch
        kernels.accept_reply_batch = accept_reply_batch
    counts = launches()
    for r in range(R):
        if not torch.equal(states[r].exec_cursor.long(), cursor_want):
            raise AssertionError(f"storm: replica {r} exec_cursor differs "
                                 "from the recount")
        if r and not torch.equal(states[r].dec, states[0].dec):
            raise AssertionError(f"storm: replica {r} dec plane differs")
    del states
    torch.cuda.empty_cache()
    # one propose launch a step, one accept, one accept-reply and one
    # commit launch a replica a step, and no wave kernel runs
    want = {"accept": STORM_STEPS * R, "commit": STORM_STEPS * R,
            "propose": STORM_STEPS, "accept_reply": STORM_STEPS * R,
            "acceptor_wave": 0, "coordinator_wave": 0}
    if counts != want:
        raise AssertionError(f"storm: launches {counts} != {want}")
    return {"decided": decided_total, "wall_s": wall,
            "decisions_per_s": decided_total / wall, "launches": counts}


# -- phase 4 -----------------------------------------------------------------


def phase_spi():
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend, _chunks
    G, W, B = G_FULL, W_FULL, SPI_B
    bks = [ColumnarBackend(G, W) for _ in range(3)]
    rows = np.arange(G, dtype=np.int32)
    for r, b in enumerate(bks):
        b.create(rows, np.full(G, 3, np.int32), np.zeros(G, np.int32),
                 np.zeros(G, np.int32), np.full(G, r == 0))
    torch.cuda.synchronize()
    rng = np.random.default_rng(1)
    granted_rows = []
    decided_total = granted_total = 0
    # exact launches: a plain propose wave is one propose launch a chunk,
    # a plain accept wave one accept launch a chunk, a plain accept_reply
    # wave one accept-reply launch a chunk; a commit wave and a fused
    # acceptor wave one acceptor-wave launch a chunk
    want = dict.fromkeys(KERNEL_NAMES, 0)

    def replies(g, pr, acks):
        newly = np.zeros(len(g), np.int32)
        for s in range(3):
            rr = bks[0].accept_reply(g, pr.slot, pr.cbal,
                                     np.full(len(g), s, np.int32), acks[s])
            want["accept_reply"] += len(_chunks(len(g)))
            newly += rr.newly_decided
        if newly.max(initial=0) > 1:
            raise AssertionError("spi: a lane was decided twice")
        if np.any((newly == 1) != pr.granted):
            raise AssertionError("spi: granted lane not decided (or a "
                                 "non-granted lane decided)")
        return newly == 1

    def wave(it):
        g = rng.integers(0, G, B, dtype=np.int32)
        reqs = np.uint64((it + 1) << 40) | rng.integers(
            1, 1 << 31, B, dtype=np.int64).astype(np.uint64)
        want["propose"] += len(_chunks(B))
        return g, reqs, bks[0].propose(g, reqs)

    reset_launches()
    t0 = time.perf_counter()
    for it in range(SPI_ITERS):
        g, reqs, pr = wave(it)
        acks = []
        for b in bks:
            acks.append(b.accept(g, pr.slot, pr.cbal, reqs).acked &
                        pr.granted)
            want["accept"] += len(_chunks(B))
        newly = replies(g, pr, acks)
        for b in bks:
            b.commit(g, pr.slot, reqs)
            want["acceptor_wave"] += len(_chunks(B))
        decided_total += int(newly.sum())
        granted_total += int(pr.granted.sum())
        granted_rows.append(g[pr.granted])
    wall = time.perf_counter() - t0
    plain_decided = decided_total
    # fused acceptor waves: this wave's accepts ride with the previous
    # wave's commits in one submit per replica
    pending = (np.zeros(0, np.int32), np.zeros(0, np.int32),
               np.zeros(0, np.uint64))
    for it in range(SPI_ITERS, SPI_ITERS + SPI_FUSED_ITERS):
        g, reqs, pr = wave(it)
        waves = [b.accept_commit_submit(g, pr.slot, pr.cbal, reqs,
                                        *pending) for b in bks]
        acks = []
        for wv in waves:
            ares, cres = wv.collect()
            if not cres.applied.all():
                raise AssertionError("spi: fused commit not applied")
            acks.append(ares.acked & pr.granted)
            want["acceptor_wave"] += len(_chunks(max(B, len(pending[0]))))
        newly = replies(g, pr, acks)
        pending = (g[newly], pr.slot[newly], reqs[newly])
        decided_total += int(newly.sum())
        granted_total += int(pr.granted.sum())
        granted_rows.append(g[pr.granted])
    for b in bks:
        if not b.commit(*pending).applied.all():
            raise AssertionError("spi: final commit not applied")
        want["acceptor_wave"] += len(_chunks(len(pending[0])))
    counts = launches()
    if decided_total != granted_total:
        raise AssertionError(f"spi: decided {decided_total} != granted "
                             f"{granted_total}")
    want_cursor = np.bincount(np.concatenate(granted_rows), minlength=G)
    for r, b in enumerate(bks):
        cur = b.state.exec_cursor.cpu().numpy()
        if not np.array_equal(cur, want_cursor):
            raise AssertionError(f"spi: replica {r} exec_cursor differs "
                                 "from the recount")
    if counts != want:
        raise AssertionError(f"spi: launches {counts} != {want}")
    mem = bks[0].memory_info()
    del bks
    torch.cuda.empty_cache()
    return {"decided": decided_total, "wall_s": wall,
            "decisions_per_s": plain_decided / wall,
            "launches": counts, "slab_bytes": mem["total_bytes"]}


# -- phase 5 -----------------------------------------------------------------


def _wait(cond, timeout_s: float, what: str, detail=None) -> None:
    """Poll ``cond`` until it holds; on timeout raise, with what
    ``detail()`` reports of the state at that moment."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            more = f" ({detail()})" if detail is not None else ""
            raise AssertionError(f"runtime: timed out waiting for {what}"
                                 f"{more}")
        time.sleep(0.05)


def _executed(nodes):
    """Each node's executed requests, summed over its app's groups."""
    return [sum(n.app.count.values()) for n in nodes]


def _runtime_threads():
    """Live threads of the node runtime (each is named ``gp-...``)."""
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("gp-") and t.is_alive()]


def _detection() -> dict:
    """The failure detection and congestion guard a phase runs under."""
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    return {"failure_timeout_s": Config.get(PC.FAILURE_TIMEOUT_S),
            "backlog_limit": Config.get(PC.INTAKE_BACKLOG_LIMIT)}


def _pin_lanes() -> None:
    """Phase 8's failure detection and congestion guard
    (``LANES_FAILURE_TIMEOUT_S``, ``LANES_BACKLOG_LIMIT``)."""
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    Config.set(PC.FAILURE_TIMEOUT_S, LANES_FAILURE_TIMEOUT_S)
    Config.set(PC.INTAKE_BACKLOG_LIMIT, LANES_BACKLOG_LIMIT)


def _settle(nodes, res, n_requests, strict, what):
    """Every request answered with status 0 and executed on every
    replica, or (not ``strict``) a failure only reported.  Returns
    whether all was answered and executed."""
    ok = res["ok"] == n_requests and not res["errors"]
    if strict and not ok:
        raise AssertionError(
            f"{what}: {res['ok']} of {n_requests} answered, "
            f"{res['errors']} errors: {json.dumps(res)}; coordinator "
            f"installs {sum(n.n_installs for n in nodes)}, shed "
            f"{sum(n.n_shed for n in nodes)}, re-driven "
            f"{sum(n.n_redriven for n in nodes)}")
    if ok:
        try:
            _wait(lambda: all(c == n_requests for c in _executed(nodes)),
                  RT_TIMEOUT_S, "every replica to execute every request",
                  lambda: f"executed {_executed(nodes)} of {n_requests}")
        except AssertionError:
            if strict:
                raise
            info(f"{what}: executed {_executed(nodes)} of {n_requests} "
                 f"after {RT_TIMEOUT_S} s")
            ok = False
    return ok


def phase_runtime(device="cuda", n_groups=RT_GROUPS, capacity=RT_CAPACITY,
                  n_requests=RT_REQUESTS, depth=RT_DEPTH, strict=True):
    """Config 2 through the node runtime: 3 ``PaxosNode``s on loopback,
    every fused wave of every node through the wave kernels.  Checks
    every request answered, the replicas in agreement (counts, digests,
    ``exec_cursor`` on every group that took traffic) and the launches.
    ``strict=False`` reports what the run did (requests answered,
    elections, agreement) instead of failing on it.
    ``device="cpu"`` runs the same drive on the plain versions (a small
    rehearsal off the card)."""
    import shutil
    import tempfile
    from gigapaxos_tpu_torch import native
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
    if not native.have_native():
        raise AssertionError("runtime: the host C++ hot path did not build "
                             "(native.have_native() is false)")
    Config.set(PC.COLUMNAR_DEVICE, device)
    Config.set(PC.PIPELINE_WORKER, True)
    Config.set(PC.FUSE_WAVES, "auto")
    Config.set(PC.PAUSE_IDLE_S, RT_PAUSE_IDLE_S)
    detection = _detection()
    logdir = tempfile.mkdtemp(prefix="gp_chip_smoke_")
    emu = None
    try:
        emu = PaxosEmulation(logdir, n_nodes=RT_NODES, n_groups=0,
                             app_cls=CounterApp, capacity=capacity,
                             window=RT_WINDOW, sync_wal=False)
        nodes = [emu.nodes[i] for i in range(RT_NODES)]
        if device == "cuda" and not all(n._fuse_waves for n in nodes):
            raise AssertionError("runtime: fused waves are off on the card")
        t0 = time.perf_counter()
        emu.create_groups(n_groups)
        create_s = time.perf_counter() - t0
        DelayProfiler.clear()
        reset_launches()
        res = emu.run_load_fast(n_requests, concurrency=depth,
                                timeout=RT_TIMEOUT_S)
        answered = _settle(nodes, res, n_requests, strict, "runtime")
        counts = launches()
        buckets = bucket_launches()
        totals = {k: v for k, v in DelayProfiler.totals().items()
                  if k.startswith(("w.", "eng.submit", "eng.collect"))}
        # elections won mid-phase (0 unless a peer was suspected) and
        # accepts the coordinators re-drove (a decision not back in 1 s)
        installs = sum(n.n_installs for n in nodes)
        redriven = sum(n.n_redriven for n in nodes)
        shed = sum(n.n_shed for n in nodes)
        if strict and installs:
            raise AssertionError(
                f"runtime: {installs} coordinators installed during the "
                f"load (a live peer suspected: spurious elections); "
                f"re-driven {redriven}, shed {shed}")
        emu.stop()
        emu = None
        # a node's stop joins its threads with bounded waits; one still
        # inside a torch call when the interpreter exits aborts the
        # process (std::terminate), and the state read below must not
        # race it, so every runtime thread must have ended
        _wait(lambda: not _runtime_threads(), RT_TIMEOUT_S,
              "the nodes' threads to end after stop")
        mems = [n.backend.memory_info() for n in nodes]
        apps = [dict(n.app.count) for n in nodes]
        digests = [dict(n.app.digest) for n in nodes]
        try:
            if any(c != apps[0] for c in apps[1:]):
                raise AssertionError("runtime: replicas' counts differ")
            if any(d != digests[0] for d in digests[1:]):
                raise AssertionError("runtime: replicas' digests differ")
            for i, n in enumerate(nodes):
                cur = state_to_numpy(n.backend.state)["exec_cursor"]
                for name, c in apps[i].items():
                    row = n.table.by_name(name).row
                    if int(cur[row]) != c:
                        raise AssertionError(
                            f"runtime: node {i} group {name}: exec_cursor "
                            f"{int(cur[row])} != count {c}")
            agree = True
        except AssertionError:
            if strict:
                raise
            agree = False
        if device == "cuda":
            require_waves(counts, "runtime", each=True)
        if "jax" in sys.modules:
            raise AssertionError("runtime: jax was imported")
    finally:
        if emu is not None:
            emu.stop()
        Config.clear()
        shutil.rmtree(logdir, ignore_errors=True)
    return {"groups": n_groups, "requests": n_requests, "depth": depth,
            "installs": installs, "redriven": redriven, "shed": shed,
            "create_s": create_s, "res": res, "launches": counts,
            "buckets": buckets, "totals": totals, "memory": mems,
            "detection": detection, "answered": answered, "agree": agree,
            "groups_with_traffic": len(apps[0])}


# -- phase 6 -----------------------------------------------------------------


def _node_threads(i):
    """Live threads of node ``i``'s loop, worker and pipeline stages."""
    import threading
    names = (f"gp-loop-{i}", f"gp-work-{i}", f"gp-node{i}-")
    return [t.name for t in threading.enumerate()
            if t.name.startswith(names) and t.is_alive()]


def _count_rows(backend, tally):
    """Count the rows each of ``backend``'s phase-1 calls takes."""
    for name in ("prepare", "install_coordinator"):
        fn = getattr(backend, name)

        def counted(rows, *args, _fn=fn, _name=name):
            tally[_name] += len(rows)
            return _fn(rows, *args)
        setattr(backend, name, counted)


def _quiesce(nodes, timeout_s):
    """Wait until the nodes' executed counters hold still over a few
    polls (no state-changing traffic left in flight)."""
    last, stable = None, 0
    deadline = time.monotonic() + timeout_s
    while stable < 3:
        if time.monotonic() > deadline:
            raise AssertionError("failover: the survivors never quiesced")
        cur = tuple(n.n_executed for n in nodes)
        stable = stable + 1 if cur == last else 0
        last = cur
        time.sleep(0.3)


def _check_agreement(nodes, what):
    """Equal counts and digests, and each node's ``exec_cursor`` equal to
    its count on every group that took traffic."""
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    counts = [dict(n.app.count) for n in nodes]
    digests = [dict(n.app.digest) for n in nodes]
    if any(c != counts[0] for c in counts[1:]):
        raise AssertionError(f"{what}: replicas' counts differ")
    if any(d != digests[0] for d in digests[1:]):
        raise AssertionError(f"{what}: replicas' digests differ")
    for n in nodes:
        cur = state_to_numpy(n.backend.state)["exec_cursor"]
        for name, c in counts[0].items():
            row = n.table.by_name(name).row
            if int(cur[row]) != c:
                raise AssertionError(
                    f"{what}: node {n.id} group {name}: exec_cursor "
                    f"{int(cur[row])} != count {c}")
    return len(counts[0])


def phase_failover(device="cuda", n_groups=RT_GROUPS, capacity=RT_CAPACITY,
                   n_requests=FO_REQUESTS, depth=FO_DEPTH, out_dir=None):
    """Config 2 loses its coordinator: 3 ``PaxosNode``s with the flight
    recorder armed, ``n_requests`` at ``depth``, node 0 killed, node 1
    takes over every group node 0 led (prepare and install on the card),
    then ``n_requests`` more through the survivors.  Writes node 1's
    capture into ``out_dir`` and returns the phase's numbers."""
    import shutil
    import tempfile
    from gigapaxos_tpu_torch.ops.types import unpack_ballot
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.paxos.packets import group_key
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
    Config.set(PC.COLUMNAR_DEVICE, device)
    Config.set(PC.PIPELINE_WORKER, True)
    Config.set(PC.FUSE_WAVES, "auto")
    Config.set(PC.INTAKE_BACKLOG_LIMIT, FO_BACKLOG_LIMIT)
    Config.set(PC.BLACKBOX_MB, FO_BLACKBOX_MB)
    Config.set(PC.BLACKBOX_S, 0.0)  # no age eviction: the whole history
    for key, val in FO_KNOBS.items():
        Config.set(getattr(PC, key), val)
    logdir = tempfile.mkdtemp(prefix="gp_chip_failover_")
    emu = None
    out = {}
    try:
        emu = PaxosEmulation(logdir, n_nodes=RT_NODES, n_groups=0,
                             app_cls=CounterApp, capacity=capacity,
                             window=RT_WINDOW, sync_wal=False)
        nodes = [emu.nodes[i] for i in range(RT_NODES)]
        if any(n.blackbox is None for n in nodes):
            raise AssertionError("failover: a node's recorder is not armed")
        t0 = time.perf_counter()
        emu.create_groups(n_groups)
        out["create_s"] = time.perf_counter() - t0
        led = [g for g in emu.groups if group_key(g) % RT_NODES == FO_VICTIM]
        succ = nodes[FO_SUCCESSOR]
        survivors = [n for n in nodes if n.id != FO_VICTIM]
        rows = {"prepare": 0, "install_coordinator": 0}
        for n in survivors:
            _count_rows(n.backend, rows)
        DelayProfiler.clear()
        reset_launches()
        waves0 = [n.blackbox.n_records for n in nodes]
        pre = emu.run_load_fast(n_requests, concurrency=depth,
                                timeout=FO_TIMEOUT_S)
        if pre["ok"] != n_requests or pre["errors"]:
            raise AssertionError(f"failover: before the kill {pre['ok']} of "
                                 f"{n_requests} answered: {json.dumps(pre)}")
        _wait(lambda: all(c == n_requests for c in _executed(nodes)),
              FO_TIMEOUT_S, "every replica to execute the first load",
              lambda: f"executed {_executed(nodes)} of {n_requests}")
        if sum(n.n_installs for n in nodes):
            raise AssertionError("failover: a coordinator was installed "
                                 "before the kill (spurious election)")
        out["pre"] = pre
        out["pre_launches"] = launches()
        pre_totals = DelayProfiler.totals()
        out["pre_ring"] = [n.blackbox.n_records - w0
                           for n, w0 in zip(nodes, waves0)]
        time.sleep(FO_KNOBS["PING_INTERVAL_S"])
        t_kill = time.monotonic()
        emu.kill(FO_VICTIM)
        # the dead node's threads must end before its state is let go (a
        # thread inside a torch call at exit aborts the process)
        _wait(lambda: not _node_threads(FO_VICTIM), FO_TIMEOUT_S,
              "the killed node's threads to end")
        detect_s = None
        deadline = t_kill + FO_TIMEOUT_S
        while succ.n_installs < len(led) or succ.open_elections:
            if detect_s is None and (succ.open_elections or succ.n_installs):
                detect_s = time.monotonic() - t_kill
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"failover: node {FO_SUCCESSOR} installed "
                    f"{succ.n_installs} of {len(led)} groups within "
                    f"{FO_TIMEOUT_S} s ({succ.open_elections} elections "
                    "open)")
            time.sleep(0.01)
        out["takeover_s"] = time.monotonic() - t_kill
        out["detect_s"] = out["takeover_s"] if detect_s is None else detect_s
        out["led"] = len(led)
        out["groups"] = n_groups
        out["capacity"] = capacity
        out["installs"] = succ.n_installs
        launches_kill = launches()
        post = emu.run_load_fast(n_requests, concurrency=depth,
                                 timeout=FO_TIMEOUT_S, client_id=1 << 21)
        if post["ok"] != n_requests or post["errors"]:
            raise AssertionError(f"failover: after the kill {post['ok']} of "
                                 f"{n_requests} answered: {json.dumps(post)}")
        out["post"] = post
        _wait(lambda: all(c == 2 * n_requests
                          for c in _executed(survivors)),
              FO_TIMEOUT_S, "every survivor to execute both loads",
              lambda: f"executed {_executed(survivors)} of "
                      f"{2 * n_requests}")
        _quiesce(survivors, FO_TIMEOUT_S)
        out["launches"] = launches()
        out["post_launches"] = {k: v - launches_kill[k]
                                for k, v in out["launches"].items()}
        if device == "cuda":
            require_waves(out["post_launches"], "failover after the kill",
                          each=False)
        totals = DelayProfiler.totals()
        out["totals"] = {k: v for k, v in totals.items()
                         if k.startswith(("w.prepare", "w.install"))}
        out["process"] = {"pre": pre_totals.get("w.process"),
                          "all": totals.get("w.process")}
        out["rows"] = rows
        out["elections_after"] = succ.n_installs - len(led)
        t0 = time.perf_counter()
        for _ in range(20):
            succ._bb_digest(0)
        # the recorder folds the slab's host mirrors twice a wave
        out["digest_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        t0 = time.perf_counter()
        path = succ.blackbox.dump("failover")
        out["dump_s"] = time.perf_counter() - t0
        out["ring"] = succ.blackbox.snapshot()
        if out_dir is not None:
            path = shutil.copy(path, out_dir)
        out["capture"] = path
        emu.stop()
        emu = None
        _wait(lambda: not _runtime_threads(), FO_TIMEOUT_S,
              "the nodes' threads to end after stop")
        out["groups_with_traffic"] = _check_agreement(survivors, "failover")
        for name in led[:: max(1, len(led) // 64)]:
            row = succ.table.by_name(name).row
            for bal in (int(succ._bal[row]),
                        int(succ.backend.inspect_rows([row])["bal"][0])):
                if unpack_ballot(bal)[1] != FO_SUCCESSOR:
                    raise AssertionError(
                        f"failover: group {name} ballot {bal} is not led "
                        f"by node {FO_SUCCESSOR}")
        if "jax" in sys.modules:
            raise AssertionError("failover: jax was imported")
    finally:
        if emu is not None:
            emu.stop()
        Config.clear()
        shutil.rmtree(logdir, ignore_errors=True)
    return out


# -- phase 7 -----------------------------------------------------------------


def replay_one(path, device="cuda", knobs=None):
    """Replay one capture on ``device``: verdict ``MATCH``, not partial,
    no group mismatch, and (on the card) a wave kernel launched.
    ``knobs`` are the tick-driven settings (``PC`` names) the capture was
    recorded under; the defaults for the rest."""
    from gigapaxos_tpu_torch.blackbox.replay import replay_capture
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    Config.set(PC.COLUMNAR_DEVICE, device)
    for key, val in (knobs or {}).items():
        Config.set(getattr(PC, key), val)
    try:
        reset_launches()
        t0 = time.perf_counter()
        rep = replay_capture(path)
        rep["wall_s"] = time.perf_counter() - t0
        rep["launches"] = launches()
    finally:
        Config.clear()
    if rep["verdict"] != "MATCH" or rep["partial"] or \
            rep["group_mismatches"] or rep["row_mismatches"]:
        from gigapaxos_tpu_torch.blackbox.replay import render_report
        raise AssertionError(f"replay of {path}:\n{render_report(rep)}")
    if device == "cuda":
        require_waves(rep["launches"], f"replay of {path}", each=False)
    if "jax" in sys.modules:
        raise AssertionError("replay: jax was imported")
    return rep


def phase_replay(capture, n_groups, device="cuda"):
    """The committed JAX-written captures, then phase 6's: each must
    replay ``MATCH`` through the port's node; phase 6's must hold every
    group, the whole history (nothing evicted) and the takeover's
    prepare and install waves."""
    import os
    from gigapaxos_tpu_torch.blackbox.capture import read_capture
    here = os.path.dirname(os.path.abspath(__file__))
    reps = [replay_one(os.path.join(here, p), device, knobs)
            for p, knobs in REPLAY_REFS]
    records, manifest = read_capture(capture)
    if manifest["n_evicted"] != 0:
        raise AssertionError(f"replay: phase 6's ring evicted "
                             f"{manifest['n_evicted']} records")
    rep = replay_one(capture, device, FO_KNOBS)
    if rep["groups"] != n_groups:
        raise AssertionError(f"replay: {rep['groups']} groups in phase 6's "
                             f"capture, not {n_groups}")
    # the takeover's waves: each F record holding a prepare or its reply
    # must have its W record (MATCH held every W record to the replay's)
    from gigapaxos_tpu_torch.paxos.packets import PacketType
    phase1 = (PacketType.PREPARE_BATCH, PacketType.PREPARE_REPLY_BATCH)
    waves = {r["wave"] for r in records if r["t"] == "F"
             and any(f and f[0] in phase1 for f in r["frames"])}
    verified = {r["wave"] for r in records if r["t"] == "W"}
    if not waves or not waves <= verified:
        raise AssertionError(f"replay: phase 6's capture holds {len(waves)}"
                             f" prepare waves, {len(waves - verified)} of "
                             "them without a wave record")
    rep["prepare_waves"] = len(waves)
    return reps + [rep]


def phase_failover_and_replay(device="cuda", n_groups=RT_GROUPS,
                              capacity=RT_CAPACITY, n_requests=FO_REQUESTS,
                              depth=FO_DEPTH):
    """Phases 6 and 7, with phase 6's capture in a directory removed
    after the replays."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="gp_chip_capture_")
    try:
        fo = phase_failover(device, n_groups, capacity, n_requests, depth,
                            out_dir=tmp)
        reps = phase_replay(fo["capture"], n_groups, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return fo, reps


# -- phase 8 -----------------------------------------------------------------


# metric_name{label="value",...} <number>
_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?P<labels>\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?'
    r'|NaN|[+-]?Inf))$')


def exposition_series(text: str) -> dict:
    """A Prometheus text exposition (format 0.0.4) as ``{series: value}``;
    raises on a malformed line, a family declared twice, a duplicate
    series, or a sample of no declared family."""
    typed, series = {}, {}
    for ln in text.splitlines():
        if not ln.strip() or ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, mtype = ln.split(None, 3)
            if name in typed or mtype not in ("counter", "gauge",
                                              "summary", "histogram"):
                raise AssertionError(f"metrics: bad TYPE line {ln!r}")
            typed[name] = mtype
            continue
        m = _SAMPLE.match(ln)
        if m is None:
            raise AssertionError(f"metrics: malformed line {ln!r}")
        key = ln.rsplit(" ", 1)[0]
        if key in series:
            raise AssertionError(f"metrics: duplicate series {key}")
        base = m.group("name")
        if base not in typed and not any(
                base == n + suf and t == "summary"
                for n, t in typed.items() for suf in ("_sum", "_count")):
            raise AssertionError(f"metrics: {base} has no TYPE")
        series[key] = float(m.group("value"))
    if not series:
        raise AssertionError("metrics: empty exposition")
    return series


def _scrape(port: int, path: str) -> bytes:
    """GET ``path`` off a node's stats listener on loopback; on a timeout
    every thread's stack goes to stderr first (what held the node's loop
    thread or its engine locks)."""
    import faulthandler
    import socket
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"lanes: GET {path} answered "
                                     f"{r.status}")
            return r.read()
    except (socket.timeout, TimeoutError):
        print(f"chip_smoke: GET {path} on port {port} timed out; the "
              "threads:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise


def _check_scrapes(node, n_groups, slab_bytes, cuda=True):
    """``/engine``, ``/engine/kernels`` and ``/metrics`` of one node of
    the lanes phase; returns the ``/engine`` view and the series count."""
    port = node.stats_http.port
    eng = json.loads(_scrape(port, "/engine"))
    mem, bal, waves = eng["memory"], eng["balance"], eng["waves"]
    what = f"lanes: node {node.id} /engine"
    if eng["engine_shards"] != LANES:
        raise AssertionError(f"{what}: engine_shards {eng['engine_shards']}")
    if len(bal["shards"]) != LANES or \
            sum(bal["shards"]) != bal["rows_active"] or \
            bal["rows_active"] != n_groups:
        raise AssertionError(f"{what}: balance {bal}")
    if sorted(waves["per_shard"]) != [str(k) for k in range(LANES)]:
        raise AssertionError(f"{what}: waves.per_shard "
                             f"{sorted(waves['per_shard'])}")
    if mem["total_bytes"] != sum(mem["planes"].values()) or \
            (slab_bytes is not None and mem["total_bytes"] != slab_bytes):
        raise AssertionError(f"{what}: memory {mem['total_bytes']} B, "
                             f"planes {mem['planes']}, one slab "
                             f"{slab_bytes} B")
    ks = json.loads(_scrape(port, "/engine/kernels"))
    want = {"propose_p", "accept_p", "accept_reply_p", "commit_p",
            "accept_commit_p", "request_reply_p"}
    if set(ks["costs"]) != want or any(
            r["flops"] is not None or not r["bytes_accessed"] > 0
            for r in ks["costs"].values()):
        raise AssertionError(f"lanes: node {node.id} /engine/kernels "
                             f"{ks['costs']}")
    # on the card, one ledger row a CUDA library built or loaded in this
    # process (the commit, propose and accept-reply kernels' only where an
    # earlier phase ran them), the runtime's two (the accept kernel's and
    # the wave kernels') loaded
    libs = {k: r for k, r in ks["kernels"].items() if k.startswith("cuda:")}
    ran = ("cuda:accept", "cuda:wave")
    if cuda and (not set(ran) <= set(libs) <=
                 {*ran, "cuda:commit", "cuda:propose",
                  "cuda:accept_reply"} or any(
            libs[k]["loads"] < 1 for k in ran)):
        raise AssertionError(f"lanes: node {node.id} /engine/kernels "
                             f"ledger rows {ks['kernels']}")
    series = exposition_series(_scrape(port, "/metrics").decode())
    if series.get("gp_engine_shards") != LANES:
        raise AssertionError(f"lanes: node {node.id} /metrics lacks "
                             "gp_engine_shards 4")
    return eng, len(series)


def phase_lanes(device="cuda", n_groups=RT_GROUPS, capacity=RT_CAPACITY,
                n_requests=RT_REQUESTS, depth=RT_DEPTH, slab_bytes=None,
                pins=True, strict=True):
    """Phase 5's drive at ``ENGINE_SHARDS=4``, every node's stats listener
    on: each node's rows in four slabs, each slab on its own stream,
    every lane's worker submitting waves.  Checks phase 5's answers and
    agreement, four WAL segments a node, the streams, the per-lane
    profiler totals and the live scrapes (``slab_bytes``: phase 5's one
    slab, which the four must add up to).  ``pins``: failure detection
    and the guard as ``_pin_lanes`` sets them, else at the package
    defaults.  ``device="cpu"`` rehearses the drive off the card;
    ``strict`` is :func:`phase_runtime`'s (a run that leaves requests
    unanswered is then reported without its scrapes, which its nodes'
    catch-up traffic would hold up)."""
    import asyncio
    import os
    import shutil
    import tempfile
    from gigapaxos_tpu_torch.net.cluster import (merge_cluster_engine,
                                                 scrape_cluster)
    from gigapaxos_tpu_torch.paxos.backend import ShardedColumnarBackend
    from gigapaxos_tpu_torch.paxos.interfaces import CounterApp
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.testing.harness import PaxosEmulation
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
    Config.set(PC.COLUMNAR_DEVICE, device)
    Config.set(PC.PIPELINE_WORKER, True)
    Config.set(PC.FUSE_WAVES, "auto")
    Config.set(PC.PAUSE_IDLE_S, RT_PAUSE_IDLE_S)
    Config.set(PC.ENGINE_SHARDS, LANES)
    Config.set(PC.STATS_PORT, 0)
    if pins:
        _pin_lanes()
    detection = _detection()
    logdir = tempfile.mkdtemp(prefix="gp_chip_lanes_")
    emu = None
    out = {"groups": n_groups, "requests": n_requests, "depth": depth,
           "detection": detection}
    try:
        emu = PaxosEmulation(logdir, n_nodes=RT_NODES, n_groups=0,
                             app_cls=CounterApp, capacity=capacity,
                             window=RT_WINDOW, sync_wal=False)
        nodes = [emu.nodes[i] for i in range(RT_NODES)]
        for n in nodes:
            if n.shards != LANES or not isinstance(
                    n.backend, ShardedColumnarBackend) or \
                    [s.capacity for s in n.backend.slabs] != \
                    [capacity // LANES] * LANES:
                raise AssertionError(f"lanes: node {n.id} runs "
                                     f"{n.shards} lanes")
            if n.stats_http is None:
                raise AssertionError(f"lanes: node {n.id} has no stats "
                                     "listener")
        if device == "cuda":
            if not all(n._fuse_waves for n in nodes):
                raise AssertionError("lanes: fused waves are off on the "
                                     "card")
            # one stream a slab, none of them the default stream
            handles = [s.stream.cuda_stream for n in nodes
                       for s in n.backend.slabs]
            legacy = torch.cuda.default_stream().cuda_stream
            if len(set(handles)) != len(handles) or \
                    any(h in (0, legacy) for h in handles):
                raise AssertionError(f"lanes: slab streams {handles}, "
                                     f"default {legacy}")
            out["streams"] = handles
        t0 = time.perf_counter()
        emu.create_groups(n_groups)
        out["create_s"] = time.perf_counter() - t0
        DelayProfiler.clear()
        reset_launches()
        res = emu.run_load_fast(n_requests, concurrency=depth,
                                timeout=RT_TIMEOUT_S)
        out["answered"] = _settle(nodes, res, n_requests, strict, "lanes")
        out["res"] = res
        out["launches"] = launches()
        out["buckets"] = bucket_launches()
        info(f"lanes: the load: {json.dumps(res)}; installs "
             f"{sum(n.n_installs for n in nodes)}, shed "
             f"{sum(n.n_shed for n in nodes)}, re-driven "
             f"{sum(n.n_redriven for n in nodes)}; scraping")
        totals = DelayProfiler.totals()
        out["lanes"] = {k: {tag: totals.get(f"{tag}@{k}", (0.0, 0, 0))[:3]
                            for tag in ("eng.submit", "eng.collect",
                                        "eng.overlap")}
                        for k in range(LANES)}
        out["totals"] = {k: v for k, v in totals.items()
                         if k.startswith(("w.", "eng.submit",
                                          "eng.collect"))
                         and "@" not in k}
        for k, lane in out["lanes"].items():
            if not lane["eng.submit"][1]:
                raise AssertionError(f"lanes: lane {k}'s slab submitted "
                                     "no wave")
        out["installs"] = sum(n.n_installs for n in nodes)
        out["redriven"] = sum(n.n_redriven for n in nodes)
        out["shed"] = sum(n.n_shed for n in nodes)
        # the flight deck, scraped live off each node's listener
        out["engine"], out["series"], out["merged_bytes"] = [], [], None
        for n in nodes if out["answered"] else ():
            eng, n_series = _check_scrapes(n, n_groups, slab_bytes,
                                           device == "cuda")
            out["engine"].append(eng)
            out["series"].append(n_series)
        if out["answered"]:
            peers = {n.id: ("127.0.0.1", n.stats_http.port) for n in nodes}
            merged = merge_cluster_engine(asyncio.run(
                scrape_cluster(peers, "/engine", timeout=60.0)))
            if merged["cluster"]["nodes"] != {n.id: 1 for n in nodes}:
                raise AssertionError(f"lanes: cluster merge "
                                     f"{merged['cluster']}")
            out["merged_bytes"] = merged["memory"]["total_bytes"]
        for i in range(RT_NODES):
            segs = sorted(f for f in os.listdir(os.path.join(logdir,
                                                             f"n{i}"))
                          if f.startswith("wal"))
            if segs != [f"wal-{k}.log" for k in range(LANES)]:
                raise AssertionError(f"lanes: node {i}'s WAL files {segs}")
        emu.stop()
        emu = None
        _wait(lambda: not _runtime_threads(), RT_TIMEOUT_S,
              "the nodes' threads to end after stop")
        counts = [dict(n.app.count) for n in nodes]
        digests = [dict(n.app.digest) for n in nodes]
        try:
            if any(c != counts[0] for c in counts[1:]):
                raise AssertionError("lanes: replicas' counts differ")
            if any(d != digests[0] for d in digests[1:]):
                raise AssertionError("lanes: replicas' digests differ")
            for i, n in enumerate(nodes):
                names = sorted(counts[i])
                rows = np.asarray([n.table.by_name(g).row for g in names])
                cur = n.backend.inspect_rows(rows)["exec_cursor"]
                for name, c in zip(names, cur.tolist()):
                    if c != counts[i][name]:
                        raise AssertionError(
                            f"lanes: node {i} group {name}: exec_cursor "
                            f"{c} != count {counts[i][name]}")
            out["agree"] = True
        except AssertionError:
            if strict:
                raise
            out["agree"] = False
        out["groups_with_traffic"] = len(counts[0])
        if device == "cuda":
            require_waves(out["launches"], "lanes", each=True)
        if "jax" in sys.modules:
            raise AssertionError("lanes: jax was imported")
    finally:
        if emu is not None:
            emu.stop()
        Config.clear()
        shutil.rmtree(logdir, ignore_errors=True)
    return out


# -- phase 9 -----------------------------------------------------------------


def _stage_delta(before: dict, after: dict) -> dict:
    """``w.*`` profiler totals over one window: (wall s, calls, items)
    each, for the tags that moved."""
    out = {}
    for tag, t in after.items():
        if not tag.startswith("w."):
            continue
        b = before.get(tag, (0.0, 0, 0))
        d = (t[0] - b[0], t[1] - b[1], t[2] - b[2])
        if d[1] > 0:
            out[tag] = d
    return out


def _stage_lines(tag, stages):
    for k in sorted(stages):
        wall_s, calls, items = stages[k]
        info(f"{tag} profiler {k}: {wall_s:.4f} s over {calls} calls, "
             f"{items} items")


def _rows_on(actives, names):
    """How many of ``names`` each active hosts (a row on its slab, or a
    row the deactivator paused), by active id."""
    from gigapaxos_tpu_torch.paxos.packets import group_key
    return {a.id: sum(a.node.table.by_name(nm) is not None
                      or group_key(nm) in a.node._paused for nm in names)
            for a in actives}


def phase_churn(device="cuda", n_names=CHURN_NAMES, capacity=CHURN_CAPACITY,
                chunk=CHURN_CHUNK, inflight=CHURN_INFLIGHT,
                sample=CHURN_SAMPLE, probe=CHURN_PROBE):
    """Config 4 through the port's control plane: 3 actives and 3
    reconfigurators (``ReconfigurableNode``s on loopback), each on a
    ``ColumnarBackend(capacity, 16)`` on ``device``; ``n_names`` names
    created through ``ReconfigurableAppClient.create_names`` in chunks of
    ``chunk``, ``inflight`` chunks at a time, then deleted the same way.
    Checks every create and delete acknowledged, ``sample`` names with a
    row on each of their actives after the creates (and a request to
    ``probe`` of them decided and answered) and on none after the
    deletes, and, on the card, the accept kernel and the acceptor wave
    kernel launched."""
    import asyncio
    import shutil
    import tempfile
    from gigapaxos_tpu_torch.paxos.interfaces import NoopApp
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.reconfiguration.appclient import \
        ReconfigurableAppClient
    from gigapaxos_tpu_torch.reconfiguration.node import (NodeConfig,
                                                          ReconfigurableNode)
    from gigapaxos_tpu_torch.testing.harness import free_ports
    from gigapaxos_tpu_torch.utils.config import Config
    from gigapaxos_tpu_torch.utils.profiler import DelayProfiler
    Config.set(PC.COLUMNAR_DEVICE, device)
    Config.set(PC.SYNC_WAL, False)
    Config.set(PC.PING_INTERVAL_S, 0.05)  # testing/main.py's churn cadence
    detection = _detection()
    ports = free_ports(CHURN_ACTIVES + CHURN_RCS)
    cfg = NodeConfig(
        actives={i: ("127.0.0.1", ports[i]) for i in range(CHURN_ACTIVES)},
        reconfigurators={100 + i: ("127.0.0.1", ports[CHURN_ACTIVES + i])
                         for i in range(CHURN_RCS)},
        actives_per_name=3)
    logdir = tempfile.mkdtemp(prefix="gp_chip_churn_")
    nodes = []
    ok = False
    try:
        for i in list(cfg.actives) + list(cfg.reconfigurators):
            nodes.append(ReconfigurableNode(i, cfg, NoopApp, logdir,
                                            capacity=capacity, window=16))
        engines = [n.active.node if n.active else n.reconfigurator.node
                   for n in nodes]
        for e in engines:
            if e.backend.device.type != device:
                raise AssertionError(f"churn: node {e.id} runs on "
                                     f"{e.backend.device}, not {device}")
        for n in nodes:
            n.start()
        actives = [n.active for n in nodes if n.active]
        names = [f"rchurn{i}" for i in range(n_names)]
        pick = np.random.default_rng(CHURN_SEED).choice(
            n_names, size=min(sample, n_names), replace=False)
        sampled = [names[i] for i in sorted(pick)]
        out = {"names": n_names, "device": device, "detection": detection,
               "capacity": capacity, "chunk": chunk, "inflight": inflight,
               "sample": len(sampled), "probe": min(probe, len(sampled))}

        async def wave(cli, op):
            done = 0
            chunks = [names[at:at + chunk]
                      for at in range(0, len(names), chunk)]
            for at in range(0, len(chunks), inflight):
                res = await asyncio.gather(
                    *[op(c) for c in chunks[at:at + inflight]])
                done += sum(res)
            return done

        async def body():
            cli = ReconfigurableAppClient((1 << 16) + 7, cfg,
                                          timeout=CHURN_TIMEOUT_S)
            try:
                t0 = time.perf_counter()
                out["created"] = await wave(cli, cli.create_names)
                out["create_s"] = time.perf_counter() - t0
                info(f"churn: {out['created']} of {n_names} creates "
                     f"acknowledged in {out['create_s']:.3f} s")
                out["stages_create"] = _stage_delta(
                    before, DelayProfiler.totals())
                _stage_lines("churn create", out["stages_create"])
                # (b) every sampled name on each of its three actives (the
                # third may ack after the majority), then one request to
                # each of the probe names decided and answered
                _wait(lambda: all(v == len(sampled) for v in
                                  _rows_on(actives, sampled).values()),
                      CHURN_TIMEOUT_S, "the sampled names on every active",
                      lambda: f"rows {_rows_on(actives, sampled)} of "
                              f"{len(sampled)}")
                got = await asyncio.gather(*[
                    cli.send_request(nm, f"probe {nm}".encode())
                    for nm in sampled[:probe]])
                out["answered"] = sum(
                    g == f"probe {nm}".encode()
                    for g, nm in zip(got, sampled[:probe]))
                mid = DelayProfiler.totals()
                t1 = time.perf_counter()
                out["deleted"] = await wave(cli, cli.delete_names)
                out["delete_s"] = time.perf_counter() - t1
                info(f"churn: {out['deleted']} of {n_names} deletes "
                     f"acknowledged in {out['delete_s']:.3f} s")
                out["stages_delete"] = _stage_delta(
                    mid, DelayProfiler.totals())
                _stage_lines("churn delete", out["stages_delete"])
            finally:
                await cli.close()

        def drops():
            """Frames the nodes' transports dropped, by cause."""
            out = {}
            for e in engines:
                for k, v in (("congestion", e.transport.drop_congestion),
                             ("peer_gone", e.transport.drop_peer_gone),
                             ("write_error", e.transport.drop_write_error)):
                    out[k] = out.get(k, 0) + v
            return out

        reset_launches()
        before = DelayProfiler.totals()
        asyncio.run(body())
        out["drops"] = drops()
        # (c) no sampled name keeps a row on any active once dropped
        _wait(lambda: not any(_rows_on(actives, sampled).values()),
              CHURN_TIMEOUT_S, "the sampled names to leave every active",
              lambda: f"rows {_rows_on(actives, sampled)}, transport "
                      f"drops {drops()}")
        out["launches"] = launches()
        out["buckets"] = bucket_launches()
        out["stages"] = _stage_delta(before, DelayProfiler.totals())
        out["installs"] = sum(e.n_installs for e in engines)
        out["shed"] = sum(e.n_shed for e in engines)
        out["redriven"] = sum(e.n_redriven for e in engines)
        out["memory"] = [e.backend.memory_info()["total_bytes"]
                         for e in engines]
        if out["created"] != n_names or out["deleted"] != n_names:
            raise AssertionError(
                f"churn: {out['created']} of {n_names} creates and "
                f"{out['deleted']} of {n_names} deletes acknowledged")
        if out["answered"] != min(probe, len(sampled)):
            raise AssertionError(f"churn: {out['answered']} of "
                                 f"{min(probe, len(sampled))} requests "
                                 "answered with their payload")
        if device == "cuda" and (out["launches"]["accept"] < 1 or
                                 out["launches"]["acceptor_wave"] < 1):
            raise AssertionError(f"churn: kernel launches "
                                 f"{out['launches']}: the accept kernel "
                                 "and the acceptor wave kernel must each "
                                 "launch")
        if "jax" in sys.modules:
            raise AssertionError("churn: jax was imported")
        ok = True
    finally:
        for n in nodes:
            n.stop()
        # a node thread still inside a torch call at interpreter exit
        # aborts the process: every runtime thread must have ended (on
        # the way out of a failure, the failure is what is reported)
        try:
            _wait(lambda: not _runtime_threads(), CHURN_TIMEOUT_S,
                  "the churn nodes' threads to end after stop",
                  lambda: f"alive {_runtime_threads()}")
        except AssertionError:
            if ok:
                raise
        Config.clear()
        shutil.rmtree(logdir, ignore_errors=True)
    return out


def _churn_lines(ch, line):
    ops = 2 * ch["names"]
    wall = ch["create_s"] + ch["delete_s"]
    d = ch["detection"]
    info(f"churn: {CHURN_ACTIVES} actives + {CHURN_RCS} reconfigurators, "
         f"each a ColumnarBackend({ch['capacity']}, 16) on "
         f"{ch['device']} ({sum(ch['memory'])} B in "
         f"{len(ch['memory'])} slabs); {ops} operations in {wall:.3f} s: "
         f"{ops / wall:.1f} ops/s; creates {ch['created']} of "
         f"{ch['names']} in {ch['create_s']:.3f} s "
         f"({ch['names'] / ch['create_s']:.1f}/s), deletes "
         f"{ch['deleted']} of {ch['names']} in {ch['delete_s']:.3f} s "
         f"({ch['names'] / ch['delete_s']:.1f}/s); chunks of "
         f"{ch['chunk']}, {ch['inflight']} in flight; failure timeout "
         f"{d['failure_timeout_s']} s, backlog limit {d['backlog_limit']} "
         f"({line})")
    info(f"churn: {ch['sample']} sampled names on each of their actives "
         f"after the creates and on none after the deletes; "
         f"{ch['answered']} of {ch['probe']} requests answered; "
         f"coordinator installs (elections won) {ch['installs']}, accepts "
         f"re-driven {ch['redriven']}, requests shed {ch['shed']}, frames "
         f"dropped {ch['drops']}; kernel "
         f"launches {ch['launches']}")
    info(f"churn: wave kernel launches by bucket (lanes: launches) "
         f"{json.dumps(ch['buckets'])}")


# -- phase 9b ----------------------------------------------------------------


def _listening(port: int) -> bool:
    import socket
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
        return True
    except OSError:
        return False


def phase_cli(device="cuda"):
    """The port's entry points as processes: ``python -m
    gigapaxos_tpu_torch.server`` for 3 actives and 1 reconfigurator (the
    chat app, the columnar backend on ``device``, each with a stats
    listener), one chat room created, posted to, read and deleted
    through ``python -m gigapaxos_tpu_torch.client_cli``, and every
    server's ``/engine/kernels`` scraped: on the card one server at least
    launched the accept kernel.  Every server is stopped on the way out;
    one that dies fails the phase with its stderr."""
    import os
    import shutil
    import tempfile
    from gigapaxos_tpu_torch.testing.harness import free_ports
    repo = str(Path(__file__).resolve().parent)
    ids = (0, 1, 2, 100)
    ports = free_ports(2 * len(ids))
    node_ports, stats_ports = ports[:len(ids)], ports[len(ids):]
    tmp = Path(tempfile.mkdtemp(prefix="gp_chip_cli_"))
    conf = tmp / "gp.properties"
    conf.write_text(
        "".join(f"active.{i}=127.0.0.1:{node_ports[i]}\n" for i in range(3))
        + f"reconfigurator.100=127.0.0.1:{node_ports[3]}\n"
        "APPLICATION=gigapaxos_tpu_torch.examples.chatapp:ChatApp\n"
        "CAPACITY=1024\nWINDOW=8\nBACKEND=columnar\nRC_GROUP_SIZE=1\n")
    env = dict(os.environ, PYTHONPATH=repo)
    if device != "cuda":  # a rehearsal off the card
        env["GP_PC_COLUMNAR_DEVICE"] = device
    procs, errs = [], []
    out = {"device": device}

    def died():
        for i, p in zip(ids, procs):
            if p.poll() is not None:
                raise AssertionError(
                    f"cli: server {i} exited {p.returncode}: "
                    + (tmp / f"err{i}.log").read_text()[-4000:])

    def cli(*args):
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "gigapaxos_tpu_torch.client_cli",
             "--config", str(conf), "--timeout", str(CLI_TIMEOUT_S),
             *args], env=env, capture_output=True, text=True,
            timeout=4 * CLI_TIMEOUT_S)
        out.setdefault("cli_s", []).append(time.perf_counter() - t)
        if r.returncode != 0:
            died()
            raise AssertionError(f"cli: client_cli {' '.join(args)} exited "
                                 f"{r.returncode}: {r.stderr[-4000:]}")
        return r.stdout.strip()

    try:
        t0 = time.perf_counter()
        for i, sp in zip(ids, stats_ports):
            errs.append(open(tmp / f"err{i}.log", "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gigapaxos_tpu_torch.server",
                 "--config", str(conf), "--id", str(i),
                 "--logdir", str(tmp / "logs"), "--stats-port", str(sp)],
                env=env, stdout=subprocess.DEVNULL, stderr=errs[-1],
                cwd=repo))
        deadline = time.monotonic() + CLI_BOOT_S
        for port in node_ports + stats_ports:
            while not _listening(port):
                died()
                if time.monotonic() > deadline:
                    raise AssertionError(f"cli: no server listened on "
                                         f"{port} within {CLI_BOOT_S} s")
                time.sleep(0.1)
        out["boot_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        checks = [
            (("create", "room1"), lambda s: s == "created"),
            (("actives", "room1"), lambda s: len(s.split()) == 3),
            (("send", "room1",
              '{"op":"post","who":"alice","msg":"hello card"}'),
             lambda s: '"ok": true' in s and '"seq": 1' in s),
            (("send", "room1", '{"op":"read","n":5}'),
             lambda s: "hello card" in s),
            (("delete", "room1"), lambda s: s == "deleted"),
            (("actives", "room1"), None),
        ]
        for args, ok in checks[:-1]:
            got = cli(*args)
            if not ok(got):
                raise AssertionError(f"cli: {' '.join(args)} printed "
                                     f"{got!r}")
        # the deleted room no longer resolves (client_cli exits 1)
        r = subprocess.run(
            [sys.executable, "-m", "gigapaxos_tpu_torch.client_cli",
             "--config", str(conf), "--timeout", str(CLI_TIMEOUT_S),
             *checks[-1][0]], env=env, capture_output=True, text=True,
            timeout=4 * CLI_TIMEOUT_S)
        if r.returncode != 1 or "no such service" not in r.stderr:
            raise AssertionError(f"cli: actives of the deleted room exited "
                                 f"{r.returncode}: {r.stdout!r} "
                                 f"{r.stderr[-2000:]!r}")
        out["round_trip_s"] = time.perf_counter() - t1
        died()
        out["kernels"] = {}
        for i, sp in zip(ids, stats_ports):
            ks = json.loads(_scrape(sp, "/engine/kernels"))
            out["kernels"][i] = ks["launches"]
        top = max(k["cuda:accept"] for k in out["kernels"].values())
        if device == "cuda" and top < 1:
            raise AssertionError(f"cli: no server launched the accept "
                                 f"kernel: {out['kernels']}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in errs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _cli_lines(cl, line):
    info(f"cli: 3 actives + 1 reconfigurator as `python -m "
         f"gigapaxos_tpu_torch.server` processes on {cl['device']}, "
         f"listening {cl['boot_s']:.3f} s after launch; create, actives, "
         f"post, read, delete and a failed lookup through `python -m "
         f"gigapaxos_tpu_torch.client_cli` in {cl['round_trip_s']:.3f} s "
         f"(each call {', '.join(f'{s:.2f}' for s in cl['cli_s'])} s); "
         f"/engine/kernels launches by server {json.dumps(cl['kernels'])} "
         f"({line})")


def _failover_lines(fo, line):
    for when in ("pre", "post"):
        r = fo[when]
        info(f"failover {when} the kill: {r['ok']} of {r['requests']} "
             f"answered at depth {FO_DEPTH} in {r['wall_s']} s: "
             f"{r['throughput_rps']} decided requests/s, client p50 "
             f"{r['lat_p50_ms']} ms, p99 {r['lat_p99_ms']} ms ({line})")
    info(f"failover: {fo['led']} of {fo['groups']} groups led by node "
         f"{FO_VICTIM}; kill to first prepare {fo['detect_s']:.3f} s, to "
         f"the last of {fo['installs']} installs on node {FO_SUCCESSOR} "
         f"{fo['takeover_s']:.3f} s (ping "
         f"{FO_KNOBS['PING_INTERVAL_S']} s, failure timeout "
         f"{FO_KNOBS['FAILURE_TIMEOUT_S']} s); groups created in "
         f"{fo['create_s']:.3f} s ({line})")
    info(f"failover: rows through the survivors' backend.prepare "
         f"{fo['rows']['prepare']}, install_coordinator "
         f"{fo['rows']['install_coordinator']}; kernel launches "
         f"{fo['pre_launches']} before the kill, "
         f"{fo['post_launches']} after the takeover; survivors agree on "
         f"{fo['groups_with_traffic']} groups with traffic")
    for tag in sorted(fo["totals"]):
        wall, calls, items = fo["totals"][tag][:3]
        info(f"failover profiler {tag}: {wall:.4f} s over {calls} calls, "
             f"{items} items")
    pre, tot = fo["process"]["pre"], fo["process"]["all"]
    if pre:
        info(f"failover recorder armed: w.process {pre[0]:.4f} s over "
             f"{pre[1]} waves before the kill, {tot[0]:.4f} s over {tot[1]}"
             f" in the whole load; node {FO_SUCCESSOR}'s ring "
             f"{fo['ring']['records']} records, {fo['ring']['bytes']} B, "
             f"{fo['ring']['evicted']} evicted; dump {fo['dump_s']:.3f} s; "
             f"one lane digest of the {fo['capacity']}-row slab "
             f"{fo['digest_ms']:.3f} ms (two a wave)")


def _replay_lines(reps, line):
    for r in reps:
        info(f"replay {r['file']}: {r['verdict']}, {r['waves_replayed']} "
             f"waves replayed ({r['waves_captured']} captured), "
             f"{r['frames']} frames, {r['groups']} groups, "
             f"{r.get('prepare_waves', 0)} prepare waves; create "
             f"{r['create_s']:.3f} s, replay {r['replay_s']:.3f} s, wall "
             f"{r['wall_s']:.3f} s; kernel launches {r['launches']} "
             f"({line})")


def _runtime_lines(rt, line, tag="runtime"):
    r = rt["res"]
    d = rt["detection"]
    info(f"{tag}: {RT_NODES} PaxosNodes on loopback, {rt['groups']} groups "
         f"created in {rt['create_s']:.3f} s; {r['ok']} of {rt['requests']} "
         f"requests answered ({r['errors']} errors) at depth {rt['depth']} "
         f"in {r['wall_s']} s: {r['throughput_rps']} decided requests/s, "
         f"client p50 {r['lat_p50_ms']} ms, p99 {r['lat_p99_ms']} ms; "
         f"failure timeout {d['failure_timeout_s']} s, backlog limit "
         f"{d['backlog_limit']} ({line})")
    n = max(1, rt["requests"])
    info(f"{tag}: replicas {'agree' if rt['agree'] else 'DISAGREE'} on "
         f"counts, digests and exec_cursor over {rt['groups_with_traffic']} "
         f"groups with traffic; kernel launches {rt['launches']}, "
         + ", ".join(f"{k} {v / n:.4f}" for k, v in rt["launches"].items())
         + f" a request; coordinator installs (elections won) "
         f"{rt['installs']}; accepts re-driven {rt['redriven']}; requests "
         f"shed {rt['shed']}")
    info(f"{tag}: wave kernel launches by bucket (lanes: launches) "
         f"{json.dumps(rt['buckets'])}")
    for k in sorted(rt["totals"]):
        wall, calls, items = rt["totals"][k][:3]
        info(f"{tag} profiler {k}: {wall:.4f} s over {calls} calls, "
             f"{items} items")
    for i, m in enumerate(rt["memory"]):
        info(f"{tag} engine {i} memory_info: {json.dumps(m)}")


def _lanes_lines(ln, rt, line, tag="lanes"):
    """The lanes phase beside phase 5's single lane, from the same run."""
    for what, d in (("one lane (phase 5)", rt), (f"{LANES} lanes", ln)):
        r = d["res"]
        info(f"{tag} compare, {what}: groups created in "
             f"{d['create_s']:.3f} s; {r['ok']} of {d['requests']} "
             f"answered ({r['errors']} errors) at depth {d['depth']} in "
             f"{r['wall_s']} s: {r['throughput_rps']} decided requests/s, "
             f"client p50 {r['lat_p50_ms']} ms, p99 {r['lat_p99_ms']} ms; "
             f"re-driven {d['redriven']}, installs {d['installs']}, shed "
             f"{d['shed']}, kernel "
             f"launches {d['launches']}; failure timeout "
             f"{d['detection']['failure_timeout_s']} s, backlog limit "
             f"{d['detection']['backlog_limit']} ({line})")
    info(f"{tag}: wave kernel launches by bucket (lanes: launches), "
         f"{LANES} lanes {json.dumps(ln['buckets'])}")
    for k, lane in ln["lanes"].items():
        info(f"{tag}: lane {k}: " + ", ".join(
            f"{t}@{k} {v[0]:.4f} s over {v[1]} calls, {v[2]} items"
            for t, v in lane.items()))
    for k in sorted(ln["totals"]):
        wall, calls, items = ln["totals"][k][:3]
        info(f"{tag} profiler {k}: {wall:.4f} s over {calls} calls, "
             f"{items} items")
    if not ln["engine"]:
        info(f"{tag}: not every request answered; no scrape, replicas "
             f"{'agree' if ln['agree'] else 'DISAGREE'}")
        return
    e = ln["engine"][0]
    info(f"{tag}: replicas "
         f"{'agree' if ln['agree'] else 'DISAGREE'} on counts, digests and "
         "exec_cursor over "
         f"{ln['groups_with_traffic']} groups with traffic; wal-0..3.log on "
         f"every node; slab streams {ln.get('streams')}; /engine of node 0: "
         f"balance {e['balance']['shards']}, memory "
         f"{e['memory']['total_bytes']} B in {LANES} slabs "
         f"({e['memory']['per_shard']}); /metrics series "
         f"{ln['series']}; cluster merge {ln['merged_bytes']} B, every node "
         "up")


# -- phase 10 ----------------------------------------------------------------


def _bench_mode(tag, argv, device):
    """One run of ``gigapaxos_tpu_torch.testing.main`` in this process,
    from the package defaults, on ``device``: its row, this process's
    kernel launches over the run, its wall seconds.  The node threads
    must have ended when it returns."""
    import shutil
    import tempfile
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.testing import main as bench
    from gigapaxos_tpu_torch.utils.config import Config
    Config.clear()
    if device != "cuda":  # a rehearsal off the card
        Config.set(PC.COLUMNAR_DEVICE, device)
    logdir = tempfile.mkdtemp(prefix=f"gp_chip_main_{tag}_")
    reset_launches()
    t0 = time.perf_counter()
    try:
        row = bench.run(argv + ["--logdir", logdir])
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    counts = launches()
    _wait(lambda: not _runtime_threads(), 30.0,
          f"{tag}: every node thread to end", _runtime_threads)
    Config.clear()
    return row, counts, wall


def _loads_ok(tag, loads):
    """Each named load answered every request with status 0."""
    for what, r in loads.items():
        if r["ok"] != r["requests"] or r["errors"]:
            raise AssertionError(
                f"main {tag}: {what} answered {r['ok']} of {r['requests']}"
                f" with {r['errors']} errors")


def check_main_row(tag, argv, row, device):
    """The row shows no failure (every request answered with status 0,
    the takeover complete, every group made, the tail group's request
    answered with status 0) and, on the card, kernel launches in its
    engine rollup."""
    i = row["info"]
    if "takeover_complete" in i:
        if not i["takeover_complete"]:
            raise AssertionError(
                f"main {tag}: takeover incomplete, {i['installed']} of "
                f"{i['takeover_target']} installed")
        _loads_ok(tag, {"pre": i["pre"], "post": i["post_through_failover"]})
    elif "post" in i:
        _loads_ok(tag, {"pre": i["pre"], "post": i["post"]})
    elif "tail_request_status" in i:
        n = int(argv[argv.index("--requests") + 1])
        tails = [i["tail_request_status"]] + (
            [i["recovery"]["tail_request_status"]] if "recovery" in i
            else [])
        if i["groups"] != n or any(tails):
            raise AssertionError(f"main {tag}: {i['groups']} of {n} groups "
                                 f"made, tail request status {tails}")
    else:
        _loads_ok(tag, {"measured": i})
        bad = [r for r in i.get("depth_sweep", []) if r["errors"]]
        if bad:
            raise AssertionError(f"main {tag}: errors in the sweep {bad}")
    if device == "cuda" and not sum(i["engine"]["launches"].values()):
        raise AssertionError(f"main {tag}: no kernel launch in the engine "
                             f"rollup {i['engine']['launches']}")


def phase_main(device="cuda", modes=MAIN_MODES):
    """Phase 10: the bench CLI's modes on the card, each held to
    :func:`check_main_row`; returns ``(tag, row, launches, wall_s)`` a
    mode.  Replicas as processes count their launches in their own
    processes: the row's ``engine`` carries them."""
    out = []
    for tag, argv in modes:
        row, counts, wall = _bench_mode(tag, list(argv), device)
        if "--multiproc" in argv:
            counts = {k[len("cuda:"):]: v for k, v in
                      row["info"]["engine"]["launches"].items()}
        try:
            check_main_row(tag, argv, row, device)
        except AssertionError:
            info(f"main row {tag} (failed): {_row_brief(row)}")
            raise
        out.append((tag, row, counts, wall))
    return out


def _row_brief(row) -> str:
    """The row as JSON without its profiler snapshot and stage totals."""
    return json.dumps({k: v for k, v in row.items() if k != "info"} | {
        "info": {k: v for k, v in row["info"].items()
                 if k not in ("profiler", "stage_totals")}})


def _main_lines(runs, line):
    for tag, row, counts, wall in runs:
        i = row["info"]
        head = (f"main {tag}: {row['metric']}: {row['value']} {row['unit']};"
                f" {wall:.3f} s of wall; kernel launches {counts}")
        if "takeover_s" in i:
            info(f"{head}; groups created in {i['create_s']} s, takeover "
                 f"{i['takeover_s']} s, {i['installed']} installed of "
                 f"{i['takeover_target']}, {i['spurious_pre_kill_installs']}"
                 f" spurious pre-kill installs; pre {i['pre']['ok']}/"
                 f"{i['pre']['requests']} at {i['pre']['throughput_rps']} "
                 f"req/s, through the takeover "
                 f"{i['post_through_failover']['ok']}/"
                 f"{i['post_through_failover']['requests']} p99 "
                 f"{i['post_through_failover']['lat_p99_ms']} ms ({line})")
            for k in sorted(i["stage_totals"]):
                if k.startswith(("fo.", "w.prepare")):
                    info(f"main {tag} stage {k}: "
                         f"{json.dumps(i['stage_totals'][k])}")
        elif "tail_request_status" in i:
            info(f"{head}; {i['groups']} groups in {i['wall_s']} s, bytes "
                 f"a group {i['bytes_per_group']} (host "
                 f"{i['host_bytes_per_group']}, device "
                 f"{i['device_bytes_per_group']}; host RSS +"
                 f"{i['rss_delta_mb']} MB, device +{i['device_delta_mb']} "
                 f"MB), tail request status {i['tail_request_status']}, "
                 f"recovery {json.dumps(i.get('recovery'))} ({line})")
        elif "post" in i:
            info(f"{head}; pre {i['pre']['ok']}/{i['pre']['requests']} at "
                 f"{i['pre']['throughput_rps']} req/s, post "
                 f"{i['post']['ok']}/{i['post']['requests']} at "
                 f"{i['post']['throughput_rps']} req/s p99 "
                 f"{i['post']['lat_p99_ms']} ms, post wall "
                 f"{i['post_wall_s']} s ({line})")
        else:
            lp = i["latency_point"]
            info(f"{head}; {i['ok']} of {i['requests']} answered, p50 "
                 f"{i['lat_p50_ms']} ms, p99 {i['lat_p99_ms']} ms; latency"
                 f" point at depth 32: {lp['throughput_rps']} req/s, p50 "
                 f"{lp['lat_p50_ms']} ms, p99 {lp['lat_p99_ms']} ms ({line})")
            for r in i.get("depth_sweep", []):
                info(f"main {tag} sweep depth {r['depth']}: "
                     f"{r['throughput_rps']} req/s, p50 {r['lat_p50_ms']} "
                     f"ms, p99 {r['lat_p99_ms']} ms, errors {r['errors']}"
                     + (" (knee)" if r["depth"] == i.get("knee_depth")
                        else ""))
            ch = i.get("consensus_health")
            if ch:
                info(f"main {tag} consensus health {json.dumps(ch)}")
        info(f"main row {tag}: {_row_brief(row)}")


# -- phase 11 ----------------------------------------------------------------


def phase_chaos(device="cuda", scenarios=None):
    """Phase 11: ``python -m gigapaxos_tpu_torch.chaos --seed 1`` in this
    process over the default drill (or ``scenarios``) on the port's
    columnar engine on ``device``: every row must hold all five
    invariants, and its fault schedule must be the one the reference
    recorded for seed 1 (``CHAOS_r02.json``'s fingerprints)."""
    import contextlib
    import io
    import tempfile
    from gigapaxos_tpu_torch.chaos import __main__ as chaos
    from gigapaxos_tpu_torch.paxos.paxosconfig import PC
    from gigapaxos_tpu_torch.utils.config import Config
    Config.clear()
    if device != "cuda":  # a rehearsal off the card
        Config.set(PC.COLUMNAR_DEVICE, device)
    names = list(scenarios or chaos.DEFAULT)
    ref = json.loads((Path(__file__).resolve().parent
                      / CHAOS_REFERENCE).read_text())
    ref_fp = {r["scenario"]: r["schedule_fingerprint"] for r in ref["rows"]}
    with tempfile.TemporaryDirectory(prefix="gp_chip_chaos_") as tmp:
        path = Path(tmp) / "chaos.json"
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = chaos.main(["--seed", str(ref["seed"]), "--scenarios",
                             ",".join(names), "--out", str(path)])
        wall = time.perf_counter() - t0
        counts = launches()
        rows = json.loads(path.read_text())["rows"]
    Config.clear()
    _wait(lambda: not _runtime_threads(), 30.0,
          "chaos: every node thread to end", _runtime_threads)
    bad = [(r["scenario"], r.get("error") or r.get("violations"))
           for r in rows if not r.get("ok")
           or not all(r["invariants"].values())]
    if rc or bad or len(rows) != len(names):
        raise AssertionError(f"chaos: exit {rc}, rows failing: {bad}")
    off = {r["scenario"]: r["schedule_fingerprint"] for r in rows
           if r["schedule_fingerprint"] != ref_fp[r["scenario"]]}
    if off:
        raise AssertionError(f"chaos: fault schedules differ from "
                             f"{CHAOS_REFERENCE}'s: {off}")
    if device == "cuda":
        require_waves(counts, "chaos", each=True)
    return {"rows": rows, "launches": counts, "wall_s": wall}


def _chaos_lines(ch, line):
    for r in ch["rows"]:
        f, s = r["faults"], r["storage_faults"]
        info(f"chaos {r['scenario']}: {r['backend']} on {r['n_nodes']} "
             f"nodes, {r['groups']} groups; invariants "
             f"{json.dumps(r['invariants'])}; recovery {r['recovery_s']} s,"
             f" {r['acked']} acked, {r['client_errors']} client errors, "
             f"wall {r['wall_s']} s; faults dropped {f['dropped']}, "
             f"blocked {f['blocked']}, delayed {f['delayed']}, reordered "
             f"{f['reordered']}; storage fsync EIO {s['fsync_eio']}, "
             f"ENOSPC {s['enospc']}; schedule {r['schedule_fingerprint']} "
             f"(= {CHAOS_REFERENCE})"
             + (f"; engine shards {r['engine_shards_timeline']}"
                if "engine_shards_timeline" in r else "") + f" ({line})")
    info(f"chaos: {len(ch['rows'])} scenarios in {ch['wall_s']:.3f} s, "
         f"kernel launches {ch['launches']}")


def _write_rows(path, mn, ch):
    """Phases 10 and 11's rows, whole, as JSON at ``path`` (if given)."""
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps({
            "main": [{"tag": t, "row": r, "launches": c, "wall_s": w}
                     for t, r, c, w in mn or []],
            "chaos": (ch or {}).get("rows", [])}, indent=1))


def _ptxas_lines(names):
    """What ptxas said of each built library's kernels: the entry, its
    registers, shared memory and spills."""
    from gigapaxos_tpu_torch.ops import _build
    for name in names:
        for ln in _build.ptxas_report(name).splitlines():
            if "registers" in ln or "spill" in ln or "entry" in ln:
                info(f"ptxas {name}: {ln.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runtime-only", choices=("cuda", "cpu"),
                    help="run only phase 5, with the engines on this "
                    "device (cpu: the same drive on the card's host, no "
                    "kernel), print its lines and exit")
    ap.add_argument("--failover-only", action="store_true",
                    help="run only phases 6 and 7 (failover, replay), "
                    "print their lines and exit")
    ap.add_argument("--lanes-only", action="store_true",
                    help="run only phases 5 and 8 (one engine lane, "
                    "then four), print their lines and exit")
    ap.add_argument("--wave-ab", metavar="DIR",
                    help="time the wave kernels of an older checkout "
                    "unpacked in DIR against this tree's, in turns on one "
                    "card (both bit-exact first), and exit")
    ap.add_argument("--storm-ab", metavar="DIR",
                    help="run the decide storm (phase 3) of an older "
                    "checkout unpacked in DIR and of this tree in turns on "
                    "one card, one process a run, and exit")
    ap.add_argument("--kernel-ab", metavar="DIR",
                    help="time the accept-reply and commit kernels of an "
                    "older checkout unpacked in DIR against this tree's "
                    "and its variants, in turns on one card (each "
                    "bit-exact first), and exit")
    ap.add_argument("--parity-only", action="store_true",
                    help="build, run phase 2's commit, propose, "
                    "accept-reply and wave kernel checks and phases 3 and "
                    "4 (their launch counts), print their lines and exit")
    ap.add_argument("--out", help="with --wave-ab, --storm-ab or "
                    "--kernel-ab: write its rows here as JSON; otherwise "
                    "phases 10 and 11's rows, whole")
    ap.add_argument("--main-only", action="store_true",
                    help="run only phase 10 (the bench CLI's modes), with "
                    "recovery at 1M groups, config 5 and config 6 too, "
                    "print their lines and exit")
    ap.add_argument("--chaos-only", action="store_true",
                    help="run only phase 11 (the chaos drill), print its "
                    "lines and exit")
    ap.add_argument("--churn-only", action="store_true",
                    help="run only phases 9 and 9b (config 4 through the "
                    "control plane, then the server and client processes), "
                    "print their lines and exit")
    ap.add_argument("--defaults", action="store_true",
                    help="run only phases 5 and 8 with failure detection "
                    "and the congestion guard at the package defaults "
                    "(phase 5 runs so in the whole run too) and report "
                    "what they did (answers, elections, sheds, agreement) "
                    "instead of failing on it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        from gigapaxos_tpu_torch.ops import _build
    except ImportError as e:
        return fail(f"the port is not beside this script: {e}")
    try:
        line = card_line()
        info(f"card: {line}; torch {torch.__version__}, cuda "
             f"{torch.version.cuda}, python {sys.version.split()[0]}")
        if args.wave_ab:
            _ptxas_lines(_build.build_all())
            phase_wave_ab(args.wave_ab, line, args.out)
            info(f"wave-ab: {args.wave_ab} against this tree")
            return 0
        if args.storm_ab:
            phase_storm_ab(args.storm_ab, line, args.out)
            info(f"storm-ab: {args.storm_ab} against this tree")
            return 0
        if args.kernel_ab:
            _ptxas_lines(_build.build_all(["accept_reply", "commit"]))
            phase_kernel_ab(args.kernel_ab, line, args.out)
            info(f"kernel-ab: {args.kernel_ab} against this tree")
            return 0
        if args.runtime_only:
            _build.build_all()
            _runtime_lines(phase_runtime(device=args.runtime_only), line)
            info(f"runtime-only: engines on {args.runtime_only}")
            return 0
        if args.failover_only:
            _build.build_all()
            fo, reps = phase_failover_and_replay()
            _failover_lines(fo, line)
            _replay_lines(reps, line)
            info("failover-only: phases 6 and 7")
            return 0
        if args.lanes_only:
            _build.build_all()
            rt = phase_runtime()
            _runtime_lines(rt, line)
            ln = phase_lanes(slab_bytes=rt["memory"][0]["total_bytes"])
            _lanes_lines(ln, rt, line)
            info("lanes-only: phases 5 and 8")
            return 0
        if args.churn_only:
            _build.build_all()
            _churn_lines(phase_churn(), line)
            _cli_lines(phase_cli(), line)
            info("churn-only: phases 9 and 9b")
            return 0
        if args.main_only:
            _build.build_all()
            mn = phase_main(modes=MAIN_ONLY_MODES)
            _main_lines(mn, line)
            _write_rows(args.out, mn, None)
            info("main-only: phase 10 with its extras")
            return 0
        if args.chaos_only:
            # built, loaded and launched before any node boots: the drill
            # detects a failure at 1 s, and a first launch must not stall
            # a worker that long
            _build.build_all()
            wave_submit_no_sync()
            ch = phase_chaos()
            _chaos_lines(ch, line)
            _write_rows(args.out, None, ch)
            info("chaos-only: phase 11")
            return 0
        if args.defaults:
            _build.build_all()
            rt = phase_runtime(strict=False)
            _runtime_lines(rt, line, "defaults runtime")
            ln = phase_lanes(slab_bytes=rt["memory"][0]["total_bytes"],
                             pins=False, strict=False)
            _lanes_lines(ln, rt, line, "defaults lanes")
            ok = all(d["answered"] and d["agree"] and not d["installs"]
                     for d in (rt, ln))
            info(f"defaults: phases 5 and 8 at the package defaults; every "
                 f"request answered with status 0, the replicas in "
                 f"agreement and no election: {ok}")
            return 0
        t0 = time.perf_counter()
        secs = _build.build_all()
        info(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
             f" ({time.perf_counter() - t0:.2f} s wall, one nvcc a source)")
        _ptxas_lines(secs)

        timing, max_err = phase_parity(line)
        ctiming, commit_err, commit_checked = phase_commit_parity(line)
        info(f"parity: commit kernel bit-identical to commit_reference in "
             f"{commit_checked} calls: G={G_FULL}, W={W_FULL} with decided "
             f"slots behind a gap at each cursor, B={list(COMMIT_BS)} over "
             f"seeds {list(PARITY_SEEDS)}, each past 8 also half live and "
             f"padded; B={BIG_B}; {CONTENDED[0]} lanes on {CONTENDED[1]} "
             f"rows; {STORM_B} lanes on {CONTENDED[1]} rows; the storm's "
             f"lanes at B={STORM_B} and {BIG_B} (no second barrier); "
             f"cursors near INT32_MAX at B={STORM_B}, each seed")
        ptiming, propose_err, propose_checked = phase_propose_parity(line)
        info(f"parity: propose kernel bit-identical to propose_reference "
             f"in {propose_checked} calls: G={G_FULL}, W={W_FULL} with "
             f"inactive, non-coordinator and phase-1-pending rows, "
             f"B={list(PROPOSE_BS)} over seeds {list(PARITY_SEEDS)}, each "
             f"past 8 also half live and padded; B={BIG_B}; "
             + "; ".join(f"{b} lanes on {n} rows" for b, n in PROPOSE_CROWDS)
             + f"; the epoch wrapping; the storm's lanes at B={STORM_B}; "
             f"slots near INT32_MAX at B={STORM_B}, each seed; the "
             f"runtime's slab (G={RT_CAPACITY}) at every bucket "
             f"{list(RT_BUCKETS)}, padded")
        rtiming, reply_err, reply_checked = phase_reply_parity(line)
        info(f"parity: accept-reply kernel bit-identical to "
             f"accept_reply_reference in {reply_checked} calls: G={G_FULL}, "
             f"W={W_FULL} with non-coordinator and phase-1-pending rows, "
             f"columns holding other slots or already emitted, partial "
             f"vote bitmaps, members 1, 3 and 5; B={list(REPLY_BS)} (one "
             f"CTA to 512, one cluster to 4096, the grid above) over "
             f"seeds {list(PARITY_SEEDS)}, each past 8 also half live, "
             f"padded and packed; B={BIG_B}; "
             + "; ".join(f"{b} lanes on {n} rows" for b, n in REPLY_CROWDS)
             + " (acks beside preempting nacks); "
             + "; ".join(f"{k} keys across {b // SPLIT_SEG} segments of {b} "
                         f"lanes" for k, b in REPLY_SPLITS)
             + f"; the wide path's epoch wrapping; the storm's lanes at "
             f"B=4096, {STORM_B} and {BIG_B}; slots near INT32_MAX at "
             f"B={STORM_B}, each seed; the runtime's slab (G={RT_CAPACITY}) "
             f"at every bucket {list(RT_BUCKETS)}, padded and packed")
        wtiming, wave_err, wave_checked = phase_wave_parity(line)
        info(f"parity: the acceptor and coordinator wave kernels "
             f"bit-identical to their torch bodies in {wave_checked} "
             f"chunks: the runtime's slab (G={RT_CAPACITY}) and a lane's "
             f"slab (G={LANE_CAPACITY}) at every bucket {list(RT_BUCKETS)}, "
             f"seeds {list(PARITY_SEEDS)}, both halves live and each half "
             f"empty; and the geometry's seams, each half alone too: "
             + "; ".join(w for w, *_ in WAVE_SEAMS))
        wave_submit_no_sync()
        info("parity: a fused acceptor wave and a fused coordinator wave "
             "submitted under torch.cuda.set_sync_debug_mode('error'): no "
             "host synchronization")
        info(f"parity: accept kernel bit-identical to accept_reference at "
             f"B={list(PARITY_BS)}, seeds {list(PARITY_SEEDS)}; at "
             f"B={BIG_B}; {CONTENDED[0]} lanes on {CONTENDED[1]} rows; "
             f"the storm's lanes at B={STORM_B}; G={G_FULL}, W={W_FULL}; "
             f"and on the runtime's slab (G={RT_CAPACITY}, W={RT_WINDOW}) "
             f"and a lane's slab (G={LANE_CAPACITY}) at every bucket "
             f"{list(RT_BUCKETS)} with live lanes padded as "
             f"ColumnarBackend pads them, seeds {list(PARITY_SEEDS)}")
        phase_cpu_parity()
        info("parity: storm steps and SPI waves on the card bit-identical "
             "to the same calls on the CPU (small size)")
        p1 = phase_phase1_parity()
        info(f"parity: prepare and install_coordinator on the card "
             f"bit-identical to the CPU on the runtime's slab (G="
             f"{RT_CAPACITY}, W={RT_WINDOW}) at every bucket "
             f"{list(RT_BUCKETS)}, and one ColumnarBackend.prepare of "
             f"{p1['rows']} rows ({p1['acked']} acked and installed, "
             f"{PAUSED_ROWS} snapshotted and restored): "
             f"prepare {p1['prepare_card']:.4f} s on the card, "
             f"{p1['prepare_cpu']:.4f} s on the CPU; install "
             f"{p1['install_card']:.4f} s, {p1['install_cpu']:.4f} s "
             f"({line})")

        storm = phase_storm()
        info(f"storm: {storm['decided']} decisions in {STORM_STEPS} steps "
             f"at B={STORM_B}, {storm['decisions_per_s']:.0f} decisions/s "
             f"({line}); kernel launches {storm['launches']}")
        spi = phase_spi()
        info(f"spi: {spi['decided']} decisions through 3 ColumnarBackend "
             f"replicas at B={SPI_B}, {spi['decisions_per_s']:.0f} "
             f"decisions/s over the plain waves ({line}); kernel launches "
             f"{spi['launches']}; slab {spi['slab_bytes']} B a replica")
        if args.parity_only:
            info("parity-only: phases 2 to 4")
            return 0
        rt = phase_runtime()
        _runtime_lines(rt, line)
        fo, reps = phase_failover_and_replay()
        _failover_lines(fo, line)
        _replay_lines(reps, line)
        ln = phase_lanes(slab_bytes=rt["memory"][0]["total_bytes"])
        _lanes_lines(ln, rt, line)
        ch = phase_churn()
        _churn_lines(ch, line)
        _cli_lines(phase_cli(), line)
        mn = phase_main()
        _main_lines(mn, line)
        drill = phase_chaos()
        _chaos_lines(drill, line)
        _write_rows(args.out, mn, drill)
    except Exception as e:  # every phase's failure ends the run non-zero
        import traceback
        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    paths = {"storm": [storm["launches"]], "spi": [spi["launches"]],
             "runtime": [rt["launches"]], "failover": [fo["launches"]],
             "replay": [r["launches"] for r in reps],
             "lanes": [ln["launches"]], "churn": [ch["launches"]],
             "main": [c for _t, _r, c, _w in mn],
             "chaos": [drill["launches"]]}

    def launched(name):
        by_path = {p: [c[name] for c in cs] for p, cs in paths.items()}
        return sum(sum(v) for v in by_path.values()), by_path

    # the runtime's replies go through the coordinator wave: only the
    # storm and the SPI's plain accept_reply waves launch the kernel
    stray = {p: v for p, v in launched("accept_reply")[1].items()
             if p not in ("storm", "spi") and any(v)}
    if stray:
        return fail(f"accept-reply kernel launched off the storm and the "
                    f"SPI: {stray}")

    big = timing[str(max(PARITY_BS))]
    n, by_path = launched("accept")
    kernels = [{
        "name": "accept",
        "route": "cuda",
        "source": "gigapaxos_tpu_torch/ops/csrc/accept.cu",
        "replaces": "gigapaxos_tpu/ops/pallas_accept.py:165",
        "launches": n,
        "launches_by_path": by_path,
        "parity": "bit-exact",
        "max_abs_err": max_err,
        "lanes": max(PARITY_BS),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "by_lanes": timing,
    }]
    big = ctiming[str(STORM_B)]
    n, by_path = launched("commit")
    kernels.append({
        "name": "commit",
        "route": "cuda",
        "source": "gigapaxos_tpu_torch/ops/csrc/commit.cu",
        "replaces": "gigapaxos_tpu/ops/kernels.py:301",
        "launches": n,
        "launches_by_path": by_path,
        "parity": "bit-exact",
        "max_abs_err": commit_err,
        "lanes": STORM_B,
        "ms": big["ms"],
        "ms_cold_l2": big["ms_cold"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "floor_ms": big["floor_ms"],
        "library_ms": None,
        "by_lanes": ctiming,
    })
    big = ptiming[f"storm_{STORM_B}"]
    n, by_path = launched("propose")
    kernels.append({
        "name": "propose",
        "route": "cuda",
        "source": "gigapaxos_tpu_torch/ops/csrc/propose.cu",
        "replaces": "gigapaxos_tpu/ops/kernels.py:243",
        "launches": n,
        "launches_by_path": by_path,
        "parity": "bit-exact",
        "max_abs_err": propose_err,
        "lanes": STORM_B,
        "ms": big["ms"],
        "ms_cold_l2": big["ms_cold"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "floor_ms": big["floor_ms"],
        "library_ms": None,
        "by_lanes": ptiming,
    })
    big = rtiming[f"storm_{STORM_B}"]
    n, by_path = launched("accept_reply")
    kernels.append({
        "name": "accept_reply",
        "route": "cuda",
        "source": "gigapaxos_tpu_torch/ops/csrc/accept_reply.cu",
        "replaces": "gigapaxos_tpu/ops/kernels.py:152",
        "launches": n,
        "launches_by_path": by_path,
        "parity": "bit-exact",
        "max_abs_err": reply_err,
        "lanes": STORM_B,
        "ms": big["ms"],
        "ms_cold_l2": big["ms_cold"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "floor_ms": big["floor_ms"],
        "library_ms": None,
        "by_lanes": rtiming,
    })
    for name, replaces in (("acceptor_wave", "gigapaxos_tpu/ops/kernels.py:644"),
                           ("coordinator_wave",
                            "gigapaxos_tpu/ops/kernels.py:629")):
        n, by_path = launched(name)
        top = wtiming[f"{name}_rt_{max(RT_BUCKETS)}"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gigapaxos_tpu_torch/ops/csrc/wave.cu",
            "replaces": replaces,
            "launches": n,
            "launches_by_path": by_path,
            "parity": "bit-exact",
            "max_abs_err": wave_err,
            "lanes": max(RT_BUCKETS),
            "live_lanes": top["live"],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": "bytes",
            "floor_ms": top["floor_ms"],
            "library_ms": None,
            "by_lanes": {k[len(name) + 1:]: v for k, v in wtiming.items()
                         if k.startswith(name)},
        })
    info(line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
