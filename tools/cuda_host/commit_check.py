"""The commit kernel's logic on a CPU host, against its plain version.

Compiles ``gigapaxos_tpu_torch/ops/csrc/commit.cu`` with g++ against the
stand-ins in ``cuda_runtime.h`` (one ``std::thread`` a CUDA thread,
``std::barrier`` for the block and grid barriers), runs sequences of
calls through ``commit_harness.cc`` at small sizes on a few blocks (so a
thread takes several rounds of lanes), and holds every call's four
output rows, and the final ``dec`` and ``exec_cursor``, against
``commit_cuda.commit_reference``; the readers word must be 0 after
every sequence.  Cases: widths from 1 to 6000 lanes, batches where
every lane stores (the second barrier skipped) and where some do not
(stale, out-of-window, inactive, invalid and padding lanes beside store
lanes of their rows; one such lane alone, in no block's first thread), rows whose gaps close out of lane order across
blocks and rounds, valid lanes outside ``[0, G)`` (invalid in the
kernel) and cursors near INT32_MAX.  The card's compiler and memory
model are not checked: ``chip_smoke.py`` phase 2 does that.

Run from the repo root (the build goes to ``tools/cuda_host/_build/``)::

    python tools/cuda_host/commit_check.py [--seed N]
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gigapaxos_tpu_torch.ops.commit_cuda import (  # noqa: E402
    commit_reference, grid_plan)
from gigapaxos_tpu_torch.ops.types import make_state  # noqa: E402

HERE = Path(__file__).resolve().parent
CSRC = ROOT / "gigapaxos_tpu_torch" / "ops" / "csrc"
BUILD = HERE / "_build"
INT32_MAX = (1 << 31) - 1
NO_SLOT = -1


def build() -> Path:
    """The harness, built from the current sources."""
    BUILD.mkdir(exist_ok=True)
    src = (CSRC / "commit.cu").read_text()
    # a prefetch is a hint the host has no use for
    src = src.replace('asm volatile("prefetch.global.L2 [%0];" ::"l"(p));',
                      "(void)p;")
    # the anonymous namespace, named so the harness can reach the kernel
    src = src.replace("namespace {\n", "namespace commit_k {\n", 1)
    src = src.replace("}  // namespace\n",
                      "}  // namespace commit_k\nusing namespace commit_k;\n",
                      1)
    (BUILD / "commit_host.cu").write_text(src)
    exe = BUILD / "commit_harness"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{HERE}", f"-I{BUILD}", f"-I{CSRC}", "-o", str(exe),
                    str(HERE / "commit_harness.cc")], check=True)
    return exe


def wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def state(rng, G, W, active_share=0.9, near_max=False):
    """Active rows (a share), cursors, and decided slots ahead of each
    cursor behind a gap at it (each other column holds the slot a window
    earlier); with ``near_max`` the cursors lie in [INT32_MAX - 2W,
    INT32_MAX], where the window and the scan wrap."""
    st = make_state(G, W, "cpu")
    st.active = torch.from_numpy(rng.random(G) < active_share)
    cur = (INT32_MAX - rng.integers(0, 2 * W + 1, G)) if near_max else \
        rng.integers(0, 1000, G)
    st.exec_cursor = torch.from_numpy(wrap(cur))
    k = np.arange(W)
    slots = cur[:, None].astype(np.int64) + k[None, :]
    decided = (rng.random((G, W)) < 0.5) & (k[None, :] >= 1)
    dec = np.zeros((G, W, 3), np.int64)
    rows = np.repeat(np.arange(G), W)
    cols = (wrap(slots) % W).ravel()
    dec[rows, cols, 0] = np.where(decided, slots, slots - W).ravel()
    dec[..., 1:] = rng.integers(-(1 << 31), 1 << 31, (G, W, 2))
    st.dec = torch.from_numpy(wrap(dec))
    return st


def lanes(rng, st, B, blocks, rows=None, lo=-4, hi=None, valid_share=0.9,
          pad=0):
    """B lanes with distinct (row, slot) (the kernel's precondition) on
    random rows (or ``rows``): offsets from the row's cursor in [lo, hi)
    (stale, in the window, beyond it), a share valid; the last ``pad``
    lanes padding as the backend pads (row 0, NO_SLOT, invalid)."""
    G, W = st.G, st.W
    hi = W + 4 if hi is None else hi
    rows = np.arange(G) if rows is None else np.asarray(rows)
    span = hi - lo
    key = rng.choice(len(rows) * span, B, replace=False)
    g = rows[key // span]
    slot = wrap(st.exec_cursor.numpy()[g].astype(np.int64) + key % span + lo)
    rlo, rhi = (rng.integers(-(1 << 31), 1 << 31, B) for _ in range(2))
    valid = rng.random(B) < valid_share
    if pad:
        g[B - pad:] = rlo[B - pad:] = rhi[B - pad:] = 0
        slot[B - pad:] = NO_SLOT
        valid[B - pad:] = False
    return [g.astype(np.int32), slot, wrap(rlo), wrap(rhi), valid, blocks]


def storm_lanes(rng, st, B, blocks, rows):
    """Every lane stores: B lanes on random ``rows`` (repeated), a row's
    lanes on consecutive slots from its cursor, shuffled, all valid, on
    an all-active state; rows with more than W lanes take fewer."""
    W = st.W
    g = rng.choice(rows, B)
    order = np.argsort(g, kind="stable")
    gs = g[order]
    start = np.r_[0, np.flatnonzero(gs[1:] != gs[:-1]) + 1]
    rank = np.arange(B) - np.repeat(start, np.diff(np.r_[start, B]))
    keep = rank < W
    g, rank = gs[keep], rank[keep]
    perm = rng.permutation(len(g))
    g, rank = g[perm], rank[perm]
    slot = wrap(st.exec_cursor.numpy()[g].astype(np.int64) + rank)
    n = len(g)
    rlo, rhi = (rng.integers(-(1 << 31), 1 << 31, n) for _ in range(2))
    return [g.astype(np.int32), slot, wrap(rlo), wrap(rhi),
            np.ones(n, bool), blocks]


def run(exe, st, calls):
    """Every call through the harness on a copy of ``st``: the outputs,
    exec_cursor, dec and the readers word."""
    G, W = st.G, st.W
    with tempfile.TemporaryDirectory() as d:
        inp, outp = os.path.join(d, "in"), os.path.join(d, "out")
        with open(inp, "wb") as f:
            f.write(np.array([len(calls), G, W], np.int32).tobytes())
            f.write(st.active.numpy().astype(np.uint8).tobytes())
            f.write(st.exec_cursor.numpy().astype(np.int32).tobytes())
            f.write(st.dec.numpy().astype(np.int32).tobytes())
            for g, slot, rlo, rhi, valid, blocks in calls:
                f.write(np.array([len(g), blocks], np.int32).tobytes())
                for a in (g, slot, rlo, rhi):
                    f.write(np.asarray(a, np.int32).tobytes())
                f.write(np.asarray(valid, np.uint8).tobytes())
        subprocess.run([str(exe), inp, outp], check=True,
                       timeout=120)  # a deadlock fails, not hangs
        raw = np.fromfile(outp, np.int32)
    outs, k = [], 0
    for g, *_ in calls:
        outs.append(raw[k:k + 4 * len(g)].reshape(4, len(g)))
        k += 4 * len(g)
    cur = raw[k:k + G]
    dec = raw[k + G:k + G + G * W * 3].reshape(G, W, 3)
    return outs, cur, dec, int(raw[-1:].view(np.uint32)[0])


def check(exe, name, st, calls, ref_valid=None):
    """The harness against ``commit_reference`` call by call;
    ``ref_valid`` gives the reference's valid masks where the kernel's
    lanes outside [0, G) must count as invalid."""
    st_r = make_state(st.G, st.W, "cpu")
    for p in ("active", "exec_cursor", "dec"):
        setattr(st_r, p, getattr(st, p).clone())
    outs, cur, dec, readers = run(exe, st, calls)
    stored = skipped = 0
    for c, (g, slot, rlo, rhi, valid, _blocks) in enumerate(calls):
        v = valid if ref_valid is None else ref_valid[c]
        o = commit_reference(
            st_r, torch.from_numpy(np.where(v, g, 0).astype(np.int32)),
            *(torch.from_numpy(np.asarray(a, np.int32))
              for a in (slot, rlo, rhi)),
            torch.from_numpy(np.asarray(v, bool))).numpy()
        if not np.array_equal(o, outs[c]):
            at = np.argwhere(o != outs[c])[0]
            raise AssertionError(f"{name}, call {c}: out{list(at)} "
                                 f"{outs[c][tuple(at)]} != {o[tuple(at)]}")
        stored += int(o[0].sum())
        skipped += bool(len(g)) and bool(o[0].all())
    for what, a, b in (("exec_cursor", cur, st_r.exec_cursor.numpy()),
                       ("dec", dec, st_r.dec.numpy())):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
    if readers:
        raise AssertionError(f"{name}: readers word {readers} after the "
                             "calls, not 0")
    print(f"ok {name}: {len(calls)} calls, {stored} stores, {skipped} "
          f"calls with every lane storing (no second barrier)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    exe = build()
    rng = np.random.default_rng(args.seed)
    G, W = 512, 8
    st = state(rng, G, W)
    check(exe, "widths", st, [
        lanes(rng, st, B, grid_plan(B, 3)) for B in
        (1, 8, 33, 64, 300, 512, 513, 1100, 2000, 6000)])
    G2 = 4096  # room for disjoint rows a call, each call on cursors as
    #            they stood before the sequence
    st = state(rng, G2, W, active_share=1.0)
    parts = np.array_split(rng.permutation(G2), 5)
    check(exe, "every lane stores", st, [
        storm_lanes(rng, st, B, grid_plan(B, bl), rows) for (B, bl), rows
        in zip(((1, 1), (200, 1), (1500, 1), (3000, 2), (5000, 9)), parts)])
    st = state(rng, G2, W, active_share=1.0)
    parts = np.array_split(rng.permutation(G2), 3)
    check(exe, "storing batches around a non-storing one", st, [
        storm_lanes(rng, st, 1200, 1, parts[0]),
        lanes(rng, st, 700, 2, rows=parts[1]),
        storm_lanes(rng, st, 900, 2, parts[2])])
    # one lane that does not store, off every block's thread 0 (lane 37
    # of a 1200-lane batch): an invalid lane reading row 0, which the
    # batch advances; only that lane makes the second barrier run
    st = state(rng, G2, W, active_share=1.0)
    call = storm_lanes(rng, st, 1200, 1, np.arange(100))
    for f in range(5):  # an invalid lane (row 0) put in at lane 37
        call[f] = np.insert(call[f], 37, False if f == 4 else 0)
    st_r = make_state(G2, W, "cpu")
    for p in ("active", "exec_cursor", "dec"):
        setattr(st_r, p, getattr(st, p).clone())
    out = commit_reference(st_r, *(torch.from_numpy(np.asarray(a, np.int32))
                                   for a in call[:4]),
                           torch.from_numpy(call[4]))
    assert int(out[3][37]) != int(st.exec_cursor[0]), "row 0 not raised"
    check(exe, "one lane that does not store, off thread 0", st, [call])
    st = state(rng, G, W)
    check(exe, "six rows, gaps closed out of lane order", st, [
        lanes(rng, st, B, grid_plan(B, bl), rows=rng.choice(G, 6, False),
              lo=-8, hi=W + 8) for B, bl in ((90, 1), (96, 2))])
    st = state(rng, G, W)
    check(exe, "padded", st, [
        lanes(rng, st, B, grid_plan(B, 2), valid_share=1.0, pad=B // 2)
        for B in (8, 64, 512, 4096)])
    st = state(rng, G, W)
    n = 2000
    call = lanes(rng, st, n, 2, valid_share=1.0)
    out_of_range = rng.random(n) < 0.1
    call[0] = np.where(out_of_range,
                       np.where(rng.random(n) < 0.5,
                                rng.integers(G, 2 * G, n),
                                -rng.integers(1, G, n)),
                       call[0]).astype(np.int32)
    check(exe, "valid lanes outside [0, G)", st, [call],
          ref_valid=[~out_of_range])
    st = state(rng, G, W, near_max=True)
    check(exe, "near INT32_MAX", st, [
        lanes(rng, st, B, grid_plan(B, 3), lo=-2, hi=W + 2)
        for B, in ((400,), (3000,))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
