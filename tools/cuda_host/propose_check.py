"""The propose kernel's logic on a CPU host, against its plain version.

Compiles ``gigapaxos_tpu_torch/ops/csrc/propose.cu`` with g++ against the
stand-ins in ``cuda_runtime.h`` (one ``std::thread`` a CUDA thread,
``std::barrier`` for the block and grid barriers), runs sequences of
calls through ``propose_harness.cc`` at small sizes with a few blocks
(so blocks take several tiles, and rows have lanes in several tiles),
and holds every call's five output rows, and the final ``next_slot``,
``prop`` and epoch, against ``propose_cuda.propose_reference``: widths
from 1 to 2000 lanes, every lane on one row, a few rows, padded lanes,
valid lanes outside ``[0, G)`` (invalid in the kernel), slots near
INT32_MAX, and the workspace's epoch wrapping.  The card's compiler and
memory model are not checked: ``chip_smoke.py`` phase 2 does that.

Run from the repo root (the build goes to ``tools/cuda_host/_build/``)::

    python tools/cuda_host/propose_check.py [--seed N]
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gigapaxos_tpu_torch.ops.propose_cuda import (THREADS,  # noqa: E402
                                                  propose_reference)
from gigapaxos_tpu_torch.ops.types import make_state  # noqa: E402

HERE = Path(__file__).resolve().parent
CSRC = ROOT / "gigapaxos_tpu_torch" / "ops" / "csrc"
BUILD = HERE / "_build"
INT32_MAX = (1 << 31) - 1
PLANES = ("active", "is_coord", "coord_active", "cbal", "exec_cursor",
          "next_slot", "prop")


def build() -> Path:
    """The harness, built from the current sources."""
    BUILD.mkdir(exist_ok=True)
    src = (CSRC / "propose.cu").read_text()
    src = re.sub(r"__shared__ (.*) tab\[kCap\];",
                 r"auto& tab = emu::block_shared<\1[kCap]>();", src)
    # the anonymous namespace, named so the harness can reach the kernel
    src = src.replace("namespace {\n", "namespace propose_k {\n", 1)
    src = src.replace("}  // namespace\n",
                      "}  // namespace propose_k\nusing namespace propose_k;\n",
                      1)
    (BUILD / "propose_host.cu").write_text(src)
    exe = BUILD / "propose_harness"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{HERE}", f"-I{BUILD}", f"-I{CSRC}", "-o", str(exe),
                    str(HERE / "propose_harness.cc")], check=True)
    return exe


def wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def state(rng, G, W, near_max=False):
    """Inactive rows, coordinators with phase 1 done or pending,
    ``next_slot`` up to W past each cursor (the runtime's bound)."""
    st = make_state(G, W, "cpu")
    st.active = torch.from_numpy(rng.random(G) < 0.9)
    st.is_coord = torch.from_numpy(rng.random(G) < 0.8)
    st.coord_active = st.is_coord & torch.from_numpy(rng.random(G) < 0.85)
    st.cbal = torch.from_numpy(rng.integers(0, 1 << 20, G).astype(np.int32))
    cur = (INT32_MAX - rng.integers(0, 2 * W + 1, G)) if near_max else \
        rng.integers(0, 1000, G)
    st.exec_cursor = torch.from_numpy(wrap(cur))
    st.next_slot = torch.from_numpy(wrap(cur + rng.integers(0, W + 1, G)))
    st.prop = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (G, W, 4)).astype(np.int32))
    return st


def run(exe, st, calls, epoch0=0):
    """Every call ``(g, rlo, rhi, valid, blocks)`` through the harness
    on a copy of ``st``: the outputs, next_slot, prop and epoch."""
    G, W = st.G, st.W
    max_b = max([len(c[0]) for c in calls] + [1])
    with tempfile.TemporaryDirectory() as d:
        inp, outp = os.path.join(d, "in"), os.path.join(d, "out")
        with open(inp, "wb") as f:
            f.write(np.array([len(calls), G, W, max_b], np.int32).tobytes())
            for p in PLANES:
                a = getattr(st, p).numpy()
                f.write(a.astype(np.uint8 if a.dtype == np.bool_
                                 else np.int32).tobytes())
            f.write(np.array([epoch0], np.uint32).tobytes())
            for g, rlo, rhi, valid, blocks in calls:
                f.write(np.array([len(g), blocks], np.int32).tobytes())
                for a in (g, rlo, rhi):
                    f.write(np.asarray(a, np.int32).tobytes())
                f.write(np.asarray(valid, np.uint8).tobytes())
        subprocess.run([str(exe), inp, outp], check=True)
        raw = np.fromfile(outp, np.int32)
    outs, k = [], 0
    for g, *_ in calls:
        outs.append(raw[k:k + 5 * len(g)].reshape(5, len(g)))
        k += 5 * len(g)
    ns = raw[k:k + G]
    prop = raw[k + G:k + G + G * W * 4].reshape(G, W, 4)
    return outs, ns, prop, int(raw[-1:].view(np.uint32)[0])


def check(exe, name, st, calls, ref_valid=None, epoch0=0):
    """The harness against ``propose_reference`` call by call;
    ``ref_valid`` gives the reference's valid masks where the kernel's
    lanes outside [0, G) must count as invalid."""
    st_r = make_state(st.G, st.W, "cpu")
    for p in PLANES:
        setattr(st_r, p, getattr(st, p).clone())
    outs, ns, prop, epoch = run(exe, st, calls, epoch0)
    for c, (g, rlo, rhi, valid, _blocks) in enumerate(calls):
        v = valid if ref_valid is None else ref_valid[c]
        o = propose_reference(
            st_r, torch.from_numpy(np.where(v, g, 0).astype(np.int32)),
            torch.from_numpy(np.asarray(rlo, np.int32)),
            torch.from_numpy(np.asarray(rhi, np.int32)),
            torch.from_numpy(np.asarray(v, bool))).numpy()
        if not np.array_equal(o, outs[c]):
            at = np.argwhere(o != outs[c])[0]
            raise AssertionError(f"{name}, call {c}: out{list(at)} "
                                 f"{outs[c][tuple(at)]} != {o[tuple(at)]}")
    for what, a, b in (("next_slot", ns, st_r.next_slot.numpy()),
                       ("prop", prop, st_r.prop.numpy())):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
    want = epoch0
    for c in calls:
        if len(c[0]):
            want = (want + 1) % (1 << 32) or 1  # 0 is no call's epoch
    if epoch != want:
        raise AssertionError(f"{name}: epoch {epoch} != {want}")
    print(f"ok {name}: {len(calls)} calls, epoch {epoch0} -> {epoch}")


def lanes(rng, B, G, blocks, rows=None, valid_share=0.9, pad=0):
    g = rng.choice(np.arange(G) if rows is None else rows, B)
    rlo, rhi = (rng.integers(-(1 << 31), 1 << 31, B) for _ in range(2))
    valid = rng.random(B) < valid_share
    if pad:
        g[B - pad:] = rlo[B - pad:] = rhi[B - pad:] = 0
        valid[B - pad:] = False
    return g, rlo, rhi, valid, blocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    exe = build()
    rng = np.random.default_rng(args.seed)
    G, W = 512, 8
    check(exe, "widths", state(rng, G, W), [
        lanes(rng, B, G, min(-(-B // THREADS), bl)) for B, bl in
        ((1, 1), (8, 1), (33, 1), (64, 1), (300, 2), (600, 2), (1100, 3),
         (1500, 2))])
    check(exe, "one row", state(rng, G, W), [
        lanes(rng, B, G, bl, rows=np.array([7])) for B, bl in
        ((40, 1), (700, 2), (1300, 3))])
    check(exe, "five rows", state(rng, G, W), [
        lanes(rng, B, G, bl, rows=rng.choice(G, 5)) for B, bl in
        ((900, 2), (1800, 3), (2000, 1))])
    check(exe, "padded", state(rng, G, W), [
        lanes(rng, B, G, bl, valid_share=1.0, pad=B // 2) for B, bl in
        ((8, 1), (64, 1), (512, 2), (1024, 4))])
    n = 600
    out_of_range = rng.random(n) < 0.1
    g = np.where(out_of_range,
                 np.where(rng.random(n) < 0.5, rng.integers(G, 2 * G, n),
                          -rng.integers(1, G, n)),
                 rng.integers(0, G, n))
    check(exe, "valid lanes outside [0, G)", state(rng, G, W),
          [(g, rng.integers(0, 9, n), rng.integers(0, 9, n),
            np.ones(n, bool), 2)], ref_valid=[~out_of_range])
    check(exe, "near INT32_MAX", state(rng, G, W, near_max=True), [
        lanes(rng, B, G, bl) for B, bl in ((400, 2), (600, 3))])
    check(exe, "the epoch wrapping", state(rng, G, W), [
        lanes(rng, B, G, bl, rows=rng.choice(G, 9)) for B, bl in
        ((700, 2), (900, 3), (500, 2))], epoch0=0xFFFFFFFE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
