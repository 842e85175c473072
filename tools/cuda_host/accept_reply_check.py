"""The accept-reply kernel's logic on a CPU host, against its plain
version.

Compiles ``gigapaxos_tpu_torch/ops/csrc/accept_reply.cu`` with g++
against the stand-ins in ``cuda_runtime.h`` (one ``std::thread`` a CUDA
thread, ``std::barrier`` for the block and grid barriers), runs
sequences of calls through ``accept_reply_harness.cc`` at small sizes
with a few blocks (so blocks take several tiles, and keys have lanes in
several tiles), and holds every call's six output rows, and the final
``prop``, ``is_coord``, ``coord_active`` and epoch, against
``accept_reply_cuda.accept_reply_reference``: widths from 1 to 2000
lanes, bool and int32 (packed) flag lanes, keys whose first lane does
not match while later tiles' lanes carry the quorum, preempting nacks
beside acks of their rows, columns already emitted, padded lanes, valid
lanes outside ``[0, G)`` (invalid in the kernel), slots near INT32_MAX
and the workspace's epoch wrapping.  The card's compiler and memory
model are not checked: ``chip_smoke.py`` phase 2 does that.

Run from the repo root (the build goes to ``tools/cuda_host/_build/``)::

    python tools/cuda_host/accept_reply_check.py [--seed N]
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

from gigapaxos_tpu_torch.ops.accept_reply_cuda import (  # noqa: E402
    THREADS, accept_reply_reference)
from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT,  # noqa: E402
                                           make_state)

HERE = Path(__file__).resolve().parent
CSRC = ROOT / "gigapaxos_tpu_torch" / "ops" / "csrc"
BUILD = HERE / "_build"
INT32_MAX = (1 << 31) - 1
NO_SLOT, NO_BALLOT = -1, -1
SENDERS = 5


def build() -> Path:
    """The harness, built from the current sources."""
    BUILD.mkdir(exist_ok=True)
    src = (CSRC / "accept_reply.cu").read_text()
    src = re.sub(r"__shared__ (.*) tab\[kCap\];",
                 r"auto& tab = emu::block_shared<\1[kCap]>();", src)
    # the anonymous namespace, named so the harness can reach the kernel
    src = src.replace("namespace {\n", "namespace reply_k {\n", 1)
    src = src.replace("}  // namespace\n",
                      "}  // namespace reply_k\nusing namespace reply_k;\n",
                      1)
    (BUILD / "accept_reply_host.cu").write_text(src)
    exe = BUILD / "accept_reply_harness"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-w",
                    f"-I{HERE}", f"-I{BUILD}", f"-I{CSRC}", "-o", str(exe),
                    str(HERE / "accept_reply_harness.cc")], check=True)
    return exe


def wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def state(rng, G, W, near_max=False):
    """Coordinator rows (some not coordinators, some with phase 1
    pending), members 1, 3 and 5, each column holding the slot of its
    window position (or the one a window earlier, or none), partial
    vote bitmaps and some columns already emitted."""
    st = make_state(G, W, "cpu")
    st.is_coord = torch.from_numpy(rng.random(G) < 0.85)
    st.coord_active = st.is_coord & torch.from_numpy(rng.random(G) < 0.85)
    st.cbal = torch.from_numpy(rng.integers(0, 1 << 20, G).astype(np.int32))
    st.members = torch.from_numpy(rng.choice([1, 3, 5], G).astype(np.int32))
    cur = (INT32_MAX - rng.integers(0, 2 * W + 1, G)) if near_max else \
        rng.integers(0, 1000, G)
    col = np.arange(W)[None, :]
    slot = cur[:, None] + (col - cur[:, None]) % W
    kind = rng.random((G, W))
    slot = np.where(kind < 0.1, slot - W, slot)
    slot = wrap(np.where(kind > 0.95, NO_SLOT, slot))
    votes = rng.integers(0, 1 << SENDERS, (G, W)) & \
        rng.integers(0, 1 << SENDERS, (G, W))
    votes = np.where(rng.random((G, W)) < 0.15, votes | EMITTED_BIT, votes)
    prop = np.stack([slot, rng.integers(-(1 << 31), 1 << 31, (G, W)),
                     rng.integers(-(1 << 31), 1 << 31, (G, W)),
                     votes], axis=-1).astype(np.int32)
    st.prop = torch.from_numpy(prop)
    return st


def lanes(rng, st, B, blocks, rows=None, valid_share=0.9, pad=0, fb=1):
    """B lanes with distinct (row, slot, sender): a column's own slot
    (which may match), the slot a window later or earlier (which does
    not), ballots at, below and above ``cbal``, a share of nacks."""
    G, W = st.G, st.W
    rows = np.arange(G) if rows is None else np.asarray(rows)
    space = len(rows) * W * 3 * SENDERS
    key = rng.choice(space, B, replace=False)
    r = rows[key // (W * 3 * SENDERS)]
    c = key // (3 * SENDERS) % W
    variant = key // SENDERS % 3
    sender = (key % SENDERS).astype(np.int32)
    base = st.prop.numpy()[r, c, 0].astype(np.int64)
    slot = wrap(base + np.array([0, W, -W])[variant])
    cb = st.cbal.numpy()[r].astype(np.int64)
    bal = wrap(cb + rng.choice([0, 0, 0, 0, -1, 1, 3], B))
    acked = rng.random(B) < 0.85
    valid = rng.random(B) < valid_share
    g = r.astype(np.int32)
    if pad:
        g[B - pad:] = sender[B - pad:] = 0
        slot[B - pad:] = NO_SLOT
        bal[B - pad:] = NO_BALLOT
        acked[B - pad:] = False
        valid[B - pad:] = False
    return [g, slot, bal, sender, acked, valid, blocks, fb]


def run(exe, st, calls, epoch0=0):
    """Every call through the harness on a copy of ``st``: the outputs,
    is_coord, coord_active, prop and epoch."""
    G, W = st.G, st.W
    max_b = max([len(c[0]) for c in calls] + [1])
    with tempfile.TemporaryDirectory() as d:
        inp, outp = os.path.join(d, "in"), os.path.join(d, "out")
        with open(inp, "wb") as f:
            f.write(np.array([len(calls), G, W, max_b], np.int32).tobytes())
            for p in ("is_coord", "coord_active"):
                f.write(getattr(st, p).numpy().astype(np.uint8).tobytes())
            for p in ("cbal", "members", "prop"):
                f.write(getattr(st, p).numpy().astype(np.int32).tobytes())
            f.write(np.array([epoch0], np.uint32).tobytes())
            for g, slot, bal, sender, acked, valid, blocks, fb in calls:
                f.write(np.array([len(g), blocks, fb], np.int32).tobytes())
                for a in (g, slot, bal, sender):
                    f.write(np.asarray(a, np.int32).tobytes())
                ft = np.uint8 if fb == 1 else np.int32
                for a in (acked, valid):
                    f.write(np.asarray(a, ft).tobytes())
        subprocess.run([str(exe), inp, outp], check=True)
        raw = np.fromfile(outp, np.uint8)
    outs, k = [], 0
    for g, *_ in calls:
        n = 6 * len(g) * 4
        outs.append(raw[k:k + n].view(np.int32).reshape(6, len(g)))
        k += n
    ic = raw[k:k + G].astype(bool)
    ca = raw[k + G:k + 2 * G].astype(bool)
    k += 2 * G
    prop = raw[k:k + G * W * 16].view(np.int32).reshape(G, W, 4)
    return outs, ic, ca, prop, int(raw[-4:].view(np.uint32)[0])


def check(exe, name, st, calls, ref_valid=None, epoch0=0):
    """The harness against ``accept_reply_reference`` call by call;
    ``ref_valid`` gives the reference's valid masks where the kernel's
    lanes outside [0, G) must count as invalid."""
    st_r = make_state(st.G, st.W, "cpu")
    for p in ("is_coord", "coord_active", "cbal", "members", "prop"):
        setattr(st_r, p, getattr(st, p).clone())
    outs, ic, ca, prop, epoch = run(exe, st, calls, epoch0)
    decided = 0
    for c, (g, slot, bal, sender, acked, valid, _b, _fb) in enumerate(calls):
        v = valid if ref_valid is None else ref_valid[c]
        o = accept_reply_reference(
            st_r, torch.from_numpy(np.where(v, g, 0).astype(np.int32)),
            *(torch.from_numpy(np.asarray(a, np.int32))
              for a in (slot, bal, sender)),
            torch.from_numpy(np.asarray(acked, bool)),
            torch.from_numpy(np.asarray(v, bool))).numpy()
        if not np.array_equal(o, outs[c]):
            at = np.argwhere(o != outs[c])[0]
            raise AssertionError(f"{name}, call {c}: out{list(at)} "
                                 f"{outs[c][tuple(at)]} != {o[tuple(at)]}")
        decided += int(o[0].sum())
    for what, a, b in (("is_coord", ic, st_r.is_coord.numpy()),
                       ("coord_active", ca, st_r.coord_active.numpy()),
                       ("prop", prop, st_r.prop.numpy())):
        if not np.array_equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
    want = epoch0
    for c in calls:
        if len(c[0]):
            want = (want + 1) % (1 << 32) or 1  # 0 is no call's epoch
    if epoch != want:
        raise AssertionError(f"{name}: epoch {epoch} != {want}")
    print(f"ok {name}: {len(calls)} calls, {decided} newly decided, epoch "
          f"{epoch0} -> {epoch}")


def split_keys(rng, st, n_keys, B, blocks):
    """Keys whose lanes lie in different tiles: a first lane (in lane
    order) that does not match (a ballot below cbal), a matching lane in
    a later tile and another in a later one still, on columns with one
    vote before the batch and members 5 (quorum 3: only the last tile's
    vote crosses it); the rest of the B lanes on other rows."""
    G, W = st.G, st.W
    rows = rng.choice(G, n_keys, replace=False)
    st.members[rows] = 5
    st.is_coord[rows] = st.coord_active[rows] = True
    c = rng.integers(0, W, n_keys)
    p = st.prop.numpy()
    slot = wrap(1000 + np.arange(n_keys) * W + c)
    p[rows, c, 0] = slot
    p[rows, c, 3] = 1  # sender 0's vote
    others = np.setdiff1d(np.arange(G), rows)
    call = lanes(rng, st, B - 3 * n_keys, blocks, rows=others)
    tiles = -(-B // THREADS)
    cb = st.cbal.numpy()[rows]
    pos = []
    for k in range(n_keys):
        t = np.sort(rng.choice(tiles, 3, replace=False))  # in order
        pos.append(np.minimum(t * THREADS + rng.integers(0, THREADS, 3),
                              B - 1))
    lane = [np.empty(B, np.int64) for _ in range(6)]
    placed = np.zeros(B, bool)
    for k in range(n_keys):
        for j, at in enumerate(pos[k]):
            while placed[at]:
                at = (at + 1) % B
            placed[at] = True
            vals = (rows[k], slot[k], cb[k] - (j == 0), 1 + j, True, True)
            for f in range(6):
                lane[f][at] = vals[f]
    rest = np.flatnonzero(~placed)
    for f in range(6):
        lane[f][rest] = call[f]
    g, sl, bal, sender = (wrap(lane[f]) for f in range(4))
    return [g, sl, bal, sender, lane[4].astype(bool), lane[5].astype(bool),
            blocks, 1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    exe = build()
    rng = np.random.default_rng(args.seed)
    G, W = 128, 8
    st = state(rng, G, W)
    check(exe, "widths", st, [
        lanes(rng, st, B, min(-(-B // THREADS), bl)) for B, bl in
        ((1, 1), (8, 1), (33, 1), (64, 1), (300, 2), (600, 2), (1100, 3),
         (1500, 2), (2000, 1))])
    st = state(rng, G, W)
    check(exe, "packed int32 flags", st, [
        lanes(rng, st, B, bl, fb=4) for B, bl in ((64, 1), (900, 2))])
    st = state(rng, G, W)
    check(exe, "keys across tiles", st,
          [split_keys(rng, st, 24, 1500, 2)])
    st = state(rng, G, W)
    check(exe, "eight rows", st, [
        lanes(rng, st, B, bl, rows=rng.choice(G, 8, replace=False))
        for B, bl in ((200, 1), (480, 2))])
    st = state(rng, G, W)
    check(exe, "padded", st, [
        lanes(rng, st, B, bl, valid_share=1.0, pad=B // 2) for B, bl in
        ((8, 1), (64, 1), (512, 2), (1024, 4))])
    st = state(rng, G, W)
    call = lanes(rng, st, 600, 2, valid_share=1.0)
    out_of_range = rng.random(600) < 0.1
    call[0] = np.where(out_of_range,
                       np.where(rng.random(600) < 0.5,
                                rng.integers(G, 2 * G, 600),
                                -rng.integers(1, G, 600)),
                       call[0]).astype(np.int32)
    check(exe, "valid lanes outside [0, G)", st, [call],
          ref_valid=[~out_of_range])
    st = state(rng, G, W, near_max=True)
    check(exe, "near INT32_MAX", st, [
        lanes(rng, st, B, bl) for B, bl in ((400, 2), (600, 3))])
    st = state(rng, G, W)
    check(exe, "the epoch wrapping", st, [
        lanes(rng, st, B, bl, rows=rng.choice(G, 9, replace=False))
        for B, bl in ((300, 2), (400, 3), (200, 1))], epoch0=0xFFFFFFFE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
