"""The accept-reply kernel's logic on a CPU host, against its plain
version.

Compiles ``gigapaxos_tpu_torch/ops/csrc/accept_reply.cu`` with g++
against the stand-ins in ``cuda_runtime.h`` (one ``std::thread`` a CUDA
thread, ``std::barrier`` for the block, cluster and grid barriers, a
cluster's shared memory readable by its blocks), runs sequences of calls
through ``accept_reply_harness.cc`` at small sizes, on both paths: the
small path (one CTA up to 512 lanes, one cluster of 8 CTAs above, up to
4096) and the wide path on a few blocks (so a thread takes several
rounds of lanes, and keys have lanes in several blocks and rounds).  It
holds every call's six output rows, and the final ``prop``,
``is_coord``, ``coord_active`` and epoch, against
``accept_reply_cuda.accept_reply_reference``: widths from 1 to 6000
lanes, bool and int32 (packed) flag lanes, keys whose first lane does
not match while later CTAs' or blocks' lanes carry the quorum,
preempting nacks beside acks of their rows, columns already emitted,
padded lanes, valid lanes outside ``[0, G)`` (invalid in the kernel),
slots near INT32_MAX and the wide path's epoch wrapping.  The card's compiler and memory
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
    CHUNK_LANES, THREADS, accept_reply_reference, plan)
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
    src = re.sub(r"extern __shared__ (.*) tab\[\];",
                 r"\1* tab = &emu::block_shared<\1>();", src)
    # the anonymous namespace, named so the harness can reach the kernel
    src = src.replace("namespace {\n", "namespace reply_k {\n", 1)
    src = src.replace("}  // namespace\n",
                      "}  // namespace reply_k\nusing namespace reply_k;\n",
                      1)
    (BUILD / "accept_reply_host.cu").write_text(src)
    # the launch helper's config members, out of the way of the stand-ins'
    # gridDim and blockDim macros (found before csrc/'s copy)
    (BUILD / "vote_dev.cuh").write_text(re.sub(
        r"\.(gridDim|blockDim)\b", r".\1_",
        (CSRC / "vote_dev.cuh").read_text()))
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
    key = rng.permutation(space)
    r = rows[key // (W * 3 * SENDERS)]
    c = key // (3 * SENDERS) % W
    variant = key // SENDERS % 3
    sender = (key % SENDERS).astype(np.int32)
    base = st.prop.numpy()[r, c, 0].astype(np.int64)
    slot = wrap(base + np.array([0, W, -W])[variant])
    # one lane a (row, slot, sender): a column of no slot shifted a window
    # may name another column's slot
    _, first = np.unique(np.stack([r, slot, sender]), axis=1,
                         return_index=True)
    keep = np.sort(first)[:B]
    assert len(keep) == B
    r, sender, slot = r[keep], sender[keep], slot[keep]
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
        subprocess.run([str(exe), inp, outp], check=True,
                       timeout=120)  # a deadlock fails, not hangs
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
        if len(c[0]) > CHUNK_LANES:  # the wide path's calls
            want = (want + 1) % (1 << 32) or 1  # 0 is no call's epoch
    if epoch != want:
        raise AssertionError(f"{name}: epoch {epoch} != {want}")
    print(f"ok {name}: {len(calls)} calls, {decided} newly decided, epoch "
          f"{epoch0} -> {epoch}")


def split_keys(rng, st, n_keys, B, blocks, seg):
    """Keys whose lanes lie in different ``seg``-lane segments (a
    cluster's CTAs on the small path, a block's lane slots on the wide
    one): a first lane (in lane order) that does not match (a ballot
    below cbal), a matching lane in a later segment and another in a
    later one still, on columns with one vote before the batch and
    members 5 (quorum 3: only the last lane's vote crosses it); the rest
    of the B lanes on other rows."""
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
    segs = -(-B // seg)
    cb = st.cbal.numpy()[rows]
    pos = []
    for k in range(n_keys):
        t = np.sort(rng.choice(segs, 3, replace=False))  # in order
        pos.append(np.minimum(t * seg + rng.integers(0, seg, 3), B - 1))
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


def blocks_of(B, limit=3):
    """The blocks a call of B lanes launches with a co-resident limit of
    ``limit`` (the wide path's rounds), as the wrapper plans it."""
    return plan(B, limit).blocks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    exe = build()
    rng = np.random.default_rng(args.seed)
    G, W = 128, 8
    st = state(rng, G, W)
    check(exe, "small path widths (one CTA, one cluster)", st, [
        lanes(rng, st, B, blocks_of(B)) for B in
        (1, 8, 33, 64, 300, 512, 513, 1100, 2000)])
    st = state(rng, G, W)
    check(exe, "wide path widths (rounds of a small grid)", st, [
        lanes(rng, st, B, bl) for B, bl in
        ((4097, 1), (4097, 9), (5000, 2), (6000, 3))])
    st = state(rng, G, W)
    check(exe, "packed int32 flags", st, [
        lanes(rng, st, B, blocks_of(B), fb=4) for B in (64, 900, 4500)])
    # every lane a candidate on a column of its own (the SPI's and the
    # storm's replies): each decides alone, no rank lookup
    G2 = 1024
    st = state(rng, G2, W)
    st.members[:] = 3
    st.is_coord[:] = st.coord_active[:] = True
    p = st.prop.numpy()
    for B in (300, 1500, 4500):
        cols = rng.choice(G2 * W, B, replace=False)
        r, c = cols // W, cols % W
        p[r, c, 0] = wrap(3000 + r * W + c)
        p[r, c, 3] = 1  # sender 0's vote: sender 1's crosses quorum
        one = np.ones(B, bool)
        check(exe, f"every lane a candidate, B={B}", st, [
            [r.astype(np.int32), p[r, c, 0].copy(), st.cbal.numpy()[r],
             np.ones(B, np.int32), one, one, blocks_of(B), 1]])
    st = state(rng, G, W)
    check(exe, "keys across a cluster's CTAs", st,
          [split_keys(rng, st, 24, 1500, 1, 1500 // 8 // 32 * 32 + 32)])
    st = state(rng, G, W)
    check(exe, "keys across blocks and rounds", st,
          [split_keys(rng, st, 40, 6000, 2, THREADS)])
    st = state(rng, G, W)
    check(exe, "eight rows", st, [
        lanes(rng, st, B, blocks_of(B), rows=rng.choice(G, 8,
                                                        replace=False))
        for B in (200, 480, 900)])
    st = state(rng, G, W)
    check(exe, "eight rows, wide", st, [
        lanes(rng, st, 4400, 2, rows=rng.choice(G, 40, replace=False))])
    st = state(rng, G, W)
    check(exe, "padded", st, [
        lanes(rng, st, B, blocks_of(B), valid_share=1.0, pad=B // 2)
        for B in (8, 64, 512, 4096, 8192)])
    st = state(rng, G, W)
    for B in (600, 5000):
        call = lanes(rng, st, B, blocks_of(B), valid_share=1.0)
        out_of_range = rng.random(B) < 0.1
        call[0] = np.where(out_of_range,
                           np.where(rng.random(B) < 0.5,
                                    rng.integers(G, 2 * G, B),
                                    -rng.integers(1, G, B)),
                           call[0]).astype(np.int32)
        check(exe, f"valid lanes outside [0, G), B={B}", st, [call],
              ref_valid=[~out_of_range])
    st = state(rng, G, W, near_max=True)
    check(exe, "near INT32_MAX", st, [
        lanes(rng, st, B, blocks_of(B)) for B in (400, 600, 4800)])
    # quorum across the wrap on contested columns (two candidates each):
    # the call before it leaves a tag on every column it votes on without
    # deciding (members 5, two votes), and the call that wraps decides
    # them all, which needs the table cleared
    G2 = 1024
    st = state(rng, G2, W)
    st.members[:] = 5
    st.is_coord[:] = st.coord_active[:] = True
    p = st.prop.numpy()
    cols = rng.choice(G2 * W, 2200, replace=False)
    r, c = cols // W, cols % W
    p[r, c, 0] = wrap(2000 + r * W + c)
    p[r, c, 3] = 0
    rr = np.repeat(r, 2).astype(np.int32)
    sl = np.repeat(p[r, c, 0], 2)
    cb = st.cbal.numpy()[rr]
    one = np.ones(4400, bool)
    check(exe, "the epoch wrapping, contested quorum across it", st, [
        [rr, sl, cb, np.tile(np.array(pair, np.int32), 2200), one, one,
         blocks_of(4400), 1] for pair in ((1, 2), (3, 4))],
        epoch0=0xFFFFFFFE)
    st = state(rng, G, W)
    check(exe, "the epoch wrapping", st, [
        lanes(rng, st, B, blocks_of(B), rows=rng.choice(G, 48,
                                                        replace=False))
        for B in (4200, 300, 4300, 4400)], epoch0=0xFFFFFFFE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
