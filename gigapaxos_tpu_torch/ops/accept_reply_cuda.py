"""The accept-reply kernel (vote counting at any width, in one launch
a call: one CTA or one thread-block cluster up to 4096 lanes, a
cooperative grid with one barrier above) and its plain torch version.

Replaces the XLA-jit body
``gigapaxos_tpu/ops/kernels.py:accept_reply_batch`` (with ``_run_rank``;
packed ``accept_reply_packed``, jits ``accept_reply`` and
``accept_reply_p``), which the decide storm runs R times a step and the
SPI's plain ``ColumnarBackend.accept_reply`` once a chunk.  The
hand-written Hopper kernel is ``csrc/accept_reply.cu``; its header
comment holds the semantics and the design.  In short:

- **Bound:** device-memory bytes, about 42 B a lane of inputs and
  outputs, 10 B a touched row, 16 B a touched ``prop`` column, 4 B a
  changed vote word and 2 B a preempted row; at the storm's B = 2^18
  about 19 MB, some 6 us at 3.35 TB/s.
- **Small path** (B <= ``CHUNK_LANES``, the SPI's chunks): one CTA of
  B threads rounded up to a warp, or above 512 lanes one cluster of 8
  CTAs (``wave_cuda.geometry``; the geometry, barriers and run rank of
  ``csrc/vote_dev.cuh``, which the runtime's coordinator wave shares).
  A candidate claims its column as on the wide path and enters the run
  rank in shared memory before the one barrier; after it the lone
  candidate of an uncontested column decides alone, and only a
  contested column's candidates look the rank up (across the cluster's
  CTAs in distributed shared memory); no grid barrier, no workspace.
- **Wide path** (above): ONE cooperative launch, ``LANES`` lanes a
  thread.  The lanes of one column match only its slot, so the column
  is the key, and a key's quorum lanes are all its candidates (matching
  lanes on a column not yet emitted) or none.  Phase A gathers,
  matches, and a candidate adds its fresh vote and claims its column in
  one ``atomicOr`` of the vote word's bit 31 (never set in a state);
  a later claimer marks a contest (bit 30) and enters its tag
  ``epoch << 32 | ~lane`` in a table word of the column.  After the
  grid barrier, the lone candidate of an uncontested column (every
  column of the storm) is newly decided iff past quorum and stores the
  cleaned vote word; a contested column's candidates settle after a
  second grid barrier, run only when a contest happened, by the
  table's largest tag (the first in lane order).

:data:`accept_reply` is the wrapper ``kernels.accept_reply_batch`` and
``kernels.accept_reply_packed`` call.  For a state on a CUDA device it
launches the kernel of the path :func:`plan` picks — or raises; there is
no fallback — and counts each launch in ``accept_reply.launches``.  For
a state on the CPU it runs :func:`accept_reply_reference`, the plain
version (the JAX body as torch ops), which the CPU tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the
card.  The coordinator wave's torch yardsticks call
:func:`accept_reply_reference` directly, so they launch no kernel.  The
wide path's table, epoch and contest word (:class:`Workspace`) are one
a device, stream, ``G`` and ``W``.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from gigapaxos_tpu_torch.ops.rank_cuda import run_rank
from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT, PROP_RHI, PROP_RLO,
                                           PROP_SLOT, PROP_VOTES, VOTE_MASK,
                                           ColumnarState)
from gigapaxos_tpu_torch.ops.wave_cuda import MAX_LANES as CHUNK_LANES
from gigapaxos_tpu_torch.ops.wave_cuda import geometry as chunk_geometry

# the wide path's geometry in csrc/accept_reply.cu (kThreads, kLanes);
# the library reports its own at load and the wrapper checks they agree
THREADS = 128
LANES = 4
KERNEL_NAMES = ("accept_reply_chunk_kernel", "accept_reply_grid_kernel")
i32 = torch.int32


def popcount(x):
    """Bit count of non-negative int32 values (SWAR; CPU torch has no
    ``bitwise_count``)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def accept_reply_reference(state: ColumnarState, g, slot, bal, sender,
                           acked, valid) -> torch.Tensor:
    """Plain torch version of the accept-reply transition, in place on
    ``state.prop``'s vote words, ``state.is_coord`` and
    ``state.coord_active``.  ``bal`` is the accepted ballot on ack lanes
    and the acceptor's (higher) promise on nack lanes.  Returns
    ``out[6, B]`` int32: newly_decided, preempted, dec_bal, req_lo,
    req_hi, dec_slot — on every lane, invalid ones included (they read
    row 0, as ``kernels.py:_gi`` does)."""
    W = state.W
    gi = torch.where(valid, g, 0).long()
    w = torch.where(valid, slot % W, 0).long()

    coord_here = state.is_coord[gi] & state.coord_active[gi]
    cbal = state.cbal[gi]
    is_rel = valid & coord_here & (bal == cbal)
    propc = state.prop[gi, w]  # [B, 4] pre-batch proposal columns
    match = is_rel & acked & (slot >= 0) & (propc[:, PROP_SLOT] == slot)

    sender_i = sender.to(i32)
    bit = torch.ones_like(sender_i) << sender_i
    prev = propc[:, PROP_VOTES]
    fresh = match & (((prev >> sender_i) & 1) == 0)
    votes = state.prop.view(-1)
    flat = (gi * W + w) * 4 + PROP_VOTES
    # live lanes only: dead lanes add the identity at word 0
    votes.index_add_(0, torch.where(fresh, flat, 0),
                     torch.where(fresh, bit, 0))

    # re-gather POST-scatter: every lane of a column sees the whole
    # batch's votes; `fresh` never adds a bit twice (no carry into
    # EMITTED_BIT)
    newv = votes[flat]
    cnt = popcount(newv & VOTE_MASK)
    quorum = match & (cnt >= state.members[gi] // 2 + 1)
    iota = torch.arange(g.shape[0], dtype=i32, device=g.device)
    dup_before = quorum & (run_rank(torch.where(quorum, g, -1),
                                    torch.where(quorum, slot, iota)) > 0)
    emitted_prev = (prev & EMITTED_BIT) != 0
    newly = quorum & ~emitted_prev & ~dup_before
    votes.index_add_(0, torch.where(newly, flat, 0),
                     torch.where(newly, EMITTED_BIT, 0).to(i32))

    # preemption: a nack above our ballot ends our reign; a min scatter
    # on the uint8 view, where lanes outside `pre` carry the identity
    pre = valid & state.is_coord[gi] & ~acked & (bal > cbal)
    for flags in (state.is_coord, state.coord_active):
        flags.view(torch.uint8).scatter_reduce_(
            0, gi, (~pre).to(torch.uint8), reduce="amin")
    return torch.stack([newly.to(i32), pre.to(i32), cbal,
                        propc[:, PROP_RLO], propc[:, PROP_RHI], slot])


class Plan(NamedTuple):
    """One call's launch: ``path`` ("none", "cta", "cluster" or
    "grid"), its ``blocks`` (CTAs, or the cooperative grid), ``threads``
    a block and ``lanes`` a thread."""

    path: str
    blocks: int
    threads: int
    lanes: int


def plan(B: int, limit: int, lanes: int = LANES) -> Plan:
    """The launch over ``B`` lanes, from ``B`` alone: no launch for no
    lanes; up to ``CHUNK_LANES`` the small path (one CTA up to 512 lanes,
    else one cluster); above, the cooperative grid of one block per
    ``THREADS * lanes`` lanes, at most ``limit`` (the co-resident block
    count, which the grid barrier needs)."""
    if B <= 0:
        return Plan("none", 0, 0, 0)
    if B <= CHUNK_LANES:
        ctas, per = chunk_geometry(B)
        return Plan("cta" if ctas == 1 else "cluster", ctas, per, 1)
    if limit < 1:
        raise ValueError(f"accept-reply kernel: co-resident limit {limit} "
                         f"< 1")
    return Plan("grid", min(-(-B // (THREADS * lanes)), limit), THREADS,
                lanes)


def lane_walk(p: Plan, B: int) -> np.ndarray:
    """The lanes the kernel's threads take under plan ``p``, in the
    kernel's index arithmetic (below ``B``): the small path's thread
    ``b * threads + t``; the grid's lane ``round * stride + b * threads *
    lanes + k * threads + t``."""
    if p.path == "none":
        return np.zeros(0, np.int64)
    b = np.arange(p.blocks, dtype=np.int64)[:, None, None]
    t = np.arange(p.threads, dtype=np.int64)[None, None, :]
    k = np.arange(p.lanes, dtype=np.int64)[None, :, None]
    first = (b * p.threads * p.lanes + k * p.threads + t).ravel()
    stride = p.blocks * p.threads * p.lanes
    rounds = max(1, -(-B // stride))
    lanes = (first[None, :] + stride * np.arange(rounds)[:, None]).ravel()
    return lanes[lanes < B]


@dataclass
class Workspace:
    """The wide path's device workspace for one device, stream, ``G`` and
    ``W``: ``first[G * W]`` (int64 words, ``epoch << 32 | ~lane`` of a
    contested column's first candidate; zero at allocation, no call's),
    ``epoch`` (the last call's, kept and advanced by the kernel) and
    ``contested`` (set by a launch with a contest, cleared by it)."""

    first: torch.Tensor
    epoch: torch.Tensor
    contested: torch.Tensor


_workspaces: Dict[Tuple[int, int, int, int], Workspace] = {}
_ws_lock = threading.Lock()


def workspace(dev: torch.device, G: int, W: int) -> Workspace:
    """The wide path's workspace of the current stream on ``dev`` for a
    ``[G, W]`` window (made zeroed at first use)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream, G, W)
    with _ws_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = Workspace(
                first=torch.zeros(G * W, dtype=torch.int64, device=dev),
                epoch=torch.zeros(1, dtype=torch.int32, device=dev),
                contested=torch.zeros(1, dtype=torch.int32, device=dev))
            _workspaces[key] = ws
        return ws


_P = ctypes.c_void_p
_I = ctypes.c_int


class AcceptReplyKernel:
    """Wrapper of the CUDA accept-reply kernel: plans, checks, launches,
    counts.  ``lanes`` is the wide path's lanes a thread the library must
    report (a variant of the source built with another ``kLanes`` is
    bound with its own)."""

    name = "accept_reply"

    def __init__(self, lanes: int = LANES):
        # CUDA kernel launches (one per call), bumped under a lock
        self.launches = 0
        self.lanes = lanes
        self._count_lock = threading.Lock()
        self._lib = None
        self._limit = {}  # device index -> co-resident block count

    def load(self) -> ctypes.CDLL:
        """Build (first use) and bind the kernel's library, and check its
        small path's geometry against :func:`plan`'s."""
        if self._lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = _build.load(self.name)
            lib.gp_accept_reply.argtypes = [_P] * 15 + [_I] * 5 + [_P]
            lib.gp_accept_reply.restype = _I
            lib.gp_accept_reply_limits.argtypes = [ctypes.POINTER(_I)] * 4
            lib.gp_accept_reply_limits.restype = _I
            lib.gp_accept_reply_geometry.argtypes = [_I] + \
                [ctypes.POINTER(_I)] * 2
            lib.gp_accept_reply_geometry.restype = _I
            lib.gp_accept_reply_floor.argtypes = [_I, _I, _P]
            lib.gp_accept_reply_floor.restype = _I
            for B in (1, 8, 32, 33, 64, 512, 513, 4095, CHUNK_LANES):
                c, t = _I(), _I()
                rc = lib.gp_accept_reply_geometry(B, ctypes.byref(c),
                                                  ctypes.byref(t))
                if rc or (c.value, t.value) != chunk_geometry(B):
                    raise RuntimeError(
                        f"accept-reply kernel: library geometry at {B} "
                        f"lanes {c.value}x{t.value} (rc {rc}) != "
                        f"{chunk_geometry(B)}")
            self._lib = lib
        return self._lib

    def coresident_blocks(self, dev: torch.device) -> int:
        """The wide path's co-resident block count on ``dev`` (queried
        once a device); raises if the device takes no cooperative
        launch or the library's geometry differs from this wrapper's."""
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if idx not in self._limit:
            lib = self.load()
            t, k, n, coop = _I(), _I(), _I(), _I()
            with torch.cuda.device(idx):
                rc = lib.gp_accept_reply_limits(
                    ctypes.byref(t), ctypes.byref(k), ctypes.byref(n),
                    ctypes.byref(coop))
            if rc:
                raise RuntimeError(f"accept-reply kernel: limit query "
                                   f"failed: cuda error {rc}")
            if not coop.value:
                raise RuntimeError(f"accept-reply kernel: device {idx} does "
                                   "not support cooperative launches")
            if (t.value, k.value) != (THREADS, self.lanes):
                raise RuntimeError(
                    f"accept-reply kernel: library geometry {t.value} "
                    f"threads x {k.value} lanes != {THREADS} x "
                    f"{self.lanes}")
            if n.value < 1:
                raise RuntimeError("accept-reply kernel: no block fits an "
                                   "SM")
            self._limit[idx] = n.value
        return self._limit[idx]

    def plan(self, B: int, dev: torch.device) -> Plan:
        """This call's launch on ``dev`` (:func:`plan`)."""
        wide = B > CHUNK_LANES
        return plan(B, self.coresident_blocks(dev) if wide else 1,
                    lanes=self.lanes)

    def __call__(self, state: ColumnarState, g, slot, bal, sender, acked,
                 valid) -> torch.Tensor:
        """``out[6, B]`` int32 (newly_decided, preempted, dec_bal,
        req_lo, req_hi, dec_slot); the state's vote words and
        coordinator flags are updated in place.  ``acked`` and ``valid``
        are bool lanes or int32 ones (a packed batch's rows, nonzero
        true)."""
        g, slot, bal, sender = (t.to(torch.int32)
                                for t in (g, slot, bal, sender))
        if state.prop.device.type == "cpu":
            return accept_reply_reference(state, g, slot, bal, sender,
                                          acked != 0, valid != 0)
        if acked.dtype != valid.dtype or acked.dtype not in (torch.bool,
                                                             torch.int32):
            acked, valid = acked != 0, valid != 0
        return self._launch(state, g, slot, bal, sender, acked, valid)

    def _launch(self, state, g, slot, bal, sender, acked, valid):
        dev = state.prop.device
        if dev.type != "cuda":
            raise ValueError(f"accept-reply kernel: unsupported device "
                             f"{dev}")
        B = g.shape[0]
        lanes = [t.contiguous() for t in (g, slot, bal, sender, acked,
                                          valid)]
        for t in lanes:
            if t.device != dev or t.dim() != 1 or t.shape[0] != B:
                raise ValueError(f"accept-reply kernel: lane tensors must "
                                 f"be [{B}] on {dev}")
        planes = ("is_coord", "coord_active", "cbal", "members", "prop")
        for f in planes:
            t = getattr(state, f)
            want = torch.bool if f in planes[:2] else torch.int32
            if t.device != dev or t.dtype != want or not t.is_contiguous():
                raise ValueError(f"accept-reply kernel: state.{f} must be a "
                                 f"contiguous {want} tensor on {dev}")
        out = torch.empty((6, B), dtype=torch.int32, device=dev)
        if B == 0:
            return out  # a zero-block grid is an invalid launch
        p = self.plan(B, dev)
        lib = self.load()
        with torch.cuda.device(dev):
            ws = workspace(dev, state.G, state.W) if p.path == "grid" \
                else None
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gp_accept_reply(
                *(t.data_ptr() for t in lanes),
                *(getattr(state, f).data_ptr() for f in planes),
                out.data_ptr(),
                *((ws.first.data_ptr(), ws.epoch.data_ptr(),
                   ws.contested.data_ptr()) if ws else (None,) * 3),
                B, state.G, state.W, acked.element_size(), p.blocks, stream)
            if rc:
                raise RuntimeError(f"accept-reply launch failed: cuda error "
                                   f"{rc}")
            with self._count_lock:
                self.launches += 1
        return out

    def floor(self, B: int) -> None:
        """Launch an empty kernel as the accept-reply kernel is launched
        over ``B`` lanes (the small path's CTA or cluster with its shared
        memory, or the wide path's cooperative grid), on the current
        stream: the launch floor of a call, not counted in
        ``launches``."""
        dev = torch.device("cuda", torch.cuda.current_device())
        p = self.plan(B, dev)
        rc = self.load().gp_accept_reply_floor(
            B, p.blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"accept-reply floor launch failed: cuda "
                               f"error {rc}")


accept_reply = AcceptReplyKernel()
