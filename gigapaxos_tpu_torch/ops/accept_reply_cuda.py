"""The accept-reply kernel (vote counting at any width, one grid barrier,
the run rank of ``rank_cuda``) and its plain torch version.

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
- **Design:** ONE cooperative launch a call, 256-lane tiles over the
  co-resident blocks.  Phase A gathers, matches, adds each fresh vote
  (``atomicAdd``), ranks each matching lane among its tile's matching
  lanes of the same (row, slot) and appends one list entry a (tile,
  key); a grid-wide barrier; phase B re-gathers the vote word, and a
  key's first matching lane of its tile, past quorum and with no
  ``EMITTED_BIT`` before the batch, is newly decided unless its row's
  list shows the key in an earlier tile.  The lanes of one (row, slot)
  read one column, so a key's quorum lanes are all its matching lanes
  or none: ranking the matching lanes before the votes are counted
  gives the quorum lanes' rank, with no second barrier.

:data:`accept_reply` is the wrapper ``kernels.accept_reply_batch`` and
``kernels.accept_reply_packed`` call.  For a state on a CUDA device it
launches the kernel — or raises; there is no fallback — and counts each
launch in ``accept_reply.launches``.  For a state on the CPU it runs
:func:`accept_reply_reference`, the plain version (the JAX body as torch
ops), which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.  The
coordinator wave's torch yardsticks call :func:`accept_reply_reference`
directly, so they launch no kernel.  The run rank's workspace is
``rank_cuda``'s, shared with the propose kernel on the same stream.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gigapaxos_tpu_torch.ops import rank_cuda
from gigapaxos_tpu_torch.ops.rank_cuda import THREADS, grid_plan, run_rank
from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT, PROP_RHI, PROP_RLO,
                                           PROP_SLOT, PROP_VOTES, VOTE_MASK,
                                           ColumnarState)

KERNEL_NAME = "accept_reply_coop_kernel"
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


_P = ctypes.c_void_p
_I = ctypes.c_int


class AcceptReplyKernel:
    """Wrapper of the CUDA accept-reply kernel: checks, launches,
    counts."""

    name = "accept_reply"

    def __init__(self):
        # CUDA kernel launches (one per call), bumped under a lock
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib = None
        self._limit = {}  # device index -> co-resident block count

    def load(self) -> ctypes.CDLL:
        """Build (first use) and bind the kernel's library."""
        if self._lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = _build.load(self.name)
            lib.gp_accept_reply.argtypes = [_P] * 15 + [_I] * 5 + [_P]
            lib.gp_accept_reply.restype = _I
            lib.gp_accept_reply_limits.argtypes = [ctypes.POINTER(_I)] * 3
            lib.gp_accept_reply_limits.restype = _I
            lib.gp_accept_reply_floor.argtypes = [_I, _P]
            lib.gp_accept_reply_floor.restype = _I
            self._lib = lib
        return self._lib

    def coresident_blocks(self, dev: torch.device) -> int:
        """The co-resident block count of the kernel on ``dev`` (queried
        once a device); raises if the device takes no cooperative
        launch or the library's geometry differs from this module's."""
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if idx not in self._limit:
            lib = self.load()
            t, n, coop = _I(), _I(), _I()
            with torch.cuda.device(idx):
                rc = lib.gp_accept_reply_limits(
                    ctypes.byref(t), ctypes.byref(n), ctypes.byref(coop))
            if rc:
                raise RuntimeError(f"accept-reply kernel: limit query "
                                   f"failed: cuda error {rc}")
            if not coop.value:
                raise RuntimeError(f"accept-reply kernel: device {idx} does "
                                   "not support cooperative launches")
            if t.value != THREADS:
                raise RuntimeError(f"accept-reply kernel: library geometry "
                                   f"{t.value} threads != {THREADS}")
            if n.value < 1:
                raise RuntimeError("accept-reply kernel: no block fits an "
                                   "SM")
            self._limit[idx] = n.value
        return self._limit[idx]

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
        blocks = grid_plan(B, self.coresident_blocks(dev))
        lib = self.load()
        with torch.cuda.device(dev):
            ws = rank_cuda.workspace(dev, state.G)
            ws.fit(B)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gp_accept_reply(
                *(t.data_ptr() for t in lanes),
                *(getattr(state, f).data_ptr() for f in planes),
                out.data_ptr(), ws.head.data_ptr(), ws.pool.data_ptr(),
                ws.epoch.data_ptr(), B, state.G, state.W,
                acked.element_size(), blocks, stream)
            if rc:
                raise RuntimeError(f"accept-reply launch failed: cuda error "
                                   f"{rc}")
            with self._count_lock:
                self.launches += 1
        return out

    def floor(self, B: int) -> None:
        """Launch an empty kernel as the accept-reply kernel is launched
        over ``B`` lanes (cooperative, the same grid and block), on the
        current stream: the launch floor of a call, not counted in
        ``launches``."""
        dev = torch.device("cuda", torch.cuda.current_device())
        blocks = grid_plan(B, self.coresident_blocks(dev))
        rc = self.load().gp_accept_reply_floor(
            blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"accept-reply floor launch failed: cuda "
                               f"error {rc}")


accept_reply = AcceptReplyKernel()
