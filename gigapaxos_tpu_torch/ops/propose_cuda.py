"""The propose kernel (slot assignment at any width, with a hand-written
run rank) and its plain torch version.

Replaces the XLA-jit body ``gigapaxos_tpu/ops/kernels.py:propose_batch``
(with ``_run_rank``; packed ``propose_packed``, jits ``propose`` and
``propose_p``), which the decide storm runs once a step and the SPI's
plain ``ColumnarBackend.propose`` once a chunk.  The hand-written Hopper
kernel is ``csrc/propose.cu``; its header comment holds the semantics
and the design, and ``csrc/rank_dev.cuh`` the run rank.  In short:

- **Bound:** device-memory bytes, about 48 B a lane and 20 B more a
  granted one — 13 B of lane inputs, 15 B of row gathers (``active``,
  ``is_coord``, ``coord_active``, ``next_slot``, ``exec_cursor``,
  ``cbal``), 20 B of outputs, a 16 B ``prop`` store and a 4 B
  ``next_slot`` add.  At the storm's B = 2^18 that is about 17 MB, some
  5 us at 3.35 TB/s.  The run rank's workspace adds about 40 B a list
  entry (one a row and tile).
- **Design:** ONE cooperative launch a call, 256-lane tiles spread over
  the co-resident blocks.  Phase A gathers every lane's row, ranks the
  lane among the earlier lanes of its tile with the same row
  (``__match_any_sync``, then per-warp counts in a shared-memory table)
  and appends one ``{tile, count}`` entry a (tile, row) to the row's
  list in a workspace; a grid-wide barrier; phase B adds the counts of
  the row's entries from earlier tiles to the rank, decides, adds to
  ``next_slot`` and stores the ``prop`` column.  No sort.

:data:`propose` is the wrapper ``kernels.propose_batch`` and
``kernels.propose_packed`` call.  For a state on a CUDA device it
launches the kernel — or raises; there is no fallback — and counts each
launch in ``propose.launches`` (one a call, exact when several threads
launch).  For a state on the CPU it runs :func:`propose_reference`, the
plain version, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.  The
coordinator wave's torch yardstick calls :func:`propose_reference`
directly, so it launches no kernel.

The run rank's workspace (``rank_cuda.Workspace``: a list head a row,
tagged with an epoch the kernels keep on the device, so no call clears
it) is one a device, stream and ``G``; ``rank_cuda`` also holds the
plain run rank and the grid plan.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# the run rank's geometry, plain version, grid and workspace
from gigapaxos_tpu_torch.ops.rank_cuda import (THREADS, grid_plan, run_rank,
                                               workspace)
from gigapaxos_tpu_torch.ops.types import ColumnarState

KERNEL_NAME = "propose_coop_kernel"


def propose_reference(state: ColumnarState, g, rlo, rhi, valid
                      ) -> torch.Tensor:
    """Plain torch version of the propose transition, in place on
    ``state.next_slot`` and ``state.prop``.  Returns ``out[5, B]`` int32:
    granted, rejected, throttled, slot, cbal — on every lane, invalid
    ones included (they read row 0, as ``kernels.py:_gi`` does)."""
    W = state.W
    gi = torch.where(valid, g, 0).long()
    act = state.active[gi]
    coord = state.is_coord[gi] & state.coord_active[gi]
    can = valid & act & coord

    iota = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
    rank = run_rank(torch.where(can, g, -1), torch.where(can, 0, iota))

    slot = state.next_slot[gi] + rank
    in_win = slot < state.exec_cursor[gi] + W
    granted = can & in_win
    cbal = state.cbal[gi]

    # granted lanes only: dead lanes add the identity on row 0
    state.next_slot.index_add_(0, torch.where(granted, gi, 0),
                               granted.to(torch.int32))
    # boolean-mask put: exact even where a dead lane aliases a live row
    w = torch.where(granted, slot % W, 0).long()
    state.prop[gi[granted], w[granted]] = torch.stack(
        [slot, rlo, rhi, torch.zeros_like(slot)], dim=-1)[granted]
    return torch.stack([granted.to(torch.int32),
                        (valid & act & ~coord).to(torch.int32),
                        (can & ~in_win).to(torch.int32), slot, cbal])


_P = ctypes.c_void_p
_I = ctypes.c_int


class ProposeKernel:
    """Wrapper of the CUDA propose kernel: checks, launches, counts."""

    name = "propose"

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
            lib.gp_propose.argtypes = [_P] * 16 + [_I] * 4 + [_P]
            lib.gp_propose.restype = _I
            lib.gp_propose_limits.argtypes = [ctypes.POINTER(_I)] * 3
            lib.gp_propose_limits.restype = _I
            lib.gp_propose_floor.argtypes = [_I, _P]
            lib.gp_propose_floor.restype = _I
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
                rc = lib.gp_propose_limits(ctypes.byref(t), ctypes.byref(n),
                                           ctypes.byref(coop))
            if rc:
                raise RuntimeError(f"propose kernel: limit query failed: "
                                   f"cuda error {rc}")
            if not coop.value:
                raise RuntimeError(f"propose kernel: device {idx} does not "
                                   "support cooperative launches")
            if t.value != THREADS:
                raise RuntimeError(f"propose kernel: library geometry "
                                   f"{t.value} threads != {THREADS}")
            if n.value < 1:
                raise RuntimeError("propose kernel: no block fits an SM")
            self._limit[idx] = n.value
        return self._limit[idx]

    def __call__(self, state: ColumnarState, g, rlo, rhi, valid
                 ) -> torch.Tensor:
        """``out[5, B]`` int32 (granted, rejected, throttled, slot,
        cbal); the state's ``next_slot`` and ``prop`` are updated in
        place."""
        g, rlo, rhi = (t.to(torch.int32) for t in (g, rlo, rhi))
        valid = valid.to(torch.bool)
        if state.prop.device.type == "cpu":
            return propose_reference(state, g, rlo, rhi, valid)
        return self._launch(state, g, rlo, rhi, valid)

    def _launch(self, state, g, rlo, rhi, valid):
        dev = state.prop.device
        if dev.type != "cuda":
            raise ValueError(f"propose kernel: unsupported device {dev}")
        B = g.shape[0]
        lanes = [t.contiguous() for t in (g, rlo, rhi, valid)]
        for t in lanes:
            if t.device != dev or t.dim() != 1 or t.shape[0] != B:
                raise ValueError(f"propose kernel: lane tensors must be "
                                 f"[{B}] on {dev}")
        planes = ("active", "is_coord", "coord_active", "cbal",
                  "exec_cursor", "next_slot", "prop")
        for f in planes:
            t = getattr(state, f)
            want = torch.bool if f in planes[:3] else torch.int32
            if t.device != dev or t.dtype != want or not t.is_contiguous():
                raise ValueError(f"propose kernel: state.{f} must be a "
                                 f"contiguous {want} tensor on {dev}")
        out = torch.empty((5, B), dtype=torch.int32, device=dev)
        if B == 0:
            return out  # a zero-block grid is an invalid launch
        blocks = grid_plan(B, self.coresident_blocks(dev))
        lib = self.load()
        with torch.cuda.device(dev):
            ws = workspace(dev, state.G)
            ws.fit(B)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gp_propose(
                *(t.data_ptr() for t in lanes),
                *(getattr(state, f).data_ptr() for f in planes),
                out.data_ptr(), ws.head.data_ptr(), ws.pool.data_ptr(),
                ws.base.data_ptr(), ws.epoch.data_ptr(),
                B, state.G, state.W, blocks, stream)
            if rc:
                raise RuntimeError(f"propose launch failed: cuda error {rc}")
            with self._count_lock:
                self.launches += 1
        return out

    def floor(self, B: int) -> None:
        """Launch an empty kernel as the propose kernel is launched over
        ``B`` lanes (cooperative, the same grid and block), on the
        current stream: the launch floor of a call, not counted in
        ``launches``."""
        dev = torch.device("cuda", torch.cuda.current_device())
        blocks = grid_plan(B, self.coresident_blocks(dev))
        rc = self.load().gp_propose_floor(
            blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"propose floor launch failed: cuda error "
                               f"{rc}")


propose = ProposeKernel()
