"""The accept kernel (acceptor phase 2, HOT LOOP #1) and its plain
torch version.

Replaces ``gigapaxos_tpu/ops/pallas_accept.py:_accept_blocks/_kernel``
(the repo's one ``pl.pallas_call``), which computes what
``kernels.py:accept_batch`` computes.  The hand-written Hopper kernel is
``csrc/accept.cu``; its header comment holds the semantics and the
design.  In short:

- **Bound:** device-memory bytes, about 66 B a lane — 21 B of lane
  inputs (g, slot, bal, rlo, rhi as int32 and the valid byte), 9 B of
  gathers (``active``, ``bal``, ``exec_cursor``), at most 4 B of ballot
  write, one 16 B ``acc`` store and 16 B of outputs.  At B = 2^18 that
  is about 17 MB, some 5 us at 3.35 TB/s; at the backend's B <= 4096 the
  bytes take well under 1 us.  Each random row gather and ``acc`` store
  touches its own 32-byte sector, so at large B the kernel is bound by
  random sector traffic, and at small B by the launch and the chain of
  dependent memory round trips each lane waits on.
- **Design:** ONE cooperative launch a call.  Phase A raises ``bal[g]``
  with ``atomicMax`` for every live lane; a grid-wide barrier; phase B
  reads the post-batch ballot (the max over the WHOLE batch, as the TPU
  kernel and the XLA body read it), decides promised / stale /
  in-window, stores the pvalue as one 16-byte ``int4`` and writes the
  packed ``out[4, B]``.  A thread owns four consecutive lanes (16-byte
  vector loads), gathers all their rows before using any, and keeps
  them in registers across the barrier, so phase B gathers only
  ``bal``.  The grid is at most the co-resident block count
  (:func:`grid_plan`); lanes beyond it take a grid-stride loop.

:data:`accept` is the wrapper the kernels call.  For a state on a CUDA
device it launches the kernel — or raises; there is no fallback — and
counts each launch in ``accept.launches`` (one a call, exact when
several threads launch).  For a state on the CPU it runs
:func:`accept_reference`, the plain version, which the CPU tests hold
against the JAX package and ``chip_smoke.py`` holds the kernel against
on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gigapaxos_tpu_torch.ops.types import ColumnarState

INT32_MIN = -(1 << 31)
# launch geometry of csrc/accept.cu (kThreads, kLanes); the library
# reports its own at load and the wrapper checks they agree
THREADS, LANES = 128, 4
KERNEL_NAME = "accept_coop_kernel"


def accept_reference(state: ColumnarState, g, slot, bal, rlo, rhi, valid
                     ) -> torch.Tensor:
    """Plain torch version of the accept transition, in place on
    ``state.bal`` and ``state.acc``.  Returns ``out[4, B]`` int32:
    acked, stale, out_window, cur_bal — on every lane, invalid ones
    included (they read row 0, as ``kernels.py:_gi`` does)."""
    W = state.W
    gi = torch.where(valid, g, 0).long()
    live = valid & state.active[gi]
    # ballot scatter-max; dead lanes hit row 0 with the identity
    state.bal.scatter_reduce_(0, gi, torch.where(live, bal, INT32_MIN),
                              reduce="amax")
    cur_bal = state.bal[gi]
    promised = live & (bal >= cur_bal)
    cursor = state.exec_cursor[gi]
    stale = live & (slot < cursor)
    in_win = (slot >= cursor) & (slot < cursor + W)
    store = promised & in_win
    # boolean-mask put: exact even where a dead lane aliases a live row
    state.acc[gi[store], (slot[store] % W).long()] = torch.stack(
        [slot, bal, rlo, rhi], dim=-1)[store]
    return torch.stack([
        (store | (promised & stale)).to(torch.int32),
        stale.to(torch.int32),
        (promised & ~in_win & ~stale).to(torch.int32),
        cur_bal])


def grid_plan(B: int, limit: int) -> int:
    """Blocks of the cooperative launch for ``B`` lanes: one block per
    ``THREADS * LANES`` lanes, at most ``limit`` (the co-resident block
    count, which the grid-wide barrier needs); 0 for no lanes."""
    if B <= 0:
        return 0
    if limit < 1:
        raise ValueError(f"accept kernel: co-resident limit {limit} < 1")
    return min(-(-B // (THREADS * LANES)), limit)


_P = ctypes.c_void_p
_I = ctypes.c_int


class AcceptKernel:
    """Wrapper of the CUDA accept kernel: checks, launches, counts."""

    name = "accept"

    def __init__(self):
        # CUDA kernel launches (one per call); the node runtime launches
        # from several threads, so the count is bumped under a lock
        self.launches = 0
        self._count_lock = threading.Lock()
        self._lib = None
        self._limit = {}  # device index -> co-resident block count

    def load(self) -> ctypes.CDLL:
        """Build (first use) and bind the kernel's library."""
        if self._lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = _build.load(self.name)
            lib.gp_accept.argtypes = [_P] * 11 + [_I] * 5 + [_P]
            lib.gp_accept.restype = _I
            lib.gp_accept_limits.argtypes = [ctypes.POINTER(_I)] * 4
            lib.gp_accept_limits.restype = _I
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
            t, k, n, coop = _I(), _I(), _I(), _I()
            with torch.cuda.device(idx):
                rc = lib.gp_accept_limits(ctypes.byref(t), ctypes.byref(k),
                                          ctypes.byref(n), ctypes.byref(coop))
            if rc:
                raise RuntimeError(f"accept kernel: limit query failed: "
                                   f"cuda error {rc}")
            if not coop.value:
                raise RuntimeError(f"accept kernel: device {idx} does not "
                                   "support cooperative launches")
            if (t.value, k.value) != (THREADS, LANES):
                raise RuntimeError(
                    f"accept kernel: library geometry {t.value}x{k.value} "
                    f"!= {THREADS}x{LANES}")
            if n.value < 1:
                raise RuntimeError("accept kernel: no block fits an SM")
            self._limit[idx] = n.value
        return self._limit[idx]

    def __call__(self, state: ColumnarState, g, slot, bal, rlo, rhi,
                 valid) -> torch.Tensor:
        """``out[4, B]`` int32 (acked, stale, out_window, cur_bal); the
        state's ``bal`` and ``acc`` are updated in place."""
        if state.acc.device.type == "cpu":
            return accept_reference(state, g, slot, bal, rlo, rhi, valid)
        return self._launch(state, g, slot, bal, rlo, rhi, valid)

    def _launch(self, state, g, slot, bal, rlo, rhi, valid):
        dev = state.acc.device
        if dev.type != "cuda":
            raise ValueError(f"accept kernel: unsupported device {dev}")
        B = g.shape[0]
        lanes = (g, slot, bal, rlo, rhi)
        for t in lanes + (valid,):
            if t.device != dev or t.dim() != 1 or t.shape[0] != B or \
                    not t.is_contiguous():
                raise ValueError("accept kernel: lane tensors must be "
                                 f"contiguous [{B}] on {dev}")
        if any(t.dtype != torch.int32 for t in lanes) or \
                valid.dtype != torch.bool:
            raise ValueError("accept kernel: lanes are int32, valid bool")
        G, W = state.G, state.W
        for t in (state.active, state.bal, state.exec_cursor, state.acc):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("accept kernel: state planes must be "
                                 f"contiguous on {dev}")
        if state.acc.data_ptr() % 16:
            raise ValueError("accept kernel: acc plane not 16-byte aligned")
        out = torch.empty((4, B), dtype=torch.int32, device=dev)
        if B == 0:
            return out  # a zero-block grid is an invalid launch
        if out.data_ptr() % 16:
            raise ValueError("accept kernel: out not 16-byte aligned")
        # the vector loads need 16-byte lane rows (4-byte valid bytes);
        # other lanes take the scalar loads
        vec_in = all(t.data_ptr() % 16 == 0 for t in lanes) and \
            valid.data_ptr() % 4 == 0
        blocks = grid_plan(B, self.coresident_blocks(dev))
        lib = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gp_accept(
                g.data_ptr(), slot.data_ptr(), bal.data_ptr(),
                rlo.data_ptr(), rhi.data_ptr(), valid.data_ptr(),
                state.active.data_ptr(), state.bal.data_ptr(),
                state.exec_cursor.data_ptr(), state.acc.data_ptr(),
                out.data_ptr(), B, G, W, blocks, int(vec_in), stream)
            if rc:
                raise RuntimeError(f"accept launch failed: cuda error {rc}")
            with self._count_lock:
                self.launches += 1
        return out


accept = AcceptKernel()
