"""The commit kernel (the decision transition at any width) and its plain
torch version.

Replaces the XLA-jit body ``gigapaxos_tpu/ops/kernels.py:commit_batch``
(packed ``commit_packed``, jit ``commit``), which the decide storm runs
once a replica a step.  The hand-written Hopper kernel is
``csrc/commit.cu``; its header comment holds the semantics and the
design, and ``csrc/commit_dev.cuh`` the lane arithmetic it shares with
the runtime's wave kernels.  In short:

- **Bound:** device-memory bytes, about 62 B a storing lane — 21 B of
  lane inputs, 5 B of row gathers (``active``, ``exec_cursor``), a 12 B
  ``dec`` store, the ``dec`` slot words its contiguity scan reads, a 4 B
  cursor write and 16 B of outputs.  At the storm's B = 2^18 that is
  about 16 MB, some 5 us at 3.35 TB/s; every row gather and store lands
  on its own sector, so the kernel is bound by random sector traffic at
  large B and by the launch and its chain of round trips at small B.
- **Design:** ONE cooperative launch a call, ``LANES`` lanes a thread:
  phase A decides each lane against its row's pre-batch cursor and
  stores the decision; a grid-wide barrier; phase B scans each storing
  lane's row in the post-batch ``dec``, raises ``exec_cursor`` by
  ``atomicMax`` and writes the lane's new cursor, ``cur + adv`` (every
  store lane of a row finds the same advance from the same cursor); a
  second grid-wide barrier and phase C, where the lanes that do not
  store read their row's new cursor, run only if phase A counted such a
  lane (a device word every block reads after the first barrier).  The
  grid is at most the co-resident block count (:func:`grid_plan`); lanes
  beyond it take further rounds and carry their pre-batch cursor across
  the barriers in their own ``new_cursor`` output word.

:data:`commit` is the wrapper ``kernels.commit_batch`` calls.  For a
state on a CUDA device it launches the kernel — or raises; there is no
fallback — and counts each launch in ``commit.launches`` (one a call,
exact when several threads launch).  For a state on the CPU it runs
:func:`commit_reference`, the plain version, which the CPU tests hold
against the JAX package and ``chip_smoke.py`` holds the kernel against
on the card.  The wave kernels' torch yardsticks call
:func:`commit_reference` directly, so they launch no kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from gigapaxos_tpu_torch.ops.accept_cuda import INT32_MIN
from gigapaxos_tpu_torch.ops.types import DEC_SLOT, ColumnarState

# launch geometry of csrc/commit.cu (kThreads, kLanes lanes a thread);
# the library reports its own at load and the wrapper checks they agree
THREADS = 128
LANES = 2
KERNEL_NAME = "commit_coop_kernel"


def commit_reference(state: ColumnarState, g, slot, rlo, rhi, valid
                     ) -> torch.Tensor:
    """Plain torch version of the commit transition, in place on
    ``state.dec`` and ``state.exec_cursor``.  Returns ``out[4, B]`` int32:
    applied, stale, out_window, new_cursor — on every lane, invalid ones
    included (they read row 0, as ``kernels.py:_gi`` does)."""
    W = state.W
    gi = torch.where(valid, g, 0).long()
    act = state.active[gi]
    cursor = state.exec_cursor[gi]

    stale = valid & act & (slot < cursor)
    in_win = (slot >= cursor) & (slot < cursor + W)
    store = valid & act & in_win
    w = torch.where(store, slot % W, 0)
    # boolean-mask put: exact even where a dead lane aliases a live row
    state.dec[gi[store], w[store].long()] = torch.stack(
        [slot, rlo, rhi], dim=-1)[store]

    # contiguity advance over the touched rows only ([B, W] gathers)
    dslotr = state.dec[gi, :, DEC_SLOT]
    want = cursor[:, None] + torch.arange(W, dtype=torch.int32,
                                          device=g.device)[None, :]
    ok = torch.gather(dslotr, 1, (want % W).long()) == want
    adv = torch.cumprod(ok.to(torch.int32), dim=1,
                        dtype=torch.int32).sum(dim=1, dtype=torch.int32)
    # scatter-max; dead lanes hit row 0 with the identity
    state.exec_cursor.scatter_reduce_(
        0, gi, torch.where(store, cursor + adv, INT32_MIN), reduce="amax")
    return torch.stack([store.to(torch.int32), stale.to(torch.int32),
                        (valid & act & (slot >= cursor + W)).to(torch.int32),
                        state.exec_cursor[gi]])


def grid_plan(B: int, limit: int, lanes: int = LANES) -> int:
    """Blocks of the cooperative launch for ``B`` lanes: one block per
    ``THREADS * lanes`` lanes, at most ``limit`` (the co-resident block
    count, which the grid-wide barriers need); 0 for no lanes."""
    if B <= 0:
        return 0
    if limit < 1:
        raise ValueError(f"commit kernel: co-resident limit {limit} < 1")
    return min(-(-B // (THREADS * lanes)), limit)


_readers: Dict[Tuple[int, int], torch.Tensor] = {}
_readers_lock = threading.Lock()


def readers_word(dev: torch.device) -> torch.Tensor:
    """The device word of the current stream on ``dev`` that phase A
    sets when a lane does not store (zero between calls: the kernel
    clears it after the second barrier)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _readers_lock:
        w = _readers.get(key)
        if w is None:
            w = _readers[key] = torch.zeros(1, dtype=torch.int32,
                                            device=dev)
        return w


_P = ctypes.c_void_p
_I = ctypes.c_int


class CommitKernel:
    """Wrapper of the CUDA commit kernel: checks, launches, counts.
    ``lanes`` is the lanes a thread the library must report (a variant of
    the source built with another ``kLanes`` is bound with its own)."""

    name = "commit"

    def __init__(self, lanes: int = LANES):
        # CUDA kernel launches (one per call), bumped under a lock
        self.launches = 0
        self.lanes = lanes
        self._count_lock = threading.Lock()
        self._lib = None
        self._limit = {}  # device index -> co-resident block count

    def load(self) -> ctypes.CDLL:
        """Build (first use) and bind the kernel's library."""
        if self._lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = _build.load(self.name)
            lib.gp_commit.argtypes = [_P] * 10 + [_I] * 4 + [_P]
            lib.gp_commit.restype = _I
            lib.gp_commit_limits.argtypes = [ctypes.POINTER(_I)] * 4
            lib.gp_commit_limits.restype = _I
            lib.gp_commit_floor.argtypes = [_I, _P]
            lib.gp_commit_floor.restype = _I
            self._lib = lib
        return self._lib

    def coresident_blocks(self, dev: torch.device) -> int:
        """The co-resident block count of the kernel on ``dev`` (queried
        once a device); raises if the device takes no cooperative
        launch or the library's geometry differs from this wrapper's."""
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if idx not in self._limit:
            lib = self.load()
            t, k, n, coop = _I(), _I(), _I(), _I()
            with torch.cuda.device(idx):
                rc = lib.gp_commit_limits(ctypes.byref(t), ctypes.byref(k),
                                          ctypes.byref(n),
                                          ctypes.byref(coop))
            if rc:
                raise RuntimeError(f"commit kernel: limit query failed: "
                                   f"cuda error {rc}")
            if not coop.value:
                raise RuntimeError(f"commit kernel: device {idx} does not "
                                   "support cooperative launches")
            if (t.value, k.value) != (THREADS, self.lanes):
                raise RuntimeError(
                    f"commit kernel: library geometry {t.value} threads x "
                    f"{k.value} lanes != {THREADS} x {self.lanes}")
            if n.value < 1:
                raise RuntimeError("commit kernel: no block fits an SM")
            self._limit[idx] = n.value
        return self._limit[idx]

    def __call__(self, state: ColumnarState, g, slot, rlo, rhi, valid
                 ) -> torch.Tensor:
        """``out[4, B]`` int32 (applied, stale, out_window, new_cursor);
        the state's ``dec`` and ``exec_cursor`` are updated in place."""
        g, slot, rlo, rhi = (t.to(torch.int32) for t in (g, slot, rlo, rhi))
        valid = valid.to(torch.bool)
        if state.dec.device.type == "cpu":
            return commit_reference(state, g, slot, rlo, rhi, valid)
        return self._launch(state, g, slot, rlo, rhi, valid)

    def _launch(self, state, g, slot, rlo, rhi, valid):
        dev = state.dec.device
        if dev.type != "cuda":
            raise ValueError(f"commit kernel: unsupported device {dev}")
        B = g.shape[0]
        lanes = [t.contiguous() for t in (g, slot, rlo, rhi, valid)]
        for t in lanes:
            if t.device != dev or t.dim() != 1 or t.shape[0] != B:
                raise ValueError(f"commit kernel: lane tensors must be "
                                 f"[{B}] on {dev}")
        for f in ("active", "exec_cursor", "dec"):
            t = getattr(state, f)
            want = torch.bool if f == "active" else torch.int32
            if t.device != dev or t.dtype != want or not t.is_contiguous():
                raise ValueError(f"commit kernel: state.{f} must be a "
                                 f"contiguous {want} tensor on {dev}")
        out = torch.empty((4, B), dtype=torch.int32, device=dev)
        if B == 0:
            return out  # a zero-block grid is an invalid launch
        blocks = grid_plan(B, self.coresident_blocks(dev), lanes=self.lanes)
        lib = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.gp_commit(
                *(t.data_ptr() for t in lanes), state.active.data_ptr(),
                state.exec_cursor.data_ptr(), state.dec.data_ptr(),
                out.data_ptr(), readers_word(dev).data_ptr(), B, state.G,
                state.W, blocks, stream)
            if rc:
                raise RuntimeError(f"commit launch failed: cuda error {rc}")
            with self._count_lock:
                self.launches += 1
        return out

    def floor(self, B: int) -> None:
        """Launch an empty kernel as the commit kernel is launched over
        ``B`` lanes (cooperative, the same grid and block), on the
        current stream: the launch floor of a call, not counted in
        ``launches``."""
        dev = torch.device("cuda", torch.cuda.current_device())
        blocks = grid_plan(B, self.coresident_blocks(dev), lanes=self.lanes)
        rc = self.load().gp_commit_floor(
            blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"commit floor launch failed: cuda error "
                               f"{rc}")


commit = CommitKernel()
