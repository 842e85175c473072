"""The node runtime's two fused engine waves as Hopper kernels.

Replaces the XLA-jit wave bodies of ``gigapaxos_tpu/ops/kernels.py``
that the runtime's ``ColumnarBackend`` runs once a worker batch (none of
them is a Pallas kernel; on the card the port ran them as torch-op
bodies, a few hundred torch calls and a host sync a wave):

- :data:`acceptor` (``acceptor_wave_kernel``): ``accept_commit_packed``
  (jit ``accept_commit_p``), an accept batch then a commit batch on one
  state; with no accept half it is ``commit_p``;
- :data:`coordinator` (``coordinator_wave_kernel``):
  ``request_reply_packed`` (jit ``request_reply_p``), that is
  ``propose_accept_self_packed`` (propose, own accept, own vote) then
  ``accept_reply_commit_self_packed`` (the replies' votes, own commit);
  either half alone is that half's jit.

The source is ``csrc/wave.cu``; its header comment holds the semantics
(each step a scatter phase and a gather phase with a barrier between),
the bound and the design.  In short: ONE launch a call, one CTA of 1024
threads over at most 4096 lanes a half, ``__syncthreads`` between the
phases, the run ranks from a bitonic sort in shared memory.  The bound
is bytes — about a megabyte at 4096 lanes, a third of a microsecond at
3.35 TB/s — and what limits a runtime chunk is the launch and the chain
of dependent memory round trips across the barriers.

A call takes each half as a packed ``[k+1, B]`` int32 tensor (the
layouts of the JAX module's packed entry points, valid mask last) or
``None``, and returns ONE ``[m, B]`` int32 tensor: the first half's
output rows, then the second's (4 and 4 for the acceptor wave, 9 and 9
for the coordinator wave), row for row the torch bodies' outputs.  The
wrappers launch on the current stream and never synchronize.  They run
only on a CUDA device and raise on anything else: the plain versions
are the torch bodies of :mod:`gigapaxos_tpu_torch.ops.kernels`, which
that module's entry points run for a state on the CPU.  Each launch
adds one to the wrapper's ``launches`` (exact when several threads
launch).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from gigapaxos_tpu_torch.ops.types import ColumnarState

# launch geometry of csrc/wave.cu (kThreads, kMaxLanes); the library
# reports its own at load and the wrapper checks they agree
THREADS, MAX_LANES = 1024, 4096

_P = ctypes.c_void_p
_I = ctypes.c_int

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (first use) and bind the waves' library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = _build.load("wave")
            for fn in (lib.gp_acceptor_wave, lib.gp_coordinator_wave):
                fn.argtypes = [_P, _P, _I, _P, _P, _I] + [_P] * 11 + \
                    [_I, _I, _P]
                fn.restype = _I
            lib.gp_wave_limits.argtypes = [ctypes.POINTER(_I)] * 2
            lib.gp_wave_limits.restype = _I
            t, n = _I(), _I()
            rc = lib.gp_wave_limits(ctypes.byref(t), ctypes.byref(n))
            if rc or (t.value, n.value) != (THREADS, MAX_LANES):
                raise RuntimeError(
                    f"wave kernels: library geometry {t.value}x{n.value} "
                    f"(rc {rc}) != {THREADS}x{MAX_LANES}")
            _lib = lib
        return _lib


_PLANES = ("active", "members", "bal", "acc", "dec", "exec_cursor",
           "is_coord", "coord_active", "cbal", "next_slot", "prop")
_BOOL_PLANES = ("active", "is_coord", "coord_active")


def _check_state(state: ColumnarState, name: str) -> torch.device:
    dev = state.acc.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: unsupported device {dev} (the "
                         "plain version runs in ops.kernels)")
    for f in _PLANES:
        t = getattr(state, f)
        want = torch.bool if f in _BOOL_PLANES else torch.int32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} kernel: state.{f} must be a "
                             f"contiguous {want} tensor on {dev}")
    for f in ("acc", "prop"):
        if getattr(state, f).data_ptr() % 16:
            raise ValueError(f"{name} kernel: state.{f} not 16-byte "
                             "aligned")
    return dev


class WaveKernel:
    """Wrapper of one CUDA wave kernel: checks, launches, counts."""

    def __init__(self, name: str, symbol: str, in_rows, out_rows):
        self.name = name
        self.kernel_name = f"{name}_kernel"  # as the profiler names it
        self._symbol = symbol
        self.in_rows = in_rows    # packed input rows of each half
        self.out_rows = out_rows  # output rows of each half
        # CUDA kernel launches (one per call); the node runtime launches
        # from several threads, so the count is bumped under a lock
        self.launches = 0
        self._count_lock = threading.Lock()

    def __call__(self, state: ColumnarState, first, second) -> torch.Tensor:
        """Both halves of one chunk in ONE launch; ``first``/``second``
        are packed ``[k+1, B]`` int32 tensors or ``None`` (not both).
        Returns ``out[m, B]``; the state is updated in place."""
        dev = _check_state(state, self.name)
        halves = (first, second)
        if first is None and second is None:
            raise ValueError(f"{self.name} kernel: both halves empty")
        B = None
        for h, k in zip(halves, self.in_rows):
            if h is None:
                continue
            if h.device != dev or h.dtype != torch.int32 or \
                    h.dim() != 2 or h.shape[0] != k or \
                    not h.is_contiguous():
                raise ValueError(f"{self.name} kernel: a half must be a "
                                 f"contiguous int32 [{k}, B] tensor on "
                                 f"{dev}")
            if B is not None and h.shape[1] != B:
                raise ValueError(f"{self.name} kernel: halves of "
                                 f"{B} and {h.shape[1]} lanes")
            B = h.shape[1]
        if not 0 < B <= MAX_LANES:
            raise ValueError(f"{self.name} kernel: {B} lanes; a chunk "
                             f"holds 1 to {MAX_LANES}")
        m = sum(r for h, r in zip(halves, self.out_rows) if h is not None)
        out = torch.empty((m, B), dtype=torch.int32, device=dev)
        args = []
        at = 0
        for h, r in zip(halves, self.out_rows):
            if h is None:
                args += [None, None, 0]
            else:
                args += [h.data_ptr(), out[at:at + r].data_ptr(), B]
                at += r
        lib = load()
        fn = getattr(lib, self._symbol)
        st = state
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*args, st.active.data_ptr(), st.members.data_ptr(),
                    st.bal.data_ptr(), st.acc.data_ptr(), st.dec.data_ptr(),
                    st.exec_cursor.data_ptr(), st.is_coord.data_ptr(),
                    st.coord_active.data_ptr(), st.cbal.data_ptr(),
                    st.next_slot.data_ptr(), st.prop.data_ptr(), st.G,
                    st.W, stream)
            if rc:
                raise RuntimeError(f"{self.name} launch failed: cuda "
                                   f"error {rc}")
            with self._count_lock:
                self.launches += 1
        return out


acceptor = WaveKernel("acceptor_wave", "gp_acceptor_wave", (6, 5), (4, 4))
coordinator = WaveKernel("coordinator_wave", "gp_coordinator_wave", (5, 6),
                         (9, 9))
KERNELS = (acceptor, coordinator)
