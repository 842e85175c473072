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
the bound and the design.  In short: ONE launch a call, one lane a
thread.  A chunk of at most ``CTA_LANES`` lanes is one CTA of as many
threads as lanes, rounded up to a warp (buckets 8, 64, 512: 32, 64, 512
threads, ``__syncthreads`` between the phases); a larger one is one
thread-block cluster of ``CLUSTER_CTAS`` CTAs (bucket 4096: 8 x 512, the
hardware cluster barrier between the phases) — :func:`geometry`, which
the library's ``gp_wave_geometry`` must match.  The contiguity scan
loads a row's W slot words at once; the run rank counts keys in a
shared-memory hash (``__match_any_sync`` inside a warp, the earlier
CTAs' tables through distributed shared memory) and sorts nothing.  The
bound is bytes — under a megabyte at 4096 lanes, a third of a
microsecond at 3.35 TB/s — and what limits a chunk is the launch and the
chain of dependent round trips across the barriers: 5 round trips and 4
barriers for the acceptor wave, 9 and 10 for the coordinator wave with
both halves.
:meth:`WaveKernel.floor` launches an empty kernel at a chunk's geometry,
the launch alone, beside which ``chip_smoke.py`` prints each time.
``-Xptxas -v`` (sm_90a, CUDA 12.8): the acceptor wave 48 registers in one
CTA and in a cluster, the coordinator wave 48 and 74, no spills, no
static shared memory; the coordinator wave's run-rank tables are
dynamic shared memory, 96 KB a CTA of 512 threads with both halves.

A call takes each half as a packed ``[k+1, B]`` int32 tensor (the
layouts of the JAX module's packed entry points, valid mask last) or
``None``, and returns ONE ``[m, B]`` int32 tensor: the first half's
output rows, then the second's (4 and 4 for the acceptor wave, 9 and 9
for the coordinator wave), row for row the torch bodies' outputs.  The
wrappers launch on the current stream and never synchronize.  They run
only on a CUDA device and raise on anything else: the plain versions
are the torch bodies of :mod:`gigapaxos_tpu_torch.ops.kernels`, which
that module's entry points run for a state on the CPU.  Each launch
adds one to the wrapper's ``launches`` and to its ``by_bucket`` count of
the chunk's lane count (exact when several threads launch).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from gigapaxos_tpu_torch.ops.types import ColumnarState

# launch geometry of csrc/wave.cu (kCtaLanes, kClusterCtas, kMaxLanes)
CTA_LANES, CLUSTER_CTAS, MAX_LANES = 512, 8, 4096
WARP = 32


def geometry(B: int):
    """``(ctas, threads)`` of the launch over a ``B``-lane chunk: one CTA
    of B threads rounded up to a warp, or above ``CTA_LANES`` lanes one
    cluster of ``CLUSTER_CTAS`` CTAs sharing the lanes."""
    if not 0 < B <= MAX_LANES:
        raise ValueError(f"wave kernels: {B} lanes; a chunk holds 1 to "
                         f"{MAX_LANES}")
    ctas = 1 if B <= CTA_LANES else CLUSTER_CTAS
    per = -(-B // ctas)
    return ctas, -(-per // WARP) * WARP


_P = ctypes.c_void_p
_I = ctypes.c_int

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the two wave entry points of a built ``wave.cu`` (their C
    signature is the same in every version of the source)."""
    for fn in (lib.gp_acceptor_wave, lib.gp_coordinator_wave):
        fn.argtypes = [_P, _P, _I, _P, _P, _I] + [_P] * 11 + [_I, _I, _P]
        fn.restype = _I
    return lib


def load() -> ctypes.CDLL:
    """Build (first use) and bind the waves' library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from gigapaxos_tpu_torch.ops import _build
            lib = bind(_build.load("wave"))
            lib.gp_wave_geometry.argtypes = [_I] + [ctypes.POINTER(_I)] * 2
            lib.gp_wave_geometry.restype = _I
            lib.gp_wave_floor.argtypes = [_I, _I, _P]
            lib.gp_wave_floor.restype = _I
            for B in (1, 8, 32, 33, 64, CTA_LANES, CTA_LANES + 1, 4095,
                      MAX_LANES):
                c, t = _I(), _I()
                rc = lib.gp_wave_geometry(B, ctypes.byref(c), ctypes.byref(t))
                if rc or (c.value, t.value) != geometry(B):
                    raise RuntimeError(
                        f"wave kernels: library geometry at {B} lanes "
                        f"{c.value}x{t.value} (rc {rc}) != {geometry(B)}")
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

    def __init__(self, name: str, symbol: str, in_rows, out_rows,
                 tables: int, lib: Optional[ctypes.CDLL] = None):
        self.name = name
        self.kernel_name = f"{name}_kernel"  # as the profiler names it
        self._symbol = symbol
        self.in_rows = in_rows    # packed input rows of each half
        self.out_rows = out_rows  # output rows of each half
        self.tables = tables      # run-rank tables of both halves
        self._lib = lib           # another build of wave.cu (``bind``)
        # CUDA kernel launches (one per call), and by the chunk's lane
        # count; the node runtime launches from several threads, so the
        # counts are bumped under a lock
        self.launches = 0
        self.by_bucket = {}
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
        geometry(B)  # raises outside 1 .. MAX_LANES
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
        fn = getattr(self._lib or load(), self._symbol)
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
                self.by_bucket[B] = self.by_bucket.get(B, 0) + 1
        return out

    def floor(self, B: int) -> None:
        """Launch an empty kernel at this wave's geometry over ``B`` lanes,
        with its shared memory for both halves, on the current stream (the
        launch floor of a chunk; not counted in ``launches``)."""
        geometry(B)
        lib = load()
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gp_wave_floor(B, self.tables, stream)
        if rc:
            raise RuntimeError(f"{self.name} floor launch failed: cuda "
                               f"error {rc}")


acceptor = WaveKernel("acceptor_wave", "gp_acceptor_wave", (6, 5), (4, 4), 0)
coordinator = WaveKernel("coordinator_wave", "gp_coordinator_wave", (5, 6),
                         (9, 9), 3)
KERNELS = (acceptor, coordinator)
