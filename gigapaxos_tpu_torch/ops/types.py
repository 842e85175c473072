"""Columnar paxos state: one row per group, slot window of width W.

Port of ``gigapaxos_tpu/ops/types.py``: the same constants, the same
field names, shapes, dtypes and layout, as torch tensors.  See the JAX
module for the design notes (packed ballots, the slot window, vote
bitmaps, packed window planes, split request ids); they hold here
unchanged.

Two differences, both at the edges:

- ``ColumnarState`` is a ``@dataclass`` of tensors that the kernels
  update IN PLACE (the JAX package donates the buffers and gets new
  arrays back; here the same buffers are simply written).
- ``prep_votes`` is ``uint32`` in JAX.  torch's ``uint32`` support is
  thin, so the port keeps the same 32 bits as ``int32``;
  :func:`state_from_numpy` / :func:`state_to_numpy` reinterpret them
  (numpy ``.view``) at the boundary, bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

# --- packed ballots ---------------------------------------------------------

NODE_BITS = 12
NODE_MASK = (1 << NODE_BITS) - 1
NO_BALLOT = -1  # sorts below every packed ballot (packed values are >= 0)
NO_SLOT = -1

# --- packed window-plane column indices -------------------------------------

# acc[G, W, 4]: the acceptor's stored pvalue per window column
ACC_SLOT, ACC_BAL, ACC_RLO, ACC_RHI = 0, 1, 2, 3
# dec[G, W, 3]: decided pvalue per window column (decided <=> DEC_SLOT
# column holds the expected slot; NO_SLOT = never)
DEC_SLOT, DEC_RLO, DEC_RHI = 0, 1, 2
# prop[G, W, 4]: the coordinator's proposal per window column; the
# PROP_VOTES word is the sender-vote bitmap (bits 0..29) with bit 30
# recording "decision emitted"
PROP_SLOT, PROP_RLO, PROP_RHI, PROP_VOTES = 0, 1, 2, 3
EMITTED_BIT = 1 << 30
VOTE_MASK = EMITTED_BIT - 1


def pack_ballot(num: int, coord: int):
    """Pack (ballotNumber, coordinatorID) into one comparable int32."""
    return (num << NODE_BITS) | (coord & NODE_MASK)


def unpack_ballot(packed: int) -> Tuple[int, int]:
    if packed < 0:
        return (-1, -1)
    return (packed >> NODE_BITS, packed & NODE_MASK)


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for.  Raises when that is a
    CUDA device and none is present: nothing moves to the CPU on its
    own — a caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


# --- the state --------------------------------------------------------------


@dataclass
class ColumnarState:
    """All-groups paxos state as device tensors.  Shapes: [G] or
    [G, W, k].  The kernels mutate these tensors in place."""

    # -- group table --
    active: torch.Tensor        # bool[G]  row allocated
    members: torch.Tensor       # i32[G]   replica count N (quorum N//2+1)
    version: torch.Tensor       # i32[G]   reconfiguration epoch

    # -- acceptor --
    bal: torch.Tensor           # i32[G]   promised ballot (packed)
    acc: torch.Tensor           # i32[G,W,4] accepted pvalue plane (ACC_*)
    dec: torch.Tensor           # i32[G,W,3] decided pvalue plane (DEC_*)
    exec_cursor: torch.Tensor   # i32[G]   first not-known-decided slot
    gc_slot: torch.Tensor       # i32[G]   checkpointed slot

    # -- coordinator --
    is_coord: torch.Tensor      # bool[G]  this node believes it coordinates
    coord_active: torch.Tensor  # bool[G]  phase-1 complete
    cbal: torch.Tensor          # i32[G]   coordinator ballot (packed)
    next_slot: torch.Tensor     # i32[G]   next slot to assign
    prep_votes: torch.Tensor    # i32[G]   phase-1 bitmap (u32 bits in JAX)
    prop: torch.Tensor          # i32[G,W,4] proposal plane (PROP_*)

    @property
    def G(self) -> int:
        return self.bal.shape[0]

    @property
    def W(self) -> int:
        return self.acc.shape[1]

    @property
    def device(self) -> torch.device:
        return self.bal.device

    def items(self):
        return ((f, getattr(self, f)) for f in FIELDS)


FIELDS = tuple(f.name for f in dataclasses.fields(ColumnarState))
_BOOL_FIELDS = ("active", "is_coord", "coord_active")


def make_state(G: int, W: int, device="cuda") -> ColumnarState:
    """Fresh all-inactive state.  G groups capacity, window width W."""
    dev = resolve_device(device)
    i32 = torch.int32

    def zG():
        return torch.zeros(G, dtype=i32, device=dev)

    def fullG(v):
        return torch.full((G,), v, dtype=i32, device=dev)

    def plane(cols):
        # materialized (not an expanded view): each field owns its buffer
        return torch.tensor(cols, dtype=i32, device=dev).repeat(G, W, 1)

    def zbool():
        return torch.zeros(G, dtype=torch.bool, device=dev)

    return ColumnarState(
        active=zbool(),
        members=zG(),
        version=zG(),
        bal=fullG(NO_BALLOT),
        acc=plane([NO_SLOT, NO_BALLOT, 0, 0]),
        dec=plane([NO_SLOT, 0, 0]),
        exec_cursor=zG(),
        gc_slot=fullG(NO_SLOT),
        is_coord=zbool(),
        coord_active=zbool(),
        cbal=fullG(NO_BALLOT),
        next_slot=zG(),
        prep_votes=zG(),
        prop=plane([NO_SLOT, 0, 0, 0]),
    )


def state_from_numpy(fields: Dict[str, np.ndarray], device="cuda"
                     ) -> ColumnarState:
    """Build the port's state from host arrays laid out as the JAX
    ``ColumnarState`` (``{f: np.asarray(getattr(st, f))}``), bit for
    bit.  ``prep_votes`` may come as ``uint32`` (JAX) or ``int32``."""
    dev = resolve_device(device)
    out = {}
    for f in FIELDS:
        a = np.ascontiguousarray(fields[f])
        if f in _BOOL_FIELDS:
            a = a.astype(np.bool_)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        else:
            a = a.astype(np.int32)
        out[f] = torch.from_numpy(a.copy()).to(dev)
    return ColumnarState(**out)


def state_to_numpy(state: ColumnarState) -> Dict[str, np.ndarray]:
    """Host arrays in the JAX layout and dtypes (``prep_votes`` back to
    ``uint32``), bit for bit."""
    out = {}
    for f, t in state.items():
        a = t.detach().cpu().numpy()
        if f == "prep_votes":
            a = a.view(np.uint32)
        out[f] = a
    return out


def split_req_id(req_id: int) -> Tuple[int, int]:
    """64-bit request id -> (lo32, hi32) as signed int32-safe Python ints."""
    lo = req_id & 0xFFFFFFFF
    hi = (req_id >> 32) & 0xFFFFFFFF
    if lo >= 1 << 31:
        lo -= 1 << 32
    if hi >= 1 << 31:
        hi -= 1 << 32
    return lo, hi


def join_req_id(lo: int, hi: int) -> int:
    return ((int(hi) & 0xFFFFFFFF) << 32) | (int(lo) & 0xFFFFFFFF)


def state_nbytes(G: int, W: int) -> int:
    """Device bytes for a state of this capacity."""
    per_g = 4 * 8 + 3    # 8 i32 [G] fields + 3 bool [G] fields
    per_gw = 4 * (4 + 3 + 4)  # acc[...,4] + dec[...,3] + prop[...,4] i32
    return G * per_g + G * W * per_gw
