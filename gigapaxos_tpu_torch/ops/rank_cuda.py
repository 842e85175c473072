"""The run rank of the propose kernel: its plain torch version (which
the accept-reply's plain version uses too), the cooperative grid the
kernel launches, and the device workspace of its lists.

``csrc/rank_dev.cuh`` holds the device code: the rank of a lane among
the earlier lanes of its tile with the same key (a row and a second
word), by warp match and a shared-memory table, and across tiles a list
a row of ``{tile, count, key2}`` entries in a workspace, walked after
the kernel's one grid barrier.  ``csrc/propose.cu`` ranks its lanes by
row.

The workspace (:class:`Workspace`) is one a device, stream and ``G``:
``head[G]`` tags each list with the epoch of the call that wrote it, the
epoch is a device word each call advances, and a walk stops at a link of
another epoch, so no call clears the heads (the call that wraps the
epoch clears them itself).  Calls on one stream run in order, so they
may share it; two streams may run the kernel at once on states of one
size (the engine lanes), so each stream has its own.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

# the tile and block size of the propose kernel (kThreads in its source,
# one lane a thread, one tile a block at a time); the library reports its
# own at load and the wrapper checks they agree
THREADS = 256
# bytes of one list entry of the workspace (rank_dev.cuh RankEntry)
ENTRY_BYTES = 16


def run_rank(key1, key2):
    """Rank of each lane within its equal-(key1, key2) run, in original
    lane order (``kernels.py:_run_rank``: stable lexsort, key1 primary,
    then a run-start cummax)."""
    B = key1.shape[0]
    o2 = torch.sort(key2, stable=True).indices
    o1 = torch.sort(key1[o2], stable=True).indices
    order = o2[o1]
    k1, k2 = key1[order], key2[order]
    iota = torch.arange(B, dtype=torch.int32, device=key1.device)
    start = torch.ones(B, dtype=torch.bool, device=key1.device)
    start[1:] = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
    run_start = torch.cummax(torch.where(start, iota, 0), 0).values
    rank = torch.empty_like(iota)
    rank[order] = iota - run_start
    return rank


def grid_plan(B: int, limit: int) -> int:
    """Blocks of the cooperative launch for ``B`` lanes: one block per
    ``THREADS``-lane tile, at most ``limit`` (the co-resident block count,
    which the grid-wide barrier needs); 0 for no lanes.  Block ``b``
    takes tiles ``b, b + blocks, ...``."""
    if B <= 0:
        return 0
    if limit < 1:
        raise ValueError(f"run rank kernel: co-resident limit {limit} < 1")
    return min(-(-B // THREADS), limit)


@dataclass
class Workspace:
    """The run rank's device workspace for one device, stream and ``G``:
    ``head[G]`` (int64: the list's first entry, tagged with the epoch of
    the call that wrote it; 0 is no call's), ``epoch`` (the last call's,
    kept and advanced by the kernels), and a pool of list entries and
    their earlier-tile sums, indexed by lane (grown to the widest call)."""

    head: torch.Tensor
    epoch: torch.Tensor
    pool: torch.Tensor
    base: torch.Tensor

    def fit(self, B: int) -> None:
        """Grow the lane-indexed pool to hold ``B`` lanes."""
        if self.base.numel() < B:
            dev = self.head.device
            self.pool = torch.empty((B, ENTRY_BYTES // 4), dtype=torch.int32,
                                    device=dev)
            self.base = torch.empty(B, dtype=torch.int32, device=dev)


_workspaces: Dict[Tuple[int, int, int], Workspace] = {}
_ws_lock = threading.Lock()


def workspace(dev: torch.device, G: int) -> Workspace:
    """The workspace of the current stream on ``dev`` for ``G`` rows
    (made zeroed at first use: no head holds a live epoch)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream, G)
    with _ws_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = Workspace(
                head=torch.zeros(G, dtype=torch.int64, device=dev),
                epoch=torch.zeros(1, dtype=torch.int32, device=dev),
                pool=torch.empty((0, ENTRY_BYTES // 4), dtype=torch.int32,
                                 device=dev),
                base=torch.empty(0, dtype=torch.int32, device=dev))
            _workspaces[key] = ws
        return ws
