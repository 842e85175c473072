"""Columnar consensus kernels — the CUDA data plane.

Port of ``gigapaxos_tpu.ops``: state for ALL groups lives in ``[G]`` /
``[G, W, k]`` device tensors and each message type is one batched
kernel over a struct-of-arrays packet batch (``kernels``), with the
accept, commit, propose and accept-reply transitions (``accept_cuda``,
``commit_cuda``, ``propose_cuda``, ``accept_reply_cuda``; the last two
share the run rank of ``rank_cuda``) and the runtime's two fused waves
(``wave_cuda``) as hand-written Hopper kernels.
"""

from gigapaxos_tpu_torch.ops.types import (
    ColumnarState,
    make_state,
    pack_ballot,
    unpack_ballot,
    NODE_BITS,
    NO_BALLOT,
)
from gigapaxos_tpu_torch.ops import kernels

__all__ = [
    "ColumnarState",
    "make_state",
    "pack_ballot",
    "unpack_ballot",
    "NODE_BITS",
    "NO_BALLOT",
    "kernels",
]
