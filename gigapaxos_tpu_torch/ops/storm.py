"""Fused decide-storm pipeline: the flagship device step.

Port of ``gigapaxos_tpu/ops/storm.py``.  One call runs the ENTIRE §3.1
hot path for a batch of B requests against an emulated R-replica fleet
living on one device:

    propose (coordinator) → accept ×R → accept_reply ×R (quorum count)
    → commit ×R (window frontier advance)

On a CUDA device the propose, each accept, each accept_reply and each
commit is one cooperative launch of a hand-written Hopper kernel
(``propose_cuda``, ``accept_cuda``, ``accept_reply_cuda``,
``commit_cuda``): 1 + 3R launches a step.  The glue (``full_like``,
the ``|`` of ``newly``, the sum) is torch ops.
The replica states are updated in place (the JAX step donates them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gigapaxos_tpu_torch.ops import kernels
from gigapaxos_tpu_torch.ops.types import ColumnarState, make_state

i32 = torch.int32


def decide_storm_step(states: Tuple[ColumnarState, ...], g, rlo, rhi,
                      valid):
    """Drive B request lanes to decision across R replica states.

    ``states[0]`` is the coordinator replica; all R states act as
    acceptors.  Returns ``(states, decided_count)`` where
    ``decided_count`` (an int32 device scalar) counts lanes whose quorum
    crossed in this step (== #granted lanes in steady state).
    """
    R = len(states)
    s0, pr = kernels.propose_batch(states[0], g, rlo, rhi, valid)
    slot, bal, granted = pr.slot, pr.cbal, pr.granted

    acks = []
    for r in range(R):
        _, ar = kernels.accept_batch(states[r], g, slot, bal, rlo, rhi,
                                     granted)
        acks.append(ar.acked)

    newly = torch.zeros_like(granted)
    for r in range(R):
        sender = torch.full_like(g, r)
        _, rr = kernels.accept_reply_batch(s0, g, slot, bal, sender,
                                           acks[r], granted)
        newly = newly | rr.newly_decided

    for r in range(R):
        kernels.commit_batch(states[r], g, slot, rlo, rhi, newly)

    return states, newly.sum(dtype=i32)



def make_fleet(G: int, W: int, R: int = 3, device="cuda"):
    """R replica states with all G rows active, members=R, node 0 the
    initial coordinator of every group (ballot (0,0))."""
    states = []
    for r in range(R):
        st = make_state(G, W, device)
        dev = st.device
        rows = torch.arange(G, dtype=i32, device=dev)
        kernels.create_groups(
            st, rows, torch.full((G,), R, dtype=i32, device=dev),
            torch.zeros(G, dtype=i32, device=dev),
            torch.zeros(G, dtype=i32, device=dev),  # pack_ballot(0, 0)
            torch.full((G,), r == 0, dtype=torch.bool, device=dev),
            torch.ones(G, dtype=torch.bool, device=dev))
        states.append(st)
    return tuple(states)
