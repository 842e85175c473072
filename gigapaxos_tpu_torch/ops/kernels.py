"""Batched columnar paxos kernels, as torch tensor ops.

Port of ``gigapaxos_tpu/ops/kernels.py``.  Each kernel is a plain
function ``(state, batch tensors...) -> (state, outs)`` over the whole
fleet's :class:`~gigapaxos_tpu_torch.ops.types.ColumnarState`.  Where
the JAX package donates the state buffers and gets new arrays back,
these functions write the state tensors IN PLACE and return the same
state object, so the compositions (fused waves, the storm step) read
exactly like the reference.

A *batch* is a struct-of-arrays of B packet lanes (int32, bool
``valid``); lanes with ``valid=False`` are padding and must not mutate
state.  Reference analogs, the determinism note (a batch is ONE
linearization: per-group ballot promises take the max over the batch)
and the intra-batch preconditions (at most one accept lane per
(group, slot), at most one accept-reply lane per (group, slot, sender)
per batch) are those of the JAX module.

How the XLA idioms map to torch, exactly:

- ``.at[].max/.add(..., mode="drop")``: dead lanes are sent to row 0
  with the reduction's identity (``INT32_MIN`` for max, 0 for add), so
  no host sync is needed and the result is exact.
- ``.at[].set(..., mode="drop")`` with a per-lane value: a boolean-mask
  ``index_put_`` over the live lanes (one host sync on CUDA).  Sending
  dead lanes to row 0 would race a live lane writing that row.
- ``.at[].set(True/False)`` on the bool planes: a max/min scatter on
  the ``uint8`` view, where the untouched value is the identity — exact,
  and no sync.
- ``jnp.lexsort((key2, key1))``: a stable sort on ``key2`` and then a
  stable sort on ``key1`` (``key1`` is the primary key).
- ``jax.lax.population_count``: a SWAR popcount in int32 (CPU torch has
  no ``bitwise_count``).
- ``jax.lax.cond(pre.any(), ...)`` in the reply's resign step: a masked
  scatter with no branch (a branch on a CUDA tensor forces a sync).

The accept, commit, propose and accept-reply transitions are not
written here: :func:`accept_batch` dispatches to
:mod:`gigapaxos_tpu_torch.ops.accept_cuda`, :func:`commit_batch` (the
decide storm's commits) to :mod:`gigapaxos_tpu_torch.ops.commit_cuda`,
:func:`propose_batch` and :func:`propose_packed` (the storm's and the
SPI's plain proposes) to :mod:`gigapaxos_tpu_torch.ops.propose_cuda`
and :func:`accept_reply_batch` and :func:`accept_reply_packed` (the
storm's and the SPI's plain accept-replies) to
:mod:`gigapaxos_tpu_torch.ops.accept_reply_cuda`, each a hand-written
Hopper kernel on a CUDA device (one cooperative launch a call) and its
plain torch version on the CPU.  The runtime's
fused waves (``accept_commit_p``, ``commit_p``,
``propose_accept_self_p``, ``accept_reply_commit_self_p`` and
``request_reply_p``) dispatch the same way, to the two kernels of
:mod:`gigapaxos_tpu_torch.ops.wave_cuda` on a CUDA device (one launch a
call) and to the torch bodies below on the CPU (:func:`acceptor_wave`,
:func:`coordinator_wave`).  Those bodies are pure torch on any device
(their propose, accept, accept-reply and commit steps are
``propose_reference``, ``accept_reference``, ``accept_reply_reference``
and ``commit_reference``), so they are also the kernels' yardstick on
the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gigapaxos_tpu_torch.ops import (accept_cuda, accept_reply_cuda,
                                     commit_cuda, propose_cuda, wave_cuda)
from gigapaxos_tpu_torch.ops.types import (ACC_BAL, ACC_RHI, ACC_RLO,
                                           ACC_SLOT, FIELDS, NO_BALLOT,
                                           NO_SLOT, ColumnarState)

i32 = torch.int32
INT32_MIN = accept_cuda.INT32_MIN


def _gi(g, valid):
    """Gather index (int64): row 0 for invalid lanes (result unused)."""
    return torch.where(valid, g, 0).long()


def _scatter_max_(dst, gi, vals, live):
    """``dst.at[g].max(vals)`` over live lanes."""
    dst.scatter_reduce_(0, gi, torch.where(live, vals, INT32_MIN),
                        reduce="amax")


def _flag_(flags, gi, live, value: bool):
    """``flags.at[g].set(value)`` over live lanes, as a max (True) or
    min (False) scatter on the uint8 view: lanes outside ``live`` carry
    the identity, so aliasing them onto a live row is harmless."""
    u8 = flags.view(torch.uint8)
    if value:
        u8.scatter_reduce_(0, gi, live.to(torch.uint8), reduce="amax")
    else:
        u8.scatter_reduce_(0, gi, (~live).to(torch.uint8), reduce="amin")


def _set_rows_(dst, gi, vals, live):
    """``dst.at[g].set(vals)`` over live lanes (boolean-mask put)."""
    dst[gi[live]] = vals[live]


def _set_cols_(plane, gi, w, vals, live):
    """``plane.at[g, w].set(vals)`` over live lanes (boolean-mask put);
    ``vals`` is ``[..., k]`` for a ``[G, W, k]`` plane."""
    plane[gi[live], w[live].long()] = vals[live]


# --------------------------------------------------------------------------
# accept (acceptor side)                                  ref: PaxosAcceptor
# --------------------------------------------------------------------------


class AcceptOut(NamedTuple):
    acked: torch.Tensor       # bool[B] pvalue stored (or stale-decided)
    stale: torch.Tensor       # bool[B] slot < exec_cursor (already decided)
    out_window: torch.Tensor  # bool[B] beyond window: host must requeue
    cur_bal: torch.Tensor     # i32[B]  promised ballot after this batch


def accept_batch(state: ColumnarState, g, slot, bal, rlo, rhi, valid):
    """Through the accept kernel (``accept_cuda.accept``)."""
    out = accept_cuda.accept(state, g, slot, bal, rlo, rhi, valid)
    return state, AcceptOut(out[0] != 0, out[1] != 0, out[2] != 0, out[3])


# --------------------------------------------------------------------------
# accept-reply (coordinator side)            ref: PaxosCoordinator majority
# --------------------------------------------------------------------------


class AcceptReplyOut(NamedTuple):
    newly_decided: torch.Tensor  # bool[B] quorum crossed: emit a commit
    preempted: torch.Tensor      # bool[B] coordinator resigned
    dec_slot: torch.Tensor       # i32[B]  slot of the decision
    dec_bal: torch.Tensor        # i32[B]  coordinator ballot
    req_lo: torch.Tensor         # i32[B]  request id of the decided pvalue
    req_hi: torch.Tensor


def _reply_out(out) -> AcceptReplyOut:
    """The accept-reply's packed ``out[6, B]`` as named lanes."""
    return AcceptReplyOut(out[0] != 0, out[1] != 0, out[5], out[2], out[3],
                          out[4])


def accept_reply_batch(state: ColumnarState, g, slot, bal, sender, acked,
                       valid):
    """Through the accept-reply kernel (``accept_reply_cuda.accept_reply``):
    ``bal`` is the accepted ballot on ack lanes and the acceptor's
    (higher) promise on nack lanes."""
    return state, _reply_out(accept_reply_cuda.accept_reply(
        state, g, slot, bal, sender, acked, valid))


# --------------------------------------------------------------------------
# propose (coordinator slot assignment)         ref: PaxosCoordinator.propose
# --------------------------------------------------------------------------


class ProposeOut(NamedTuple):
    granted: torch.Tensor    # bool[B] slot assigned; emit AcceptPackets
    rejected: torch.Tensor   # bool[B] not coordinator here (host forwards)
    throttled: torch.Tensor  # bool[B] window full: host requeues
    slot: torch.Tensor       # i32[B]  assigned slot
    cbal: torch.Tensor       # i32[B]  coordinator ballot for the accept


def propose_batch(state: ColumnarState, g, rlo, rhi, valid):
    """Through the propose kernel (``propose_cuda.propose``)."""
    out = propose_cuda.propose(state, g, rlo, rhi, valid)
    return state, ProposeOut(out[0] != 0, out[1] != 0, out[2] != 0, out[3],
                             out[4])


# --------------------------------------------------------------------------
# commit / decision                        ref: decision handling + window GC
# --------------------------------------------------------------------------


class CommitOut(NamedTuple):
    applied: torch.Tensor     # bool[B] decision recorded
    stale: torch.Tensor       # bool[B] already below exec_cursor
    out_window: torch.Tensor  # bool[B] host must requeue
    new_cursor: torch.Tensor  # i32[B]  group frontier after this batch


def commit_batch(state: ColumnarState, g, slot, rlo, rhi, valid):
    """Through the commit kernel (``commit_cuda.commit``)."""
    out = commit_cuda.commit(state, g, slot, rlo, rhi, valid)
    return state, CommitOut(out[0] != 0, out[1] != 0, out[2] != 0, out[3])


# --------------------------------------------------------------------------
# prepare (acceptor side)                    ref: PaxosAcceptor.handlePrepare
# --------------------------------------------------------------------------


class PrepareOut(NamedTuple):
    acked: torch.Tensor        # bool[B]
    cur_bal: torch.Tensor      # i32[B] promise after batch
    exec_cursor: torch.Tensor  # i32[B]
    win_slot: torch.Tensor     # i32[B,W] accepted-pvalue window
    win_bal: torch.Tensor      # i32[B,W]
    win_req_lo: torch.Tensor   # i32[B,W]
    win_req_hi: torch.Tensor   # i32[B,W]


def prepare_batch(state: ColumnarState, g, bal, valid):
    """Phase-1 prepare: promise update + dense gather of the accepted
    window."""
    gi = _gi(g, valid)
    live = valid & state.active[gi]
    _scatter_max_(state.bal, gi, bal, live)
    cur_bal = state.bal[gi]
    accr = state.acc[gi]  # [B, W, 4]
    out = PrepareOut(
        acked=live & (bal >= cur_bal),
        cur_bal=cur_bal,
        exec_cursor=state.exec_cursor[gi],
        win_slot=accr[..., ACC_SLOT],
        win_bal=accr[..., ACC_BAL],
        win_req_lo=accr[..., ACC_RLO],
        win_req_hi=accr[..., ACC_RHI],
    )
    return state, out


# --------------------------------------------------------------------------
# coordinator install (phase-1 completion + carryover)
# --------------------------------------------------------------------------


def install_coordinator_batch(state: ColumnarState, g, cbal, next_slot,
                              carry_slot, carry_rlo, carry_rhi, valid):
    """Install this node as active coordinator for groups ``g`` at ballot
    ``cbal``; ``carry_*`` are ``[B, W]`` carryover pvalues (columns with
    ``carry_slot == -1`` are empty)."""
    W = state.W
    gi = _gi(g, valid)
    _flag_(state.is_coord, gi, valid, True)
    _flag_(state.coord_active, gi, valid, True)
    _set_rows_(state.cbal, gi, cbal, valid)
    _set_rows_(state.next_slot, gi, next_slot, valid)

    has = valid[:, None] & (carry_slot >= 0)
    w = torch.where(has, carry_slot % W, 0)
    _set_cols_(state.prop, gi[:, None].expand_as(carry_slot), w,
               torch.stack([carry_slot, carry_rlo, carry_rhi,
                            torch.zeros_like(carry_slot)], dim=-1), has)
    return state, None


# --------------------------------------------------------------------------
# group lifecycle                     ref: PaxosManager.createPaxosInstance
# --------------------------------------------------------------------------


def create_groups_batch(state: ColumnarState, rows, members, version,
                        init_bal, self_coord, valid):
    """(Re)initialize rows for newly created groups (see the JAX
    docstring: every replica starts promised to ``init_bal``)."""
    r = rows[valid].long()
    sc = self_coord[valid]
    ib = init_bal[valid]
    dev = rows.device

    def cols(v):
        return torch.tensor(v, dtype=i32, device=dev)

    state.active[r] = True
    state.members[r] = members[valid].to(i32)
    state.version[r] = version[valid].to(i32)
    state.bal[r] = ib
    state.acc[r] = cols([NO_SLOT, NO_BALLOT, 0, 0])
    state.dec[r] = cols([NO_SLOT, 0, 0])
    state.exec_cursor[r] = 0
    state.gc_slot[r] = NO_SLOT
    state.is_coord[r] = sc
    state.coord_active[r] = sc
    state.cbal[r] = torch.where(sc, ib, NO_BALLOT)
    state.next_slot[r] = 0
    state.prep_votes[r] = 0
    state.prop[r] = cols([NO_SLOT, 0, 0, 0])
    return state, None


def delete_groups_batch(state: ColumnarState, rows, valid):
    r = rows[valid].long()
    state.active[r] = False
    state.is_coord[r] = False
    state.coord_active[r] = False
    return state, None


def set_cursor_batch(state: ColumnarState, rows, cursor, next_slot, valid):
    """Restore execution frontier on recovery/unpause."""
    gi = _gi(rows, valid)
    _set_rows_(state.exec_cursor, gi, cursor, valid)
    _scatter_max_(state.next_slot, gi, next_slot, valid)
    return state, None


def gc_batch(state: ColumnarState, rows, upto, valid):
    """Record checkpoint slot (log below it is GC-eligible host-side)."""
    _scatter_max_(state.gc_slot, _gi(rows, valid), upto, valid)
    return state, None


# --------------------------------------------------------------------------
# row export/import (pause/unpause, debugging)
# --------------------------------------------------------------------------


def gather_rows(state: ColumnarState, rows) -> ColumnarState:
    """Full per-row state for ``rows`` as a state of [B, ...] tensors."""
    r = rows.long()
    return ColumnarState(**{f: t[r] for f, t in state.items()})


def scatter_rows(state: ColumnarState, rows, row_state: ColumnarState,
                 valid):
    """Write previously gathered rows back (unpause)."""
    r = rows[valid].long()
    for f in FIELDS:
        getattr(state, f)[r] = getattr(row_state, f)[valid]
    return state, None


# --------------------------------------------------------------------------
# packed wrappers: ONE [k, B] i32 input and ONE [k, B] i32 output per call
# (the layouts of the JAX module's packed entry points, row for row)
# --------------------------------------------------------------------------


def _i(b):
    return b.to(i32)


def propose_packed(state: ColumnarState, packed):
    """packed[4, B]: g, rlo, rhi, valid -> out[5, B]: granted, rejected,
    throttled, slot, cbal (the propose kernel's own output)."""
    return state, propose_cuda.propose(state, packed[0], packed[1],
                                       packed[2], packed[3] != 0)


def accept_packed(state: ColumnarState, packed):
    """packed[6, B]: g, slot, bal, rlo, rhi, valid -> out[4, B]: acked,
    stale, out_window, cur_bal (the accept kernel's own output)."""
    return state, accept_cuda.accept(state, packed[0], packed[1],
                                     packed[2], packed[3], packed[4],
                                     packed[5] != 0)


def accept_reply_packed(state: ColumnarState, packed):
    """packed[6, B]: g, slot, bal, sender, acked, valid -> out[6, B]:
    newly_decided, preempted, dec_bal, req_lo, req_hi, dec_slot (the
    accept-reply kernel's own output)."""
    return state, accept_reply_cuda.accept_reply(
        state, packed[0], packed[1], packed[2], packed[3], packed[4],
        packed[5])


def propose_accept_self_packed(state: ColumnarState, packed):
    """packed[5, B]: g, rlo, rhi, self_member_idx, valid -> out[9, B]:
    granted, rejected, throttled, slot, cbal, self_acked,
    newly_decided, preempted, acc_cur_bal.  Propose + this node's own
    accept + its own vote, in that order."""
    g, rlo, rhi, smidx = packed[0], packed[1], packed[2], packed[3]
    valid = packed[4] != 0
    po = propose_cuda.propose_reference(state, g, rlo, rhi, valid)
    po = ProposeOut(po[0] != 0, po[1] != 0, po[2] != 0, po[3], po[4])
    gr = valid & po.granted
    ao = accept_cuda.accept_reference(state, g, po.slot, po.cbal, rlo, rhi,
                                      gr)
    acked, cur_bal = ao[0] != 0, ao[3]
    reply_bal = torch.where(acked, po.cbal, cur_bal)
    ro = _reply_out(accept_reply_cuda.accept_reply_reference(
        state, g, po.slot, reply_bal, smidx, acked, gr))
    return state, torch.stack([
        _i(po.granted), _i(po.rejected), _i(po.throttled), po.slot,
        po.cbal, _i(gr & acked), _i(ro.newly_decided),
        _i(ro.preempted), cur_bal])


def accept_reply_commit_self_packed(state: ColumnarState, packed):
    """packed[6, B]: g, slot, bal, sender_midx, acked, valid ->
    out[9, B]: newly_decided, preempted, dec_bal, req_lo, req_hi,
    dec_slot, applied, stale, new_cursor.  Vote, then own commit."""
    g = packed[0]
    ro = _reply_out(accept_reply_cuda.accept_reply_reference(
        state, g, packed[1], packed[2], packed[3], packed[4] != 0,
        packed[5] != 0))
    co = commit_cuda.commit_reference(state, g, ro.dec_slot, ro.req_lo,
                                      ro.req_hi, ro.newly_decided)
    return state, torch.stack([
        _i(ro.newly_decided), _i(ro.preempted), ro.dec_bal, ro.req_lo,
        ro.req_hi, ro.dec_slot, co[0], co[1], co[3]])


def commit_packed(state: ColumnarState, packed):
    """packed[5, B]: g, slot, rlo, rhi, valid -> out[4, B]: applied,
    stale, out_window, new_cursor (the plain version's output: the
    acceptor wave's yardstick launches no kernel)."""
    return state, commit_cuda.commit_reference(
        state, packed[0], packed[1], packed[2], packed[3], packed[4] != 0)


# --------------------------------------------------------------------------
# the runtime's fused waves: ONE [m, B] output per call, the first half's
# rows then the second's; the Hopper kernels of ``wave_cuda`` on a CUDA
# device (one launch), the torch bodies above on the CPU
# --------------------------------------------------------------------------


def acceptor_wave_plain(state: ColumnarState, acc, com) -> torch.Tensor:
    """The acceptor wave's torch bodies (the JAX module's
    ``accept_commit_packed``: accepts, then commits, in the order the
    manager's handlers run them): ``acc[6, B]`` (or None) through the
    accept, then ``com[5, B]`` (or None) through the commit; returns
    their outputs, ``[4|8, B]``."""
    outs = []
    if acc is not None:
        outs.append(accept_cuda.accept_reference(
            state, acc[0], acc[1], acc[2], acc[3], acc[4], acc[5] != 0))
    if com is not None:
        outs.append(commit_packed(state, com)[1])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def coordinator_wave_plain(state: ColumnarState, req, rep) -> torch.Tensor:
    """The coordinator wave's torch bodies (the JAX module's
    ``request_reply_packed``): ``req[5, B]`` (or None) through
    :func:`propose_accept_self_packed`, then ``rep[6, B]`` (or None)
    through :func:`accept_reply_commit_self_packed` (they touch disjoint
    window columns — see the JAX docstring); returns ``[9|18, B]``."""
    outs = []
    if req is not None:
        outs.append(propose_accept_self_packed(state, req)[1])
    if rep is not None:
        outs.append(accept_reply_commit_self_packed(state, rep)[1])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def acceptor_wave(state: ColumnarState, acc, com) -> torch.Tensor:
    """The acceptor wave (:func:`acceptor_wave_plain`): the Hopper kernel
    for a state on a CUDA device — one launch, or it raises — and the
    torch bodies for one on the CPU."""
    if state.acc.device.type == "cpu":
        return acceptor_wave_plain(state, acc, com)
    return wave_cuda.acceptor(state, acc, com)


def coordinator_wave(state: ColumnarState, req, rep) -> torch.Tensor:
    """The coordinator wave (:func:`coordinator_wave_plain`), dispatched
    as :func:`acceptor_wave` is."""
    if state.acc.device.type == "cpu":
        return coordinator_wave_plain(state, req, rep)
    return wave_cuda.coordinator(state, req, rep)


def accept_commit_p(state: ColumnarState, acc, com):
    out = acceptor_wave(state, acc, com)
    return state, out[:4], out[4:]


def commit_p(state: ColumnarState, packed):
    return state, acceptor_wave(state, None, packed)


def propose_accept_self_p(state: ColumnarState, packed):
    return state, coordinator_wave(state, packed, None)


def accept_reply_commit_self_p(state: ColumnarState, packed):
    return state, coordinator_wave(state, None, packed)


def request_reply_p(state: ColumnarState, req, rep):
    out = coordinator_wave(state, req, rep)
    return state, out[:9], out[9:]


# --------------------------------------------------------------------------
# entry points: the JAX package's jit names, as plain functions (torch
# runs eagerly; the state is updated in place instead of donated); the
# fused waves' entry points are defined above
# --------------------------------------------------------------------------

accept = accept_batch
accept_reply = accept_reply_batch
propose = propose_batch
commit = commit_batch
propose_p = propose_packed
accept_p = accept_packed
accept_reply_p = accept_reply_packed
prepare = prepare_batch
install_coordinator = install_coordinator_batch
create_groups = create_groups_batch
delete_groups = delete_groups_batch
set_cursor = set_cursor_batch
gc = gc_batch
