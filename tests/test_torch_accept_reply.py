"""The port's accept-reply transition (its plain torch version, which the
CPU runs; the card runs ``csrc/accept_reply.cu``, which ``chip_smoke.py``
holds against this plain version) against the JAX package's
``accept_reply_batch`` (the XLA body, jit ``accept_reply``) and
``accept_reply_packed`` (jit ``accept_reply_p``).  Integer state: the
tolerance is exact equality on every state plane (``prop``,
``is_coord``, ``coord_active`` among them) and on all six output rows of
every lane, padding lanes included (both read row 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.types import ColumnarState as JaxState
from gigapaxos_tpu.ops.types import make_state as jax_make_state
from gigapaxos_tpu_torch.ops import accept_reply_cuda, rank_cuda
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT, NO_BALLOT, NO_SLOT,
                                           VOTE_MASK, state_from_numpy,
                                           state_to_numpy)

G, W, B = 64, 8, 64
WIDE = 600  # lanes of a wide batch: three of the kernel's 256-lane tiles
SENDERS = 5
INT32_MAX = (1 << 31) - 1


def _wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _host(rng, near_max=False):
    """A state in the JAX layout: every row created, a share of them
    coordinators and a share of those active, members 1, 3 and 5, each
    ``prop`` column holding the slot of its window position (or the one
    a window earlier, or none), partial vote bitmaps, some columns with
    ``EMITTED_BIT`` already set."""
    st = jax_make_state(G, W)
    st, _ = jk.create_groups(
        st, jnp.arange(G, dtype=jnp.int32), jnp.full(G, 3, jnp.int32),
        jnp.zeros(G, jnp.int32), jnp.zeros(G, jnp.int32),
        jnp.zeros(G, bool), jnp.ones(G, bool))
    host = {f: np.array(getattr(st, f)) for f in st._fields}
    host["is_coord"][:] = rng.random(G) < 0.85
    host["coord_active"][:] = host["is_coord"] & (rng.random(G) < 0.85)
    host["cbal"][:] = rng.integers(0, 1 << 20, G)
    host["members"][:] = rng.choice([1, 3, 5], G)
    cur = (INT32_MAX - rng.integers(0, 2 * W + 1, G)) if near_max else \
        rng.integers(0, 1000, G)
    col = np.arange(W)[None, :]
    slot = cur[:, None] + (col - cur[:, None]) % W
    kind = rng.random((G, W))
    slot = np.where(kind < 0.1, slot - W, slot)
    host["prop"][..., 0] = _wrap(np.where(kind > 0.95, NO_SLOT, slot))
    host["prop"][..., 1:3] = rng.integers(-(1 << 31), 1 << 31, (G, W, 2))
    votes = rng.integers(0, 1 << SENDERS, (G, W)) & \
        rng.integers(0, 1 << SENDERS, (G, W))
    host["prop"][..., 3] = np.where(rng.random((G, W)) < 0.15,
                                    votes | EMITTED_BIT, votes)
    return host


def _pair(host):
    """The same state in both packages."""
    return (JaxState(**{f: jnp.asarray(v) for f, v in host.items()}),
            state_from_numpy(host, device="cpu"))


def _lanes(rng, host, n, rows=None, valid_share=0.9, pad_to=None):
    """``n`` lanes with distinct (row, slot, sender) (the kernel's
    precondition): a column's own slot (which may match), the slot a
    window later or earlier (which does not), ballots at, below and
    above ``cbal``, a share of nacks (those above ``cbal`` preempt), a
    share invalid; then padding to ``pad_to`` as the backend pads (row
    0, ``NO_SLOT``, ``NO_BALLOT``, sender 0, nack, invalid)."""
    rows = np.arange(G) if rows is None else np.asarray(rows)
    key = rng.choice(len(rows) * W * 3 * SENDERS, n, replace=False)
    r = rows[key // (W * 3 * SENDERS)]
    c = key // (3 * SENDERS) % W
    variant = key // SENDERS % 3
    slot = _wrap(host["prop"][r, c, 0].astype(np.int64) +
                 np.array([0, W, -W])[variant])
    bal = _wrap(host["cbal"][r].astype(np.int64) +
                rng.choice([0, 0, 0, 0, -1, 1, 3], n))
    lanes = [r.astype(np.int32), slot, bal,
             (key % SENDERS).astype(np.int32), rng.random(n) < 0.85,
             rng.random(n) < valid_share]
    pad = (pad_to or n) - n
    fills = (0, NO_SLOT, NO_BALLOT, 0, False, False)
    return tuple(np.concatenate([a, np.full(pad, f, a.dtype)])
                 for a, f in zip(lanes, fills))


def _run(st_x, st_t, lanes, packed, msg):
    """One accept-reply batch through both packages, unpacked
    (``accept_reply``) or packed (``accept_reply_p``); every output row
    of every lane and every state plane must be equal.  Returns the JAX
    state and the port's output."""
    if packed:
        p = np.stack([*lanes[:4], lanes[4].astype(np.int32),
                      lanes[5].astype(np.int32)])
        _, out = tk.accept_reply_packed(st_t, torch.from_numpy(p))
        st_x, ref = jk.accept_reply_p(st_x, jnp.asarray(p))
        ref = np.asarray(ref)
    else:
        _, o = tk.accept_reply_batch(st_t, *(torch.from_numpy(a)
                                             for a in lanes))
        out = torch.stack([o.newly_decided.int(), o.preempted.int(),
                           o.dec_bal, o.req_lo, o.req_hi, o.dec_slot])
        st_x, r = jk.accept_reply(st_x, *(jnp.asarray(a) for a in lanes))
        ref = np.stack([np.asarray(r.newly_decided).astype(np.int32),
                        np.asarray(r.preempted).astype(np.int32),
                        np.asarray(r.dec_bal), np.asarray(r.req_lo),
                        np.asarray(r.req_hi), np.asarray(r.dec_slot)])
    out = out.numpy()
    np.testing.assert_array_equal(out, ref, err_msg=msg)
    port = state_to_numpy(st_t)
    for f in st_x._fields:
        np.testing.assert_array_equal(port[f], np.asarray(getattr(st_x, f)),
                                      err_msg=f"{msg}: state.{f}")
    return st_x, out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_reply_matches_jax(seed, packed):
    """Three batches on one state: matching and stale votes, columns
    already emitted, members 1, 3 and 5, preempting nacks beside acks of
    their rows, non-coordinator rows and invalid lanes; the later
    batches see the earlier ones' votes and resignations."""
    rng = np.random.default_rng(seed)
    st_x, st_t = _pair(_host(rng))
    decided = preempted = 0
    for round_ in range(3):
        lanes = _lanes(rng, state_to_numpy(st_t), 48, pad_to=B)
        st_x, out = _run(st_x, st_t, lanes, packed,
                         f"seed {seed} round {round_}")
        decided += int(out[0].sum())
        preempted += int(out[1].sum())
    assert decided and preempted
    assert accept_reply_cuda.accept_reply.launches == 0  # CPU: plain


def _split_keys(rng, host, n_keys):
    """``WIDE`` lanes: ``n_keys`` keys (row, slot), each with a first
    lane (in lane order) that does not match (a ballot below ``cbal``),
    then two matching lanes in later tiles of the kernel, on a column
    with one vote before the batch and members 5 (quorum 3, so only the
    last lane's vote crosses it); the other lanes random, on other
    rows.  Returns the lanes and each key's three lane indices."""
    T = rank_cuda.THREADS
    rows = rng.choice(G, n_keys, replace=False)
    c = rng.integers(0, W, n_keys)
    host["members"][rows] = 5
    host["is_coord"][rows] = host["coord_active"][rows] = True
    slot = (1000 + np.arange(n_keys) * W + c).astype(np.int32)
    host["prop"][rows, c, 0] = slot
    host["prop"][rows, c, 3] = 1  # sender 0's vote
    n_other = WIDE - 3 * n_keys
    lanes = [a.copy() for a in _lanes(
        rng, host, n_other, rows=np.setdiff1d(np.arange(G), rows))]
    # three lanes a key, one in each of the three tiles, in order
    at = np.stack([rng.choice(np.arange(t * T, min((t + 1) * T, WIDE)),
                   n_keys, replace=False) for t in range(3)], axis=1)
    free = np.setdiff1d(np.arange(WIDE), at.ravel())
    full = [np.zeros(WIDE, a.dtype) for a in lanes]
    for f in range(6):
        full[f][free] = lanes[f]
    cb = host["cbal"][rows]
    for j in range(3):
        vals = (rows, slot, cb - (j == 0), 1 + j, True, True)
        for f in range(6):
            full[f][at[:, j]] = vals[f]
    return tuple(full), at


@pytest.mark.parametrize("packed", [False, True])
def test_accept_reply_keys_across_tiles(packed):
    """The first matching lane of a key in lane order is the one newly
    decided, though the key's first lane does not match and quorum is
    crossed only by a later lane's vote; the later matching lane is a
    duplicate."""
    rng = np.random.default_rng(4)
    host = _host(rng)
    lanes, at = _split_keys(rng, host, 40)
    st_x, st_t = _pair(host)
    _, out = _run(st_x, st_t, lanes, packed, "keys across tiles")
    assert (out[0][at[:, 1]] == 1).all()
    assert not out[0][at[:, 0]].any() and not out[0][at[:, 2]].any()


def test_accept_reply_emitted_columns_and_nacks():
    """A column with ``EMITTED_BIT`` set before the batch counts the
    votes but decides nothing again; a nack above ``cbal`` clears both
    coordinator flags of its row, while the acks of that row in the same
    batch are still counted against the flags as they stood."""
    rng = np.random.default_rng(5)
    host = _host(rng)
    r0, r1 = 3, 9
    for r in (r0, r1):
        host["is_coord"][r] = host["coord_active"][r] = True
        host["members"][r] = 3
        host["prop"][r, 2] = [50, 7, 8, 0]  # slot 50, column 50 % W
    host["prop"][r0, 2, 3] = EMITTED_BIT
    cb = host["cbal"]
    # r0: two acks (quorum on an emitted column); r1: two acks and a
    # nack above cbal from a third sender
    g = np.array([r0, r0, r1, r1, r1], np.int32)
    lanes = (g, np.full(5, 50, np.int32),
             np.array([cb[r0], cb[r0], cb[r1], cb[r1], cb[r1] + 5],
                      np.int32),
             np.array([0, 1, 0, 1, 2], np.int32),
             np.array([True, True, True, True, False]), np.ones(5, bool))
    st_x, st_t = _pair(host)
    _, out = _run(st_x, st_t, lanes, False, "emitted columns and nacks")
    assert list(out[0]) == [0, 0, 1, 0, 0]
    assert list(out[1]) == [0, 0, 0, 0, 1]
    after = state_to_numpy(st_t)
    assert after["prop"][r0, 2, 3] == EMITTED_BIT | 3
    assert after["prop"][r1, 2, 3] == EMITTED_BIT | 3
    assert not after["is_coord"][r1] and not after["coord_active"][r1]
    assert after["is_coord"][r0] and after["coord_active"][r0]


@pytest.mark.parametrize("packed", [False, True])
def test_accept_reply_padding_lanes_read_row_0(packed):
    """Padding lanes (as the backend pads a wave) change nothing and
    report row 0's column 0 and cbal, and their own ``NO_SLOT``."""
    rng = np.random.default_rng(6)
    host = _host(rng)
    lanes = _lanes(rng, host, 20, valid_share=1.0, pad_to=B)
    st_x, st_t = _pair(host)
    _, out = _run(st_x, st_t, lanes, packed, "padding lanes")
    assert not out[:2, 20:].any()
    assert (out[2, 20:] == host["cbal"][0]).all()
    assert (out[3, 20:] == host["prop"][0, 0, 1]).all()
    assert (out[5, 20:] == NO_SLOT).all()


@pytest.mark.parametrize("packed", [False, True])
def test_accept_reply_slots_near_int32_max(packed):
    """Columns near INT32_MAX: slots past it wrap negative and never
    match (the ``slot >= 0`` guard), those below it decide."""
    rng = np.random.default_rng(7)
    host = _host(rng, near_max=True)
    assert (host["prop"][..., 0] < -1).any()
    st_x, st_t = _pair(host)
    _, out = _run(st_x, st_t, _lanes(rng, host, WIDE, valid_share=1.0),
                  packed, "near INT32_MAX")
    assert out[0].any()


def test_accept_reply_zero_lanes():
    _, st_t = _pair(_host(np.random.default_rng(0)))
    before = state_to_numpy(st_t)
    e = torch.zeros(0, dtype=torch.int32)
    f = torch.zeros(0, dtype=torch.bool)
    out = accept_reply_cuda.accept_reply(st_t, e, e, e, e, f, f)
    assert tuple(out.shape) == (6, 0)
    _, out = tk.accept_reply_packed(st_t, torch.zeros((6, 0), dtype=torch.int32))
    assert tuple(out.shape) == (6, 0)
    after = state_to_numpy(st_t)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


def _run_rank_np(key1, key2):
    """Each lane's count of earlier lanes with the same (key1, key2)."""
    seen, rank = {}, np.zeros(len(key1), np.int64)
    for i, k in enumerate(zip(key1.tolist(), key2.tolist())):
        rank[i] = seen.get(k, 0)
        seen[k] = rank[i] + 1
    return rank


@pytest.mark.parametrize("seed", range(6))
def test_ranking_match_lanes_decides_as_ranking_quorum_lanes(seed):
    """What the wide path rests on: ranking the lanes that match their
    column (before any vote is counted) decides as the plain version's
    rank of the lanes that reached quorum (after).  On random legal
    batches, on few rows so keys repeat, ``newly`` computed the first way
    equals the plain version's."""
    rng = np.random.default_rng(100 + seed)
    host = _host(rng)
    lanes = _lanes(rng, host, 300, rows=rng.choice(G, 6, replace=False))
    g, slot, bal, sender, acked, valid = lanes
    st_t = state_from_numpy(host, device="cpu")
    out = accept_reply_cuda.accept_reply_reference(
        st_t, *(torch.from_numpy(a) for a in lanes)).numpy()
    after = state_to_numpy(st_t)
    gi = np.where(valid, g, 0)
    w = np.where(valid, slot % W, 0)
    col = host["prop"][gi, w]
    match = valid & host["is_coord"][gi] & host["coord_active"][gi] & \
        (bal == host["cbal"][gi]) & acked & (slot >= 0) & \
        (col[:, 0] == slot)
    cnt = np.array([bin(v & VOTE_MASK).count("1")
                    for v in after["prop"][gi, w, 3].tolist()])
    quorum_col = cnt >= host["members"][gi] // 2 + 1
    first = _run_rank_np(np.where(match, g, -1),
                         np.where(match, slot, np.arange(len(g)))) == 0
    newly = match & first & quorum_col & ((col[:, 3] & EMITTED_BIT) == 0)
    np.testing.assert_array_equal(newly, out[0] != 0)
    assert newly.any() and (match & ~first).any()


@pytest.mark.parametrize("seed", range(6))
def test_first_match_of_column_decides_as_ranking_quorum_lanes(seed):
    """The wide path's design: the matching lanes of one column all carry
    the column's slot, so (row, column) is the key.  A candidate
    (matching, on a column not yet emitted) adds its vote and claims the
    column (bit 31 of the vote word); in whatever order they arrive, the
    first claimer of a column no other candidate claims is its lone
    candidate and decides alone, and a contested column's candidates
    decide by the largest tag (epoch << 32 | ~lane, ``atomicMax``) of a
    table holding other epochs' tags before the call.  On random legal
    batches on few rows, ``newly`` and the vote words computed that way
    (bits 30 and 31 cleared, ``EMITTED_BIT`` set where decided) equal the
    plain version's."""
    rng = np.random.default_rng(300 + seed)
    host = _host(rng)
    lanes = _lanes(rng, host, 300, rows=rng.choice(G, 6, replace=False))
    g, slot, bal, sender, acked, valid = lanes
    st_t = state_from_numpy(host, device="cpu")
    out = accept_reply_cuda.accept_reply_reference(
        st_t, *(torch.from_numpy(a) for a in lanes)).numpy()
    after = state_to_numpy(st_t)
    gi = np.where(valid, g, 0)
    w = np.where(valid, slot % W, 0)
    col = host["prop"][gi, w]
    match = valid & host["is_coord"][gi] & host["coord_active"][gi] & \
        (bal == host["cbal"][gi]) & acked & (slot >= 0) & \
        (col[:, 0] == slot)
    key = gi * W + w
    for k in np.unique(key[match]):  # one slot a matching column
        assert len(np.unique(slot[match & (key == k)])) == 1
    cand = match & ((col[:, 3] & EMITTED_BIT) == 0)
    votes = host["prop"][..., 3].astype(np.int64).reshape(-1)
    fresh = match & (((col[:, 3] >> sender) & 1) == 0)
    claimed, contested = set(), set()
    for i in rng.permutation(np.flatnonzero(match)):  # any arrival order
        votes[key[i]] |= int(fresh[i]) << int(sender[i])
        if cand[i]:
            (contested if key[i] in claimed else claimed).add(key[i])
    epoch = int(rng.integers(2, 1 << 31))
    table = rng.integers(0, epoch, G * W).astype(np.uint64) << np.uint64(32)
    tag = (np.uint64(epoch) << np.uint64(32)) | \
        (~np.arange(len(g), dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    for i in np.flatnonzero(cand):
        if key[i] in contested:
            table[key[i]] = max(table[key[i]], tag[i])
    cnt = np.array([bin(int(votes[k]) & VOTE_MASK).count("1") for k in key])
    quorum = cand & (cnt >= host["members"][gi] // 2 + 1)
    lone = np.array([k not in contested for k in key])
    newly = quorum & (lone | (table[key] == tag))
    np.testing.assert_array_equal(newly, out[0] != 0)
    for i in np.flatnonzero(newly):
        votes[key[i]] |= EMITTED_BIT
    np.testing.assert_array_equal(votes, after["prop"][..., 3].reshape(-1))
    assert newly.any() and contested and (newly & ~lone).any()


@pytest.mark.parametrize("B_", [0, 1, 8, 64, 512, 513, 4096, 4097,
                                1 << 18, 1 << 21])
def test_accept_reply_plan_covers_every_lane_once(B_):
    """The path is a function of B alone: none for no lanes, one CTA of
    B threads rounded up to a warp up to 512 lanes, one cluster of 8
    CTAs up to 4096, the cooperative grid above (never past the
    co-resident limit, one round of blocks with no idle one below it);
    the kernels' walk visits every lane exactly once."""
    limit = 1056
    p = accept_reply_cuda.plan(B_, limit)
    want = ("none" if B_ == 0 else "cta" if B_ <= 512 else
            "cluster" if B_ <= accept_reply_cuda.CHUNK_LANES else "grid")
    assert p.path == want
    if p.path in ("cta", "cluster"):
        assert p.blocks == (1 if want == "cta" else 8)
        assert p.threads % 32 == 0 and p.threads <= 512
        assert p.blocks * p.threads - B_ < 32 * p.blocks
    if p.path == "grid":
        per_block = accept_reply_cuda.THREADS * accept_reply_cuda.LANES
        assert 0 < p.blocks <= limit
        if p.blocks < limit:
            assert p.blocks * per_block >= B_ > (p.blocks - 1) * per_block
    visited = accept_reply_cuda.lane_walk(p, B_)
    assert len(visited) == B_ and len(np.unique(visited)) == B_


def test_accept_reply_batch_launches_yardsticks_do_not(monkeypatch):
    """The storm's accept-replies (``kernels.accept_reply_batch``, R a
    step) and the SPI's plain ``accept_reply`` (``accept_reply_p``
    through ``ColumnarBackend.accept_reply_submit``) go through the
    accept-reply wrapper; the coordinator wave's torch yardsticks
    (``propose_accept_self_packed`` and
    ``accept_reply_commit_self_packed`` under ``coordinator_wave_plain``)
    run the plain version and never reach the wrapper."""
    from gigapaxos_tpu_torch.ops.storm import decide_storm_step, make_fleet
    from gigapaxos_tpu_torch.paxos.backend import ColumnarBackend
    calls = []

    def wrapper(*args):
        calls.append(args)
        return accept_reply_cuda.accept_reply_reference(
            args[0], *args[1:5], args[5] != 0, args[6] != 0)

    monkeypatch.setattr(accept_reply_cuda, "accept_reply", wrapper)
    states = make_fleet(G, W, R=3, device="cpu")
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.integers(0, G, 40).astype(np.int32))
    one = torch.ones(40, dtype=torch.int32)
    _, n = decide_storm_step(states, g, one, one, one.bool())
    assert len(calls) == 3 and int(n) > 0
    bk = ColumnarBackend(G, W, device="cpu")
    bk.accept_reply(np.arange(5, dtype=np.int32), np.zeros(5, np.int32),
                    np.zeros(5, np.int32), np.zeros(5, np.int32),
                    np.ones(5, bool))
    assert len(calls) == 4
    host = _host(rng)
    _, st_t = _pair(host)
    req = torch.stack([g, one, one, torch.zeros_like(g), one])
    rep = torch.from_numpy(np.stack([a.astype(np.int32) for a in
                                     _lanes(rng, host, 40)]))
    tk.coordinator_wave_plain(st_t, req, rep)
    assert len(calls) == 4


def test_accept_reply_raises_off_cpu_without_fallback():
    """A state on neither the CPU nor a CUDA device: the wrapper raises
    rather than run the plain version."""
    _, st_t = _pair(_host(np.random.default_rng(0)))
    meta = dataclasses.replace(st_t, **{f: t.to("meta")
                                        for f, t in st_t.items()})
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        accept_reply_cuda.accept_reply(meta, one, one, one, one, one.bool(),
                                       one.bool())
