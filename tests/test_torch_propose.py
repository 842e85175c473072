"""The port's propose transition (its plain torch version, which the CPU
runs; the card runs ``csrc/propose.cu``, which ``chip_smoke.py`` holds
against this plain version) against the JAX package's ``propose_batch``
(the XLA body, jit ``propose``) and ``propose_packed`` (jit
``propose_p``).  Integer state: the tolerance is exact equality on every
state plane and on all five output rows of every lane, padding lanes
included (both read row 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.types import ColumnarState as JaxState
from gigapaxos_tpu.ops.types import make_state as jax_make_state
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops import propose_cuda
from gigapaxos_tpu_torch.ops.types import state_from_numpy, state_to_numpy

G, W, B = 64, 8, 64
INT32_MAX = (1 << 31) - 1


def _wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _host(rng, cursors, n_active=56, coord_share=0.75, active_share=0.8):
    """A state in the JAX layout: ``n_active`` created rows, a share of
    them coordinators and a share of those with phase 1 complete, the
    given cursors, ``next_slot`` in ``[cursor, cursor + W]`` (as the
    runtime keeps it: at most one lane writes a column per batch),
    random ballots and a filled proposal plane."""
    st = jax_make_state(G, W)
    st, _ = jk.create_groups(
        st, jnp.arange(n_active, dtype=jnp.int32),
        jnp.full(n_active, 3, jnp.int32), jnp.zeros(n_active, jnp.int32),
        jnp.zeros(n_active, jnp.int32), jnp.zeros(n_active, bool),
        jnp.ones(n_active, bool))
    host = {f: np.array(getattr(st, f)) for f in st._fields}
    cur = np.asarray(cursors, np.int64)
    host["exec_cursor"][:] = _wrap(cur)
    host["next_slot"][:] = _wrap(cur + rng.integers(0, W + 1, G))
    host["is_coord"][:] = rng.random(G) < coord_share
    host["coord_active"][:] = host["is_coord"] & (rng.random(G) <
                                                  active_share)
    host["cbal"][:] = rng.integers(0, 1 << 20, G)
    host["prop"][:] = rng.integers(-(1 << 31), 1 << 31, (G, W, 4))
    return host


def _pair(host):
    """The same state in both packages."""
    return (JaxState(**{f: jnp.asarray(v) for f, v in host.items()}),
            state_from_numpy(host, device="cpu"))


def _pad(g, rlo, rhi, valid):
    """Live lanes padded to B as the backend pads a wave: row 0, request
    id 0, invalid."""
    pad = B - len(g)
    return (np.concatenate([g, np.zeros(pad, np.int32)]).astype(np.int32),
            np.concatenate([rlo, np.zeros(pad, np.int32)]).astype(np.int32),
            np.concatenate([rhi, np.zeros(pad, np.int32)]).astype(np.int32),
            np.concatenate([valid, np.zeros(pad, bool)]))


def _lanes(rng, n, rows, valid_share=0.85):
    """``n`` lanes on ``rows`` (repeated, in random order), random
    request ids, a share valid, then padding."""
    g = rng.choice(rows, n).astype(np.int32)
    rlo, rhi = (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
                for _ in range(2))
    return _pad(g, rlo, rhi, rng.random(n) < valid_share)


def _run(st_x, st_t, lanes, packed, msg):
    """One propose batch through both packages, unpacked (``propose``)
    or packed (``propose_p``); every output row of every lane and every
    state plane must be equal.  Returns the JAX state and the port's
    output."""
    if packed:
        p = np.stack([lanes[0], lanes[1], lanes[2],
                      lanes[3].astype(np.int32)])
        _, out = tk.propose_packed(st_t, torch.from_numpy(p))
        st_x, ref = jk.propose_p(st_x, jnp.asarray(p))
        ref = np.asarray(ref)
    else:
        _, o = tk.propose_batch(st_t, *(torch.from_numpy(a) for a in lanes))
        out = torch.stack([o.granted.int(), o.rejected.int(),
                           o.throttled.int(), o.slot, o.cbal])
        st_x, r = jk.propose(st_x, *(jnp.asarray(a) for a in lanes))
        ref = np.stack([np.asarray(r.granted).astype(np.int32),
                        np.asarray(r.rejected).astype(np.int32),
                        np.asarray(r.throttled).astype(np.int32),
                        np.asarray(r.slot), np.asarray(r.cbal)])
    out = out.numpy()
    np.testing.assert_array_equal(out, ref, err_msg=msg)
    port = state_to_numpy(st_t)
    for f in st_x._fields:
        np.testing.assert_array_equal(port[f], np.asarray(getattr(st_x, f)),
                                      err_msg=f"{msg}: state.{f}")
    return st_x, out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propose_matches_jax(seed, packed):
    """Three batches: lanes repeated on rows (ranks above 0, earlier
    batches' grants moving next_slot), inactive rows (56 of 64 active),
    non-coordinator and phase-1-pending rows (rejected), invalid and
    padding lanes."""
    rng = np.random.default_rng(seed)
    host = _host(rng, rng.integers(0, 1000, G))
    st_x, st_t = _pair(host)
    for round_ in range(3):
        lanes = _lanes(rng, 48, rng.choice(G, 20))
        st_x, out = _run(st_x, st_t, lanes, packed,
                         f"seed {seed} round {round_}")
        assert out[0].any() and out[1].any()
    assert propose_cuda.propose.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("packed", [False, True])
def test_propose_ranks_past_the_window_throttle(packed):
    """40 lanes on one coordinator row with next_slot at its cursor,
    interleaved with lanes on other rows: the first W are granted on
    consecutive slots in lane order, the rest throttled with slots
    running on past the window."""
    rng = np.random.default_rng(3)
    host = _host(rng, np.full(G, 100))
    r = 5
    host["active"][r] = host["is_coord"][r] = host["coord_active"][r] = True
    host["next_slot"][r] = 100
    st_x, st_t = _pair(host)
    n = 56
    g = rng.choice(np.arange(6, 40), n).astype(np.int32)
    on_r = np.sort(rng.choice(n, 40, replace=False))
    g[on_r] = r
    lanes = _pad(g, np.arange(n, dtype=np.int32), -np.arange(n, dtype=np.int32),
                 np.ones(n, bool))
    _, out = _run(st_x, st_t, lanes, packed, "one row past the window")
    assert list(out[3][on_r]) == list(range(100, 140))
    assert list(out[0][on_r]) == [1] * W + [0] * (40 - W)
    assert list(out[2][on_r]) == [0] * W + [1] * (40 - W)
    assert int(st_t.next_slot[r]) == 100 + W


@pytest.mark.parametrize("packed", [False, True])
def test_propose_rejects_and_padding(packed):
    """Inactive rows propose nothing and reject nothing; rows that are
    not coordinators, or whose phase 1 is pending, reject; invalid lanes
    on any row and padding lanes read row 0's pre-batch next_slot and
    cbal even where row 0 grants lanes."""
    rng = np.random.default_rng(6)
    host = _host(rng, rng.integers(0, 50, G), n_active=32)
    host["is_coord"][10:16] = False
    host["coord_active"][10:16] = False
    host["is_coord"][16:20] = True
    host["coord_active"][16:20] = False
    host["is_coord"][0] = host["coord_active"][0] = True
    host["next_slot"][0] = host["exec_cursor"][0]
    st_x, st_t = _pair(host)
    ns0, cb0 = int(host["next_slot"][0]), int(host["cbal"][0])
    g = np.concatenate([np.arange(40, 46), np.arange(10, 20), [0, 0, 0]])
    n = len(g)
    lanes = _pad(g.astype(np.int32), rng.integers(0, 99, n).astype(np.int32),
                 rng.integers(0, 99, n).astype(np.int32), np.ones(n, bool))
    lanes = (np.concatenate([lanes[0][:n],
                             rng.integers(0, G, B - n)]).astype(np.int32),
             *lanes[1:])
    _, out = _run(st_x, st_t, lanes, packed, "rejects and padding")
    assert not out[:3, :6].any()  # inactive rows
    assert out[1, 6:n - 3].all() and not out[0, 6:n - 3].any()
    assert list(out[0, n - 3:n]) == [1, 1, 1]
    assert list(out[3, n - 3:n]) == [ns0, ns0 + 1, ns0 + 2]
    assert not out[:3, n:].any()
    assert (out[3, n:] == ns0).all() and (out[4, n:] == cb0).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_propose_slots_near_int32_max(seed, packed):
    """Cursors in [INT32_MAX - 2W, INT32_MAX] and next_slot up to W
    beyond: slots, the window's end and the next_slot adds wrap as
    int32.  At most W lanes a row, so no two granted lanes of a batch
    share a column."""
    rng = np.random.default_rng(10 + seed)
    host = _host(rng, INT32_MAX - rng.integers(0, 2 * W + 1, G),
                 coord_share=1.0, active_share=1.0)
    st_x, st_t = _pair(host)
    granted = 0
    for round_ in range(2):
        g = np.repeat(rng.choice(G, 8, replace=False), W)[:B]
        rng.shuffle(g)
        lanes = _pad(g.astype(np.int32),
                     rng.integers(0, 99, B).astype(np.int32),
                     rng.integers(0, 99, B).astype(np.int32), np.ones(B, bool))
        st_x, out = _run(st_x, st_t, lanes, packed,
                         f"near INT32_MAX, round {round_}")
        granted += int(out[0].sum())
    after = state_to_numpy(st_t)["next_slot"]
    assert granted and (after < 0).any()  # some next_slot wrapped


def test_propose_zero_lanes():
    _, st_t = _pair(_host(np.random.default_rng(0), np.zeros(G)))
    before = state_to_numpy(st_t)
    e = torch.zeros(0, dtype=torch.int32)
    out = propose_cuda.propose(st_t, e, e, e, torch.zeros(0, dtype=torch.bool))
    assert tuple(out.shape) == (5, 0)
    after = state_to_numpy(st_t)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f])


@pytest.mark.parametrize("limit", [1, 7, 1056])
@pytest.mark.parametrize("B_", [0, 1, 8, 4096, 4099, 1 << 18, 1 << 21])
def test_propose_grid_plan_covers_every_lane_once(B_, limit):
    """The cooperative launch's grid never exceeds the co-resident limit
    and launches nothing for no lanes; block b's walk over tiles b,
    b + blocks, ... (THREADS lanes a tile, below B) then visits every
    lane exactly once."""
    blocks = propose_cuda.grid_plan(B_, limit)
    T = propose_cuda.THREADS
    assert 0 <= blocks <= limit
    assert (blocks == 0) == (B_ == 0)
    if not B_:
        return
    tiles = -(-B_ // T)
    assert blocks == min(tiles, limit)  # every block has a tile
    b = np.arange(blocks, dtype=np.int64)
    rounds = -(-tiles // blocks)
    tile = (b[None, :] + blocks * np.arange(rounds)[:, None]).ravel()
    tile = tile[tile < tiles]
    lanes = (tile[:, None] * T + np.arange(T)[None, :]).ravel()
    lanes = lanes[lanes < B_]
    assert len(lanes) == B_ and len(np.unique(lanes)) == B_


def test_propose_batch_launches_yardsticks_do_not(monkeypatch):
    """``kernels.propose_batch`` (the storm's propose) and
    ``kernels.propose_packed`` (the SPI's ``propose_p``) go through the
    propose wrapper; the coordinator wave's torch yardstick
    (``propose_accept_self_packed`` under ``coordinator_wave_plain``)
    runs the plain version and never reaches the wrapper."""
    rng = np.random.default_rng(8)
    _, st_t = _pair(_host(rng, rng.integers(0, 100, G)))
    lanes = tuple(torch.from_numpy(a) for a in
                  _lanes(rng, 40, rng.choice(G, 12)))
    calls = []

    def wrapper(*args):
        calls.append(args)
        return propose_cuda.propose_reference(*args)

    monkeypatch.setattr(propose_cuda, "propose", wrapper)
    _, o = tk.propose_batch(st_t, *lanes)
    assert len(calls) == 1 and o.granted.dtype == torch.bool
    packed = torch.stack([lanes[0], lanes[1], lanes[2],
                          lanes[3].to(torch.int32)])
    tk.propose_packed(st_t, packed)
    assert len(calls) == 2
    req = torch.stack([lanes[0], lanes[1], lanes[2],
                       torch.zeros_like(lanes[0]), lanes[3].to(torch.int32)])
    tk.coordinator_wave_plain(st_t, req, None)
    assert len(calls) == 2


def test_propose_raises_off_cpu_without_fallback():
    """A state on neither the CPU nor a CUDA device: the wrapper raises
    rather than run the plain version."""
    _, st_t = _pair(_host(np.random.default_rng(0), np.zeros(G)))
    meta = dataclasses.replace(st_t, **{f: t.to("meta")
                                        for f, t in st_t.items()})
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        propose_cuda.propose(meta, one, one, one, one.bool())
