"""The port's commit transition (its plain torch version, which the CPU
runs; the card runs ``csrc/commit.cu``, which ``chip_smoke.py`` holds
against this plain version) against the JAX package's ``commit_batch``
(the XLA body, jit ``commit``).  Integer state: the tolerance is exact
equality on every state plane and on every output row of every lane,
padding lanes included (both read row 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.types import ColumnarState as JaxState
from gigapaxos_tpu.ops.types import make_state as jax_make_state
from gigapaxos_tpu_torch.ops import accept_reply_cuda, commit_cuda
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops.types import (NO_SLOT, state_from_numpy,
                                           state_to_numpy)

G, W, B = 64, 8, 48
INT32_MAX = (1 << 31) - 1


def _wrap(a):
    """int64 values as int32 wraps them."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _host(rng, cursors, n_active=56):
    """A state in the JAX layout: ``n_active`` created rows, the given
    cursors, and decided slots ahead of each cursor behind a gap at it
    (the other columns hold the slot a window earlier)."""
    st = jax_make_state(G, W)
    st, _ = jk.create_groups(
        st, jnp.arange(n_active, dtype=jnp.int32),
        jnp.full(n_active, 3, jnp.int32), jnp.zeros(n_active, jnp.int32),
        jnp.zeros(n_active, jnp.int32), jnp.zeros(n_active, bool),
        jnp.ones(n_active, bool))
    host = {f: np.array(getattr(st, f)) for f in st._fields}
    cur = np.asarray(cursors, np.int64)
    host["exec_cursor"][:] = _wrap(cur)
    k = np.arange(W)
    slots = cur[:, None] + k[None, :]
    decided = (rng.random((G, W)) < 0.5) & (k[None, :] >= 1)
    cols = _wrap(slots) % W
    rows = np.repeat(np.arange(G), W)
    dec = host["dec"]
    dec[rows, cols.ravel(), 0] = _wrap(np.where(decided, slots,
                                                slots - W)).ravel()
    dec[rows, cols.ravel(), 1] = rng.integers(-(1 << 31), 1 << 31, G * W)
    dec[rows, cols.ravel(), 2] = rng.integers(-(1 << 31), 1 << 31, G * W)
    return host


def _pair(host):
    """The same state in both packages."""
    return (JaxState(**{f: jnp.asarray(v) for f, v in host.items()}),
            state_from_numpy(host, device="cpu"))


def _lanes(rng, host, n, rows, lo=-3, hi=W + 3, valid_share=0.85):
    """``n`` lanes on distinct (row, slot) pairs of ``rows``, offsets from
    the row's cursor in [lo, hi) (stale, in the window, beyond it), a
    third at offset 0 (each closes its row's gap), in shuffled order;
    then padding to B as the backend pads (row 0, NO_SLOT, invalid)."""
    span = hi - lo
    keys = np.unique(rng.choice(rows, 4 * n).astype(np.int64) * span
                     + np.where(rng.random(4 * n) < 0.3, -lo,
                                rng.integers(0, span, 4 * n)))
    keys = rng.permutation(keys)[:n]
    assert len(keys) == n
    g = (keys // span).astype(np.int32)
    cur = host["exec_cursor"][g].astype(np.int64)
    slot = _wrap(cur + keys % span + lo)
    rlo, rhi = (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
                for _ in range(2))
    valid = rng.random(n) < valid_share
    pad = B - n
    return (np.concatenate([g, np.zeros(pad, np.int32)]),
            np.concatenate([slot, np.full(pad, NO_SLOT, np.int32)]),
            np.concatenate([rlo, np.zeros(pad, np.int32)]),
            np.concatenate([rhi, np.zeros(pad, np.int32)]),
            np.concatenate([valid, np.zeros(pad, bool)]))


def _run(st_x, st_t, lanes, msg):
    """One commit batch through both packages; every output row of every
    lane and every state plane must be equal.  Returns the JAX state and
    the port's output."""
    out = commit_cuda.commit(st_t, *(torch.from_numpy(a) for a in lanes))
    st_x, o = jk.commit(st_x, *(jnp.asarray(a) for a in lanes))
    ref = np.stack([np.asarray(o.applied), np.asarray(o.stale),
                    np.asarray(o.out_window)]).astype(np.int32)
    np.testing.assert_array_equal(out[:3].numpy(), ref, err_msg=msg)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(o.new_cursor),
                                  err_msg=msg)
    port = state_to_numpy(st_t)
    for f in st_x._fields:
        np.testing.assert_array_equal(port[f], np.asarray(getattr(st_x, f)),
                                      err_msg=f"{msg}: state.{f}")
    return st_x, out.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_matches_jax(seed):
    """Three batches on advanced cursors with gaps: several store lanes
    a row closing gaps out of lane order, stale and out-of-window lanes,
    inactive rows (56 of 64 active), invalid and padding lanes."""
    rng = np.random.default_rng(seed)
    host = _host(rng, rng.integers(0, 1000, G))
    st_x, st_t = _pair(host)
    for round_ in range(3):
        lanes = _lanes(rng, state_to_numpy(st_t), 40, rng.choice(G, 12))
        st_x, out = _run(st_x, st_t, lanes, f"seed {seed} round {round_}")
        assert out[0].any() and out[1].any() and out[2].any()
    assert commit_cuda.commit.launches == 0  # CPU: the plain version


def test_commit_closes_gaps_out_of_lane_order():
    """One row at cursor 100 with slots 102 and 104 decided: lanes for
    105, 103, 101 and 100 in that order (and one for 106 on a row of its
    own) advance it to 106; every lane of the row reads 106."""
    rng = np.random.default_rng(3)
    host = _host(rng, np.full(G, 100))
    r, other = 5, 9
    for s in range(100, 100 + W):  # only 102 and 104 decided
        host["dec"][r, s % W, 0] = s if s in (102, 104) else s - W
    st_x, st_t = _pair(host)
    slots = [105, 103, 101, 100, 106]
    n = len(slots)
    lanes = (np.asarray([r] * 4 + [other] + [0] * (B - n), np.int32),
             np.asarray(slots + [NO_SLOT] * (B - n), np.int32),
             np.arange(B, dtype=np.int32), -np.arange(B, dtype=np.int32),
             np.arange(B) < n)
    _, out = _run(st_x, st_t, lanes, "gap closing")
    assert list(out[0][:n]) == [1] * n
    assert list(out[3][:4]) == [106] * 4 and out[3][4] == 100
    assert int(st_t.exec_cursor[r]) == 106


def test_commit_window_wraps_slot_mod_w():
    """The window [2W - 3, 3W - 3) crosses a multiple of W: every slot of
    it stored in one batch, in reverse lane order, advances the row by
    W; slots a window beyond land nowhere (out_window)."""
    rng = np.random.default_rng(4)
    cur = 2 * W - 3
    host = _host(rng, np.full(G, cur))
    st_x, st_t = _pair(host)
    r = 7
    slots = list(range(cur + W - 1, cur - 1, -1)) + [cur + W, cur + 2 * W]
    n = len(slots)
    lanes = (np.full(B, r, np.int32) * (np.arange(B) < n),
             np.asarray(slots + [NO_SLOT] * (B - n), np.int32),
             np.arange(B, dtype=np.int32), np.arange(B, dtype=np.int32),
             np.arange(B) < n)
    _, out = _run(st_x, st_t, lanes, "window wraps")
    assert list(out[0][:n]) == [1] * W + [0, 0]
    assert list(out[2][:n]) == [0] * W + [1, 1]
    assert int(st_t.exec_cursor[r]) == cur + W


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_cursors_near_int32_max(seed):
    """Cursors in [INT32_MAX - 2W, INT32_MAX]: the window's end, the
    slot offsets and the scan's cur + k wrap as int32 (a window that
    wraps stores nothing in either package; one that ends at INT32_MAX
    advances to it)."""
    rng = np.random.default_rng(10 + seed)
    host = _host(rng, INT32_MAX - rng.integers(0, 2 * W + 1, G))
    st_x, st_t = _pair(host)
    applied = 0
    for round_ in range(2):
        lanes = _lanes(rng, state_to_numpy(st_t), 40, rng.choice(G, 10),
                       lo=-2, hi=W + 2)
        st_x, out = _run(st_x, st_t, lanes, f"near INT32_MAX, round "
                         f"{round_}")
        applied += int(out[0].sum())
    after = state_to_numpy(st_t)["exec_cursor"]
    assert applied and (after != host["exec_cursor"]).any()
    assert (after >= 0).all() and (after == INT32_MAX).any()


def test_commit_inactive_rows_and_padding():
    """Lanes on inactive rows decide nothing; invalid lanes on any row
    and padding lanes write nothing and report row 0's new cursor."""
    rng = np.random.default_rng(6)
    host = _host(rng, rng.integers(0, 50, G), n_active=32)
    host["exec_cursor"][0] = 40
    st_x, st_t = _pair(host)
    g = np.concatenate([np.arange(32, 44), np.arange(0, 12)]).astype(
        np.int32)
    cur = host["exec_cursor"][g].astype(np.int64)
    slot = _wrap(cur + rng.integers(-2, W + 2, len(g)))
    lanes = (np.concatenate([g, rng.integers(0, G, B - len(g))]).astype(
                 np.int32),
             np.concatenate([slot, rng.integers(0, 60, B - len(g))]).astype(
                 np.int32),
             rng.integers(0, 99, B).astype(np.int32),
             rng.integers(0, 99, B).astype(np.int32),
             np.arange(B) < len(g))
    _, out = _run(st_x, st_t, lanes, "inactive rows and padding")
    assert not out[:3, :12].any()  # inactive rows
    assert not out[:3, len(g):].any()
    assert (out[3, len(g):] == int(st_t.exec_cursor[0])).all()


def test_commit_zero_lanes():
    _, st_t = _pair(_host(np.random.default_rng(0), np.zeros(G)))
    before = state_to_numpy(st_t)
    e = torch.zeros(0, dtype=torch.int32)
    out = commit_cuda.commit(st_t, e, e, e, e,
                             torch.zeros(0, dtype=torch.bool))
    assert tuple(out.shape) == (4, 0)
    after = state_to_numpy(st_t)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f])


@pytest.mark.parametrize("limit", [1, 7, 1056])
@pytest.mark.parametrize("B_", [0, 1, 8, 64, 512, 513, 4096, 4097, 4099,
                                1 << 18, 1 << 21])
def test_commit_grid_plan_covers_every_lane_once(B_, limit):
    """The cooperative launch's grid never exceeds the co-resident limit
    and launches nothing for no lanes; the kernel's walk (a thread's
    ``LANES`` lanes a round, rounds of the whole grid) then visits every
    lane exactly once."""
    blocks = commit_cuda.grid_plan(B_, limit)
    per_block = commit_cuda.THREADS * commit_cuda.LANES
    assert 0 <= blocks <= limit
    assert (blocks == 0) == (B_ == 0)
    if not B_:
        return
    if blocks < limit:  # one round of the grid, no idle block
        assert blocks * per_block >= B_ > (blocks - 1) * per_block
    visited = accept_reply_cuda.lane_walk(accept_reply_cuda.Plan(
        "grid", blocks, commit_cuda.THREADS, commit_cuda.LANES), B_)
    assert len(visited) == B_ and len(np.unique(visited)) == B_


def _advance(dec, gi, cur):
    """Each lane's contiguity advance from ``cur`` in ``dec`` (the
    kernel's scan: the leading k < W with dec[row, (cur + k) % W].slot ==
    cur + k)."""
    k = np.arange(W)
    want = _wrap(cur[:, None].astype(np.int64) + k[None, :])
    ok = dec[gi[:, None], want % W, 0] == want
    return np.cumprod(ok, axis=1).sum(axis=1)


def _known_cursors(host, lanes, out, after):
    """What each lane knows of its new cursor without reading it after
    the batch: a store lane ``cur + adv`` (its own scan of the
    post-batch ``dec``), any other lane its pre-batch ``cur``.  Returns
    that, the store mask, the rows and the advances."""
    g, _slot, _rlo, _rhi, valid = lanes
    gi = np.where(valid, g, 0)
    cur = host["exec_cursor"][gi]
    adv = _advance(after["dec"], gi, cur)
    store = out[0] != 0
    return (np.where(store, _wrap(cur.astype(np.int64) + adv), cur), store,
            gi, adv)


@pytest.mark.parametrize("seed", range(4))
def test_store_lanes_need_no_read_back(seed):
    """The kernel's design: every store lane of a row sees the same
    advance from the same pre-batch cursor, so its new cursor is
    ``cur + adv`` with no read after the batch; only lanes that do not
    store (the ones phase A counts) can need the post-batch cursor, and
    on random batches some do, so the second barrier cannot always be
    skipped; in a batch where every lane stores (the storm's), every new
    cursor is ``cur + adv``."""
    rng = np.random.default_rng(200 + seed)
    host = _host(rng, rng.integers(0, 1000, G))
    lanes = _lanes(rng, host, 40, rng.choice(G, 10))
    st_t = state_from_numpy(host, device="cpu")
    out = commit_cuda.commit_reference(
        st_t, *(torch.from_numpy(a) for a in lanes)).numpy()
    known, store, gi, adv = _known_cursors(host, lanes, out,
                                           state_to_numpy(st_t))
    need = out[3] != known
    assert need.any() and not (need & store).any()
    for r in np.unique(gi[store]):  # one advance a row
        assert len(np.unique(adv[store & (gi == r)])) == 1
    # every lane stores: active rows (the first 56), distinct window
    # offsets from each row's cursor, every lane valid, no padding
    rows = rng.choice(56, 8, replace=False)
    off = np.stack([rng.permutation(W)[:5] for _ in rows])
    g = np.repeat(rows, 5).astype(np.int32)
    slot = _wrap(host["exec_cursor"][g].astype(np.int64) + off.ravel())
    perm = rng.permutation(len(g))
    lanes = (g[perm], slot[perm], np.arange(40, dtype=np.int32),
             np.arange(40, dtype=np.int32), np.ones(40, bool))
    st_t = state_from_numpy(host, device="cpu")
    out = commit_cuda.commit_reference(
        st_t, *(torch.from_numpy(a) for a in lanes)).numpy()
    known, store, _gi, adv = _known_cursors(host, lanes, out,
                                            state_to_numpy(st_t))
    assert store.all() and adv.any()
    np.testing.assert_array_equal(out[3], known)


def test_commit_batch_launches_yardsticks_do_not(monkeypatch):
    """``kernels.commit_batch`` (the storm's commits) goes through the
    commit wrapper; the wave kernels' torch yardsticks
    (``commit_packed`` under ``acceptor_wave_plain``, and the own commit
    of ``accept_reply_commit_self_packed``) run the plain version and
    never reach the wrapper."""
    rng = np.random.default_rng(8)
    host = _host(rng, rng.integers(0, 100, G))
    _, st_t = _pair(host)
    lanes = tuple(torch.from_numpy(a) for a in
                  _lanes(rng, host, 40, rng.choice(G, 12)))
    calls = []

    def wrapper(*args):
        calls.append(args)
        return commit_cuda.commit_reference(*args)

    monkeypatch.setattr(commit_cuda, "commit", wrapper)
    _, o = tk.commit_batch(st_t, *lanes)
    assert len(calls) == 1 and o.applied.dtype == torch.bool
    packed = torch.stack([lanes[0], lanes[1], lanes[2], lanes[3],
                          lanes[4].to(torch.int32)])
    tk.commit_packed(st_t, packed)
    tk.acceptor_wave_plain(st_t, None, packed)
    rep = torch.stack([lanes[0], lanes[1], torch.zeros_like(lanes[0]),
                       torch.zeros_like(lanes[0]), torch.ones_like(lanes[0]),
                       lanes[4].to(torch.int32)])
    tk.coordinator_wave_plain(st_t, None, rep)
    assert len(calls) == 1


def test_commit_raises_off_cpu_without_fallback():
    """A state on neither the CPU nor a CUDA device: the wrapper raises
    rather than run the plain version."""
    _, st_t = _pair(_host(np.random.default_rng(0), np.zeros(G)))
    meta = dataclasses.replace(st_t, **{f: t.to("meta")
                                        for f, t in st_t.items()})
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        commit_cuda.commit(meta, one, one, one, one, one.bool())
