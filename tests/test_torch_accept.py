"""The port's accept transition (its plain torch version, which the CPU
runs) against BOTH of the JAX package's accepts: the Pallas kernel in
interpret mode (``PallasAccept``) and the XLA body (``kernels.accept``).
Integer state: the tolerance is exact equality on ``bal``, ``acc`` and
every live-lane output (``PallasAccept`` reports NO_BALLOT on padding
lanes where the XLA body and the port read row 0; against the XLA body
every lane is compared)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.pallas_accept import PallasAccept
from gigapaxos_tpu.ops.types import make_state as jax_make_state
from gigapaxos_tpu_torch.ops import accept_cuda
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops.types import (ACC_RLO, ACC_SLOT,
                                           state_from_numpy, state_to_numpy)

G, W, B = 64, 8, 48


def _jax_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _mk_states(n_active=56, seed=None):
    """The same state in both packages: n_active created rows, then (with
    a seed) advanced cursors and promised ballots."""
    st = jax_make_state(G, W)
    st, _ = jk.create_groups(
        st, jnp.arange(n_active, dtype=jnp.int32),
        jnp.full(n_active, 3, jnp.int32), jnp.zeros(n_active, jnp.int32),
        jnp.zeros(n_active, jnp.int32), jnp.zeros(n_active, bool),
        jnp.ones(n_active, bool))
    fields = _jax_np(st)
    if seed is not None:
        rng = np.random.default_rng(100 + seed)
        fields["exec_cursor"] = rng.integers(0, 3, G).astype(np.int32)
        fields["bal"] = np.where(fields["active"],
                                 rng.integers(0, 3, G) * 4,
                                 -1).astype(np.int32)
        st = st._replace(exec_cursor=jnp.array(fields["exec_cursor"]),
                         bal=jnp.array(fields["bal"]))
    return st, state_from_numpy(fields, device="cpu")


def _lanes(rng):
    """Distinct rows (so the Pallas octiles hold <= 8 lanes at L=8, the
    whole batch in one call), inactive rows included, slots stale / in
    window / beyond it, ballots below and above the promise, ~10%
    invalid lanes."""
    g = rng.permutation(G)[:B].astype(np.int32)
    slot = rng.integers(-2, W + 4, B).astype(np.int32)
    bal = (rng.integers(0, 5, B) * 4).astype(np.int32)
    rlo = rng.integers(1, 1 << 30, B).astype(np.int32)
    rhi = rng.integers(1, 1 << 30, B).astype(np.int32)
    valid = rng.random(B) < 0.9
    return g, slot, bal, rlo, rhi, valid


def _port(st, lanes):
    g, slot, bal, rlo, rhi, valid = (torch.from_numpy(np.asarray(a))
                                     for a in lanes)
    return accept_cuda.accept(st, g, slot, bal, rlo, rhi, valid).numpy()


def _check_state(port_st, jax_st, msg):
    pn, jn = state_to_numpy(port_st), _jax_np(jax_st)
    for f in ("bal", "acc"):
        np.testing.assert_array_equal(pn[f], jn[f], err_msg=f"{msg}: {f}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_matches_pallas_and_xla(seed):
    rng = np.random.default_rng(seed)
    st_x, st_t = _mk_states(seed=seed)
    st_p, _ = _mk_states(seed=seed)
    pal = PallasAccept(L=8, interpret=True)
    for round_ in range(3):
        lanes = _lanes(rng)
        g, slot, bal, rlo, rhi, valid = lanes
        out = _port(st_t, lanes)
        st_x, o = jk.accept(st_x, *(jnp.asarray(a) for a in lanes))
        st_p, (acked, stale, ow, cur_bal) = pal(st_p, *lanes)
        msg = f"seed {seed} round {round_}"
        xla = np.stack([np.asarray(o.acked), np.asarray(o.stale),
                        np.asarray(o.out_window)]).astype(np.int32)
        np.testing.assert_array_equal(out[:3], xla, err_msg=msg)
        np.testing.assert_array_equal(out[3], np.asarray(o.cur_bal),
                                      err_msg=msg)
        pal_out = np.stack([acked, stale, ow]).astype(np.int32)
        np.testing.assert_array_equal(out[:3], pal_out, err_msg=msg)
        np.testing.assert_array_equal(out[3][valid], cur_bal[valid],
                                      err_msg=msg)
        _check_state(st_t, st_x, msg + " vs xla")
        _check_state(st_t, st_p, msg + " vs pallas")
    assert accept_cuda.accept.launches == 0  # CPU: the plain version


def test_accept_untouched_rows_preserved():
    st_x, st_t = _mk_states()
    one = (np.asarray([3], np.int32), np.zeros(1, np.int32),
           np.zeros(1, np.int32), np.full(1, 7, np.int32),
           np.full(1, 9, np.int32), np.ones(1, bool))
    _port(st_t, one)
    st_x, _ = jk.accept(st_x, *(jnp.asarray(a) for a in one))
    before = st_t.acc[3, :, ACC_RLO].clone()
    two = (np.asarray([10, 11], np.int32), np.zeros(2, np.int32),
           np.zeros(2, np.int32), np.full(2, 5, np.int32),
           np.full(2, 6, np.int32), np.ones(2, bool))
    out = _port(st_t, two)
    st_x, _ = jk.accept(st_x, *(jnp.asarray(a) for a in two))
    assert out[0].all()
    assert torch.equal(st_t.acc[3, :, ACC_RLO], before)
    assert int(st_t.acc[10, 0, ACC_RLO]) == 5
    _check_state(st_t, st_x, "untouched rows")


@pytest.mark.parametrize("with_pallas", [False, True])
def test_accept_several_slots_per_row(with_pallas):
    """Several lanes on one row (distinct slots) in one batch: all
    stored in their own window columns, as in both JAX accepts."""
    st_x, st_t = _mk_states()
    g = np.asarray([1, 1, 1, 2, 2, 2], np.int32)
    slot = np.asarray([0, 1, 2, 0, 1, 2], np.int32)
    lanes = (g, slot, np.zeros(6, np.int32),
             np.arange(10, 16, dtype=np.int32),
             np.arange(20, 26, dtype=np.int32), np.ones(6, bool))
    out = _port(st_t, lanes)
    if with_pallas:
        st_x, (acked, stale, ow, cb) = PallasAccept(L=8, interpret=True)(
            st_x, *lanes)
        ref = np.stack([acked, stale, ow]).astype(np.int32)
        np.testing.assert_array_equal(out[3], cb)
    else:
        st_x, o = jk.accept(st_x, *(jnp.asarray(a) for a in lanes))
        ref = np.stack([np.asarray(o.acked), np.asarray(o.stale),
                        np.asarray(o.out_window)]).astype(np.int32)
        np.testing.assert_array_equal(out[3], np.asarray(o.cur_bal))
    np.testing.assert_array_equal(out[:3], ref)
    assert out[0].all() and not out[1].any() and not out[2].any()
    for i in range(6):
        assert int(st_t.acc[g[i], slot[i] % W, ACC_SLOT]) == slot[i]
        assert int(st_t.acc[g[i], slot[i] % W, ACC_RLO]) == 10 + i
    _check_state(st_t, st_x, "several slots per row")


def test_accept_packed_is_the_kernel_output():
    """``kernels.accept_p`` returns the accept wrapper's packed output
    row for row, padding lanes included."""
    rng = np.random.default_rng(5)
    st_x, st_t = _mk_states(seed=5)
    g, slot, bal, rlo, rhi, valid = _lanes(rng)
    packed = np.stack([g, slot, bal, rlo, rhi, valid.astype(np.int32)])
    _, out = tk.accept_p(st_t, torch.from_numpy(packed))
    st_x, ref = jk.accept_p(st_x, jnp.asarray(packed))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    _check_state(st_t, st_x, "accept_p")


def test_accept_zero_lanes():
    _, st_t = _mk_states()
    before = state_to_numpy(st_t)
    e = torch.zeros(0, dtype=torch.int32)
    out = accept_cuda.accept(st_t, e, e, e, e, e,
                             torch.zeros(0, dtype=torch.bool))
    assert tuple(out.shape) == (4, 0)
    after = state_to_numpy(st_t)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f])


@pytest.mark.parametrize("limit", [1, 7, 2112])
@pytest.mark.parametrize("B", [0, 1, 8, 4096, 4099, 1 << 18, 1 << 21])
def test_accept_grid_plan_covers_every_lane_once(B, limit):
    """The cooperative launch's grid never exceeds the co-resident
    limit and launches nothing for no lanes.  Under the limit one round
    of the grid covers every lane and no block is idle; at the limit the
    kernel's grid-stride loop takes the rest (the card's parity cases
    at B = 4099 and 2^21 in ``chip_smoke.py`` check the kernel's own
    lane walk)."""
    blocks = accept_cuda.grid_plan(B, limit)
    per_block = accept_cuda.THREADS * accept_cuda.LANES
    assert 0 <= blocks <= limit
    assert (blocks == 0) == (B == 0)
    if B and blocks < limit:
        assert blocks * per_block >= B > (blocks - 1) * per_block
    elif B:
        assert blocks == limit and limit * per_block < B + per_block


def test_build_cache_key_follows_sources(tmp_path, monkeypatch):
    """The kernel library is named by a hash of its source, the headers
    beside it and the flags: an edit rebuilds, an unchanged tree loads
    what it built.  (The build itself needs nvcc and runs on the card.)"""
    from gigapaxos_tpu_torch.ops import _build
    assert "accept" in _build.sources()
    assert _build.lib_path("accept").parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// v1\n")
    first = _build.lib_path("k")
    assert first == _build.lib_path("k") and first.suffix == ".so"
    (tmp_path / "k.cu").write_text("// v2\n")
    second = _build.lib_path("k")
    (tmp_path / "common.cuh").write_text("// shared\n")
    assert len({first, second, _build.lib_path("k")}) == 3
