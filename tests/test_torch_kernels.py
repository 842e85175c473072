"""Randomized cross-package harness for the kernel bodies: the same
packed ``[k, B]`` inputs (made with numpy from a seed) go to
``gigapaxos_tpu.ops.kernels`` and to ``gigapaxos_tpu_torch.ops.kernels``
(CPU), and after every call every state plane and every output lane must
be equal — exact equality, the state is integer.  The inputs keep the
kernels' intra-batch preconditions (one accept/commit lane per
(group, slot), one reply lane per (group, slot, sender))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.types import make_state as jax_make_state
from gigapaxos_tpu_torch.ops import accept_reply_cuda, rank_cuda
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops.types import (NO_BALLOT, NO_SLOT,
                                           state_from_numpy, state_to_numpy)

G, W, B = 32, 8, 32
N_ACTIVE = 28


def _np(x):
    return np.asarray(x)


class Mirror:
    """One node's state in both packages, driven in lockstep."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        st = jax_make_state(G, W)
        members = rng.choice([1, 3, 3, 5], N_ACTIVE).astype(np.int32)
        st, _ = jk.create_groups(
            st, jnp.arange(N_ACTIVE, dtype=jnp.int32), jnp.asarray(members),
            jnp.zeros(N_ACTIVE, jnp.int32), jnp.zeros(N_ACTIVE, jnp.int32),
            jnp.asarray(rng.random(N_ACTIVE) < 0.8),
            jnp.ones(N_ACTIVE, bool))
        self.jst = st
        self.tst = state_from_numpy({f: _np(getattr(st, f))
                                     for f in st._fields}, device="cpu")
        self.calls = 0

    def state(self, f):
        return _np(getattr(self.jst, f))

    def check_state(self, msg):
        tn = state_to_numpy(self.tst)
        for f in self.jst._fields:
            np.testing.assert_array_equal(
                tn[f], self.state(f), err_msg=f"{msg}: state.{f}")

    def run(self, name, *args):
        """Apply ``name`` to both states; compare every output and every
        plane; return the JAX outputs as numpy."""
        self.jst, *jouts = getattr(jk, name)(
            self.jst, *(jnp.asarray(a) for a in args))
        _, *touts = getattr(tk, name)(
            self.tst, *(torch.from_numpy(np.ascontiguousarray(a))
                        for a in args))
        self.calls += 1
        msg = f"{name} (call {self.calls})"
        res = []
        for jo, to in zip(jouts, touts):
            if jo is None:
                assert to is None
                res.append(None)
                continue
            if hasattr(jo, "_fields"):
                for f, a, b in zip(jo._fields, jo, to):
                    np.testing.assert_array_equal(
                        b.numpy(), _np(a), err_msg=f"{msg}: out.{f}")
                res.append(type(jo)(*(_np(a) for a in jo)))
            else:
                np.testing.assert_array_equal(to.numpy(), _np(jo),
                                              err_msg=f"{msg}: out")
                res.append(_np(jo))
        self.check_state(msg)
        return res[0] if len(res) == 1 else res

    # -- lane generators (keep the intra-batch preconditions) -------------

    def packed(self, cols, n=None):
        """[k+1, B] i32: the columns (truncated/padded to B) + valid."""
        n = len(cols[0]) if n is None else n
        n = min(n, B)
        out = np.zeros((len(cols) + 1, B), np.int32)
        for i, c in enumerate(cols):
            out[i, :n] = np.asarray(c)[:n]
        out[len(cols), :n] = self.rng.random(n) < 0.92
        return out

    def requests(self):
        rng = self.rng
        g = rng.integers(0, G, B).astype(np.int32)  # dups, inactive rows
        return g, rng.integers(1, 1 << 30, B).astype(np.int32), \
            rng.integers(-(1 << 30), 1 << 30, B).astype(np.int32)

    def accept_lanes(self, g, slot, bal, rlo, rhi):
        """The granted lanes plus noise lanes on fresh (group, slot)
        pairs: stale, beyond the window, low and high ballots."""
        rng = self.rng
        cur = self.state("exec_cursor")
        pbal = self.state("bal")
        seen = set(zip(g.tolist(), slot.tolist()))
        extra = []
        while len(g) + len(extra) < B:
            r = int(rng.integers(0, G))
            s = int(cur[r] + rng.integers(-3, W + 4))
            if (r, s) in seen:
                continue
            seen.add((r, s))
            b = int(pbal[r] + rng.choice([-4, 0, 0, 4096]))
            extra.append((r, s, b, int(rng.integers(1, 1 << 30)),
                          int(rng.integers(1, 1 << 30))))
        e = np.asarray(extra, np.int32).reshape(-1, 5).T
        return [np.concatenate([c, x]).astype(np.int32)
                for c, x in zip((g, slot, bal, rlo, rhi), e)]

    def reply_lanes(self, g, slot, bal, senders=(0, 1, 2)):
        """Replies for (g, slot) lanes from a random subset of senders:
        mostly acks at ``bal``, some nacks, a rare higher-ballot nack."""
        rng = self.rng
        rows = []
        for i in range(len(g)):
            for s in senders:
                if rng.random() < 0.8:
                    acked = rng.random() < 0.9
                    b = bal[i] if acked or rng.random() < 0.7 else \
                        bal[i] + 4096
                    rows.append((g[i], slot[i], b, s, int(acked)))
        rng.shuffle(rows)
        if not rows:
            return [np.zeros(0, np.int32)] * 5
        return list(np.asarray(rows, np.int32).T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_waves_match(seed):
    """propose_p -> accept_p -> accept_reply_p -> commit_p, four rounds."""
    m = Mirror(seed)
    for _ in range(4):
        g, rlo, rhi = m.requests()
        pk = m.packed([g, rlo, rhi])
        po = m.run("propose_p", pk)
        live = (po[0] != 0) & (pk[3] != 0)
        sel = np.flatnonzero(live)
        gg, ss, bb = g[sel], po[3][sel], po[4][sel]
        acc = m.accept_lanes(gg, ss, bb, rlo[sel], rhi[sel])
        m.run("accept_p", m.packed(acc))
        rp = m.packed(m.reply_lanes(gg, ss, bb))
        ro = m.run("accept_reply_p", rp)
        dec = np.flatnonzero(ro[0] != 0)
        m.run("commit_p", m.packed([rp[0][dec], ro[5][dec], ro[3][dec],
                                    ro[4][dec]]))
    assert m.calls == 16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_waves_match(seed):
    """The four fused waves: propose_accept_self_p and
    accept_reply_commit_self_p (the coordinator's own accept/vote and
    commit), accept_commit_p (the acceptor wave) and request_reply_p
    (the coordinator wave)."""
    m = Mirror(10 + seed)
    pending = None  # (g, slot, cbal) proposed, replies not yet in
    for _ in range(3):
        g, rlo, rhi = m.requests()
        smidx = np.zeros(B, np.int32)
        pk = m.packed([g, rlo, rhi, smidx])
        po = m.run("propose_accept_self_p", pk)
        sel = np.flatnonzero((po[0] != 0) & (pk[4] != 0))
        gg, ss, bb = g[sel], po[3][sel], po[4][sel]
        rp = m.packed(m.reply_lanes(gg, ss, bb, senders=(1, 2)))
        ro = m.run("accept_reply_commit_self_p", rp)
        # acceptor wave: new accepts + commits of what just decided
        dec = np.flatnonzero(ro[0] != 0)
        acc = m.accept_lanes(gg, ss, bb, rlo[sel], rhi[sel])
        com = [rp[0][dec], ro[5][dec], ro[3][dec], ro[4][dec]]
        m.run("accept_commit_p", m.packed(acc), m.packed(com))
        # coordinator wave: new requests + replies for the last batch
        g2, rlo2, rhi2 = m.requests()
        req = m.packed([g2, rlo2, rhi2, np.zeros(B, np.int32)])
        if pending is None:
            pending = (gg, ss, bb)
        rep2 = m.reply_lanes(*pending, senders=(1, 2))
        pout, rout = m.run("request_reply_p", req, m.packed(rep2))
        sel2 = np.flatnonzero((pout[0] != 0) & (req[4] != 0))
        pending = (g2[sel2], pout[3][sel2], pout[4][sel2])
    assert m.calls == 12


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_and_install_match(seed):
    """Phase 1: prepare (promise + dense window gather) at mixed
    ballots, then install_coordinator with the gathered window as
    carryover, then a propose/accept round on the new ballot."""
    m = Mirror(20 + seed)
    g, rlo, rhi = m.requests()
    pk = m.packed([g, rlo, rhi, np.zeros(B, np.int32)])
    po = m.run("propose_accept_self_p", pk)
    rng = m.rng
    rows = rng.permutation(G)[:B // 2].astype(np.int32)
    n = len(rows)
    newbal = ((rng.integers(0, 3, n) << 12) | 1).astype(np.int32)
    valid = rng.random(n) < 0.9
    pr = m.run("prepare", rows, newbal, valid)
    acked = pr.acked & valid
    sel = np.flatnonzero(acked)
    carry_slot = np.where(pr.win_slot[sel] >= pr.exec_cursor[sel, None],
                          pr.win_slot[sel], NO_SLOT).astype(np.int32)
    nxt = (pr.exec_cursor[sel] + W // 2).astype(np.int32)
    m.run("install_coordinator", rows[sel], newbal[sel], nxt, carry_slot,
          pr.win_req_lo[sel], pr.win_req_hi[sel], np.ones(len(sel), bool))
    g, rlo, rhi = m.requests()
    po = m.run("propose_p", m.packed([g, rlo, rhi]))
    live = np.flatnonzero(po[0] != 0)
    acc = m.accept_lanes(g[live], po[3][live], po[4][live], rlo[live],
                         rhi[live])
    m.run("accept_p", m.packed(acc))
    assert (po[4][live] != NO_BALLOT).all()


def test_row_ops_match():
    """Cold row ops: delete, set_cursor, gc, then gather/scatter rows."""
    m = Mirror(30)
    rows = np.arange(0, 12, dtype=np.int32)
    valid = m.rng.random(12) < 0.8
    m.run("delete_groups", rows[:4], valid[:4])
    m.run("set_cursor", rows, m.rng.integers(0, 9, 12).astype(np.int32),
          m.rng.integers(0, 12, 12).astype(np.int32), valid)
    m.run("gc", rows, m.rng.integers(-1, 6, 12).astype(np.int32), valid)
    sel = np.asarray([5, 7, 9], np.int32)
    rows_t = tk.gather_rows(m.tst, torch.from_numpy(sel))
    rows_j = jk.gather_rows(m.jst, jnp.asarray(sel))
    tn = state_to_numpy(rows_t)
    for f in m.jst._fields:
        np.testing.assert_array_equal(tn[f], _np(getattr(rows_j, f)))
    dst = np.asarray([20, 21, 22], np.int32)
    v = np.asarray([True, False, True])
    m.jst, _ = jk.scatter_rows(m.jst, jnp.asarray(dst), rows_j,
                               jnp.asarray(v))
    tk.scatter_rows(m.tst, torch.from_numpy(dst), rows_t,
                    torch.from_numpy(v))
    m.check_state("scatter_rows")


def test_run_rank_and_popcount_edges():
    """The two helpers with no one-call torch counterpart."""
    k1 = torch.tensor([3, -1, 3, 3, 2, -1, 2, 3], dtype=torch.int32)
    k2 = torch.tensor([0, 1, 0, 1, 5, 5, 5, 0], dtype=torch.int32)
    rank = rank_cuda.run_rank(k1, k2).tolist()
    assert rank == [0, 0, 1, 0, 0, 0, 1, 2]
    assert rank == _np(jk._run_rank(jnp.asarray(k1.numpy()),
                                    jnp.asarray(k2.numpy()))).tolist()
    x = torch.tensor([0, 1, 3, (1 << 30) - 1, 0x2AAAAAAA, 1 << 29],
                     dtype=torch.int32)
    assert accept_reply_cuda.popcount(x).tolist() == [0, 1, 2, 30, 15, 1]
