"""The port's AcceptorBackend engines (CPU) against the JAX package's:
the 3-replica propose -> accept x3 -> accept_reply x3 -> commit x3
pipeline on ``ColumnarBackend`` against the JAX ``ColumnarBackend`` with
its Pallas accept on (interpret mode), the fused and cold SPI surfaces,
submit/collect against blocking calls, and a chunked (>4096-lane) wave
against the port's ``ScalarBackend``.  Exact equality throughout."""

import numpy as np
import pytest

from gigapaxos_tpu.paxos import backend as jb
from gigapaxos_tpu.paxos.paxosconfig import PC
from gigapaxos_tpu.utils.config import Config
from gigapaxos_tpu_torch.paxos import backend as tb
from gigapaxos_tpu_torch.utils.instrument import RequestInstrumenter
from gigapaxos_tpu_torch.utils.profiler import DelayProfiler

G, W = 64, 8


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The suite's conftest resets the JAX package's profiler and
    instrumenter; the port keeps its own copies, reset here."""
    yield
    DelayProfiler.clear()
    RequestInstrumenter.reset()


@pytest.fixture(scope="module")
def jax_engines():
    """JAX engines with the Pallas accept on, built once per module (each
    construction compiles the hot kernels).  The suite's virtual 8-device
    mesh would turn the Pallas path off, so the mesh is pinned off."""
    Config.set(PC.ENGINE_MESH, "off")
    try:
        engines = [jb.ColumnarBackend(G, W, use_pallas_accept=True)
                   for _ in range(4)]
    finally:
        Config.clear()
    assert all(e._pallas is not None for e in engines)
    return engines


def _create(bk, n, coord):
    rows = np.arange(n, dtype=np.int32)
    bk.create(rows, np.full(n, 3, np.int32), np.zeros(n, np.int32),
              np.zeros(n, np.int32), np.full(n, coord))


def _eq(a, b, msg):
    if isinstance(a, dict):
        assert set(a) == set(b), msg
        for k in a:
            _eq(a[k], b[k], f"{msg}[{k}]")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{msg}.{f}")
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{msg}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=msg)


def _pipeline(triples, B, iters, seed=1):
    """bench.py's _baseline_pipeline loop, over several backend triples
    in lockstep; every result tuple is compared each iteration."""
    rng = np.random.default_rng(seed)
    for bks in triples:
        for r, b in enumerate(bks):
            _create(b, G, r == 0)
    decided = 0
    for it in range(iters):
        g = rng.integers(0, G, B, dtype=np.int32)
        reqs = np.uint64((it + 1) << 40) | rng.integers(
            1, 1 << 31, B, dtype=np.int64).astype(np.uint64)
        prs = [bks[0].propose(g, reqs) for bks in triples]
        _eq(prs[0], prs[1], f"it {it} propose")
        acks = [[] for _ in triples]
        for k, (bks, pr) in enumerate(zip(triples, prs)):
            for r, b in enumerate(bks):
                ar = b.accept(g, pr.slot, pr.cbal, reqs)
                acks[k].append((ar, ar.acked & pr.granted))
        for r in range(3):
            _eq(acks[0][r][0], acks[1][r][0], f"it {it} accept r{r}")
        newly = np.zeros(B, bool)
        for s in range(3):
            rrs = [bks[0].accept_reply(g, pr.slot, pr.cbal,
                                       np.full(B, s, np.int32), ak[s][1])
                   for bks, pr, ak in zip(triples, prs, acks)]
            _eq(rrs[0], rrs[1], f"it {it} reply s{s}")
            newly |= rrs[0].newly_decided
        for r in range(3):
            crs = [bks[r].commit(g, pr.slot, reqs)
                   for bks, pr in zip(triples, prs)]
            _eq(crs[0], crs[1], f"it {it} commit r{r}")
        decided += int(newly.sum())
    return decided


def _states_equal(port_bk, jax_bk, msg):
    from gigapaxos_tpu_torch.ops.types import state_to_numpy
    port = state_to_numpy(port_bk.state)
    for f in jax_bk.state._fields:
        np.testing.assert_array_equal(
            port[f], np.asarray(getattr(jax_bk.state, f)),
            err_msg=f"{msg} state.{f}")


def test_pipeline_matches_jax_pallas_engine(jax_engines):
    port = [tb.ColumnarBackend(G, W, device="cpu") for _ in range(3)]
    jax3 = jax_engines[:3]
    decided = _pipeline([port, jax3], B=40, iters=8)
    assert decided > 0
    rows = np.arange(G)
    for r in range(3):
        _eq(port[r].inspect_rows(rows), jax3[r].inspect_rows(rows),
            f"inspect_rows r{r}")
        _states_equal(port[r], jax3[r], f"replica {r}")


def test_fused_and_cold_spi_match_jax(jax_engines):
    """The coordinator's fused surfaces, the acceptor's fused wave, and
    the cold row paths (prepare, install, set_cursor, gc, snapshot and
    restore) on one engine of each package."""
    jx = jax_engines[3]
    pt = tb.ColumnarBackend(G, W, device="cpu")
    for b in (pt, jx):
        _create(b, 48, True)
    rng = np.random.default_rng(4)
    B = 8
    for it in range(4):
        g = rng.integers(0, 48, B, dtype=np.int32)
        reqs = rng.integers(1, 1 << 62, B).astype(np.uint64)
        midx = np.zeros(B, np.int32)
        ps = [b.propose_self(g, reqs, midx) for b in (pt, jx)]
        _eq(ps[0], ps[1], f"it {it} propose_self")
        pr = ps[0][0]
        sl = np.flatnonzero(pr.granted)
        ones = np.ones(len(sl), np.int32)
        rs = [b.accept_reply_commit_self(g[sl], pr.slot[sl], pr.cbal[sl],
                                         ones, np.ones(len(sl), bool))
              for b in (pt, jx)]
        _eq(rs[0], rs[1], f"it {it} reply_commit_self")
        dec = rs[0][0].newly_decided
        acs = [b.accept_commit(g[sl], pr.slot[sl], pr.cbal[sl], reqs[sl],
                               g[sl][dec], pr.slot[sl][dec],
                               reqs[sl][dec]) for b in (pt, jx)]
        _eq(acs[0], acs[1], f"it {it} accept_commit")
        g2 = rng.integers(0, 48, B, dtype=np.int32)
        reqs2 = rng.integers(1, 1 << 62, B).astype(np.uint64)
        prr = [b.propose_self_reply(g2, reqs2, midx, g[sl], pr.slot[sl],
                                    pr.cbal[sl], 2 * ones,
                                    np.ones(len(sl), bool))
               for b in (pt, jx)]
        _eq(prr[0], prr[1], f"it {it} propose_self_reply")
    rows = np.arange(0, 16, dtype=np.int32)
    bals = np.full(16, (1 << 12) | 5, np.int32)
    preps = [b.prepare(rows, bals) for b in (pt, jx)]
    _eq(preps[0], preps[1], "prepare")
    p = preps[0]
    carry_req = (p.win_req_lo.view(np.uint32).astype(np.uint64) |
                 (p.win_req_hi.view(np.uint32).astype(np.uint64) << 32))
    for b in (pt, jx):
        b.install_coordinator(rows, bals, p.exec_cursor + 3, p.win_slot,
                              carry_req)
        b.set_cursor(rows[:4], np.full(4, 2, np.int32),
                     np.full(4, 9, np.int32))
        b.gc(rows, np.arange(16, dtype=np.int32) - 1)
    _eq(pt.snapshot_rows(rows)[3], jx.snapshot_rows(rows)[3], "snapshot")
    snaps = [b.snapshot_row(7) for b in (pt, jx)]
    for b, s in zip((pt, jx), snaps):
        b.restore_row(40, s)
    _eq(pt.inspect_rows(np.arange(G)), jx.inspect_rows(np.arange(G)),
        "inspect_rows")
    assert pt.cursor_of(40) == jx.cursor_of(40)
    _states_equal(pt, jx, "fused/cold")
    mp, mj = pt.memory_info(), jx.memory_info()
    for k in ("planes", "total_bytes", "bytes_per_group", "capacity",
              "window"):
        assert mp[k] == mj[k], k
    assert pt.row_ownership()["rows_active"] == \
        jx.row_ownership()["rows_active"]


def test_submit_collect_matches_blocking():
    """Waves submitted together and collected later (the manager's
    overlapped acceptor shape) give the blocking calls' results and
    state."""
    a = tb.ColumnarBackend(G, W, device="cpu")
    b = tb.ColumnarBackend(G, W, device="cpu")
    for bk in (a, b):
        _create(bk, G, True)
    rng = np.random.default_rng(2)
    prev = None
    for it in range(5):
        g = rng.integers(0, G, 24, dtype=np.int32)
        reqs = rng.integers(1, 1 << 62, 24).astype(np.uint64)
        pa, pb = a.propose(g, reqs), b.propose(g, reqs)
        _eq(pa, pb, f"it {it} propose")
        wa = a.accept_submit(g, pa.slot, pa.cbal, reqs)
        wc = a.commit_submit(*prev) if prev else None
        ra = wa.collect()
        rb = b.accept(g, pb.slot, pb.cbal, reqs)
        _eq(ra, rb, f"it {it} accept")
        if wc is not None:
            _eq(wc.collect(), b.commit(*prev), f"it {it} commit")
        acked = ra.acked & pa.granted
        ws = [a.accept_reply_submit(g, pa.slot, pa.cbal,
                                    np.full(24, s, np.int32), acked)
              for s in range(2)]
        for s, w in enumerate(ws):
            _eq(w.collect(), b.accept_reply(g, pb.slot, pb.cbal,
                                            np.full(24, s, np.int32),
                                            acked), f"it {it} reply {s}")
        prev = (g[pa.granted], pa.slot[pa.granted], reqs[pa.granted])
    for f, x in a.state.items():
        assert bool((x == getattr(b.state, f)).all()), f
    assert DelayProfiler.snapshot()["totals"]["eng.collect"]["calls"] > 0


def test_chunked_wave_above_cap_matches_scalar():
    """A wave wider than the 4096-lane bucket cap is applied in chunks
    and agrees lane for lane with the scalar oracle through the whole
    pipeline."""
    n = tb._BUCKET_CAP + 901
    assert tb._chunks(n) == [(0, 4096), (4096, n)]
    cb = tb.ColumnarBackend(8192, W, device="cpu")
    sb = tb.ScalarBackend(W)
    for bk in (cb, sb):
        _create(bk, n, True)
    rows = np.arange(n, dtype=np.int32)
    reqs = np.random.default_rng(3).integers(1, 1 << 62, n).astype(
        np.uint64)
    pr_c, pr_s = cb.propose(rows, reqs), sb.propose(rows, reqs)
    _eq(pr_c, pr_s, "propose")
    ar_c = cb.accept(rows, pr_c.slot, pr_c.cbal, reqs)
    _eq(ar_c, sb.accept(rows, pr_s.slot, pr_s.cbal, reqs), "accept")
    for s in range(2):
        sid = np.full(n, s, np.int32)
        _eq(cb.accept_reply(rows, pr_c.slot, pr_c.cbal, sid, ar_c.acked),
            sb.accept_reply(rows, pr_s.slot, pr_s.cbal, sid, ar_c.acked),
            f"reply{s}")
    cr = cb.commit(rows, pr_c.slot, reqs)
    _eq(cr, sb.commit(rows, pr_s.slot, reqs), "commit")
    assert cr.applied.all()
