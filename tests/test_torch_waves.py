"""The runtime's two fused waves, through the port's wave wrappers
(``kernels.acceptor_wave`` and ``kernels.coordinator_wave``, one Hopper
kernel launch a chunk on the card), against the JAX package's jitted
fused waves on the CPU.  On the CPU a wrapper runs its plain version,
the torch bodies, which ``chip_smoke.py`` phase 2 holds the kernels
against on the card.

The same state (made with numpy from a seed) and the same packed inputs
go to both packages; every state plane and every live lane of every
output row must be equal, exactly.  Besides a random mix at every
bucket (``chip_smoke.py``'s own state and lane makers, which phase 2
feeds the kernels on the card), each case the kernels must order is
built on purpose: run ranks and throttling at the window edge, two
quorum lanes in one column, single-member groups deciding on the self
vote, a self-nack whose preemption the second half's vote must see, a
commit that closes a gap, and each half of a wave empty.  The chunks
``chip_smoke.py`` phase 2 adds at the seams of the kernels' launch
geometry (one CTA up to 512 lanes, one cluster of 8 CTAs above) run
here too, at small G, through both halves of each wave."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops.types import ColumnarState as JaxState
from gigapaxos_tpu_torch.ops import kernels as tk
from gigapaxos_tpu_torch.ops import wave_cuda
from gigapaxos_tpu_torch.ops.types import (EMITTED_BIT, NO_SLOT,
                                           state_from_numpy, state_to_numpy)

G, W = 256, 16
# the seam chunks of 4096 lanes need as many rows (one lane a row); the
# others share G, and with it the JAX jits, with the random test
SEAMS = [(what, n, B, how, 4096 if B == 4096 else G)
         for what, n, B, how in chip_smoke.WAVE_SEAMS[1:]]


def packed(half, cols, B):
    """``[k+1, B]`` int32 numpy: the columns padded to B lanes as
    ``ColumnarBackend`` pads a wave, every column lane valid."""
    return chip_smoke.wave_packed(half, cols, len(cols[0]), B,
                                  "cpu").numpy()


class Pair:
    """One state in both packages, driven in lockstep."""

    def __init__(self, host):
        self.jst = JaxState(**{f: jnp.asarray(a) for f, a in host.items()})
        self.tst = state_from_numpy(host, device="cpu")

    def host(self):
        return state_to_numpy(self.tst)

    def run(self, wave, jax_fn, *halves):
        """``tk.<wave>`` on the port's state and ``jk.<jax_fn>`` (the
        present halves) on the JAX state; every plane and the live lanes
        of every output row must be equal.  Returns the port's output
        split by half, as numpy ``[rows, B]`` arrays."""
        present = [h for h in halves if h is not None]
        self.jst, *jouts = getattr(jk, jax_fn)(
            self.jst, *(jnp.asarray(h) for h in present))
        out = getattr(tk, wave)(self.tst, *(
            None if h is None else torch.from_numpy(h.copy())
            for h in halves)).numpy()
        assert out.shape[0] == sum(np.asarray(j).shape[0] for j in jouts)
        split, at = [], 0
        for h, jo in zip(present, jouts):
            jo = np.asarray(jo)
            live = h[-1] != 0
            mine = out[at:at + jo.shape[0]]
            np.testing.assert_array_equal(mine[:, live], jo[:, live],
                                          err_msg=f"{wave}: output rows")
            split.append(mine)
            at += jo.shape[0]
        tn = self.host()
        for f in JaxState._fields:
            np.testing.assert_array_equal(
                tn[f], np.asarray(getattr(self.jst, f)),
                err_msg=f"{wave} via {jax_fn}: state.{f}")
        return split


def _ids(rng, n):
    return [rng.integers(1, 1 << 30, n).astype(np.int32) for _ in range(2)]


def coordinator(row, host, nxt, cbal=None, members=3):
    """Make ``row`` an active coordinator with ``members`` members, no
    proposals, next_slot ``nxt`` and (unless given) cbal = bal."""
    host["active"][row] = True
    host["members"][row] = members
    host["is_coord"][row] = host["coord_active"][row] = True
    host["cbal"][row] = host["bal"][row] if cbal is None else cbal
    host["prop"][row] = (NO_SLOT, 0, 0, 0)
    host["next_slot"][row] = nxt


@pytest.mark.parametrize("kind", ["acceptor", "coordinator"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_waves_at_every_bucket(kind, seed):
    """A random mix at each bucket of the runtime's ladder, partly
    padded, with both halves live, then with each half empty; three
    waves a bucket on one evolving state."""
    rng = np.random.default_rng(seed)
    pair = Pair(chip_smoke.wave_host_state(G, W, rng))
    name = f"{kind}_wave"
    kinds, _, jax_fns = chip_smoke.WAVE_KERNELS[name]
    for B in (8, 64, 512):
        n = int(rng.integers(B // 8 + 1, B + 1))
        host = pair.host()
        first, second = (chip_smoke.wave_packed(
            h, chip_smoke.wave_half(h, host, n, rng), n, B, "cpu").numpy()
            for h in kinds)
        for fn, halves in zip(jax_fns, ((first, second), (first, None),
                                        (None, second))):
            if fn == "accept_p":  # the accept alone is not a wave
                continue
            pair.run(name, fn, *halves)


def test_run_ranks_and_throttle_at_the_window_edge():
    """Twelve proposals to a group with three free slots of its window,
    interleaved with proposals to a group with room: ranks in lane
    order, three granted, the rest throttled."""
    rng = np.random.default_rng(3)
    host = chip_smoke.wave_host_state(G, W, rng)
    cur = host["exec_cursor"]
    coordinator(5, host, int(cur[5]) + W - 3)
    coordinator(6, host, int(cur[6]))
    g = np.asarray([5, 6] * 12, np.int32)
    req = packed("request", [g, *_ids(rng, 24), np.zeros(24, np.int32)], 64)
    pair = Pair(host)
    (out,) = pair.run("coordinator_wave", "propose_accept_self_p", req, None)
    granted, throttled, slot = out[0, :24], out[2, :24], out[3, :24]
    assert granted[g == 5].sum() == 3 and throttled[g == 5].sum() == 9
    assert granted[g == 6].all()
    np.testing.assert_array_equal(slot[g == 6], cur[6] + np.arange(12))


def test_two_quorum_lanes_in_one_column_decide_once():
    """Two fresh acks for one column in one batch both cross quorum
    (2 of 3); only the first lane emits the decision, and the column's
    EMITTED_BIT is set once."""
    rng = np.random.default_rng(4)
    host = chip_smoke.wave_host_state(G, W, rng)
    r = 7
    s = int(host["exec_cursor"][r])
    coordinator(r, host, s + 1)
    host["prop"][r, s % W] = (s, 11, 12, 0)
    cb = int(host["cbal"][r])
    rep = packed("reply", [np.asarray([r, r], np.int32),
                           np.asarray([s, s], np.int32),
                           np.asarray([cb, cb], np.int32),
                           np.asarray([1, 2], np.int32),
                           np.ones(2, np.int32)], 8)
    pair = Pair(host)
    (out,) = pair.run("coordinator_wave", "accept_reply_commit_self_p", None,
                      rep)
    assert out[0, :2].tolist() == [1, 0]
    assert pair.host()["prop"][r, s % W, 3] == EMITTED_BIT | 0b110


def test_single_member_groups_decide_on_the_self_vote():
    """A one-member group's own accept and vote decide its proposals in
    the request half itself."""
    rng = np.random.default_rng(5)
    host = chip_smoke.wave_host_state(G, W, rng)
    for r in (9, 10):
        coordinator(r, host, int(host["exec_cursor"][r]), members=1)
    g = np.asarray([9, 10, 9], np.int32)
    req = packed("request", [g, *_ids(rng, 3), np.zeros(3, np.int32)], 8)
    rep = packed("reply", [np.zeros(0, np.int32)] * 5, 8)
    pair = Pair(host)
    pout, _ = pair.run("coordinator_wave", "request_reply_p", req, rep)
    assert pout[6, :3].all()  # newly decided


def test_self_nack_preemption_is_seen_by_the_replies():
    """The coordinator's own accept nacks (a higher promise landed): its
    own vote resigns the group, and the second half's acks for an older
    column of that group must then not decide — where, without the
    request half, they do."""
    rng = np.random.default_rng(6)
    host = chip_smoke.wave_host_state(G, W, rng)
    r = 11
    s = int(host["exec_cursor"][r])
    coordinator(r, host, s + 1, cbal=int(host["bal"][r]) - 4096)
    host["prop"][r, s % W] = (s, 21, 22, 0b001)
    cb = int(host["cbal"][r])
    req = packed("request", [np.asarray([r], np.int32), *_ids(rng, 1),
                             np.zeros(1, np.int32)], 8)
    rep = packed("reply", [np.asarray([r], np.int32),
                           np.asarray([s], np.int32),
                           np.asarray([cb], np.int32),
                           np.asarray([1], np.int32),
                           np.ones(1, np.int32)], 8)
    alone = Pair(host)
    (rout,) = alone.run("coordinator_wave", "accept_reply_commit_self_p",
                        None, rep)
    assert rout[0, 0] == 1
    pair = Pair(host)
    pout, rout = pair.run("coordinator_wave", "request_reply_p", req, rep)
    assert pout[7, 0] == 1 and rout[0, 0] == 0  # preempted; not decided
    assert not pair.host()["is_coord"][r]


def test_a_commit_that_closes_a_gap_advances_past_the_run():
    """Slots cursor+1 .. cursor+5 are decided; the commit of the cursor's
    own slot, beside accepts, moves the frontier by six."""
    rng = np.random.default_rng(8)
    host = chip_smoke.wave_host_state(G, W, rng)
    r = 13
    host["active"][r] = True
    c = int(host["exec_cursor"][r])
    host["dec"][r] = (NO_SLOT, 0, 0)
    for k in range(1, 6):
        host["dec"][r, (c + k) % W] = (c + k, k, k)
    acc = packed("accept", [np.asarray([r], np.int32),
                            np.asarray([c + 7], np.int32),
                            host["bal"][[r]], *_ids(rng, 1)], 8)
    com = packed("commit", [np.asarray([r], np.int32),
                            np.asarray([c], np.int32), *_ids(rng, 1)], 8)
    pair = Pair(host)
    aout, cout = pair.run("acceptor_wave", "accept_commit_p", acc, com)
    assert aout[0, 0] == 1 and cout[0, 0] == 1
    assert cout[3, 0] == c + 6


@pytest.mark.parametrize("kind", ["acceptor", "coordinator"])
def test_wave_bound_counts_live_lanes_only(kind):
    """``chip_smoke.wave_bound_bytes``, the byte bound phase 2 prints:
    padding lanes add their packed input and output words and nothing
    else, and a chunk with no live lane moves only those words."""
    rng = np.random.default_rng(5)
    host = chip_smoke.wave_host_state(G, W, rng)
    name = f"{kind}_wave"
    kinds, outs, _ = chip_smoke.WAVE_KERNELS[name]
    plain = getattr(tk, f"{name}_plain")
    base = state_from_numpy(host, device="cpu")
    n = 40
    cols = [chip_smoke.wave_half(h, host, n, rng) for h in kinds]

    def bound(live, B):
        halves = [chip_smoke.wave_packed(h, [a[:live] for a in c], live,
                                         B, "cpu")
                  for h, c in zip(kinds, cols)]
        after = chip_smoke.clone_all(base)
        plain(after, *halves)
        io = sum(4 * (h.shape[0] + r) * B for h, r in zip(halves, outs))
        return chip_smoke.wave_bound_bytes(name, base, halves, after), io

    (small, io64), (big, io512) = bound(n, 64), bound(n, 512)
    assert big - small == io512 - io64
    assert small > io64
    assert bound(0, 64) == (io64, io64)


@pytest.mark.parametrize("kind", ["acceptor", "coordinator"])
@pytest.mark.parametrize("what,n,B,how,g_rows", SEAMS,
                         ids=[re.sub(r"\W+", "-", s[0]).strip("-")
                              for s in SEAMS])
def test_chunks_at_the_geometry_seams(kind, what, n, B, how, g_rows):
    """Phase 2's seam chunks (``chip_smoke.WAVE_SEAMS``): 4096 lanes on
    one row, on 8 rows, on rows of their own, 512 live lanes in the last
    CTA's range of 4096, and bucket 512 all live, both halves."""
    rng = np.random.default_rng(9)
    host = chip_smoke.wave_host_state(g_rows, W, rng)
    name = f"{kind}_wave"
    kinds, _, jax_fns = chip_smoke.WAVE_KERNELS[name]
    rows = chip_smoke.seam_rows(host, rng, how)
    halves, live = chip_smoke.seam_halves(kinds, host, rng, n, B, how, rows,
                                          "cpu")
    first, second = (h.numpy() for h in halves)
    if how.get("last"):  # the live lanes sit at the end of the chunk
        assert not first[-1, :B - n].any() and first[-1, B - n:].all()
    Pair(host).run(name, jax_fns[0], first, second)


def test_launch_geometry_follows_the_bucket():
    """One CTA of the bucket's lanes rounded up to a warp up to 512
    lanes, one cluster of 8 CTAs sharing them above, nothing beyond a
    chunk of 4096."""
    assert [wave_cuda.geometry(B) for B in (1, 8, 33, 64, 512, 513, 4096)] \
        == [(1, 32), (1, 32), (1, 64), (1, 64), (1, 512), (8, 96), (8, 512)]
    for B in (0, wave_cuda.MAX_LANES + 1):
        with pytest.raises(ValueError):
            wave_cuda.geometry(B)
