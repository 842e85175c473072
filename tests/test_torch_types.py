"""Port state layout (gigapaxos_tpu_torch.ops.types) against the JAX
package's: constants, fresh-state planes, the numpy boundary (bit for
bit, the uint32 vote word included), request-id splitting, and import
hygiene (the port imports neither jax nor the JAX package)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import kernels as jk
from gigapaxos_tpu.ops import types as jt
from gigapaxos_tpu_torch.ops import types as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _assert_planes_equal(a, b, msg=""):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}{f}: {a[f].dtype} vs " \
            f"{b[f].dtype}"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}{f}")


def test_constants_identical():
    for name in ("NODE_BITS", "NODE_MASK", "NO_BALLOT", "NO_SLOT",
                 "ACC_SLOT", "ACC_BAL", "ACC_RLO", "ACC_RHI", "DEC_SLOT",
                 "DEC_RLO", "DEC_RHI", "PROP_SLOT", "PROP_RLO", "PROP_RHI",
                 "PROP_VOTES", "EMITTED_BIT", "VOTE_MASK"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.FIELDS == jt.ColumnarState._fields
    for num, coord in ((0, 0), (3, 7), (1 << 18, 4095)):
        p = tt.pack_ballot(num, coord)
        assert p == jt.pack_ballot(num, coord)
        assert tt.unpack_ballot(p) == jt.unpack_ballot(p)
    assert tt.unpack_ballot(-1) == (-1, -1)


@pytest.mark.parametrize("G,W", [(8, 4), (64, 16)])
def test_make_state_matches_jax(G, W):
    port = tt.state_to_numpy(tt.make_state(G, W, device="cpu"))
    _assert_planes_equal(_jax_np(jt.make_state(G, W)), port)
    assert tt.state_nbytes(G, W) == jt.state_nbytes(G, W)
    assert sum(a.nbytes for a in port.values()) == tt.state_nbytes(G, W)


def test_state_numpy_roundtrip_bit_for_bit():
    """A used JAX state (created rows, random planes, high-bit vote
    words) crosses into the port and back unchanged."""
    G, W = 32, 8
    rng = np.random.default_rng(0)
    st = jt.make_state(G, W)
    st, _ = jk.create_groups(
        st, jnp.arange(G, dtype=jnp.int32), jnp.full(G, 3, jnp.int32),
        jnp.zeros(G, jnp.int32), jnp.zeros(G, jnp.int32),
        jnp.asarray(rng.random(G) < 0.5), jnp.asarray(rng.random(G) < 0.8))
    fields = _jax_np(st)
    fields["acc"] = rng.integers(-2**31, 2**31 - 1, (G, W, 4),
                                 dtype=np.int32)
    fields["prep_votes"] = rng.integers(0, 2**32, G, dtype=np.uint64) \
        .astype(np.uint32)
    fields["prep_votes"][0] = 0xFFFFFFFF
    port = tt.state_from_numpy(fields, device="cpu")
    assert port.prep_votes.dtype == torch.int32
    assert int(port.prep_votes[0]) == -1  # same 32 bits, signed view
    _assert_planes_equal(fields, tt.state_to_numpy(port))
    assert port.G == G and port.W == W


def test_entry_points_refuse_a_missing_gpu():
    """Nothing moves to the CPU on its own: asking for a CUDA device
    where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.make_state(8, 4)


@pytest.mark.parametrize("req", [0, 1, (1 << 31) - 1, 1 << 31,
                                 (1 << 32) - 1, 1 << 32, (1 << 63) + 12345,
                                 (1 << 64) - 1])
def test_split_join_req_id(req):
    lo, hi = tt.split_req_id(req)
    assert (lo, hi) == jt.split_req_id(req)
    assert -(1 << 31) <= lo < (1 << 31) and -(1 << 31) <= hi < (1 << 31)
    assert tt.join_req_id(lo, hi) == req == jt.join_req_id(lo, hi)


_HYGIENE = r"""
import importlib, pkgutil, sys
import gigapaxos_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m.startswith("jaxlib.") or m == "gigapaxos_tpu"
       or m.startswith("gigapaxos_tpu.")]
print(",".join(names), "BAD=" + ",".join(sorted(bad)))
"""

# the node runtime's, the flight recorder's, the flight deck's, the
# bench CLI's and the chaos drill's modules, which the walk must reach
_RUNTIME = ("paxos.manager", "net.transport", "paxos.client",
            "testing.harness", "testing.loadgen", "native", "blackbox",
            "blackbox.replay", "blackbox.__main__", "utils.prom",
            "net.statshttp", "net.cluster", "utils.statsdump",
            "testing.main", "chaos.invariants", "chaos.scenarios",
            "chaos.__main__")


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    walked, bad = out.stdout.split()
    walked = set(walked.split(","))
    assert len(walked) >= 30  # every submodule was walked
    for mod in _RUNTIME:
        assert f"gigapaxos_tpu_torch.{mod}" in walked, mod
    assert bad == "BAD=", bad
