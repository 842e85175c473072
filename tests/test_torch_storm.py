"""The port's decide-storm step against the JAX ``storm`` (CPU): the
same lanes (numpy, from a seed) for 3 steps; the decided counts and
every plane of all 3 replica states must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigapaxos_tpu.ops import storm as jstorm
from gigapaxos_tpu_torch.ops import storm as tstorm
from gigapaxos_tpu_torch.ops.types import state_to_numpy

G, W, B, R = 256, 8, 128, 3


def _lanes(rng, dup_heavy):
    if dup_heavy:  # few groups, many lanes each: window throttling
        g = rng.integers(0, 12, B)
    else:
        g = rng.integers(0, G, B)
    return (g.astype(np.int32),
            rng.integers(1, 1 << 30, B).astype(np.int32),
            rng.integers(-(1 << 30), 1 << 30, B).astype(np.int32),
            rng.random(B) < 0.9)


@pytest.mark.parametrize("seed,dup_heavy", [(0, False), (1, False),
                                            (2, True)])
def test_storm_matches_jax(seed, dup_heavy):
    rng = np.random.default_rng(seed)
    js = jstorm.make_fleet(G, W, R)
    ts = tstorm.make_fleet(G, W, R, device="cpu")
    total = 0
    for step in range(3):
        lanes = _lanes(rng, dup_heavy)
        assert len(np.unique(lanes[0])) < B  # duplicate groups in a batch
        js, jn = jstorm.storm(js, *(jnp.asarray(a) for a in lanes))
        ts, tn = tstorm.decide_storm_step(
            ts, *(torch.from_numpy(a) for a in lanes))
        assert int(tn) == int(jn), f"step {step}"
        total += int(tn)
        for r in range(R):
            port = state_to_numpy(ts[r])
            for f in js[r]._fields:
                np.testing.assert_array_equal(
                    port[f], np.asarray(getattr(js[r], f)),
                    err_msg=f"step {step} replica {r} state.{f}")
    assert total > 0
    if dup_heavy:  # the window throttled some lanes
        assert total < 3 * int(B * 0.9)
