"""Parity of the Pallas cascade kernel (interpret mode on the CPU) vs the XLA
masked-lockstep evaluator — which itself is oracle-verified in
test_cascade.py, giving a transitive chain to the reference semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from waldboost_tpu.ops import cascade as cop
from waldboost_tpu.ops.cascade_kernel import cascade_dense

from test_cascade import random_stage


@pytest.mark.parametrize("kind", ["stump", "depth2"])
@pytest.mark.parametrize("with_theta", [False, True])
def test_pallas_matches_xla(kind, with_theta):
    rng = np.random.RandomState(0)
    window = (8, 8)
    C = 3
    X = rng.randn(70, 150, C).astype("f")
    stages = [random_stage(rng, window, C, kind) for _ in range(12)]
    thetas = ([(-np.inf if t % 3 else rng.randn() * 0.5 - 0.5)
               for t in range(12)] if with_theta else [-np.inf] * 12)
    casc, meta = cop.cascade_from_stages(stages, thetas)
    chw = jnp.transpose(jnp.asarray(X), (2, 0, 1))
    valid = jnp.ones((62, 142), bool).at[10:20, 30:70].set(False)

    h1, a1, w1 = cop.cascade_response_grid(chw, casc, window, meta,
                                           init_alive=valid)
    h2, a2, w2 = (x[0] for x in cascade_dense(chw[None], casc, meta, valid,
                                              window, tile=(32, 128)))
    a1, a2 = np.asarray(a1), np.asarray(a2)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(np.asarray(h1)[a1], np.asarray(h2)[a2],
                               rtol=1e-6, atol=1e-6)
    assert int(w1) == int(w2)


def test_pallas_tile_early_exit_counts():
    """A cascade whose first stage rejects everything: n_weak must equal one
    evaluation per initially-alive window (tile early exit does not change
    the monotone-rejection count)."""
    rng = np.random.RandomState(1)
    window = (6, 6)
    C = 2
    X = rng.randn(40, 140, C).astype("f")
    stages = [random_stage(rng, window, C, "stump") for _ in range(5)]
    thetas = [1e9] + [-np.inf] * 4  # stage 0 rejects all
    casc, meta = cop.cascade_from_stages(stages, thetas)
    chw = jnp.transpose(jnp.asarray(X), (2, 0, 1))
    valid = jnp.ones((34, 134), bool)
    h, a, w = (x[0] for x in cascade_dense(chw[None], casc, meta, valid,
                                           window, tile=(16, 128)))
    assert not np.asarray(a).any()
    assert int(w) == 34 * 134  # one weak eval per window, then tile exits
