"""The port's unrolled Cholesky solve against the JAX package's, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops.small_solve import cholesky_solve_unrolled as j_solve
from moptimizer_0_tpu_torch.ops.small_solve import cholesky_solve_unrolled


def _spd(rng, P, lanes=()):
    M = rng.normal(size=(*lanes, P, P))
    return M @ np.swapaxes(M, -1, -2) + P * np.eye(P)


@pytest.mark.parametrize("P", range(2, 16))
def test_unrolled_solve_matches_jax(P):
    """Same operations in the same order: equal to JAX to a few ulps, and
    the solution of the system."""
    rng = np.random.default_rng(P)
    A, b = _spd(rng, P), rng.normal(size=P)
    x = cholesky_solve_unrolled(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(j_solve(jnp.asarray(A), jnp.asarray(b))), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(A @ x, b, rtol=1e-10, atol=1e-12)


def test_unrolled_solve_over_lanes_equals_each_lane():
    rng = np.random.default_rng(20)
    A, b = _spd(rng, 6, (4, 3)), rng.normal(size=(4, 3, 6))
    x = cholesky_solve_unrolled(torch.as_tensor(A), torch.as_tensor(b))
    assert x.shape == (4, 3, 6)
    for i in range(4):
        for j in range(3):
            one = cholesky_solve_unrolled(torch.as_tensor(A[i, j]), torch.as_tensor(b[i, j]))
            torch.testing.assert_close(x[i, j], one, rtol=0, atol=0)


def test_unrolled_solve_nan_on_non_spd_and_refuses_large_p():
    A = np.diag([1.0, -2.0, 3.0])
    x = cholesky_solve_unrolled(torch.as_tensor(A), torch.ones(3, dtype=torch.float64))
    assert torch.isnan(x).any()
    assert np.isnan(np.asarray(j_solve(jnp.asarray(A), jnp.ones(3)))).any()
    with pytest.raises(ValueError, match="small static P"):
        cholesky_solve_unrolled(torch.eye(17), torch.ones(17))
