"""The port's blocked Cholesky recursion (``ops/block_cholesky.py``) against
the JAX package's, on the SPD inputs of ``tests/test_block_cholesky.py``
(float64 on the CPU, built in numpy and carried across).

Tolerances and why: the factor and L⁻¹ to 1e-10 absolute of JAX's (and
L⁻¹·L to I at 1e-10), the solves to 1e-10: the bounds of
``tests/test_block_cholesky.py``, which holds the recursion to
``jnp.linalg.cholesky``; both packages factor the same base blocks with
LAPACK and form the same panels, in other summation orders. The dense BA
with ``schur_solver="blocked"``: cameras to 1e-8 of the port's
``"auto"`` solve, the trace's costs over the common iterations to 1e-9 and
the final cost to 1e-10 relative (that file's bounds for JAX's own pair);
the landmark-sharded dense BA with "blocked" to the same camera bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu.ops import block_cholesky as jbc
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch.ops import block_cholesky as tbc
from moptimizer_0_tpu_torch.parallel import make_mesh

from test_ba import make_synthetic_ba
from test_block_cholesky import make_spd
from test_torch_ba_dense import port


@pytest.mark.parametrize("n", [16, 64, 300, 700])
def test_factor_and_inverse_match_jax(n):
    A = np.array(make_spd(n, seed=n))
    L_j, iL_j = jbc.blocked_cholesky_and_inverse(jnp.asarray(A), base=128)
    L, iL = tbc.blocked_cholesky_and_inverse(torch.as_tensor(A), base=128)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(iL.numpy(), np.asarray(iL_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose((iL @ L).numpy(), np.eye(n), rtol=0, atol=1e-10)
    assert np.all(np.triu(L.numpy(), 1) == 0) and np.all(np.triu(iL.numpy(), 1) == 0)
    assert torch.equal(tbc.blocked_cholesky(torch.as_tensor(A), base=128), L)


@pytest.mark.parametrize("n", [64, 300])
def test_spd_solve_paths_agree(n):
    A = np.array(make_spd(n, seed=n + 1))
    b = np.random.default_rng(7).standard_normal(n)
    x_j = np.asarray(jbc.spd_solve_blocked(jnp.asarray(A), jnp.asarray(b), base=128))
    x_ref = np.linalg.solve(A, b)
    for method in ("xla", "blocked", "auto"):
        x = tbc.spd_solve(torch.as_tensor(A), torch.as_tensor(b), method=method, base=128)
        np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-10)
        np.testing.assert_allclose(x.numpy(), x_j, atol=1e-10)
    with pytest.raises(ValueError):
        tbc.spd_solve(torch.as_tensor(A), torch.as_tensor(b), method="nope")


def test_split_points_equal_jax():
    for base in (128, 256):
        for n in range(base + 1, 4096, 257):
            assert tbc._split_point(n, base) == jbc._split_point(n, base)


def test_non_pd_gives_nan():
    A = np.array(make_spd(300, seed=3))
    A[200, 200] = -1.0  # in the second half: the recursion's trailing block
    L_j = np.asarray(jbc.blocked_cholesky(jnp.asarray(A), base=128))
    assert np.isnan(L_j).any()
    x = tbc.spd_solve(torch.as_tensor(A), torch.ones(300, dtype=torch.float64), method="blocked", base=128)
    assert torch.isnan(x).all()


def test_dense_ba_blocked_solver_matches_auto():
    start, _ = make_synthetic_ba(C=8, L=60, noise=0.5, seed=11)
    prob = port(start)
    res_a = tbd.solve_ba_dense(prob, tbd.DenseBAConfig(schur_solver="auto"))
    res_b = tbd.solve_ba_dense(prob, tbd.DenseBAConfig(schur_solver="blocked"))
    ref = jbd.solve_ba_dense(start, jbd.DenseBAConfig(schur_solver="blocked"))
    np.testing.assert_allclose(res_b.camera_params.numpy(), res_a.camera_params.numpy(), atol=1e-8)
    np.testing.assert_allclose(res_b.camera_params.numpy(), np.asarray(ref.camera_params), atol=1e-8)
    n = min(int(res_a.iterations), int(res_b.iterations))
    np.testing.assert_allclose(res_b.trace["cost"][:n].numpy(), res_a.trace["cost"][:n].numpy(), rtol=1e-9)
    np.testing.assert_allclose(float(res_b.cost), float(res_a.cost), rtol=1e-10)
    res_s = tbd.solve_ba_dense_sharded(prob, make_mesh(2, device="cpu"), tbd.DenseBAConfig(schur_solver="blocked"))
    np.testing.assert_allclose(res_s.camera_params.numpy(), res_a.camera_params.numpy(), atol=1e-8)
