"""The port's trajectory metrics (``evaluation.py``) against the JAX
package's, float64 on the same numpy inputs, to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import evaluation as J
from moptimizer_0_tpu.lie import so3 as jso3
from moptimizer_0_tpu_torch import evaluation as P


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("reflect", [False, True], ids=["rotation", "reflection"])
def test_umeyama_matches_jax(with_scale, reflect):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 3))
    R = np.asarray(jso3.exp(jnp.array([0.3, -0.2, 0.5])))
    tgt = 1.7 * src @ R.T + np.array([1.0, -2.0, 0.5]) + 0.01 * rng.normal(size=src.shape)
    if reflect:  # det(U)·det(Vᵀ) < 0: the closest rotation, not a reflection
        tgt[:, 2] *= -1
    j = J.umeyama_alignment(jnp.asarray(src), jnp.asarray(tgt), with_scale=with_scale)
    t = P.umeyama_alignment(torch.as_tensor(src), torch.as_tensor(tgt), with_scale=with_scale)
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-12, atol=1e-12)
    assert np.linalg.det(t[1].numpy()) > 0


def test_umeyama_recovers_a_transform():
    rng = np.random.default_rng(1)
    src = torch.as_tensor(rng.normal(size=(100, 3)))
    R = torch.as_tensor(np.asarray(jso3.exp(jnp.array([0.1, 0.4, -0.3]))))
    t = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    s, R_est, t_est = P.umeyama_alignment(src, src @ R.T + t)
    np.testing.assert_allclose(R_est.numpy(), R.numpy(), atol=1e-10)
    np.testing.assert_allclose(t_est.numpy(), t.numpy(), atol=1e-10)
    assert float(s) == 1.0


@pytest.mark.parametrize("cols", [3, 6])
@pytest.mark.parametrize("align,with_scale", [(False, False), (True, False), (True, True)])
def test_ate_rmse_matches_jax(cols, align, with_scale):
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(50, cols))
    est = gt + 0.05 * rng.normal(size=gt.shape)
    est[:, :3] = 1.1 * est[:, :3] @ np.asarray(jso3.exp(jnp.array([0.0, 0.0, 0.2]))).T + 0.3
    j = J.ate_rmse(jnp.asarray(est), jnp.asarray(gt), align=align, with_scale=with_scale)
    t = P.ate_rmse(torch.as_tensor(est), torch.as_tensor(gt), align=align, with_scale=with_scale)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-12)


def test_ate_is_zero_for_an_identical_trajectory():
    traj = torch.as_tensor(np.random.default_rng(3).normal(size=(30, 3)))
    assert float(P.ate_rmse(traj, traj, align=False)) < 1e-12
    assert float(P.ate_rmse(traj + 5.0, traj, align=True)) < 1e-10


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(delta):
    rng = np.random.default_rng(4)
    gt = 0.3 * rng.normal(size=(20, 6))
    est = gt + 0.01 * rng.normal(size=gt.shape)
    j = J.rpe(jnp.asarray(est), jnp.asarray(gt), delta=delta)
    t = P.rpe(torch.as_tensor(est), torch.as_tensor(gt), delta=delta)
    for a, b in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12)
    zero = P.rpe(torch.as_tensor(gt), torch.as_tensor(gt), delta=delta)
    assert float(zero[0]) < 1e-12 and float(zero[1]) < 1e-7
