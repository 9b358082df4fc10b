"""moptimizer_0_tpu_torch.lie against moptimizer_0_tpu.lie on the same inputs.

Inputs are made with numpy from a seed and cover ordinary angles, θ < 1e-5
(the Taylor branches) and θ within 1e-6 of π (the log's hard end). float64
throughout: rtol 1e-12, with atol 1e-14 for entries that cancel to ~0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.lie import so3 as jso3
from moptimizer_0_tpu_torch.lie import se3 as tse3
from moptimizer_0_tpu_torch.lie import so3 as tso3

RTOL, ATOL = 1e-12, 1e-14


def _rotvecs(seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate(
        [
            rng.uniform(0.1, 3.0, 4),  # ordinary
            [0.0, 1e-9, 3e-7, 9e-6],  # Taylor branches
            [np.pi, np.pi - 1e-6, np.pi - 1e-9, np.pi - 1e-3],  # near a half-turn
        ]
    )
    return axes * angles[:, None]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "name",
    [
        "hat",
        "exp",
        "left_jacobian",
        "right_jacobian",
        "inverse_left_jacobian",
        "inverse_right_jacobian",
    ],
)
def test_so3_vector_functions_match_jax(name):
    w = _rotvecs()
    _close(getattr(tso3, name)(torch.as_tensor(w)), getattr(jso3, name)(jnp.asarray(w)))


def test_so3_vee_and_log_match_jax():
    w = _rotvecs(1)
    R = np.array(jso3.exp(jnp.asarray(w)))
    _close(tso3.vee(torch.as_tensor(R)), jso3.vee(jnp.asarray(R)))
    _close(tso3.log(torch.as_tensor(R)), jso3.log(jnp.asarray(R)))


def test_so3_exp_jacobian_is_finite_at_zero_and_matches_jax():
    """jacfwd goes through exp's Taylor branch at θ = 0 (the _safe_theta clamp)."""
    for w in (np.zeros(3), np.array([1e-8, -2e-8, 3e-9]), np.array([0.3, -0.2, 0.1])):
        jt = torch.func.jacfwd(tso3.exp)(torch.as_tensor(w))
        jj = jax.jacfwd(jso3.exp)(jnp.asarray(w))
        assert torch.isfinite(jt).all()
        _close(jt, jj)


def test_se3_functions_match_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=(12, 3)), _rotvecs(3)], axis=1)
    pts = rng.normal(size=(12, 5, 3))
    T = np.array(jse3.transform_from_params6(jnp.asarray(x)))
    _close(tse3.transform_from_params6(torch.as_tensor(x)), T)
    _close(
        tse3.apply_transform(torch.as_tensor(T), torch.as_tensor(pts)),
        jse3.apply_transform(jnp.asarray(T), jnp.asarray(pts)),
    )
    _close(tse3.se3_exp(torch.as_tensor(x)), jse3.se3_exp(jnp.asarray(x)))
    Te = np.array(jse3.se3_exp(jnp.asarray(x)))
    _close(tse3.se3_log(torch.as_tensor(Te)), jse3.se3_log(jnp.asarray(Te)))


def test_exp_dt_matches_jax():
    """so3.exp_dt(ω, dt) = exp(ω·dt) for one and for a batch of dt, through
    the Taylor branch too, and forward AD in dt stays finite at ω·dt = 0."""
    w = _rotvecs(3)
    for dt in (0.01, 1e-7, np.linspace(0.0, 0.2, 12)):
        _close(tso3.exp_dt(torch.as_tensor(w), dt), jso3.exp_dt(jnp.asarray(w), dt))
    jac = torch.func.jacfwd(lambda t: tso3.exp_dt(torch.as_tensor(w[4]), t))(torch.tensor(0.0, dtype=torch.float64))
    assert torch.isfinite(jac).all()
    _close(jac, jax.jacfwd(lambda t: jso3.exp_dt(jnp.asarray(w[4]), t))(0.0))


def test_rotation_from_params3_matches_jax():
    """lie.rotation_from_params3 (exported as in the JAX package) is exp of
    the three parameters, batched, through the Taylor branch and near π."""
    from moptimizer_0_tpu import lie as jlie
    from moptimizer_0_tpu_torch import lie as tlie

    w = _rotvecs(4)
    _close(tlie.rotation_from_params3(torch.as_tensor(w)), jlie.rotation_from_params3(jnp.asarray(w)))
    _close(tse3.rotation_from_params3(torch.as_tensor(w[0])), jse3.rotation_from_params3(jnp.asarray(w[0])))
