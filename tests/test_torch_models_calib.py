"""The port's camera, accelerometer and state models and
``estimate_covariance`` against the JAX package's.

Float64 on the CPU, the same numpy inputs on both sides. Tolerances and why:

* residuals and Jacobians (AD, analytic): 1e-12 relative to the largest
  entry: the same closed forms in another evaluation order; forward
  differences 1e-5 (``FD_REL``);
* the camera calibration mirrors (tests/test_camera_calibration.py) keep
  its bound, 5e-5 from the pinned Ceres solution. With ``diff_mode="fd"``
  the steps h = √ε·|x_j| make each Jacobian column a difference of
  pixel-sized residuals over ~1e-10, so the two packages' columns differ at
  ~1e-4 relative and their iterations part: those solves are held to the
  Ceres bound and to JAX's status only; the AD solve is held to JAX's
  iterations and x (1e-9), stopping on ``rel_cost_tol`` before its noise
  floor;
* covariance: 1e-10 relative, as tests/test_utils.py holds the JAX one
  against numpy's inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu.core import linearize as jlin
from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.core.covariance import estimate_covariance as j_cov
from moptimizer_0_tpu.models import accelerometer as jacc
from moptimizer_0_tpu.models import camera as jcam
from moptimizer_0_tpu.models.powell import powell_block as j_powell
from moptimizer_0_tpu.models.rational import SIMPLE_X, SIMPLE_Y
from moptimizer_0_tpu.models.rational import rational_block as j_rational
from moptimizer_0_tpu.models.state import product_state_block as j_state
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core import linearize as tlin
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.core.covariance import estimate_covariance as t_cov
from moptimizer_0_tpu_torch.lie import so3
from moptimizer_0_tpu_torch.models import accelerometer as tacc
from moptimizer_0_tpu_torch.models import camera as tcam
from moptimizer_0_tpu_torch.models.powell import powell_block as t_powell
from moptimizer_0_tpu_torch.models.rational import rational_block as t_rational
from moptimizer_0_tpu_torch.models.state import product_state_block as t_state

from test_camera_calibration import CERES_SOLUTION, PIXELS, POINTS, TOLERANCE


# A forward-difference column is (r(x + h) − r(x))/h with h = √ε·|x_j|
# (√ε where x_j = 0): a last-bit difference of a residual becomes a
# difference of |r|·ε/h in the column. At the camera's pixel-sized residuals
# and |x_j| ~ 0.05 that is ~3e-6 of the largest entry: held to 1e-5.
FD_REL = 1e-5


# the JAX side under jit: one XLA compile each instead of one per primitive
_j_residuals = jax.jit(jlin._batched_residuals)
_j_jacobian_auto = jax.jit(jlin._jacobian_auto)
_j_jacobian_fd = jax.jit(jlin._jacobian_fd)
_j_linearize = jax.jit(jlin.linearize, static_argnames=("mode",))


def _close(t, j, rel=1e-12):
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * max(np.abs(j).max(), 1e-300))


def _blocks(name):
    """(port block, JAX block, x) of each model at a generic state."""
    rng = np.random.default_rng(11)
    if name == "camera":
        return (tcam.camera_reprojection_block(POINTS, PIXELS), jcam.camera_reprojection_block(POINTS, PIXELS),
                0.05 * rng.normal(size=6))
    if name == "accelerometer":
        m = np.array([0.4, -1.1, 9.7])
        return tacc.accelerometer_block(m, analytic=True), jacc.accelerometer_block(m, analytic=True), \
            np.array([0.15, -0.1, 0.2])
    anchor = (np.array([0.1, 0.2, 0.3]), rng.normal(size=12))
    return t_state(*anchor), j_state(*anchor), np.concatenate([[0.9, -0.8, 0.6], rng.normal(size=12)])


@pytest.mark.parametrize("name", ["camera", "accelerometer", "state"])
def test_model_residuals_and_jacobians_match_jax(name):
    tb, jb, x = _blocks(name)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    r_t, valid_t = tlin._batched_residuals(tb, xt)
    r_j, valid_j = _j_residuals(jb, xj)
    _close(r_t, r_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    _close(tlin._jacobian_auto(tb, xt), _j_jacobian_auto(jb, xj))
    _close(tlin._jacobian_fd(tb, xt, r_t), _j_jacobian_fd(jb, xj, r_j), rel=FD_REL)
    for mode in ("auto", "fd"):
        for tv, jv in zip(tlin.linearize(tb, xt, mode=mode), _j_linearize(jres.problem(jb), xj, mode=mode)):
            _close(tv, jv, rel=1e-12 if mode == "auto" else FD_REL)


def test_accelerometer_analytic_jacobian_has_the_jax_sign():
    """+[R·g]ₓ·J_l(x): equal to AD (the true ∂r/∂x) and to the JAX
    package's, not the C++ reference's negative."""
    tb, jb, x = _blocks("accelerometer")
    xt = torch.as_tensor(x)
    J_an = tlin._jacobian_analytic(tb, tb.prepare_fn(xt))
    J_ad = tlin._jacobian_auto(tb, xt)
    _close(J_an, J_ad)
    _close(J_an, jlin._jacobian_analytic(jb, jb.prepare_fn(jnp.asarray(x))))
    for tv, jv in zip(tlin.linearize(tb, xt, mode="analytic"),
                      jlin.linearize(jres.problem(jb), jnp.asarray(x), mode="analytic")):
        _close(tv, jv)
    assert tacc.GRAVITY == jacc.GRAVITY


def test_camera_defaults_match_jax():
    np.testing.assert_array_equal(tcam.DEFAULT_K, jcam.DEFAULT_K)
    np.testing.assert_array_equal(tcam.default_camera_laser_frame(), jcam.default_camera_laser_frame())


@pytest.mark.parametrize(
    "x0,iterations",
    [(np.zeros(6), 15), (np.array([0.5, 0.5, 0.5, 0.2, 0.5, 0.5]), 50)],
    ids=["good_weather", "bad_weather"],
)
def test_camera_calibration_fd(x0, iterations):
    """tests/test_camera_calibration.py's good and bad weather (fd)."""
    cfg = dict(diff_mode="fd", max_iterations=iterations)
    t = tsol.levenberg_marquardt(tcam.camera_reprojection_block(POINTS, PIXELS), torch.as_tensor(x0),
                                 tsol.LMConfig(**cfg))
    np.testing.assert_allclose(t.x.numpy(), CERES_SOLUTION, atol=TOLERANCE)
    j = jsol.levenberg_marquardt(jres.problem(jcam.camera_reprojection_block(POINTS, PIXELS)), jnp.asarray(x0),
                                 JLMConfig(**cfg))
    assert int(t.status) == int(j.status)


def test_camera_calibration_auto_diff():
    block = tcam.camera_reprojection_block(POINTS, PIXELS)
    t = tsol.levenberg_marquardt(block, torch.zeros(6, dtype=torch.float64), tsol.LMConfig(diff_mode="auto"))
    np.testing.assert_allclose(t.x.numpy(), CERES_SOLUTION, atol=TOLERANCE)
    cfg = dict(diff_mode="auto", rel_cost_tol=1e-10)
    t = tsol.levenberg_marquardt(block, torch.zeros(6, dtype=torch.float64), interop.config_from_fields(cfg))
    j = jsol.levenberg_marquardt(jres.problem(jcam.camera_reprojection_block(POINTS, PIXELS)), jnp.zeros(6),
                                 JLMConfig(**cfg))
    assert int(t.status) == int(j.status) and int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)


def test_state_model_lm_matches_jax():
    """The 15-DoF boxminus state from the golden trace's start, by AD."""
    anchor_lin = np.concatenate([[-0.4, 0.11, -0.9], np.zeros(9)])
    x0 = np.concatenate([[0.9, -0.8, 0.6, 1.5, -2.0, 0.5], np.zeros(9)])
    cfg = dict(diff_mode="auto", max_iterations=10, rel_cost_tol=1e-10)
    t = tsol.levenberg_marquardt(t_state([0.1, 0.2, 0.3], anchor_lin), torch.as_tensor(x0),
                                 interop.config_from_fields(cfg))
    j = jsol.levenberg_marquardt(jres.problem(j_state(np.array([0.1, 0.2, 0.3]), anchor_lin)), jnp.asarray(x0),
                                 JLMConfig(**cfg))
    assert int(t.status) == int(j.status) and int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(so3.exp(t.x[:3]).numpy(), so3.exp(torch.tensor([0.1, 0.2, 0.3],
                               dtype=torch.float64)).numpy(), atol=1e-9)


def test_covariance_matches_jax():
    """tests/test_utils.py's rational fit: H⁻¹ at the solution, and the
    residual-variance-scaled covariance, against the JAX package's."""
    jb = j_rational(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    tb = t_rational(SIMPLE_X, SIMPLE_Y, dtype=torch.float64)
    x = jsol.levenberg_marquardt(jres.problem(jb), jnp.array([0.9, 0.2]), JLMConfig()).x
    xt = torch.as_tensor(np.array(x))
    tb_rat4 = tres.make_block(lambda x4, d: torch.stack([d[1] - x4[0] * d[0] / (x4[1] + d[0])]),
                              data=tb.data)
    jb_rat4 = jres.make_block(lambda x4, d: jnp.array([d[1] - x4[0] * d[0] / (x4[1] + d[0])]),
                              data=jb.data)
    cov = t_cov(tres.problem(tb), xt)
    _, H, _ = tlin.linearize(tres.problem(tb), xt)
    np.testing.assert_allclose(cov.numpy(), np.linalg.inv(H.numpy()), rtol=1e-10)
    np.testing.assert_allclose(cov.numpy(), np.asarray(j_cov(jres.problem(jb), x)), rtol=1e-10)
    cov_s = t_cov(tres.problem(tb), xt, scale_by_residual=True)
    np.testing.assert_allclose(cov_s.numpy(), np.asarray(j_cov(jres.problem(jb), x, scale_by_residual=True)),
                               rtol=1e-10)
    assert np.all(np.linalg.eigvalsh(cov_s.numpy()) > 0)
    # a block without data (one residual over the state) counts its width,
    # and a problem sums its blocks' counts
    x4 = np.array([3.0, -1.0, 0.5, 4.0])
    for tp, jp in ((t_powell(), j_powell()), (tres.problem(t_powell(), tb_rat4), jres.problem(j_powell(), jb_rat4))):
        np.testing.assert_allclose(
            t_cov(tp, torch.as_tensor(x4), scale_by_residual=True).numpy(),
            np.asarray(j_cov(jp, jnp.asarray(x4), scale_by_residual=True)), rtol=1e-10,
        )


def test_covariance_of_singular_system_is_nan():
    """A singular H (one parameter no residual sees) gives NaN, no raise."""
    block = tres.make_block(lambda x, d: torch.stack([d[0] - x[0]]), data=torch.ones(4, 1, dtype=torch.float64))
    cov = t_cov(block, torch.zeros(2, dtype=torch.float64))
    assert cov.shape == (2, 2) and torch.isnan(cov).all()
