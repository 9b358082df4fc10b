"""The port's float32 accuracy envelope: tests/test_f32_envelope.py's
oracles solved by the port in float32 on the CPU, each held to the bound
that file pins for the JAX package (see its table for why each bound is
what it is): the curve fit ±5e-5 (±1e-4 from the far start), Powell ±1e-2,
the rational model ±0.01 from both starts, the camera ±2e-3 from the Ceres
solution, point-to-point ICP on the fachada scan ±2e-3, the accelerometer
to a cost below 1e-6 with λ₀ = 1e-6; and the mixed cases (float32 models,
``accum_dtype=torch.float64``) to the reference's own bounds: Powell ±5e-5,
the camera ±5e-5, the accelerometer below 1e-9 with the reference's λ₀.

``test_mixed_requires_x64_guard`` is not mirrored: it checks JAX's x64
switch, and torch has float64 without one.

``chip_smoke.py`` holds the same problems to the same bounds on the card.
"""

import numpy as np
import torch

from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.models.accelerometer import GRAVITY, accelerometer_block
from moptimizer_0_tpu_torch.models.camera import camera_reprojection_block
from moptimizer_0_tpu_torch.models.curve_fitting import exponential_curve_block
from moptimizer_0_tpu_torch.models.point2point import point2point_block
from moptimizer_0_tpu_torch.models.powell import powell_block
from moptimizer_0_tpu_torch.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

from test_camera_calibration import PIXELS, POINTS

# tests/test_f32_envelope.py's Ceres solution of the float32 camera fixture
CERES_F32 = np.array([-0.010075, 0.020714, -0.058274, 0.018369, -0.001367, 0.027415])
F32 = torch.float32


def _solve(block, x0, **cfg_kwargs):
    cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", **cfg_kwargs)
    res = levenberg_marquardt(block, torch.as_tensor(np.asarray(x0), dtype=F32), cfg)
    assert res.x.dtype == F32  # the solve really ran in float32
    return res


def _solve_mixed(block, x0, **cfg_kwargs):
    res = _solve(block, x0, accum_dtype=torch.float64, **cfg_kwargs)
    assert res.cost.dtype == torch.float64  # the reductions ran wide
    return res


def _camera_block():
    return camera_reprojection_block(torch.as_tensor(POINTS, dtype=F32), torch.as_tensor(PIXELS, dtype=F32))


def _accelerometer_measurement():
    return so3.exp(torch.tensor([0.15, -0.1, 0.2], dtype=F32)) @ torch.tensor(GRAVITY, dtype=F32)


def test_curve_fitting_f32_holds_reference_tolerance():
    res = _solve(exponential_curve_block(dtype=F32), np.zeros(2))
    np.testing.assert_allclose(res.x.numpy(), [0.291861, 0.131439], atol=5e-5)


def test_curve_fitting_f32_bad_start():
    res = _solve(exponential_curve_block(dtype=F32), np.array([1.2, 2.0]), max_iterations=50)
    np.testing.assert_allclose(res.x.numpy(), [0.291861, 0.131439], atol=1e-4)


def test_powell_f32():
    res = _solve(powell_block(analytic=True), np.array([3.0, -1.0, 0.0, 4.0]), max_iterations=25)
    np.testing.assert_allclose(res.x.numpy(), np.zeros(4), atol=1e-2)


def test_simple_rational_f32_holds_reference_tolerance():
    blk = rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=F32)
    for x0 in ([0.9, 0.2], [1.9, 1.5]):
        res = _solve(blk, np.array(x0))
        np.testing.assert_allclose(res.x.numpy(), [0.362, 0.556], atol=0.01)


def test_camera_calibration_f32():
    res = _solve(_camera_block(), np.zeros(6))
    np.testing.assert_allclose(res.x.numpy(), CERES_F32, atol=2e-3)


def test_point2point_f32():
    src = torch.as_tensor(load_txt_cloud("tests/data/fachada.txt"), dtype=F32)
    x_true = np.array([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], np.float32)
    T = se3.transform_from_params6(torch.as_tensor(x_true))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    res = _solve(point2point_block(src, tgt), np.zeros(6), max_iterations=15)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=2e-3)


def test_accelerometer_f32():
    res = _solve(accelerometer_block(_accelerometer_measurement()), np.array([0.1, 0.0, 0.0]),
                 init_lambda_factor=1e-6)
    assert float(res.cost) < 1e-6


def test_powell_mixed_recovers_reference_tolerance():
    res = _solve_mixed(powell_block(analytic=True), np.array([3.0, -1.0, 0.0, 4.0]), max_iterations=25)
    np.testing.assert_allclose(res.x.numpy(), np.zeros(4), atol=5e-5)


def test_camera_calibration_mixed_recovers_reference_tolerance():
    res = _solve_mixed(_camera_block(), np.zeros(6))
    np.testing.assert_allclose(res.x.numpy(), CERES_F32, atol=5e-5)


def test_accelerometer_mixed_reference_lambda_seed():
    res = _solve_mixed(accelerometer_block(_accelerometer_measurement(), analytic=True), np.array([0.1, 0.0, 0.0]))
    assert float(res.cost) < 1e-9
