"""Accelerometer gravity-alignment residual.

PyTorch counterpart of ``moptimizer_0_tpu.models.accelerometer``: state
x ∈ R³ (rotation vector), r = m − R(x)·g with g = (0, 0, 9.81). The analytic
Jacobian is the JAX package's, +[R·g]ₓ·J_l(x) with the full left Jacobian:
the true ∂r/∂x, where the C++ reference fills its negative.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import so3
from moptimizer_0_tpu_torch.utils.device import as_float64 as _as_float64

GRAVITY = (0.0, 0.0, 9.81)


def _prepare(x):
    return dict(x=x, R=so3.exp(x))


def _make_residual(measurement, gravity):
    def residual(state, _):
        R = state["R"]
        return measurement.to(R.dtype) - R @ gravity.to(R.dtype)

    return residual


def _make_jacobian(gravity):
    def jacobian(state, _):
        # ∂r/∂x = −∂(R·g)/∂x = +[R·g]ₓ·J_l(x)
        R = state["R"]
        return so3.hat(R @ gravity.to(R.dtype)) @ so3.left_jacobian(state["x"])

    return jacobian


def accelerometer_block(measurement, *, gravity=GRAVITY, analytic=False):
    """The block of one measurement m (3,); gravity lands on m's device."""
    measurement = _as_float64(measurement)
    gravity = torch.as_tensor(gravity, dtype=measurement.dtype, device=measurement.device)
    return make_block(
        _make_residual(measurement, gravity),
        data=None,
        prepare_fn=_prepare,
        jacobian_fn=_make_jacobian(gravity) if analytic else None,
        name="accelerometer",
    )
