"""Differentiable Lie-group utilities (SO(3), SE(3)) for float32/float64 tensors."""

from moptimizer_0_tpu_torch.lie.so3 import (
    hat,
    vee,
    exp as so3_exp,
    log as so3_log,
    left_jacobian,
    right_jacobian,
    inverse_left_jacobian,
    inverse_right_jacobian,
)
from moptimizer_0_tpu_torch.lie.se3 import (
    transform_from_params6,
    rotation_from_params3,
    se3_exp,
    se3_log,
    apply_transform,
)
