"""SE(3) helpers and the 6-DoF parameterization x = [tx ty tz wx wy wz].

PyTorch counterpart of ``moptimizer_0_tpu.lie.se3``: translation stored
directly and rotation through so3 exp (the product manifold R³ × SO(3)),
plus the true SE(3) exp/log.
"""

import torch

from moptimizer_0_tpu_torch.lie import so3


def _assemble_rt(R, t):
    """[[R, t], [0, 0, 0, 1]]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    one = torch.ones_like(t[..., :1])
    zero = torch.zeros_like(t)
    bottom = torch.cat([zero, one], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def transform_from_params6(x):
    """x = [tx ty tz wx wy wz] → 4×4 transform: t = x[:3], R = so3.exp(x[3:6])."""
    R = so3.exp(x[..., 3:6])
    t = x[..., 0:3]
    return _assemble_rt(R, t)


def rotation_from_params3(x):
    """x = [wx wy wz] → 3×3 rotation: so3.exp(x[:3])."""
    return so3.exp(x[..., 0:3])


def apply_transform(T, points):
    """Apply a 4×4 transform to (..., N, 3) points: R·p + t."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]


def se3_exp(xi):
    """True SE(3) exponential. xi = [rho(3), w(3)] → 4×4 transform, t = J_l(w)·rho."""
    rho, w = xi[..., 0:3], xi[..., 3:6]
    R = so3.exp(w)
    t = torch.einsum("...ij,...j->...i", so3.left_jacobian(w), rho)
    return _assemble_rt(R, t)


def se3_log(T):
    """True SE(3) logarithm: inverse of `se3_exp`."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3.log(R)
    rho = torch.einsum("...ij,...j->...i", so3.inverse_left_jacobian(w), t)
    return torch.cat([rho, w], dim=-1)
