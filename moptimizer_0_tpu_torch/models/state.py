"""15-DoF composite-state residual: SO(3) × R¹² boxminus against an anchor.

PyTorch counterpart of ``moptimizer_0_tpu.models.state``: x ∈ R¹⁵ with x[:3]
a rotation vector and x[3:] linear; r = x ⊟ x₀, the rotation part
Log(R₀ᵀ·R(x)) and the linear part a plain difference.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import so3
from moptimizer_0_tpu_torch.utils.device import as_float64 as _as_float64


def _make_residual(anchor_rot, anchor_lin):
    def residual(x, _):
        R0 = anchor_rot.to(dtype=x.dtype, device=x.device)
        d_rot = so3.log(R0.T @ so3.exp(x[:3]))
        d_lin = x[3:] - anchor_lin.to(dtype=x.dtype, device=x.device)
        return torch.cat([d_rot, d_lin])

    return residual


def product_state_block(anchor_rotvec, anchor_lin):
    """anchor_rotvec: (3,) rotation vector of the anchor; anchor_lin: (12,)."""
    anchor_rot = so3.exp(_as_float64(anchor_rotvec))
    return make_block(
        _make_residual(anchor_rot, _as_float64(anchor_lin)),
        data=None,
        name="product_state",
    )
