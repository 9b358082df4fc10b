"""Point-to-point registration residual (the ICP core).

State x ∈ R⁶ ([t, ω]), prepared into a 4×4 transform; residual
r_i = T·src_i − tgt_i; analytic Jacobian J_i = [I₃ | −[src_i]ₓ].
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import se3, so3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, data_i):
    src, tgt = data_i["src"], data_i["tgt"]
    warped = T[:3, :3] @ src + T[:3, 3]
    return warped - tgt


def _jacobian(T, data_i):
    """J = [I₃ | −[src]ₓ]: the warped-source derivative at x = 0."""
    src = data_i["src"]
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    return torch.cat([eye, -so3.hat(src)], dim=-1)


def point2point_block(
    src, tgt, *, analytic=False, fused=True, loss=None, weight_matrix=None, update_fn=None
):
    """Block over N index-aligned correspondences src[i] ↔ tgt[i].

    ``fused=True`` (identity Σ only) linearizes through the closed-form
    moments of ``ops.icp_linearize`` for mode="auto", with no (N, 3, 6)
    Jacobian tensor.
    """
    linearize_fn = None
    if fused and weight_matrix is None:
        from moptimizer_0_tpu_torch.ops.icp_linearize import fused_point2point_linearizer

        linearize_fn = fused_point2point_linearizer
    data = dict(src=torch.as_tensor(src), tgt=torch.as_tensor(tgt))
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        weight_matrix=weight_matrix,
        update_fn=update_fn,
        linearize_fn=linearize_fn,
        name="point2point",
    )
