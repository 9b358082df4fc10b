"""Generalized ICP (plane-to-plane) registration block.

PyTorch counterpart of ``moptimizer_0_tpu.models.gicp``: each
correspondence is weighted by the information of the combined local surface
models, Ω_i = (C_qᵢ + R C_sᵢ Rᵀ + 1e-9·I)⁻¹, from per-point covariances
(``ops.surface.gicp_covariances``). Ω is a ``weight_fn``, evaluated at every
linearization and cost with the current rotation; the cost is Σ rᵀΩr
(``weighted_cost``). The inverse is ``inv_ex``: it never reads the device,
and a singular matrix gives what XLA gives, not an exception.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import se3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    r = warped - d["matched"]
    if "valid" in d:
        return r, d["valid"]
    return r


def _weight(T, d):
    R = T[:3, :3]
    C = d["matched_cov"] + R @ d["src_cov"] @ R.T
    return torch.linalg.inv_ex(C + 1e-9 * torch.eye(3, dtype=C.dtype, device=C.device))[0]


def gicp_block(src, matched, src_cov, matched_cov, *, loss=None, update_fn=None, valid=None):
    """GICP block over matched pairs src[i] ↔ matched[i] with per-point
    covariances (N, 3, 3). ``registration.gicp`` drives the matching."""
    data = dict(
        src=torch.as_tensor(src),
        matched=torch.as_tensor(matched),
        src_cov=torch.as_tensor(src_cov),
        matched_cov=torch.as_tensor(matched_cov),
    )
    if valid is not None:
        data["valid"] = torch.as_tensor(valid)
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        weight_fn=_weight,
        loss=loss,
        update_fn=update_fn,
        weighted_cost=True,
        name="gicp",
    )
