"""Point-to-plane registration residual.

PyTorch counterpart of ``moptimizer_0_tpu.models.point2plane``:
r_i = nᵢ·(T·sᵢ − qᵢ) with the target normal nᵢ, one scalar per
correspondence, and the analytic Jacobian J = [nᵀ | (s × n)ᵀ] at identity.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import se3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    return torch.dot(d["normal"], warped - d["tgt"])[None]


def _jacobian(T, d):
    s, nrm = d["src"], d["normal"]
    return torch.cat([nrm, torch.linalg.cross(s, nrm)])[None, :]


def point2plane_block(src, tgt, normals, *, analytic=False, loss=None, update_fn=None):
    data = dict(src=torch.as_tensor(src), tgt=torch.as_tensor(tgt), normal=torch.as_tensor(normals))
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        update_fn=update_fn,
        name="point2plane",
    )
