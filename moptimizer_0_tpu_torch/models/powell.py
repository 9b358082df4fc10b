"""Powell's singular function.

PyTorch counterpart of ``moptimizer_0_tpu.models.powell``:

    f1 = x1 + 10 x2
    f2 = √5 (x3 − x4)
    f3 = (x2 − 2 x3)²
    f4 = √10 (x1 − x4)²

One 4-dim residual over the whole 4-dim state (data=None, N=1); minimum 0 at
the origin. The analytic Jacobian is the true one (the JAX package's default,
not the C++ reference's fill with its sign slip in ∂f3).
"""

import math

import torch

from moptimizer_0_tpu_torch.core.residual import make_block

_S5 = math.sqrt(5.0)
_S10 = math.sqrt(10.0)


def _residual(x, _):
    # (1,) slices, never 0-dim entries: forward AD turns the tangent of a
    # 0-dim float32 tensor scaled by a Python float into float64
    x0, x1, x2, x3 = x[0:1], x[1:2], x[2:3], x[3:4]
    return torch.cat(
        [
            x0 + 10.0 * x1,
            _S5 * (x2 - x3),
            (x1 - 2.0 * x2) ** 2,
            _S10 * (x0 - x3) ** 2,
        ]
    )


def _jacobian(x, _):
    z = torch.zeros_like(x[0])
    return torch.stack(
        [
            torch.stack([1.0 + z, 10.0 + z, z, z]),
            torch.stack([z, z, _S5 + z, -_S5 + z]),
            torch.stack([z, 2.0 * (x[1] - 2.0 * x[2]), -4.0 * (x[1] - 2.0 * x[2]), z]),
            torch.stack([_S10 * 2.0 * (x[0] - x[3]), z, z, -_S10 * 2.0 * (x[0] - x[3])]),
        ]
    )


def powell_block(*, analytic=False, weight_matrix=None):
    return make_block(
        _residual,
        data=None,
        jacobian_fn=_jacobian if analytic else None,
        weight_matrix=weight_matrix,
        name="powell",
    )
