"""Rational "simple model": r_i = y_i − (a·x_i)/(b + x_i).

PyTorch counterpart of ``moptimizer_0_tpu.models.rational``: converged
minimum (0.362, 0.556) on the 7-point dataset below, with the analytic
Jacobian in the row-major convention of the reference.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block


def _residual(x, data_i):
    xd, yd = data_i[0], data_i[1]
    return torch.stack([yd - (x[0] * xd) / (x[1] + xd)])


def _jacobian(x, data_i):
    xd = data_i[0]
    denom = x[1] + xd
    return torch.stack([torch.stack([-xd / denom, (x[0] * xd) / (denom * denom)])])


def rational_block(x_data, y_data, *, analytic=False, loss=None, weight_matrix=None, dtype=None):
    data = torch.stack(
        [torch.as_tensor(x_data, dtype=dtype), torch.as_tensor(y_data, dtype=dtype)], dim=-1
    )
    return make_block(
        _residual,
        data=data,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        weight_matrix=weight_matrix,
        name="rational",
    )


# The reference's 7-point dataset.
SIMPLE_X = [0.038, 0.194, 0.425, 0.626, 1.253, 2.5, 3.70]
SIMPLE_Y = [0.05, 0.127, 0.094, 0.2122, 0.2729, 0.2665, 0.3317]
