"""Example: exponential curve fitting (the Ceres benchmark problem).

Equivalent user code to the reference's curve-fitting test: a user-defined
residual model driven through the LM solver.

    python -m moptimizer_0_tpu_torch.examples.curve_fitting
"""

import torch

from moptimizer_0_tpu_torch import LMConfig, Status, levenberg_marquardt
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_0_tpu_torch.utils.device import require
from moptimizer_0_tpu_torch.utils.logging import format_trace


def residual(x, d):
    # one observation d = (x_i, y_i); model y = exp(m·x + c)
    return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])


def main(device="cuda", dtype=torch.float32):
    """Fit the curve on ``device``; returns the LMResult."""
    dev = require(device)
    blk = make_block(residual, data=torch.as_tensor(CERES_CURVE_DATA, dtype=dtype, device=dev))
    res = levenberg_marquardt(problem(blk), torch.zeros(2, dtype=dtype, device=dev), LMConfig())
    print(f"x = {res.x.tolist()}  status = {Status(int(res.status)).name}  "
          f"iterations = {int(res.iterations)}  cost = {float(res.cost):.6f}")
    print(format_trace(res))
    return res


if __name__ == "__main__":
    main()
