"""Numeric checks of a linearization, for development and triage.

PyTorch counterpart of ``moptimizer_0_tpu.utils.checks``. The solver maps a
NaN trial cost to ``Status.NUMERIC_ERROR`` as the reference does; when a
model gives NaN at the start, ``checked_linearize`` says which output went
non-finite instead. It reads the device once, so it is a development tool
and never on the solver's path.
"""

import torch

from moptimizer_0_tpu_torch.core.linearize import linearize
from moptimizer_0_tpu_torch.core.residual import Problem


def checked_linearize(problem, x, mode="auto"):
    """``linearize`` that raises ValueError naming the first non-finite
    output (cost, then H, then b), in the JAX package's words::

        cost, H, b = checked_linearize(problem, x)   # raises if NaN/Inf
    """
    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    cost, H, b = linearize(problem, x, mode=mode)
    flags = torch.stack([
        torch.isfinite(cost).to(cost.dtype), torch.isfinite(H).all().to(cost.dtype),
        torch.isfinite(b).all().to(cost.dtype), cost, torch.max(torch.abs(H)), torch.max(torch.abs(b)),
    ]).tolist()
    cost_ok, H_ok, b_ok, c, max_H, max_b = flags
    if not cost_ok:
        raise ValueError(f"non-finite cost {c} in linearize")
    if not H_ok:
        raise ValueError(f"non-finite Hessian entries (max |H| = {max_H})")
    if not b_ok:
        raise ValueError(f"non-finite gradient entries (max |b| = {max_b})")
    return cost, H, b
