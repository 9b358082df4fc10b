"""Parameter covariance from the converged Gauss-Newton system.

PyTorch counterpart of ``moptimizer_0_tpu.core.covariance``:
Cov(x) ≈ H⁻¹ = (Σᵢ JᵢᵀΣJᵢ)⁻¹ at the solution.
"""

import torch
import torch.utils._pytree as pytree

from moptimizer_0_tpu_torch.core.linearize import _blocks_of, _split_valid, linearize


def _n_residuals(block, x):
    """N·O of a block: N from its data's leading axis (1 without data), O
    from one residual evaluated on the first row."""
    state = block.prepare_fn(x)
    if block.data is None:
        return _split_valid(block.residual_fn(state, None))[0].numel()
    n = pytree.tree_leaves(block.data)[0].shape[0]
    row = pytree.tree_map(lambda v: v[0], block.data)
    return n * _split_valid(block.residual_fn(state, row))[0].numel()


def estimate_covariance(problem, x, mode="auto", scale_by_residual=False):
    """Posterior covariance of the parameters at x.

    scale_by_residual: multiply by the residual variance
    s² = cost / max(n_residuals − n_params, 1).
    A singular H gives NaN (``inv_ex``): no exception and no host read.
    """
    cost, H, _ = linearize(problem, x, mode=mode)
    inv, info = torch.linalg.inv_ex(H)
    cov = torch.where(info != 0, torch.full_like(inv, torch.nan), inv)
    if scale_by_residual:
        n_res = sum(_n_residuals(blk, x) for blk in _blocks_of(problem))
        cov = cov * (cost / max(n_res - x.shape[0], 1))
    return cov
