"""Linearization: residual and Jacobian evaluation, Gauss-Newton accumulation.

PyTorch counterpart of ``moptimizer_0_tpu.core.linearize``. The per-index
residual is batched with ``torch.func.vmap``; H and b are one matrix product
over the flattened (N·O) axis:

    H = Aᵀ B   with A = J as (N·O, P), B = (w ⊙ ΣJ) as (N·O, P)
    b = Aᵀ (w ⊙ Σr)

``linearize_batched``, ``compute_cost_batched`` and
``compute_block_costs_batched`` evaluate the same functions for every lane of
a (B, P) x with ``torch.func.vmap``, over each block's data too where that
block's data carries the lane axis.

Derivative modes:

* ``auto``     — forward-mode AD (``torch.func.jacfwd``) through
                 prepare_fn + residual_fn;
* ``analytic`` — the block's ``jacobian_fn``;
* ``fd``       — forward differences with h_j = √ε·|x_j| (√ε where x_j = 0),
                 J[:, j] = (r(x + h_j e_j) − r(x)) / h_j.

The loss weight and Σ enter H and b only; the cost is the unweighted
Σ_valid ‖r‖² unless the block sets ``weighted_cost``. The mask selects
(``torch.where``) where the JAX code multiplies by the cast mask, as XLA
does under jit: a masked row with a NaN residual adds 0, not NaN.
"""

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap

from moptimizer_0_tpu_torch.core.residual import Problem


def _blocks_of(block_or_problem):
    blocks = getattr(block_or_problem, "blocks", None)
    return (block_or_problem,) if blocks is None else blocks


def _as_dtype(dtype, default):
    """torch dtype from None (→ default), a torch dtype, or a numpy-style name."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _split_valid(out):
    if isinstance(out, tuple):
        r, valid = out
        return torch.atleast_1d(r), torch.as_tensor(valid, device=r.device).bool()
    r = torch.atleast_1d(out)
    return r, torch.ones((), dtype=torch.bool, device=r.device)


def _eval_residuals(block, state):
    """Evaluate all residuals. Returns (r, valid): (N, O) and (N,)."""
    if block.data is None:
        r, valid = _split_valid(block.residual_fn(state, None))
        return r[None, :], valid[None]
    return vmap(lambda d: _split_valid(block.residual_fn(state, d)))(block.data)


def _batched_residuals(block, x):
    """r(x) through prepare_fn → residual_fn, batched. (N, O), (N,)."""
    return _eval_residuals(block, block.prepare_fn(x))


def _per_residual_weights(block, state):
    return vmap(lambda d: block.weight_fn(state, d))(block.data)


def compute_cost(block_or_problem, x, accum_dtype=None):
    """Unweighted Σ_valid ‖r_i‖² over one block or a problem.

    accum_dtype: optional wider dtype for the reduction; residuals are still
    evaluated in x's dtype."""
    adt = _as_dtype(accum_dtype, x.dtype)
    total = torch.zeros((), dtype=adt, device=x.device)
    for block in _blocks_of(block_or_problem):
        r, valid = _batched_residuals(block, x)
        r = r.to(adt)
        if block.weighted_cost:
            if block.weight_fn is not None:
                Sigma = _per_residual_weights(block, block.prepare_fn(x)).to(adt)
                per = torch.einsum("no,noq,nq->n", r, Sigma, r)
            elif block.weight_matrix is not None:
                Sg = torch.as_tensor(block.weight_matrix, dtype=adt, device=x.device)
                if Sg.ndim == 3:
                    per = torch.einsum("no,noq,nq->n", r, Sg, r)
                else:
                    per = torch.einsum("no,oq,nq->n", r, Sg, r)
            else:
                per = torch.sum(r * r, dim=-1)
            total = total + torch.sum(torch.where(valid, per, 0.0))
        else:
            total = total + torch.sum(torch.where(valid, torch.sum(r * r, dim=-1), 0.0))
    return total


def compute_block_costs(block_or_problem, x, accum_dtype=None):
    """Per-block unweighted Σ‖r‖², stacked to (n_blocks,)."""
    return torch.stack([compute_cost(b, x, accum_dtype) for b in _blocks_of(block_or_problem)])


def _jacobian_fd(block, x, r0):
    """Forward differences, h_j = √ε·|x_j| floored at √ε; one full
    prepare_fn + residual_fn evaluation per column. (N, O, P)."""
    eps = torch.full((), torch.finfo(x.dtype).eps, dtype=x.dtype, device=x.device)
    min_step = torch.sqrt(eps)
    h = min_step * torch.abs(x)
    h = torch.where(h == 0.0, min_step, h)

    def column(j):
        x_plus = x.clone()
        x_plus[j] = x[j] + h[j]
        r_plus, _ = _batched_residuals(block, x_plus)
        return (r_plus - r0) / h[j]

    return torch.stack([column(j) for j in range(x.shape[0])], dim=-1)


def _jacobian_auto(block, x):
    """Forward-mode AD through the full chain; (N, O, P)."""
    return jacfwd(lambda xx: _batched_residuals(block, xx)[0])(x)


def _jacobian_analytic(block, state):
    if block.data is None:
        return block.jacobian_fn(state, None)[None, ...]
    return vmap(lambda d: block.jacobian_fn(state, d))(block.data)


def linearize(block_or_problem, x, mode="auto", accum_dtype=None):
    """Accumulate (cost, H, b) over one block or a whole problem.

    H = Σᵢ wᵢ JᵢᵀΣJᵢ, b = Σᵢ wᵢ JᵢᵀΣrᵢ, cost = Σᵢ(valid) ‖rᵢ‖². ``mode`` is
    one string for every block or a tuple of per-block strings.
    accum_dtype: optional wider dtype for the H, b and cost accumulation.
    """
    blocks = _blocks_of(block_or_problem)
    modes = (mode,) * len(blocks) if isinstance(mode, str) else tuple(mode)
    adt = _as_dtype(accum_dtype, x.dtype)
    P = x.shape[0]
    H = torch.zeros((P, P), dtype=adt, device=x.device)
    b = torch.zeros((P,), dtype=adt, device=x.device)
    cost = torch.zeros((), dtype=adt, device=x.device)
    for block, m in zip(blocks, modes):
        c_i, H_i, b_i = _linearize_block(block, x, m, accum_dtype)
        cost, H, b = cost + c_i, H + H_i, b + b_i
    return cost, H, b


def _linearize_block(block, x, mode, accum_dtype=None):
    if mode == "auto" and block.linearize_fn is not None and accum_dtype is None:
        return block.linearize_fn(block, x)
    state = block.prepare_fn(x)
    r, valid = _eval_residuals(block, state)

    if mode == "analytic":
        if block.jacobian_fn is None:
            raise ValueError(f"block {block.name!r} has no jacobian_fn")
        J = _jacobian_analytic(block, state)
    elif mode == "fd":
        J = _jacobian_fd(block, x, r)
    elif mode == "auto":
        J = _jacobian_auto(block, x)
    else:
        raise ValueError(f"unknown diff mode {mode!r}")

    return _accumulate(block, x, r, valid, J, accum_dtype=accum_dtype)


def _over_lanes(fn, block_or_problem, x, batch_data):
    """fn(problem_i, x_i) for every lane i of x (B, P), through vmap.

    batch_data: True (every block's data has the lane axis), False (data is
    shared by all lanes), or one bool per block. A block with data=None is
    shared whatever it says."""
    blocks = _blocks_of(block_or_problem)
    if isinstance(batch_data, bool):
        batch_data = (batch_data,) * len(blocks)
    datas = tuple(b.data for b in blocks)
    dims = tuple(0 if (lane and d is not None) else None for lane, d in zip(batch_data, datas))

    def one(datas_i, x_i):
        return fn(
            Problem(blocks=tuple(dataclasses.replace(b, data=d) for b, d in zip(blocks, datas_i))),
            x_i,
        )

    return vmap(one, in_dims=(dims, 0))(datas, x)


def linearize_batched(block_or_problem, x, mode="auto", accum_dtype=None, batch_data=True):
    """``linearize`` for every lane of x (B, P): cost (B,), H (B, P, P), b (B, P)."""
    return _over_lanes(
        lambda p, xi: linearize(p, xi, mode=mode, accum_dtype=accum_dtype),
        block_or_problem, x, batch_data,
    )


def compute_cost_batched(block_or_problem, x, accum_dtype=None, batch_data=True):
    """``compute_cost`` for every lane of x (B, P): (B,)."""
    return _over_lanes(
        lambda p, xi: compute_cost(p, xi, accum_dtype=accum_dtype), block_or_problem, x, batch_data
    )


def compute_block_costs_batched(block_or_problem, x, accum_dtype=None, batch_data=True):
    """``compute_block_costs`` for every lane of x (B, P): (B, n_blocks)."""
    return _over_lanes(
        lambda p, xi: compute_block_costs(p, xi, accum_dtype=accum_dtype),
        block_or_problem, x, batch_data,
    )


def _accumulate(block, x, r, valid, J, accum_dtype=None):
    """H, b and cost from residuals and Jacobians in one matrix product.
    accum_dtype widens r, J and every product."""
    N, O = r.shape
    P = x.shape[0]
    if accum_dtype is not None:
        adt = _as_dtype(accum_dtype, x.dtype)
        r = r.to(adt)
        J = J.to(adt)
    sq_norm = torch.sum(r * r, dim=-1)
    w = torch.where(valid, block.loss.weight(sq_norm).to(r.dtype), 0.0)

    if block.weight_fn is not None:
        Sigma = _per_residual_weights(block, block.prepare_fn(x)).to(r.dtype)
        SJ = torch.einsum("noq,nqp->nop", Sigma, J)
        Sr = torch.einsum("noq,nq->no", Sigma, r)
    elif block.weight_matrix is None:
        SJ = J
        Sr = r
    else:
        Sigma = torch.as_tensor(block.weight_matrix, dtype=r.dtype, device=r.device)
        if Sigma.ndim == 3:
            SJ = torch.einsum("noq,nqp->nop", Sigma, J)
            Sr = torch.einsum("noq,nq->no", Sigma, r)
        else:
            SJ = torch.einsum("oq,nqp->nop", Sigma, J)
            Sr = r @ Sigma.T

    A = J.reshape(N * O, P)
    Bm = (w[:, None, None] * SJ).reshape(N * O, P)
    H = A.T @ Bm
    b = A.T @ (w[:, None] * Sr).reshape(N * O)
    if block.weighted_cost:
        cost = torch.sum(torch.where(valid, torch.einsum("no,no->n", r, Sr), 0.0))
    else:
        cost = torch.sum(torch.where(valid, sq_norm, 0.0))
    return cost, H, b
