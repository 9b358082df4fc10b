"""Residual blocks and problems.

A block is ``(residual_fn, data, loss, weight_matrix)`` plus two hooks:

* ``prepare_fn(x) -> state``: the cheap parameter → transform conversion,
  run once per evaluation;
* ``update_fn(x, data) -> data``: run once per outer LM iteration, for
  example ICP's correspondence search;
* ``batch_update_fn(x, data) -> data``: the same for every lane of a batched
  solve at once, x (B, P) and data with a leading B. A block needs one where
  its hook cannot run under ``torch.func.vmap``, as a kernel launch cannot;
  the batched solver runs ``vmap(update_fn)`` for a block without one.

``residual_fn(state, data_i)`` returns the residual (O,) of ONE index, or a
tuple ``(residual, valid)``; ``core.linearize`` batches it over the leading
axis of every tensor in ``data`` with ``torch.func.vmap``.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import vmap

from moptimizer_0_tpu_torch.core.loss import TrivialLoss


def _identity_prepare(x):
    return x


@dataclasses.dataclass
class ResidualBlock:
    """One cost block.

    Fields
    ------
    data : dict of tensors with a leading axis N, or None
        Per-residual data. None means one residual over the whole state.
    loss : object with ``.weight(sq_norm)``
        IRLS weight on H, b only.
    weight_matrix : (O, O) or (N, O, O) tensor, or None
        Information matrix Σ, applied as JᵀΣJ / JᵀΣr. None is the identity.
    residual_fn : (state, data_i) -> (O,) tensor, or ((O,), valid)
    prepare_fn : x -> state
    jacobian_fn : (state, data_i) -> (O, P) tensor, or None
        Analytic Jacobian for ``mode="analytic"``.
    update_fn : (x, data) -> data, or None
        Run once per outer iteration.
    batch_update_fn : (x (B, P), data with a leading B) -> data, or None
        The lane-aware hook of a batched solve.
    linearize_fn : (block, x) -> (cost, H, b), or None
        Fused fast path, taken for ``mode="auto"`` without ``accum_dtype``.
    weight_fn : (state, data_i) -> (O, O), or None
        State-dependent information; overrides ``weight_matrix``.
    weighted_cost : bool
        True: the cost is Σ rᵀΣr instead of the unweighted Σ‖r‖².
    name : str
    """

    data: Any
    loss: Any
    weight_matrix: Optional[torch.Tensor] = None
    residual_fn: Optional[Callable] = None
    prepare_fn: Callable = _identity_prepare
    jacobian_fn: Optional[Callable] = None
    update_fn: Optional[Callable] = None
    linearize_fn: Optional[Callable] = None
    weight_fn: Optional[Callable] = None
    weighted_cost: bool = False
    name: str = "block"
    batch_update_fn: Optional[Callable] = None

    def update(self, x):
        """Run the update hook, returning a new block."""
        if self.update_fn is None:
            return self
        return dataclasses.replace(self, data=self.update_fn(x, self.data))

    def update_batched(self, x):
        """Run the update hook for every lane of x (B, P) on data with a
        leading B, returning a new block."""
        if self.batch_update_fn is not None:
            return dataclasses.replace(self, data=self.batch_update_fn(x, self.data))
        if self.update_fn is None:
            return self
        return dataclasses.replace(self, data=vmap(self.update_fn)(x, self.data))


def make_block(
    residual_fn,
    data=None,
    *,
    loss=None,
    weight_matrix=None,
    prepare_fn=_identity_prepare,
    jacobian_fn=None,
    update_fn=None,
    linearize_fn=None,
    weight_fn=None,
    weighted_cost=False,
    name="block",
    batch_update_fn=None,
):
    """Build a `ResidualBlock`; the loss defaults to `TrivialLoss`."""
    return ResidualBlock(
        data=data,
        loss=loss if loss is not None else TrivialLoss(),
        weight_matrix=weight_matrix,
        residual_fn=residual_fn,
        prepare_fn=prepare_fn,
        jacobian_fn=jacobian_fn,
        update_fn=update_fn,
        linearize_fn=linearize_fn,
        weight_fn=weight_fn,
        weighted_cost=weighted_cost,
        name=name,
        batch_update_fn=batch_update_fn,
    )


@dataclasses.dataclass
class Problem:
    """Residual blocks over one parameter vector; their systems add up."""

    blocks: tuple

    def update(self, x):
        """Run every block's update hook (once per outer LM iteration)."""
        return Problem(blocks=tuple(b.update(x) for b in self.blocks))

    def update_batched(self, x):
        """Run every block's update hook for every lane of x (B, P)."""
        return Problem(blocks=tuple(b.update_batched(x) for b in self.blocks))


def problem(*blocks):
    if len(blocks) == 0:
        raise ValueError("No residual block added!")
    return Problem(blocks=tuple(blocks))
