"""Robust losses.

A loss maps the squared residual norm ‖r‖² to an IRLS weight w that scales
the Gauss-Newton contributions H and b only; the cost stays the unweighted
Σ‖r‖² (the semantics of ``moptimizer_0_tpu.core.loss``).
"""

import dataclasses
from typing import Any

import torch


def _param(value, like):
    """A loss parameter in like's dtype on its device: a number is filled on
    the device (a host copy would synchronise, and cannot be captured into
    a CUDA graph), a tensor converted."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device)
    return torch.full((), value, dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class TrivialLoss:
    """w ≡ 1."""

    def weight(self, sq_norm):
        return torch.ones_like(sq_norm)


@dataclasses.dataclass
class GemanMcClure:
    """w = τ² / (‖r‖² + τ)²."""

    tau: Any

    def weight(self, sq_norm):
        tau = _param(self.tau, sq_norm)
        return (tau * tau) / torch.square(sq_norm + tau)


@dataclasses.dataclass
class Huber:
    """w = 1 for ‖r‖ ≤ δ, δ/‖r‖ beyond."""

    delta: Any

    def weight(self, sq_norm):
        delta = _param(self.delta, sq_norm)
        norm = torch.sqrt(torch.clamp_min(sq_norm, torch.finfo(sq_norm.dtype).tiny))
        return torch.where(norm <= delta, torch.ones_like(norm), delta / norm)


@dataclasses.dataclass
class Cauchy:
    """w = 1 / (1 + ‖r‖²/c²)."""

    c: Any

    def weight(self, sq_norm):
        c = _param(self.c, sq_norm)
        return 1.0 / (1.0 + sq_norm / (c * c))
