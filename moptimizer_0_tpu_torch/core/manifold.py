"""Manifolds wired into the LM update.

PyTorch counterpart of ``moptimizer_0_tpu.core.manifold``: the solver
retracts through ``manifold.retract(x, δ)`` and linearizes in the tangent
space (``core.linearize.linearize_tangent``). Manifolds are frozen
dataclasses. The state is always a flat parameter vector; a manifold says
how a tangent step lands back on it.

Every branch on a value is a ``torch.where`` on tensors, never a Python
``if``: the batched solver maps the retraction over lanes with
``torch.func.vmap``. Scalars that forward AD passes through are kept as
(1,) tensors, never 0-dim (see ``lie/so3.py``).
"""

import dataclasses

import torch

from moptimizer_0_tpu_torch.lie import se3, so3


@dataclasses.dataclass(frozen=True)
class Euclidean:
    """x ⊞ δ = x + δ."""

    dim: int

    @property
    def tangent_dim(self):
        return self.dim

    def retract(self, x, delta):
        return x + delta

    def local(self, x, y):
        return y - x


@dataclasses.dataclass(frozen=True)
class SO3:
    """Rotation-vector state w ∈ R³ for R = exp(w); retraction R·exp(δ)."""

    @property
    def dim(self):
        return 3

    @property
    def tangent_dim(self):
        return 3

    def retract(self, x, delta):
        return so3.log(so3.exp(x) @ so3.exp(delta))

    def local(self, x, y):
        return so3.log(so3.exp(x).transpose(-1, -2) @ so3.exp(y))


@dataclasses.dataclass(frozen=True)
class SE3:
    """6-DoF state [t, w]; retraction composes transforms T(x)·T(δ)."""

    @property
    def dim(self):
        return 6

    @property
    def tangent_dim(self):
        return 6

    def retract(self, x, delta):
        T = se3.transform_from_params6(x) @ se3.transform_from_params6(delta)
        return torch.cat([T[:3, 3], so3.log(T[:3, :3])])

    def local(self, x, y):
        Tx = se3.transform_from_params6(x)
        Ty = se3.transform_from_params6(y)
        Rt = Tx[:3, :3].T
        return torch.cat([Rt @ (Ty[:3, 3] - Tx[:3, 3]), so3.log(Rt @ Ty[:3, :3])])


@dataclasses.dataclass(frozen=True)
class Product:
    """Product manifold over contiguous slices of the state vector, e.g. the
    15-DoF SO(3)×R¹² composite state."""

    parts: tuple  # manifolds, applied to consecutive slices

    @property
    def dim(self):
        return sum(p.dim for p in self.parts)

    @property
    def tangent_dim(self):
        return sum(p.tangent_dim for p in self.parts)

    def retract(self, x, delta):
        out, xo, do = [], 0, 0
        for p in self.parts:
            out.append(p.retract(x[xo : xo + p.dim], delta[do : do + p.tangent_dim]))
            xo += p.dim
            do += p.tangent_dim
        return torch.cat(out)

    def local(self, x, y):
        out, xo = [], 0
        for p in self.parts:
            out.append(p.local(x[xo : xo + p.dim], y[xo : xo + p.dim]))
            xo += p.dim
        return torch.cat(out)


def _sq(v):
    """Σ v², as a (1,) tensor."""
    return torch.sum(v * v, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Unit-norm state s ∈ Sⁿ⁻¹ ⊂ Rⁿ (n = dim, tangent_dim = n−1);
    quaternions (n = 4) are the canonical use.

    Chart: the Householder tangent basis B(x) and the sphere exponential map
        retract(x, δ) = cos‖δ‖·x + sinc‖δ‖·B(x)δ,
        local(x, y)   = θ·p/‖p‖,  p = B(x)ᵀy,  θ = atan2(‖p‖, x·y),
    with the JAX package's small-angle guards: θ² < √ε switches to the
    Taylor forms, and ε² inside the square roots keeps them differentiable.
    """

    dim: int

    @property
    def tangent_dim(self):
        return self.dim - 1

    def _basis(self, xn):
        # the Householder reflector sending e_{n−1} to ∓xn; its other
        # columns are an orthonormal basis of the tangent space at xn
        n = self.dim
        e = (torch.arange(n, device=xn.device) == n - 1).to(xn.dtype)
        sign = torch.where(xn[-1:] >= 0, 1.0, -1.0).to(xn.dtype)
        v = xn + sign * e
        v = v / torch.sqrt(_sq(v) + torch.finfo(xn.dtype).tiny)
        H = torch.eye(n, dtype=xn.dtype, device=xn.device) - 2.0 * torch.outer(v, v)
        return H[:, :-1]

    def retract(self, x, delta):
        eps = torch.finfo(x.dtype).eps
        xn = x / torch.sqrt(_sq(x) + eps)
        B = self._basis(xn)
        th2 = _sq(delta)
        th = torch.sqrt(th2 + eps * eps)
        small = th2 < eps**0.5
        sinc = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
        cos = torch.where(small, 1.0 - th2 / 2.0, torch.cos(th))
        return cos * xn + sinc * (B @ delta)

    def local(self, x, y):
        eps = torch.finfo(x.dtype).eps
        xn = x / torch.sqrt(_sq(x) + eps)
        yn = y / torch.sqrt(_sq(y) + eps)
        B = self._basis(xn)
        p = B.T @ yn
        pn2 = _sq(p)
        pn = torch.sqrt(pn2 + eps * eps)
        th = torch.atan2(pn, torch.sum(xn * yn, dim=-1, keepdim=True))
        scale = torch.where(pn2 < eps**0.5, 1.0, th / pn)
        return scale * p
