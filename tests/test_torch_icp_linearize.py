"""The port's linearization against the JAX package's, on the same inputs.

The closed-form ICP moments and (cost, H, b), with and without a validity
mask and with the trivial and the Geman-McClure loss, and the generic
``linearize`` in modes auto, fd and analytic on ``point2point_block``.
float64: rtol 1e-10, atol 1e-10 × the largest entry for entries that cancel
to ~0. The fd Jacobian divides differences of residuals by h ≈ 1.5e-8, which
magnifies a last-bit difference in a residual by 1/h; its H and b are held
to rtol 1e-6, while the step sizes h themselves are held equal bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import GemanMcClure as JGemanMcClure
from moptimizer_0_tpu import TrivialLoss as JTrivialLoss
from moptimizer_0_tpu.core import linearize as jlin
from moptimizer_0_tpu.models.point2point import point2point_block as jblock
from moptimizer_0_tpu.ops import icp_linearize as jicp
from moptimizer_0_tpu_torch import GemanMcClure, TrivialLoss
from moptimizer_0_tpu_torch.core import linearize as tlin
from moptimizer_0_tpu_torch.models.point2point import point2point_block as tblock
from moptimizer_0_tpu_torch.ops import icp_linearize as ticp

LOSSES = {
    "trivial": (TrivialLoss(), JTrivialLoss()),
    "geman_mcclure": (GemanMcClure(tau=0.5), JGemanMcClure(tau=jnp.asarray(0.5))),
}


def _scene(seed=0, n=257):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (n, 3))
    x = np.array([0.3, -0.2, 0.1, 0.2, -0.1, 0.3])
    tgt = src + rng.normal(0, 0.3, (n, 3))
    valid = rng.uniform(size=n) > 0.3
    return src, tgt, x, valid


def _close(t, j, rtol=1e-10):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1e-300))


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("masked", [False, True])
def test_icp_moments_and_system_match_jax(loss, masked):
    src, tgt, x, valid = _scene()
    tl, jl = LOSSES[loss]
    tv = torch.as_tensor(valid) if masked else None
    jv = jnp.asarray(valid) if masked else None
    R = np.array(jnp.asarray(jicp.so3.exp(jnp.asarray(x[3:]))))
    tm = ticp.icp_moments(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(R),
                          torch.as_tensor(x[:3]), tl, valid=tv)
    jm = jicp.icp_moments(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(R),
                          jnp.asarray(x[:3]), jl, valid=jv)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k])
    t_sys = ticp.icp_linearize(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(x), tl, valid=tv)
    j_sys = jicp.icp_linearize(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(x), jl, valid=jv)
    for a, b in zip(t_sys, j_sys):
        _close(a, b)


@pytest.mark.parametrize("mode", ["auto", "fd", "analytic"])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_generic_linearize_matches_jax(mode, loss):
    src, tgt, x, _ = _scene(1, n=97)
    tl, jl = LOSSES[loss]
    tb = tblock(torch.as_tensor(src), torch.as_tensor(tgt), analytic=True, fused=False, loss=tl)
    jb = jblock(jnp.asarray(src), jnp.asarray(tgt), analytic=True, fused=False, loss=jl)
    t_out = tlin.linearize(tb, torch.as_tensor(x), mode=mode)
    j_out = jlin.linearize(jb, jnp.asarray(x), mode=mode)
    rtol = 1e-6 if mode == "fd" else 1e-10
    for a, b in zip(t_out, j_out):
        _close(a, b, rtol=rtol)


def test_fd_steps_are_bit_identical():
    """With an elementwise residual every operation is one correctly rounded
    op in both packages, so the fd Jacobian is bit-equal exactly when
    h_j = √ε·|x_j| (√ε at x_j = 0) is the same float in both."""
    x = np.array([0.0, 2.5, -1e-3, 3.0, 0.0, -7.0])
    c = np.random.default_rng(2).normal(size=6)

    def t_res(xx, d):
        return torch.as_tensor(c) * xx * xx

    def j_res(xx, d):
        return jnp.asarray(c) * xx * xx

    from moptimizer_0_tpu.core.residual import make_block as jmake
    from moptimizer_0_tpu_torch.core.residual import make_block as tmake

    tb, jb = tmake(t_res), jmake(j_res)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    r0t, _ = tlin._batched_residuals(tb, xt)
    r0j, _ = jlin._batched_residuals(jb, xj)
    Jt = tlin._jacobian_fd(tb, xt, r0t).numpy()
    Jj = np.asarray(jlin._jacobian_fd(jb, xj, r0j))
    np.testing.assert_array_equal(Jt, Jj)


@pytest.mark.parametrize("mode", ["auto", "analytic"])
def test_weight_matrix_and_accum_dtype_match_jax(mode):
    """The Σ sandwich (shared and per-residual) and the widened accumulation."""
    src, tgt, x, _ = _scene(3, n=64)
    rng = np.random.default_rng(4)
    Bm = rng.normal(size=(3, 3))
    sigma = Bm @ Bm.T + 3 * np.eye(3)
    per = np.stack([sigma * (1 + 0.1 * i) for i in range(64)])
    for W in (sigma, per):
        tb = tblock(torch.as_tensor(src), torch.as_tensor(tgt), analytic=True,
                    weight_matrix=torch.as_tensor(W))
        jb = jblock(jnp.asarray(src), jnp.asarray(tgt), analytic=True, weight_matrix=jnp.asarray(W))
        for a, b in zip(tlin.linearize(tb, torch.as_tensor(x), mode=mode),
                        jlin.linearize(jb, jnp.asarray(x), mode=mode)):
            _close(a, b)
        wb_t = dataclasses.replace(tb, weighted_cost=True)
        wb_j = dataclasses.replace(jb, weighted_cost=True)
        _close(tlin.compute_cost(wb_t, torch.as_tensor(x)), jlin.compute_cost(wb_j, jnp.asarray(x)))
    # float32 model, float64 accumulation
    tb = tblock(torch.as_tensor(src, dtype=torch.float32), torch.as_tensor(tgt, dtype=torch.float32),
                analytic=True)
    jb = jblock(jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32), analytic=True)
    t_out = tlin.linearize(tb, torch.as_tensor(x, dtype=torch.float32), mode=mode, accum_dtype="float64")
    j_out = jlin.linearize(jb, jnp.asarray(x, jnp.float32), mode=mode, accum_dtype="float64")
    for a, b in zip(t_out, j_out):
        assert a.dtype == torch.float64
        _close(a, b, rtol=1e-5)  # float32 residuals: rounding of the model evaluation


@pytest.mark.parametrize("mode", ["auto", "fd"])
def test_state_dependent_weight_fn_matches_jax(mode):
    """weight_fn (state, data_i) -> (O, O) overrides weight_matrix, in H, b
    and, with weighted_cost, in the cost."""
    from moptimizer_0_tpu.core.residual import make_block as jmake
    from moptimizer_0_tpu.lie import se3 as jse3
    from moptimizer_0_tpu_torch.core.residual import make_block as tmake
    from moptimizer_0_tpu_torch.lie import se3 as tse3

    src, tgt, x, _ = _scene(6, n=40)
    rng = np.random.default_rng(7)
    Bm = rng.normal(size=(40, 3, 3))
    info = Bm @ Bm.transpose(0, 2, 1) + np.eye(3)
    rtol = 1e-6 if mode == "fd" else 1e-10

    def residual(T, d):
        return T[:3, :3] @ d["src"] + T[:3, 3] - d["tgt"]

    def weight(T, d):
        return d["info"] * (1.0 + T[0, 3] * T[0, 3])

    for weighted_cost in (False, True):
        tb = tmake(residual, data={k: torch.as_tensor(v) for k, v in dict(src=src, tgt=tgt, info=info).items()},
                   prepare_fn=tse3.transform_from_params6, weight_fn=weight, weighted_cost=weighted_cost)
        jb = jmake(residual, data={k: jnp.asarray(v) for k, v in dict(src=src, tgt=tgt, info=info).items()},
                   prepare_fn=jse3.transform_from_params6, weight_fn=weight, weighted_cost=weighted_cost)
        for a, b in zip(tlin.linearize(tb, torch.as_tensor(x), mode=mode),
                        jlin.linearize(jb, jnp.asarray(x), mode=mode)):
            _close(a, b, rtol=rtol)
        _close(tlin.compute_cost(tb, torch.as_tensor(x)), jlin.compute_cost(jb, jnp.asarray(x)))


def test_fused_and_generic_paths_agree():
    src, tgt, x, _ = _scene(5)
    tb = tblock(torch.as_tensor(src), torch.as_tensor(tgt), loss=GemanMcClure(tau=0.5))
    fused = tlin.linearize(tb, torch.as_tensor(x), mode="auto")
    generic = tlin.linearize(dataclasses.replace(tb, linearize_fn=None), torch.as_tensor(x), mode="auto")
    for a, b in zip(fused, generic):
        _close(a, b)
