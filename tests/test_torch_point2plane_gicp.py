"""The port's point-to-plane ICP and GICP (``models/point2plane.py``,
``models/gicp.py``, ``registration.point2plane``/``gicp``, the registrar's
and ``register_pair``'s methods) against the JAX package's, float64.

* blocks on index-aligned pairs: cost, H and b to rtol 1e-10 (point-to-plane
  analytic against AD as in ``tests/test_evaluation.py``);
* solves on smooth surfaces (``tests/test_registration.py``'s and
  ``tests/test_grid_nn.py``'s, at 1,200–1,500 points): x to 1e-9, equal
  status and iterations, by brute force and through the grid; the transform
  recovered as the JAX tests require.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import odometry as JO
from moptimizer_0_tpu import registration as JR
from moptimizer_0_tpu.core.linearize import linearize as jlinearize
from moptimizer_0_tpu.core.residual import problem as jproblem
from moptimizer_0_tpu.core.solver import LMConfig as JLMConfig
from moptimizer_0_tpu.core.solver import levenberg_marquardt as jlm
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.models.gicp import gicp_block as jgicp_block
from moptimizer_0_tpu.models.point2plane import point2plane_block as jp2p_block
from moptimizer_0_tpu.ops import surface as JS
from moptimizer_0_tpu.ops.nn_search import _nn_pallas_vpu
from moptimizer_0_tpu_torch import odometry as PO
from moptimizer_0_tpu_torch import registration as PR
from moptimizer_0_tpu_torch.core.linearize import linearize
from moptimizer_0_tpu_torch.interop import config_from_fields
from moptimizer_0_tpu_torch.models.gicp import gicp_block
from moptimizer_0_tpu_torch.models.point2plane import point2plane_block

X_ATOL = 1e-9


def _T(x):
    return np.asarray(jse3.transform_from_params6(jnp.asarray(x)))


def _surface(seed=21, n=1500):
    """tests/test_registration.py's smooth surface, float64: (src, tgt, x_true)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12, (n, 2))
    tgt = np.column_stack([xy, 0.5 * np.sin(xy[:, 0] * 0.8) * np.cos(xy[:, 1] * 0.6)])
    x_true = np.array([0.08, -0.05, 0.03, 0.02, -0.015, 0.025])
    Tinv = np.linalg.inv(_T(x_true))
    return tgt @ Tinv[:3, :3].T + Tinv[:3, 3], tgt, x_true


def _wavy(seed=14, n=2500, noise_seed=0):
    """tests/test_grid_nn.py's GICP surface: (src, tgt, x_true), tgt = T·src."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 8, (n, 2))
    src = np.column_stack([xy, 0.2 * np.sin(xy[:, 0]) + 0.01 * rng.normal(size=n)])
    src = src + 0.001 * np.random.default_rng(noise_seed).normal(size=src.shape)
    x_true = np.array([0.05, -0.03, 0.02, 0.01, -0.02, 0.03])
    T = _T(x_true)
    return src, src @ T[:3, :3].T + T[:3, 3], x_true


def _same(t, j, x_true=None, atol_true=None):
    assert int(t.status) == int(j.status)
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=X_ATOL)
    if x_true is not None:
        np.testing.assert_allclose(t.x.numpy(), x_true, atol=atol_true)


def _system_close(t, j):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


def test_point2plane_block_matches_jax_and_its_analytic_jacobian():
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 5, size=(100, 3))
    normals = rng.normal(size=(100, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    tgt = src + 0.01 * rng.normal(size=src.shape)
    x = np.array([0.01, -0.02, 0.03, 0.004, -0.002, 0.003])
    tb = point2plane_block(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(normals), analytic=True)
    jb = jp2p_block(src, tgt, normals, analytic=True)
    _system_close(linearize(tb, torch.as_tensor(x), mode="auto"), jlinearize(jb, jnp.asarray(x), mode="auto"))
    zero = torch.zeros(6, dtype=torch.float64)
    an = linearize(tb, zero, mode="analytic")
    ad = linearize(tb, zero, mode="auto")
    _system_close(an, jlinearize(jb, jnp.zeros(6), mode="analytic"))
    for a, b in zip(an[1:], ad[1:]):  # J = [n | s × n] at identity
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)


def test_gicp_block_matches_jax():
    """Σ rᵀΩr with Ω = (C_q + R C_s Rᵀ + 1e-9 I)⁻¹ at a rotated state."""
    rng = np.random.default_rng(6)
    src = rng.uniform(0, 5, size=(200, 3))
    tgt = src + 0.01 * rng.normal(size=src.shape)

    def covs(n):
        U = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        return np.einsum("nij,j,nkj->nik", U, np.array([1e-3, 1.0, 1.0]), U)

    cs, ct = covs(200), covs(200)
    x = np.array([0.02, -0.01, 0.03, 0.05, -0.04, 0.06])
    valid = rng.uniform(size=200) > 0.1
    tb = gicp_block(*(torch.as_tensor(a) for a in (src, tgt, cs, ct)), valid=torch.as_tensor(valid))
    jb = jgicp_block(src, tgt, cs, ct, valid=jnp.asarray(valid))
    _system_close(linearize(tb, torch.as_tensor(x)), jlinearize(jb, jnp.asarray(x), mode="auto"))


def _jax_point2plane_k5(src, tgt, max_corr_dist):
    """JAX's ``point2plane`` with its searcher the TPU kernel K5 run in
    interpret mode: exact direct differences, as the port's "torch"
    search. (JAX's "xla" search sums its cross term in a matrix product, and
    near ties then pick other matches than the port's plain expansion.)"""
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    blk = JR._point2plane_block_with_searcher(
        jsrc, jtgt, JS.estimate_normals(jtgt, k=10), lambda w: _nn_pallas_vpu(w, jtgt, interpret=True),
        max_corr_dist=max_corr_dist,
    )
    x0 = jnp.zeros(6).at[0:3].set(jnp.median(jtgt, axis=0) - jnp.median(jsrc, axis=0))
    return jlm(jproblem(blk), x0, JLMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky"))


@pytest.mark.parametrize("backend", ["k5", "grid"])
def test_point2plane_solve_matches_jax(backend):
    src, tgt, x_true = _surface()
    if backend == "k5":
        j = _jax_point2plane_k5(src, tgt, 0.5)
        t = PR.point2plane(torch.as_tensor(src), torch.as_tensor(tgt), nn_backend="torch", max_corr_dist=0.5)
    else:
        j = JR.point2plane(jnp.asarray(src), jnp.asarray(tgt), nn_backend="grid", max_corr_dist=0.5)
        t = PR.point2plane(torch.as_tensor(src), torch.as_tensor(tgt), nn_backend="grid", max_corr_dist=0.5)
    _same(t, j, x_true, 2e-3)


@pytest.mark.parametrize("kw", [dict(nn_backend="xla", k=8), dict(nn_backend="grid", max_corr_dist=1.0)],
                         ids=["xla_k8", "grid"])
def test_gicp_solve_matches_jax(kw):
    src, tgt, x_true = _wavy(n=1500)
    j = JR.gicp(jnp.asarray(src), jnp.asarray(tgt), jnp.zeros(6), **kw)
    t = PR.gicp(torch.as_tensor(src), torch.as_tensor(tgt), torch.zeros(6, dtype=torch.float64), **kw)
    _same(t, j, x_true, 2e-3)


@pytest.mark.parametrize("backend", ["auto", "grid"])
@pytest.mark.parametrize("method", ["point2plane", "gicp"])
def test_registrar_methods_match_jax(method, backend):
    """Two seeded pairs through one registrar of each package: brute force
    ("auto" at these sizes) and the grid, with its capacity policy."""
    cfg = JR.default_pipeline_config()
    jreg = JR.PairwiseRegistrar(method=method, max_corr_dist=1.0, nn_backend=backend, config=cfg)
    treg = PR.PairwiseRegistrar(method=method, max_corr_dist=1.0, nn_backend=backend,
                                config=config_from_fields(dataclasses.asdict(cfg)))
    assert (treg.method, treg.k, treg.epsilon) == (method, 10, 1e-3)
    for seed in range(2):
        src, tgt, x_true = (_surface(seed=22 + seed) if method == "point2plane" else _wavy(n=1500, noise_seed=seed))
        j = jreg.register(jnp.asarray(src), jnp.asarray(tgt), x0=jnp.zeros(6))
        t = treg.register(torch.as_tensor(src), torch.as_tensor(tgt), x0=torch.zeros(6, dtype=torch.float64))
        _same(t, j, x_true, 2e-3)
    assert treg._grid_policy == jreg._grid_policy
    x, r = PO.register_pair(torch.as_tensor(src), torch.as_tensor(tgt), method=method, registrar=treg,
                            x0=torch.zeros(6, dtype=torch.float64))
    assert x is r.x
    np.testing.assert_allclose(x.numpy(), t.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["point2plane", "gicp"])
def test_register_pair_methods_match_jax(method):
    """No registrar: the method's own solve, seeded by its ungated coarse
    pass when a gate is set and no x0 is given."""
    src, tgt, x_true = _surface(seed=23, n=1200)
    cfg = JLMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    kw = dict(nn_backend="xla", max_corr_dist=0.5)
    jx, jr = JO.register_pair(jnp.asarray(src), jnp.asarray(tgt), method=method, config=cfg, **kw)
    tx, tr = PO.register_pair(torch.as_tensor(src), torch.as_tensor(tgt), method=method,
                              config=config_from_fields(dataclasses.asdict(cfg)), **kw)
    _same(tr, jr, x_true, 2e-3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=X_ATOL)
