"""The port's pose-graph optimization (``pose_graph.py``) against the JAX
package's, float64 on ``tests/test_pose_graph.py``'s ring graphs carried
across as numpy (``interop.pose_graph_from_numpy``).

Per solve: poses to 1e-9, equal status and iterations, the trace NaN where
JAX's is and equal where finite (cost to rtol 1e-9 with atol 1e-15 × the
first cost, λ to rtol 1e-9, ρ to rtol 1e-9 + 1e-12·|y0|/|y0 − y1| where y1
is the next iteration's cost: the noise-floor rule of the LM tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import Cauchy as JCauchy
from moptimizer_0_tpu import GemanMcClure as JGemanMcClure
from moptimizer_0_tpu import Huber as JHuber
from moptimizer_0_tpu import pose_graph as J
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu_torch import pose_graph as P
from moptimizer_0_tpu_torch.interop import (
    loss_from_numpy,
    pgo_config_from_fields,
    pose_graph_from_numpy,
    result_to_numpy,
)
from test_pose_graph import make_ring_graph

POSE_ATOL = 1e-9
# A graph whose optimum has a non-zero cost (the bogus closure) ends, under
# the reference's tests, where a roundoff-sized ρ < 0 and |δ| < √ε fire,
# and the two packages' roundoff picks different iterations for that; it
# stops instead on rel_cost_tol, well above roundoff.
NOISE_FLOOR = J.PGOConfig(max_iterations=30, rel_cost_tol=1e-10)
# The configurations the tests share (each JAX config and graph shape is
# one compile of solve_pgo).
DENSE = J.PGOConfig(max_iterations=30)
CG = J.PGOConfig(max_iterations=30, solver="cg", cg_iterations=300, cg_tol=1e-13)
_FIELDS = ("poses", "edge_i", "edge_j", "measurements", "information")


def _port(graph, loss=None):
    """The port's copy of a JAX PoseGraph, on the CPU."""
    prior = None
    if graph.prior is not None:
        prior = {f.name: np.asarray(getattr(graph.prior, f.name)) for f in dataclasses.fields(graph.prior)}
    return pose_graph_from_numpy(*(np.asarray(getattr(graph, f)) for f in _FIELDS), n_fixed=graph.n_fixed,
                                 prior=prior, loss=loss, device="cpu")


def _config(cfg):
    return pgo_config_from_fields(dataclasses.asdict(cfg))


def _assert_same_solve(t, j):
    t = result_to_numpy(t)
    assert int(t["status"]) == int(j.status)
    assert int(t["iterations"]) == int(j.iterations)
    np.testing.assert_allclose(t["poses"], np.asarray(j.poses), rtol=0, atol=POSE_ATOL)
    jt = {k: np.asarray(v) for k, v in j.trace.items()}
    for k in jt:
        np.testing.assert_array_equal(np.isnan(t["trace"][k]), np.isnan(jt[k]), err_msg=k)
    cost = jt["cost"]
    np.testing.assert_allclose(t["trace"]["cost"], cost, rtol=1e-9, atol=1e-15 * cost[0])
    np.testing.assert_allclose(t["trace"]["lam"], jt["lam"], rtol=1e-9)
    ran = np.flatnonzero(np.isfinite(cost))
    nxt = np.append(cost[ran][1:], float(j.cost))
    with np.errstate(divide="ignore"):
        tol = 1e-9 + 1e-12 * np.abs(cost[ran]) / np.abs(cost[ran] - nxt)
    rho_t, rho_j = t["trace"]["rho"][ran], jt["rho"][ran]
    finite = np.isfinite(rho_j)
    assert np.all(np.abs(rho_t[finite] - rho_j[finite]) <= tol[finite] * np.abs(rho_j[finite]))
    np.testing.assert_allclose(t["cost"], float(j.cost), rtol=1e-9, atol=1e-15 * cost[0])


def _solve_both(graph, cfg, jloss=None, tloss=None):
    jg = graph if jloss is None else dataclasses.replace(graph, loss=jloss)
    j = J.solve_pgo(jg, cfg)
    t = P.solve_pgo(_port(graph, tloss), _config(cfg))
    _assert_same_solve(t, j)
    return t, j


def _bad_closure(seed=5):
    graph, gt = make_ring_graph(N=12, drift=0.01, seed=seed)
    meas = np.array(graph.measurements)
    meas[-1] = meas[-1] + np.array([3.0, -2.0, 1.0, 0.3, 0.2, -0.1])  # a bogus closure
    return dataclasses.replace(graph, measurements=jnp.asarray(meas)), gt


def _max_pose_err(poses, gt):
    errs = []
    for p, g in zip(np.asarray(poses), np.asarray(gt)):
        Te = np.asarray(jse3.transform_from_params6(jnp.asarray(p)))
        Tg = np.asarray(jse3.transform_from_params6(jnp.asarray(g)))
        errs.append(np.abs(np.linalg.inv(Te) @ Tg - np.eye(4)).max())
    return max(errs)


def test_residuals_jacobians_and_system_match_jax():
    graph, gt = make_ring_graph(N=12, drift=0.03)
    tg = _port(graph)
    np.testing.assert_allclose(P.residuals_all(tg).numpy(), np.asarray(J.residuals_all(graph)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(P.compute_cost(tg)), float(J.compute_cost(graph)), rtol=1e-12)
    assert float(P.compute_cost(_port(dataclasses.replace(graph, poses=gt)))) < 1e-18
    jr, jJi, jJj = jax.jit(J._linearize)(graph)
    tr, tJi, tJj = P._linearize(tg)
    for a, b in ((tr, jr), (tJi, jJi), (tJj, jJj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    jH, jb = jax.jit(J._assemble)(graph, jr, jJi, jJj)
    tH, tb = P._assemble(tg, tr, tJi, tJj, P._EdgePlan(tg))
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-12)


@pytest.mark.parametrize("cfg", [DENSE, CG], ids=["dense", "cg"])
def test_pgo_corrects_drift_matches_jax(cfg):
    graph, _ = make_ring_graph(N=12, drift=0.03)
    t, _ = _solve_both(graph, cfg)
    assert float(t.cost) < float(J.compute_cost(graph)) * 1e-2
    assert torch.equal(t.poses[0], _port(graph).poses[0])  # the first pose stays fixed


def test_pgo_exact_measurements_recovers_gt_matches_jax():
    graph, gt = make_ring_graph(N=12, drift=0.02, seed=2)
    t, _ = _solve_both(graph, DENSE)
    assert float(t.cost) < 1e-16
    assert _max_pose_err(t.poses.numpy(), gt) < 1e-6


def test_information_weighting_matches_jax():
    graph, _ = make_ring_graph(N=12, drift=0.02, seed=3)
    graph2 = dataclasses.replace(graph, information=2.0 * graph.information)
    np.testing.assert_allclose(float(P.compute_cost(_port(graph2))), 2 * float(P.compute_cost(_port(graph))),
                               rtol=1e-12)
    t1, _ = _solve_both(graph, DENSE)
    t2, _ = _solve_both(graph2, DENSE)
    np.testing.assert_allclose(t1.poses.numpy(), t2.poses.numpy(), atol=1e-8)


@pytest.mark.parametrize(
    "kind,param",
    [(None, None), ("GemanMcClure", ("tau", 0.5)), ("Huber", ("delta", 0.5)), ("Cauchy", ("c", 0.5))],
    ids=["least_squares", "geman_mcclure", "huber", "cauchy"],
)
def test_bad_loop_closure_with_robust_losses_matches_jax(kind, param):
    graph, gt = _bad_closure()
    jloss = tloss = None
    if kind is not None:
        name, value = param
        jloss = dict(GemanMcClure=JGemanMcClure, Huber=JHuber, Cauchy=JCauchy)[kind](**{name: jnp.asarray(value)})
        tloss = loss_from_numpy(kind, {name: np.asarray(value)})
    t, _ = _solve_both(graph, NOISE_FLOOR, jloss, tloss)
    if kind == "GemanMcClure":  # the robust kernel keeps the solution near the ground truth
        plain = P.solve_pgo(_port(graph), _config(NOISE_FLOOR))
        assert _max_pose_err(t.poses.numpy(), gt) < _max_pose_err(plain.poses.numpy(), gt) / 3


def test_pgo_cg_matches_dense_and_jax():
    graph, _ = make_ring_graph(N=12, drift=0.02, seed=9)
    t_cg, _ = _solve_both(graph, CG)
    t_dense = P.solve_pgo(_port(graph), _config(DENSE))
    np.testing.assert_allclose(t_cg.poses.numpy(), t_dense.poses.numpy(), atol=1e-7)
    assert float(t_cg.cost) < 1e-14


def test_pgo_cg_stops_on_its_iteration_cap_as_jax():
    """Few CG iterations a step: the cap, not the tolerance, ends each
    solve, and the outer loop carries the inexact steps as JAX's does."""
    graph, _ = make_ring_graph(N=12, drift=0.03, seed=10)
    _solve_both(graph, J.PGOConfig(max_iterations=8, solver="cg", cg_iterations=20))


def test_pgo_prior_dominant_graph_matches_jax():
    """y0 includes the prior: a prior-dominant graph is not CONVERGED at 0."""
    graph, gt = make_ring_graph(N=12, drift=0.0, seed=7)
    target = np.asarray(gt[1]) + np.array([0.5, -0.3, 0.2, 0.05, -0.04, 0.03])
    prior = J.PGOPrior(
        x_ref=jnp.asarray(target), sqrt_info=3.0 * jnp.eye(6), offset=jnp.zeros(6),
        idx=jnp.arange(6, 12, dtype=jnp.int32),
    )
    g = dataclasses.replace(graph, poses=gt, prior=prior)
    start = float(J.compute_cost(g))
    assert start > 1.0
    np.testing.assert_allclose(float(P.compute_cost(_port(g))), start, rtol=1e-12)
    t, _ = _solve_both(g, NOISE_FLOOR)
    assert int(t.iterations) > 0 and float(t.cost) < 0.9 * start


def test_pgo_rel_cost_tol_matches_jax():
    graph, _ = make_ring_graph(N=12, drift=0.03, seed=8)
    base, _ = _solve_both(graph, DENSE)
    fast, _ = _solve_both(graph, dataclasses.replace(DENSE, rel_cost_tol=1e-8))
    assert int(fast.iterations) <= int(base.iterations)
    np.testing.assert_allclose(float(fast.cost), float(base.cost), rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("cfg", [DENSE, CG], ids=["dense", "cg"])
def test_non_pd_step_is_numeric_error_in_both(cfg):
    """A negative information makes H + λ·diag(H) indefinite: the dense
    factorization gives NaN, not an exception, and CG's step diverges; both
    packages end in NUMERIC_ERROR."""
    graph, _ = make_ring_graph(N=12, drift=0.03)
    info = np.array(graph.information)
    info[:] = -np.eye(6)
    g = dataclasses.replace(graph, information=jnp.asarray(info))
    j = J.solve_pgo(g, cfg)
    t = P.solve_pgo(_port(g), _config(cfg))
    assert int(t.status) == int(j.status)
    assert int(t.iterations) == int(j.iterations)
    if cfg.solver == "dense":
        assert int(j.status) == int(P.Status.NUMERIC_ERROR)


def test_prior_with_cg_raises_in_both():
    graph, gt = make_ring_graph(N=12, drift=0.0, seed=7)
    prior = J.PGOPrior(x_ref=jnp.zeros(6), sqrt_info=jnp.eye(6), offset=jnp.zeros(6), idx=jnp.arange(6, 12))
    g = dataclasses.replace(graph, prior=prior)
    cfg = J.PGOConfig(solver="cg")
    with pytest.raises(ValueError, match="dense"):
        J.solve_pgo(g, cfg)
    with pytest.raises(ValueError, match="dense"):
        P.solve_pgo(_port(g), _config(cfg))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_two_solves_are_bit_equal(solver):
    graph, _ = _bad_closure(seed=6)
    tg = _port(graph, loss_from_numpy("Huber", {"delta": np.asarray(0.5)}))
    cfg = P.PGOConfig(max_iterations=20, solver=solver)
    a, b = P.solve_pgo(tg, cfg), P.solve_pgo(tg, cfg)
    assert int(a.iterations) == int(b.iterations) and int(a.status) == int(b.status)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.cost, b.cost)


def test_float32_graph_linearizes_in_float32():
    """The card solves in float32: the per-edge jacfwd must not promote the
    tangents to float64 (so3.log keeps no 0-dim intermediate)."""
    graph, _ = make_ring_graph(N=12, drift=0.03)
    tg = _port(graph)
    tg32 = dataclasses.replace(tg, poses=tg.poses.float(), measurements=tg.measurements.float(),
                               information=tg.information.float())
    r, Ji, Jj = P._linearize(tg32)
    assert r.dtype == Ji.dtype == Jj.dtype == torch.float32
    r64, Ji64, _ = P._linearize(tg)
    np.testing.assert_allclose(Ji.numpy(), Ji64.numpy(), rtol=0, atol=1e-5)
    res = P.solve_pgo(tg32, P.PGOConfig(max_iterations=10))
    assert res.poses.dtype == torch.float32 and float(res.cost) < 1e-3 * float(P.compute_cost(tg32))


def test_chip_smoke_ring_graph_is_the_tests_ring_graph():
    """chip_smoke.py rebuilds make_ring_graph in numpy and the port's lie
    (it imports no jax) for its 2,000-pose ring."""
    import chip_smoke

    graph, gt = make_ring_graph(N=20, drift=0.005, seed=10)
    tg, tgt = chip_smoke.make_ring_graph(20, seed=10, drift=0.005)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(gt), rtol=0, atol=1e-12)
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(graph, f)), rtol=0, atol=1e-12,
                                   err_msg=f)
    assert tg.n_fixed == graph.n_fixed == 1
