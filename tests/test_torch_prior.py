"""The port's prior factors and marginalization (``core/prior.py``,
``pose_graph.marginalize_oldest``) against the JAX package's, float64 on the
inputs of ``tests/test_prior.py`` and ``tests/test_pgo_marginalization.py``.

``marginalize`` gives JAX's x_ref, S and offset to 1e-10 on one system (the
Cholesky factor with a positive diagonal is unique, so S compares
directly); a solve with the prior gives JAX's x to 1e-8. A marginalized pose
graph carries JAX's poses, edges and prior, and its solves give JAX's poses
to 1e-9 with equal status and iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu import levenberg_marquardt as jlm
from moptimizer_0_tpu import pose_graph as JP
from moptimizer_0_tpu.core import prior as J
from moptimizer_0_tpu.core.linearize import linearize as jlinearize
from moptimizer_0_tpu.core.residual import Problem as JProblem
from moptimizer_0_tpu.core.residual import problem as jproblem
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.lie import so3 as jso3
from moptimizer_0_tpu_torch import pose_graph as PP
from moptimizer_0_tpu_torch.core import prior as P
from moptimizer_0_tpu_torch.core.residual import Problem, make_block, problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.interop import pgo_config_from_fields, pose_graph_from_numpy
from test_pgo_marginalization import _chain_graph
from test_prior import _linear_problem as _jlinear_problem

ATOL = 1e-10


def _linear_problem(A, y):
    A = torch.as_tensor(A)
    y = torch.as_tensor(y)
    P_ = A.shape[1]

    def residual(x, d):
        return (d[:P_] @ x - d[P_])[None]

    return make_block(residual, data=torch.cat([A, y[:, None]], dim=1))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_gaussian_prior_block_pulls_to_reference():
    rng = np.random.default_rng(0)
    S = np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3)
    x_ref = np.array([1.0, -2.0, 0.5])
    res = levenberg_marquardt(problem(P.prior_block(torch.as_tensor(x_ref), torch.as_tensor(S))),
                              torch.zeros(3, dtype=torch.float64), LMConfig())
    j = jlm(jproblem(J.prior_block(jnp.asarray(x_ref), jnp.asarray(S))), jnp.zeros(3), JLMConfig())
    np.testing.assert_allclose(res.x.numpy(), x_ref, atol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-12)
    assert int(res.iterations) == int(j.iterations)


@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_marginalize_matches_jax_and_is_exact_on_a_linear_problem(reg):
    """Joint linear LS over (xk, xm) ≡ marginalized LS over xk + prior."""
    rng = np.random.default_rng(1)
    n_p, n = 6, 40
    A = rng.normal(size=(n, n_p))
    y = A @ rng.normal(size=n_p) + 0.1 * rng.normal(size=n)
    x_bar = rng.normal(size=n_p)
    _, H, b = jlinearize(jproblem(_jlinear_problem(A, y)), jnp.asarray(x_bar), mode="auto")
    keep = np.array([0, 1, 2])
    jx, jS, joff = J.marginalize(H, b, jnp.asarray(x_bar), jnp.asarray(keep), reg=reg)
    tx, tS, toff = P.marginalize(torch.as_tensor(np.array(H)), torch.as_tensor(np.array(b)),
                                 torch.as_tensor(x_bar), torch.as_tensor(keep), reg=reg)
    for a, c in ((tx, jx), (tS, jS), (toff, joff)):
        np.testing.assert_allclose(_np(a), _np(c), rtol=0, atol=ATOL)
    assert np.all(np.diag(_np(tS)) > 0) and np.allclose(np.tril(_np(tS), -1), 0.0)

    cfg = LMConfig(max_iterations=30)
    full = levenberg_marquardt(problem(_linear_problem(A, y)), torch.zeros(n_p, dtype=torch.float64), cfg)
    marg = levenberg_marquardt(problem(P.prior_block(tx, tS, toff)), torch.zeros(3, dtype=torch.float64), cfg)
    if reg == 0.0:  # exact: the kept entries of the joint solve
        np.testing.assert_allclose(marg.x.numpy(), full.x.numpy()[:3], atol=1e-8)
    jmarg = jlm(jproblem(J.prior_block(jx, jS, joff)), jnp.zeros(3), JLMConfig(max_iterations=30))
    np.testing.assert_allclose(marg.x.numpy(), np.asarray(jmarg.x), rtol=0, atol=1e-10)


def test_marginalization_with_new_measurements_matches_jax():
    """Marginal prior + new measurements on the kept states ≡ the joint
    solve with all of them (linear case), in both packages."""
    rng = np.random.default_rng(2)
    n_p, n1, n2 = 5, 30, 20
    A1 = rng.normal(size=(n1, n_p))
    y1 = A1 @ rng.normal(size=n_p) + 0.05 * rng.normal(size=n1)
    A2k = rng.normal(size=(n2, 3))
    y2 = A2k @ rng.normal(size=3) + 0.05 * rng.normal(size=n2)
    cfg = LMConfig(max_iterations=40)
    A2 = np.concatenate([A2k, np.zeros((n2, n_p - 3))], axis=1)
    full = levenberg_marquardt(problem(_linear_problem(np.concatenate([A1, A2]), np.concatenate([y1, y2]))),
                               torch.zeros(n_p, dtype=torch.float64), cfg)
    _, H, b = jlinearize(jproblem(_jlinear_problem(A1, y1)), jnp.zeros(n_p), mode="auto")
    keep = np.array([0, 1, 2])
    tprior = P.marginalize(torch.as_tensor(np.array(H)), torch.as_tensor(np.array(b)),
                           torch.zeros(n_p, dtype=torch.float64), torch.as_tensor(keep))
    t = levenberg_marquardt(Problem(blocks=(P.prior_block(*tprior), _linear_problem(A2k, y2))),
                            torch.zeros(3, dtype=torch.float64), cfg)
    jprior = J.marginalize(H, b, jnp.zeros(n_p), jnp.asarray(keep))
    j = jlm(JProblem(blocks=(J.prior_block(*jprior), _jlinear_problem(A2k, y2))), jnp.zeros(3),
            JLMConfig(max_iterations=40))
    np.testing.assert_allclose(t.x.numpy(), full.x.numpy()[:3], atol=1e-8)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-10)


def test_prior_with_indices_subset():
    pb = P.prior_block(torch.tensor([2.0, -1.0], dtype=torch.float64), 10.0 * torch.eye(2, dtype=torch.float64),
                       indices=torch.tensor([1, 3]))
    other = make_block(lambda x, _: torch.stack([x[0] - 5.0, x[2] + 1.0]), data=None)
    res = levenberg_marquardt(Problem(blocks=(pb, other)), torch.zeros(4, dtype=torch.float64), LMConfig())
    np.testing.assert_allclose(res.x.numpy(), [5.0, 2.0, -1.0, -1.0], atol=1e-8)


def test_non_pd_marginal_block_gives_nan_not_an_exception():
    H = np.diag([1.0, 2.0, -3.0, 4.0])
    b = np.ones(4)
    x_bar = np.zeros(4)
    keep = np.array([0, 1])
    jx, jS, joff = J.marginalize(jnp.asarray(H), jnp.asarray(b), jnp.asarray(x_bar), jnp.asarray(keep))
    tx, tS, toff = P.marginalize(torch.as_tensor(H), torch.as_tensor(b), torch.as_tensor(x_bar), torch.as_tensor(keep))
    assert np.isnan(_np(tS)).any() and np.isnan(_np(toff)).all()
    for a, c in ((tS, jS), (toff, joff)):
        np.testing.assert_array_equal(_np(a), _np(c))  # NaN where JAX's is, 0 where JAX's is


# ---- marginalize_oldest (tests/test_pgo_marginalization.py) ----------------

CFG = JP.PGOConfig(max_iterations=30)


def _port(graph):
    prior = None
    if graph.prior is not None:
        prior = {f.name: np.asarray(getattr(graph.prior, f.name)) for f in dataclasses.fields(graph.prior)}
    return pose_graph_from_numpy(*(np.asarray(getattr(graph, f)) for f in
                                   ("poses", "edge_i", "edge_j", "measurements", "information")),
                                 n_fixed=graph.n_fixed, prior=prior, device="cpu")


def _pcfg(cfg=CFG):
    return pgo_config_from_fields(dataclasses.asdict(cfg))


def _assert_same_graph(t, j):
    for f in ("poses", "edge_i", "edge_j", "measurements", "information"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)), rtol=0, atol=1e-12, err_msg=f)
    assert t.n_fixed == j.n_fixed
    for f in ("x_ref", "sqrt_info", "offset"):
        np.testing.assert_allclose(_np(getattr(t.prior, f)), _np(getattr(j.prior, f)), rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(_np(getattr(j.prior, f))).max())), err_msg=f)
    np.testing.assert_array_equal(_np(t.prior.idx), _np(j.prior.idx))


def _assert_same_solve(t, j):
    assert int(t.status) == int(j.status) and int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0, atol=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_linearization():
    """The JAX package's marginalize_oldest runs eagerly, and its eager
    vmap(jacfwd) compiles each operation on first use (15–19 s a graph
    shape on the CPU): its _linearize and _assemble run jitted here, the
    same operations in one program."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_linearize", jax.jit(JP._linearize))
        mp.setattr(JP, "_assemble", jax.jit(JP._assemble))
        yield


@pytest.fixture(scope="module")
def converged_chain():
    """test_pgo_marginalization's chain (7 poses, 1e-4 noise) solved by both,
    then its oldest pose marginalized by both."""
    graph = _chain_graph(n=7, noise=1e-4)
    j = JP.solve_pgo(graph, CFG)
    t = PP.solve_pgo(_port(graph), _pcfg())
    _assert_same_solve(t, j)
    jg, tg = dataclasses.replace(graph, poses=j.poses), dataclasses.replace(_port(graph), poses=t.poses)
    return jg, tg, j, JP.marginalize_oldest(jg, 1), PP.marginalize_oldest(tg, 1)


def test_marginalize_oldest_matches_jax_and_is_stationary(converged_chain):
    _, _, jres, jred, tred = converged_chain
    assert tred.poses.shape[0] == 6 and tred.prior is not None and tred.n_fixed == 0
    _assert_same_graph(tred, jred)
    j2 = JP.solve_pgo(jred, CFG)
    t2 = PP.solve_pgo(tred, _pcfg())
    _assert_same_solve(t2, j2)
    # marginalizing at the solution leaves the kept poses there
    np.testing.assert_allclose(t2.poses.numpy(), np.asarray(jres.poses[1:]), atol=1e-7)


def test_marginalize_then_new_edge_matches_full(converged_chain):
    """Sliding window: marginalize pose 0, add an edge among kept poses; the
    window's solve matches the full graph's with the same edge."""
    _, tg, jres, jred, tred = converged_chain
    Ti = np.asarray(jse3.transform_from_params6(jres.poses[1]))
    Tj = np.asarray(jse3.transform_from_params6(jres.poses[5]))
    E = np.linalg.inv(Ti) @ Tj
    z_new = np.concatenate([E[:3, 3], np.asarray(jso3.log(jnp.asarray(E[:3, :3])))])
    z_new = z_new + 2e-3 * np.random.default_rng(1).normal(size=6)

    def add_edge(g, i, j):
        cat = torch.cat if isinstance(g.poses, torch.Tensor) else jnp.concatenate
        arr = torch.as_tensor if cat is torch.cat else jnp.asarray
        return dataclasses.replace(
            g,
            edge_i=cat([g.edge_i, arr([i])]),
            edge_j=cat([g.edge_j, arr([j])]),
            measurements=cat([g.measurements, arr(z_new)[None]]),
            information=cat([g.information, arr(np.eye(6))[None]]),
        )

    full = PP.solve_pgo(add_edge(tg, 1, 5), _pcfg())
    win_t = PP.solve_pgo(add_edge(tred, 0, 4), _pcfg())
    _assert_same_solve(win_t, JP.solve_pgo(add_edge(jred, 0, 4), CFG))
    np.testing.assert_allclose(win_t.poses.numpy(), full.poses.numpy()[1:], atol=1e-5)


def test_sequential_marginalization_matches_jax(converged_chain):
    """Marginalize twice in a row: the first prior folds into the second."""
    _, _, jres, jred1, tred1 = converged_chain
    j1, t1 = JP.solve_pgo(jred1, CFG), PP.solve_pgo(tred1, _pcfg())
    jred2 = JP.marginalize_oldest(dataclasses.replace(jred1, poses=j1.poses), 1)
    tred2 = PP.marginalize_oldest(dataclasses.replace(tred1, poses=t1.poses), 1)
    _assert_same_graph(tred2, jred2)
    t2 = PP.solve_pgo(tred2, _pcfg())
    _assert_same_solve(t2, JP.solve_pgo(jred2, CFG))
    np.testing.assert_allclose(t2.poses.numpy(), np.asarray(jres.poses[2:]), atol=1e-6)


def test_marginalize_oldest_of_an_unsolved_graph_matches_jax_and_rejects_cg():
    graph = _chain_graph()
    jred = JP.marginalize_oldest(graph, 2)
    tred = PP.marginalize_oldest(_port(graph), 2)
    _assert_same_graph(tred, jred)
    with pytest.raises(ValueError, match="dense"):
        PP.solve_pgo(tred, PP.PGOConfig(solver="cg"))
    lonely = dataclasses.replace(_port(graph), edge_i=torch.tensor([2]), edge_j=torch.tensor([3]),
                                 measurements=torch.zeros(1, 6, dtype=torch.float64),
                                 information=torch.eye(6, dtype=torch.float64)[None], n_fixed=0)
    with pytest.raises(ValueError, match="slice them off"):
        PP.marginalize_oldest(lonely, 1)
