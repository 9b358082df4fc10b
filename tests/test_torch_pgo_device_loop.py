"""The port's ``solve_pgo`` as a device loop, against the JAX package's.

On CUDA ``solve_pgo`` runs an outer iteration as one replay of a CUDA graph
captured once per layout, and a solve as max_iterations replays with no
host read after its edge plan (``pose_graph.py``, ``ops/device_loop.py``);
``chip_smoke.py`` phase 21 holds the graphs bit for bit to the same body run
eagerly on the card. Here, on the CPU in float64, that body runs eagerly
under the same ``StepLoop`` and is held to the JAX package's jitted
``solve_pgo`` (its ``while_loop``s) at the tolerances of
test_torch_pose_graph.py: poses to 1e-9, equal status and iterations, the
trace NaN where JAX's is, cost and λ to rtol 1e-9, ρ to rtol 1e-9 +
1e-12·|y0|/|y0 − y1|. Also: the layout keys (graphs that differ only in
their tensors share one loop; another P′ or N does not), a loop reused on
another graph of its layout, the layouts of a fixed-lag stream, and the
eager loop's host reads.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import Huber as JHuber
from moptimizer_0_tpu import pose_graph as J
from moptimizer_0_tpu_torch import odometry
from moptimizer_0_tpu_torch import pose_graph as P
from moptimizer_0_tpu_torch.interop import loss_from_numpy
from moptimizer_0_tpu_torch.ops import device_loop

from test_pose_graph import make_ring_graph
from test_torch_pose_graph import CG, DENSE, NOISE_FLOOR, _assert_same_solve, _bad_closure, _config, _port


def _drifted():
    return make_ring_graph(N=12, drift=0.03)[0], {}


def _exact():
    """The poses at the ground truth: y0 below 8ε, CONVERGED at 0 iterations."""
    graph, gt = make_ring_graph(N=12, drift=0.02, seed=2)
    return dataclasses.replace(graph, poses=gt), {}


def _prior_dominant():
    graph, gt = make_ring_graph(N=12, drift=0.0, seed=7)
    target = np.asarray(gt[1]) + np.array([0.5, -0.3, 0.2, 0.05, -0.04, 0.03])
    prior = J.PGOPrior(x_ref=jnp.asarray(target), sqrt_info=3.0 * jnp.eye(6), offset=jnp.zeros(6),
                       idx=jnp.arange(6, 12, dtype=jnp.int32))
    return dataclasses.replace(graph, poses=gt, prior=prior), {}


def _robust():
    graph, _ = _bad_closure()
    return graph, dict(jloss=JHuber(delta=jnp.asarray(0.5)), tloss=loss_from_numpy("Huber", {"delta": np.asarray(0.5)}))


def _non_pd():
    """A negative information: H + λ·diag(H) is indefinite, the dense
    factorization gives NaN and the solve ends NUMERIC_ERROR."""
    graph, _ = make_ring_graph(N=12, drift=0.03)
    info = np.array(graph.information)
    info[:] = -np.eye(6)
    return dataclasses.replace(graph, information=jnp.asarray(info)), {}


def _cg_cap():
    return make_ring_graph(N=12, drift=0.03, seed=10)[0], {}


CASES = {
    "drifted_dense": (_drifted, DENSE),
    "drifted_cg": (_drifted, CG),
    "converged0": (_exact, DENSE),
    "prior_dominant": (_prior_dominant, NOISE_FLOOR),
    "rel_cost_tol": (lambda: (make_ring_graph(N=12, drift=0.03, seed=8)[0], {}),
                     dataclasses.replace(DENSE, rel_cost_tol=1e-8)),
    "robust_huber": (_robust, NOISE_FLOOR),
    "numeric_error": (_non_pd, DENSE),
    "cg_cap": (_cg_cap, J.PGOConfig(max_iterations=8, solver="cg", cg_iterations=4)),
}


def _assert_same_start(t, j):
    """A solve that stops before its first trial: its one traced cost is the
    roundoff of a zero cost (~1e-30 in float64), which no relative
    tolerance can hold; both packages' lie below 8ε (1.8e-15) and within
    1e-28 of each other. The rest as ``_assert_same_solve``."""
    assert int(t.status) == int(j.status) and int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0, atol=1e-9)
    for k, v in j.trace.items():
        np.testing.assert_array_equal(torch.isnan(t.trace[k]).numpy(), np.isnan(np.asarray(v)), err_msg=k)
    cost = t.trace["cost"][0].item(), float(j.trace["cost"][0])
    assert max(cost) < 8 * np.finfo(np.float64).eps and abs(cost[0] - cost[1]) <= 1e-28
    np.testing.assert_allclose(t.trace["lam"][0].item(), float(j.trace["lam"][0]), rtol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_pgo_device_loop_matches_jax(case):
    """Status, iterations, poses and trace as the JAX package's jitted
    solve_pgo (``_assert_same_solve``); each case's defining outcome
    holds."""
    make, cfg = CASES[case]
    graph, losses = make()
    jg = graph if "jloss" not in losses else dataclasses.replace(graph, loss=losses["jloss"])
    j = J.solve_pgo(jg, cfg)
    t = P.solve_pgo(_port(graph, losses.get("tloss")), _config(cfg))
    status, iterations = P.Status(int(t.status)), int(t.iterations)
    if case == "converged0":
        _assert_same_start(t, j)
        assert status == P.Status.CONVERGED and iterations == 0 and torch.isnan(t.trace["rho"]).all()
        return
    _assert_same_solve(t, j)
    if case == "numeric_error":
        assert status == P.Status.NUMERIC_ERROR
    elif case == "rel_cost_tol":
        assert status == P.Status.CONVERGED
    elif case == "prior_dominant":
        assert iterations > 0
    elif case == "cg_cap":
        # each step's 4 CG iterations end it short of cg_tol: the outer loop
        # runs more iterations than the full-CG solve of the same graph
        full = J.solve_pgo(_cg_cap()[0], dataclasses.replace(cfg, cg_iterations=300, cg_tol=1e-13))
        assert iterations > int(full.iterations)


def _shifted(graph, seed):
    """A graph of the same layout with other tensors: the edges listed in
    another order (the same pose pairs), other measurements and poses."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(graph.edge_i.shape[0])
    return dataclasses.replace(
        graph,
        poses=graph.poses + 0.01 * torch.as_tensor(rng.normal(size=graph.poses.shape)),
        edge_i=graph.edge_i[order].clone(),
        edge_j=graph.edge_j[order].clone(),
        measurements=graph.measurements[order] + 0.01 * torch.as_tensor(rng.normal(size=(order.size, 6))),
        information=graph.information[order].clone(),
    )


def _key(graph, cfg):
    return P._layout(graph, cfg, P._EdgePlan(graph))


def test_layout_keys():
    """Two graphs equal in shape and plan structure but with other tensors
    have one key, and one loop of the layout cache serves both; another
    P′, N, n_fixed, loss, config or solver is another key."""
    a = _port(make_ring_graph(N=12, drift=0.03)[0])
    b = _shifted(a, 1)
    cfg = P.PGOConfig()
    assert _key(a, cfg) == _key(b, cfg)
    made = []
    store = collections.OrderedDict()
    for g in (a, b):
        device_loop.lookup(store, _key(g, cfg), lambda: made.append(1), device_loop.MAX_LOOPS)
    assert len(made) == 1 and len(store) == 1

    prior = lambda n: P.PGOPrior(x_ref=torch.zeros(6 * n, dtype=torch.float64),  # noqa: E731
                                 sqrt_info=torch.eye(6 * n, dtype=torch.float64),
                                 offset=torch.zeros(6 * n, dtype=torch.float64), idx=torch.arange(6, 6 + 6 * n))
    other_n = _port(make_ring_graph(N=14, drift=0.03)[0])
    changed = [
        _key(dataclasses.replace(a, prior=prior(1)), cfg),
        _key(dataclasses.replace(a, prior=prior(2)), cfg),
        _key(other_n, cfg),
        _key(dataclasses.replace(a, n_fixed=2), cfg),
        _key(dataclasses.replace(a, loss=loss_from_numpy("Huber", {"delta": np.asarray(0.5)})), cfg),
        _key(a, dataclasses.replace(cfg, max_iterations=7)),
        _key(a, dataclasses.replace(cfg, solver="cg")),
    ]
    base = _key(a, cfg)
    assert all(k != base for k in changed)
    assert len(set(changed)) == len(changed)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_a_loop_reused_on_another_graph_of_its_layout(solver):
    """The loop made for one graph, started on another of the same layout,
    solves that one bit for bit as a loop of its own: the body reads every
    tensor (edges, measurements, information, plan) from its carry."""
    a = _port(make_ring_graph(N=12, drift=0.03)[0])
    b = _shifted(a, 2)
    cfg = P.PGOConfig(max_iterations=20, solver=solver)
    plan_a, plan_b = P._EdgePlan(a), P._EdgePlan(b)
    assert P._layout(a, cfg, plan_a) == P._layout(b, cfg, plan_b)
    loop = P._pgo_loop(a, cfg, plan_a)
    loop.start(P._carry(b, plan_b))
    loop.solve(cfg.max_iterations, P._read)
    fresh = P.solve_pgo(b, cfg)
    assert torch.equal(loop.carry[0], fresh.poses)
    assert int(loop.it) == int(fresh.iterations) and int(loop.status) == int(fresh.status)
    for k, v in fresh.trace.items():
        assert torch.equal(torch.nan_to_num(loop.trace[k], nan=7.0), torch.nan_to_num(v, nan=7.0)), k
    assert not torch.equal(fresh.poses, P.solve_pgo(a, cfg).poses)


def test_fixed_lag_stream_layouts(monkeypatch):
    """scan_slam_fixed_lag's window solves (24 scans, window 8): the windows
    of 2…9 poses without a prior, then one layout of 9 poses with the
    marginal prior (P′ = 6) for every later scan: 9 layouts for 23 solves."""
    rng = np.random.default_rng(3)
    step = torch.tensor([0.3, 0.0, 0.0, 0.0, 0.0, 0.05], dtype=torch.float64)
    monkeypatch.setattr(odometry, "make_registrar", lambda *a, **k: None)
    monkeypatch.setattr(odometry, "register_pair", lambda *a, **k: (
        step + 1e-3 * torch.as_tensor(rng.normal(size=6)), None))
    keys = []
    real = P.solve_pgo

    def spy(graph, config):
        keys.append(_key(graph, config))
        return real(graph, config)

    monkeypatch.setattr(P, "solve_pgo", spy)
    scans = [torch.zeros(4, 3, dtype=torch.float64)] * 24
    poses = odometry.scan_slam_fixed_lag(scans, window=8)
    assert poses.shape == (24, 6) and torch.isfinite(poses).all()
    assert len(keys) == 23
    assert len(set(keys)) == 9 and len(set(keys[7:])) == 2 and len(set(keys[8:])) == 1


def test_eager_loop_host_reads(monkeypatch):
    """The eager loop reads ¬done once an outer iteration (and once more
    when a solve ends before max_iterations), ¬stop before each trial and
    once more where the trials stopped before inner_iterations; the edge
    plan reads 2 values a level and 1."""
    trials = []
    real_linearize, real_step = P._linearize, P._dense_step

    def linearize(graph):
        trials.append(0)
        return real_linearize(graph)

    def dense_step(*args):
        trials[-1] += 1
        return real_step(*args)

    monkeypatch.setattr(P, "_linearize", linearize)
    monkeypatch.setattr(P, "_dense_step", dense_step)
    for graph, cfg in ((_drifted()[0], DENSE), (_exact()[0], DENSE), (_non_pd()[0], DENSE),
                       (make_ring_graph(N=12, drift=0.03, seed=8)[0], J.PGOConfig(max_iterations=2))):
        tg = _port(graph)
        plan = P._EdgePlan(tg)
        plan_reads = 2 * (len(plan.nodes[0]) + len(plan.blocks[0])) + 1
        trials.clear()
        reads = P.HOST_READS
        res = P.solve_pgo(tg, _config(cfg))
        reads = P.HOST_READS - reads
        outer = len(trials)  # the terminal iteration runs, but is not counted
        assert outer - int(res.iterations) in (0, 1)
        n_inner = cfg.inner_iterations
        expected = plan_reads + outer + sum(t + (t < n_inner) for t in trials) + (outer < cfg.max_iterations)
        assert reads == expected, (reads, expected, trials)
