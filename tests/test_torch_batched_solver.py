"""The port's batched LM solver and fleet ICP against the JAX package's.

Mirrors ``tests/test_batched_solver.py`` in float64 on the same numpy inputs:
each lane of ``levenberg_marquardt_batched`` must do what
``levenberg_marquardt`` does alone (x to 1e-8 relative, status equal; near
the noise floor max|δ| hovers at the √ε threshold, so the stop may move by a
few iterations, as the JAX file allows), and must agree with the JAX
package's batched solve. Solves that stop before the noise floor
(``rel_cost_tol``) are held trace for trace to their single solves.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.models.powell import powell_block as j_powell
from moptimizer_0_tpu.models.rational import rational_block as j_rational
from moptimizer_0_tpu.ops.nn_search import nearest_neighbors as j_nn
from moptimizer_0_tpu.registration import _icp_block_with_searcher as j_icp_block
from moptimizer_0_tpu.registration import icp_batched as j_icp_batched
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.models.curve_fitting import CERES_CURVE_DATA, exponential_curve_block
from moptimizer_0_tpu_torch.models.point2point import point2point_block
from moptimizer_0_tpu_torch.models.powell import powell_block
from moptimizer_0_tpu_torch.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_0_tpu_torch.parallel import make_mesh
from moptimizer_0_tpu_torch.registration import (
    _icp_block_with_searcher,
    icp,
    icp_batched,
    make_searcher,
)

CURVE_X0 = np.array([[0.0, 0.0], [0.3, 0.1], [1.2, 2.0], [-0.5, 0.4]])
POWELL_X0 = np.array([[3.0, -1.0, 0.0, 4.0], [1.0, 1.0, 1.0, 1.0], [-2.0, 3.0, 0.5, -1.5]])
RATIONAL_X0 = np.array([[0.9, 0.2], [1.9, 1.5], [50.0, -40.0], [-3.0, 0.01]])
ICP_X_TRUE = np.array(
    [
        [0.1, -0.05, 0.08, 0.02, -0.01, 0.03],
        [-0.07, 0.04, 0.02, -0.015, 0.02, 0.01],
        [0.03, 0.06, -0.04, 0.01, 0.015, -0.02],
    ]
)


def _curve_datas():
    data = CERES_CURVE_DATA
    return np.stack([data[:48], data[8:56], data[16:64], data[3:51]])  # (4, 48, 2)


def _j_curve_residual(x, d):
    return jnp.stack([d[1] - jnp.exp(x[0] * d[0] + x[1])])


def _numpy(res):
    def conv(v):
        return {k: conv(u) for k, u in v.items()} if isinstance(v, dict) else np.asarray(v)

    return {f.name: conv(getattr(res, f.name)) for f in dataclasses.fields(res)}


def _lane(res, i):
    def pick(v):
        return {k: pick(u) for k, u in v.items()} if isinstance(v, dict) else v[i]

    return {k: pick(v) for k, v in res.items()}


def _floor_start(res):
    """The first outer iteration at the noise floor: an accepted step whose
    cost change is below 1e-12 of the cost (``test_torch_solver.py``'s
    rule); infinity when none is."""
    tr, n = res["trace"], int(res["iterations"])
    at = tr["accepted"][:n] & (np.abs(tr["cost"][:n] - tr["cost_new"][:n]) <= 1e-12 * np.abs(tr["cost"][:n]))
    return int(np.argmax(at)) if at.any() else np.inf


def _assert_lane_equals_single(lane, single, trace=False, rtol=1e-9, cost_rel=1e-12):
    """x and cost to 1e-8 relative (rtol·10 where rtol is looser), status
    equal, and the lane takes its single solve's steps up to the first
    noise-floor iteration of either (the traces before it held to rtol);
    the same iterations, or, where a solve reached the floor, both ending
    within the floor's 1e-12 of the cost: a lane sums in another order than
    its single solve, and past the floor the sign of ρ, and with it how long
    the stop takes, is that order's choice. With ``trace``, the same
    iterations and the whole trace to rtol; ρ to rtol + cost_rel·|y0|/|y0 −
    yi| throughout."""
    np.testing.assert_allclose(lane["x"], single["x"], rtol=max(1e-8, 10 * rtol), atol=1e-12)
    assert int(lane["status"]) == int(single["status"])
    np.testing.assert_allclose(lane["cost"], single["cost"], rtol=max(1e-8, 10 * rtol), atol=1e-20)
    its = int(lane["iterations"]), int(single["iterations"])
    if trace:
        assert its[0] == its[1]
        _assert_traces(lane, single, None, rtol, cost_rel)
        return
    floor = min(_floor_start(lane), _floor_start(single))
    if its[0] != its[1]:
        assert floor <= min(its), (its, floor)
        assert abs(float(lane["cost"]) - float(single["cost"])) <= 1e-12 * abs(float(single["cost"])), its
    _assert_traces(lane, single, min(floor, *its), rtol, cost_rel)


def _assert_traces(lane, single, rows, rtol, cost_rel):
    """The lane's trace rows [0, rows) (all with None) against its single
    solve's."""
    tr, inner = (_rows(single["trace"], rows), _rows(single["trace"]["inner"], rows))
    mine, mine_inner = _rows(lane["trace"], rows), _rows(lane["trace"]["inner"], rows)
    # the lanes sum their costs in another order than a single solve;
    # ρ divides by y0 − yi, which magnifies that by |y0|/|y0 − yi|
    y0 = tr["cost"]
    gains = dict(
        rho=np.abs(y0) / np.maximum(np.abs(y0 - tr["cost_new"]), 1e-300),
        inner=np.abs(y0)[:, None] / np.maximum(np.abs(y0[:, None] - inner["cost_new"]), 1e-300),
    )
    for key in ("cost", "cost_new", "rho", "lam", "nu", "accepted"):
        gain = cost_rel * gains["rho"] if key == "rho" else None
        _assert_rows(mine[key], tr[key], key, gain, rtol)
    for key in ("cost_new", "rho", "lam", "nu", "accepted"):
        gain = cost_rel * gains["inner"] if key == "rho" else None
        _assert_rows(mine_inner[key], inner[key], "inner." + key, gain, rtol)


def _rows(tree, rows):
    return {k: v[:rows] for k, v in tree.items() if not isinstance(v, dict)}


def _assert_rows(a, b, key, extra=None, rtol=1e-9):
    """Equal NaN slots; values to rtol (+ extra, per slot, for ρ)."""
    if b.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=key)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
    if np.isnan(b).all():
        return
    tol = rtol if extra is None else rtol + np.nan_to_num(extra)
    ok = np.isnan(b) | (np.abs(a - b) <= tol * np.abs(b) + 1e-15 * np.nanmax(np.abs(b)))
    assert ok.all(), f"{key}: {a[~ok]} != {b[~ok]}"


@pytest.fixture(scope="module")
def jax_curve():
    blk = jres.make_block(_j_curve_residual, data=jnp.asarray(_curve_datas()))
    return _numpy(
        jsol.levenberg_marquardt_batched(jres.problem(blk), jnp.asarray(CURVE_X0), jsol.LMConfig(max_iterations=40))
    )


def test_batched_matches_individual_solves(jax_curve):
    """4 curve-fitting instances (different data subsets and starts, hence
    different iteration counts) ≡ 4 individual solves ≡ the JAX batch."""
    datas = _curve_datas()
    cfg = tsol.LMConfig(max_iterations=40)
    res = interop.result_to_numpy(
        tsol.levenberg_marquardt_batched(
            tres.problem(exponential_curve_block(datas)), torch.as_tensor(CURVE_X0), cfg
        )
    )
    assert res["x"].shape == (4, 2) and res["trace"]["inner"]["rho"].shape == (4, 40, 3)
    for i in range(4):
        single = _numpy(
            tsol.levenberg_marquardt(exponential_curve_block(datas[i]), torch.as_tensor(CURVE_X0[i]), cfg)
        )
        _assert_lane_equals_single(_lane(res, i), single)
    # against the JAX batch, whose costs sum in another order, the stops at
    # the noise floor may lie an iteration apart: x to 1e-7 relative
    np.testing.assert_allclose(res["x"], jax_curve["x"], rtol=1e-7)
    np.testing.assert_array_equal(res["status"], jax_curve["status"])
    np.testing.assert_allclose(res["cost"], jax_curve["cost"], rtol=1e-8)


def test_batched_none_data_block_replicates():
    """A data=None block batches over x0 only: Powell from 3 starts."""
    cfg = tsol.LMConfig(max_iterations=30)
    res = interop.result_to_numpy(
        tsol.levenberg_marquardt_batched(tres.problem(powell_block(analytic=True)), torch.as_tensor(POWELL_X0), cfg)
    )
    assert res["x"].shape == (3, 4)
    for i in range(3):
        single = _numpy(tsol.levenberg_marquardt(powell_block(analytic=True), torch.as_tensor(POWELL_X0[i]), cfg))
        _assert_lane_equals_single(_lane(res, i), single)
    np.testing.assert_allclose(res["x"], 0.0, atol=2e-4)
    j = jsol.levenberg_marquardt_batched(
        jres.problem(j_powell(analytic=True)), jnp.asarray(POWELL_X0), jsol.LMConfig(max_iterations=30)
    )
    np.testing.assert_allclose(res["x"], np.asarray(j.x), rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(res["status"], np.asarray(j.status))


def test_multistart_picks_best_basin():
    """Rational fit: some starts find the (0.362, 0.556) basin, some a worse
    stationary point or blow up; multistart returns the global one."""
    blk = rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=torch.float64)
    best, allres = tsol.solve_multistart(tres.problem(blk), torch.as_tensor(RATIONAL_X0), tsol.LMConfig(max_iterations=40))
    assert allres.x.shape == (4, 2) and best.x.shape == (2,)
    assert int(best.status) != tsol.Status.NUMERIC_ERROR
    np.testing.assert_allclose(best.x.numpy(), [0.362, 0.556], atol=0.01)
    costs, statuses = allres.cost.numpy(), allres.status.numpy()
    healthy = costs[statuses != tsol.Status.NUMERIC_ERROR]
    np.testing.assert_allclose(float(best.cost), healthy.min(), rtol=1e-12)
    assert best.trace["inner"]["rho"].shape == (40, 3)

    jblk = j_rational(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=jnp.float64)
    jbest, jall = jsol.solve_multistart(jres.problem(jblk), jnp.asarray(RATIONAL_X0), jsol.LMConfig(max_iterations=40))
    np.testing.assert_array_equal(statuses, np.asarray(jall.status))
    np.testing.assert_allclose(best.x.numpy(), np.asarray(jbest.x), rtol=1e-8)


def _log_blocks():
    """r = log(x): from x0 ≥ 3 the Gauss-Newton step lands below 0, so the
    first trial's cost is NaN and every lane ends in NUMERIC_ERROR at the
    finite cost log(x0)²."""
    return (
        tres.make_block(lambda x, _: torch.log(x[0:1]), data=None),
        jres.make_block(lambda x, _: jnp.log(x[0:1]), data=None),
    )


def test_multistart_all_numeric_error_returns_the_lowest_raw_cost():
    tb, jb = _log_blocks()
    x0 = np.array([[10.0], [4.0], [5.0]])
    best, allres = tsol.solve_multistart(tres.problem(tb), torch.as_tensor(x0))
    jbest, jall = jsol.solve_multistart(jres.problem(jb), jnp.asarray(x0))
    assert (allres.status.numpy() == tsol.Status.NUMERIC_ERROR).all()
    np.testing.assert_array_equal(allres.status.numpy(), np.asarray(jall.status))
    np.testing.assert_allclose(allres.cost.numpy(), np.log(x0[:, 0]) ** 2, rtol=1e-12)
    assert float(best.x[0]) == float(jbest.x[0]) == 4.0

    # an all-NaN batch: both argmins take the first NaN, so lane 0
    nan_costs = [3.0, np.nan, 1.0, np.nan]
    assert int(torch.argmin(torch.tensor(nan_costs))) == int(jnp.argmin(jnp.asarray(nan_costs))) == 1
    data = np.stack([CERES_CURVE_DATA[:20]] * 3)
    data[:, 4, 1] = np.nan
    best, allres = tsol.solve_multistart(
        tres.problem(exponential_curve_block(data)), torch.zeros(3, 2, dtype=torch.float64), batch_data=True
    )
    jblk = jres.make_block(_j_curve_residual, data=jnp.asarray(data))
    jbest, jall = jsol.solve_multistart(jres.problem(jblk), jnp.zeros((3, 2)), batch_data=True)
    assert np.isnan(allres.cost.numpy()).all() and np.isnan(np.asarray(jall.cost)).all()
    assert (allres.iterations.numpy() == np.asarray(jall.iterations)).all()
    np.testing.assert_array_equal(best.x.numpy(), np.asarray(jbest.x))


@pytest.mark.parametrize(
    "fields",
    [
        dict(linear_solver="lu"),
        dict(linear_solver="cholesky", trace_block_costs=True),
        dict(linear_solver="unrolled"),
        # fd reaches its noise floor (J to ~1e-8) long before the others do
        dict(linear_solver="cholesky", diff_mode="fd", rel_cost_tol=1e-6),
    ],
    ids=["lu", "cholesky_block_costs", "unrolled", "fd"],
)
def test_batched_lanes_equal_single_solves_trace_for_trace(fields):
    """Stopped before the noise floor, every lane's whole trace equals its
    single solve, and the lanes match the JAX batch (the unrolled solve and
    the forward-difference Jacobian run inside the batched loop too)."""
    datas = _curve_datas()
    fields = dict(dict(rel_cost_tol=1e-10, max_iterations=40), **fields)
    cfg = tsol.LMConfig(**fields)
    res = interop.result_to_numpy(
        tsol.levenberg_marquardt_batched(
            tres.problem(exponential_curve_block(datas)), torch.as_tensor(CURVE_X0), cfg
        )
    )
    for i in range(4):
        single = _numpy(
            tsol.levenberg_marquardt(exponential_curve_block(datas[i]), torch.as_tensor(CURVE_X0[i]), cfg)
        )
        # the lanes' H is a batched matrix product, an ulp away from the
        # single solve's (the linearizations agree to ~2e-16); from
        # x0 = (1.2, 2.0), where the residuals reach e⁸, fd's columns
        # (differences over h ≈ 1.5e-8) and the ill-conditioned first steps
        # magnify that to ~1e-7 of the trace within a few iterations
        tol = dict(rtol=1e-6, cost_rel=1e-6) if cfg.diff_mode == "fd" else {}
        _assert_lane_equals_single(_lane(res, i), single, trace=True, **tol)
        if cfg.trace_block_costs:
            _assert_rows(res["trace"]["block_costs"][i], single["trace"]["block_costs"], "block_costs")
    assert len(set(res["iterations"].tolist())) > 1  # lanes finish at different passes
    blk = jres.make_block(_j_curve_residual, data=jnp.asarray(datas))
    j = _numpy(jsol.levenberg_marquardt_batched(jres.problem(blk), jnp.asarray(CURVE_X0), jsol.LMConfig(**fields)))
    np.testing.assert_array_equal(res["iterations"], j["iterations"])
    np.testing.assert_array_equal(res["status"], j["status"])
    np.testing.assert_allclose(res["x"], j["x"], rtol=1e-6 if cfg.diff_mode == "fd" else 1e-9, atol=1e-12)


def _offset_blocks(datas):
    """r_i = x − d_i over two data points a lane."""
    return (
        tres.make_block(lambda x, d: x[0:1] - d, data=torch.as_tensor(datas)),
        jres.make_block(lambda x, d: x[0:1] - d, data=jnp.asarray(datas)),
    )


@pytest.mark.parametrize("rel_cost_tol", [0.0, 1e-6])
def test_lanes_at_the_edges_of_the_schedule_equal_single_solves(rel_cost_tol):
    """Lanes that leave the loop at different passes and in different ways:
    at x = 0 between data −1 and 1 the step is exactly 0, so ρ = 0/0 is NaN
    and falls through to accept (λ turns NaN; without rel_cost_tol the next
    pass ends in NUMERIC_ERROR, with it the zero decrease is CONVERGED); a
    lane that starts at its zero-cost optimum converges before any trial;
    the others run on. Each lane, trace and all, equals its single solve and
    the JAX batch."""
    datas = np.array([[[-1.0], [1.0]], [[-1.0], [1.0]], [[2.0], [2.0]], [[0.5], [4.0]]])
    x0s = np.array([[0.0], [3.0], [2.0], [40.0]])
    fields = dict(linear_solver="cholesky", rel_cost_tol=rel_cost_tol, max_iterations=8)
    tb, jb = _offset_blocks(datas)
    res = interop.result_to_numpy(tsol.levenberg_marquardt_batched(tb, torch.as_tensor(x0s), tsol.LMConfig(**fields)))
    for i in range(4):
        single = _numpy(
            tsol.levenberg_marquardt(_offset_blocks(datas[i])[0], torch.as_tensor(x0s[i]), tsol.LMConfig(**fields))
        )
        _assert_lane_equals_single(_lane(res, i), single, trace=True)
    assert np.isnan(res["trace"]["rho"][0, 0]) and res["trace"]["accepted"][0, 0]
    expected = tsol.Status.CONVERGED if rel_cost_tol else tsol.Status.NUMERIC_ERROR
    assert res["status"][0] == expected and res["iterations"][2] == 0
    assert res["status"][2] == tsol.Status.CONVERGED
    j = _numpy(jsol.levenberg_marquardt_batched(jres.problem(jb), jnp.asarray(x0s), jsol.LMConfig(**fields)))
    np.testing.assert_array_equal(res["status"], j["status"])
    np.testing.assert_array_equal(res["iterations"], j["iterations"])
    np.testing.assert_allclose(res["x"], j["x"], rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(np.isnan(res["trace"]["lam"]), np.isnan(j["trace"]["lam"]))


def _icp_scene():
    rng = np.random.default_rng(15)
    B, N = 3, 1500
    srcs = rng.uniform(0, 10, (B, N, 3))
    tgts = []
    for i in range(B):
        T = np.asarray(jse3.transform_from_params6(jnp.asarray(ICP_X_TRUE[i])))
        tgts.append(srcs[i] @ T[:3, :3].T + T[:3, 3])
    return srcs, np.stack(tgts)


def test_icp_batched_with_nn_update():
    """B full ICP solves (per-iteration correspondence search) in one loop:
    each lane matches the JAX package's icp_batched and the port's own
    single ``icp(nn_backend="xla")``."""
    srcs, tgts = _icp_scene()
    res = icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), max_corr_dist=1.0)
    assert res.x.shape == (3, 6)
    np.testing.assert_allclose(res.x.numpy(), ICP_X_TRUE, atol=1e-6)
    j = j_icp_batched(jnp.asarray(srcs), jnp.asarray(tgts), max_corr_dist=1.0)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j.x), atol=1e-9)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(j.iterations))
    for i in range(3):
        single = icp(torch.as_tensor(srcs[i]), torch.as_tensor(tgts[i]), nn_backend="xla", max_corr_dist=1.0)
        np.testing.assert_allclose(res.x[i].numpy(), single.x.numpy(), atol=1e-9)
        assert int(res.status[i]) == int(single.status)
    with pytest.raises(ValueError, match="must divide"):
        icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), mesh=make_mesh(2, device="cpu"))


def test_shared_data_with_a_vmapped_update_hook():
    """batch_data=False with an ICP block whose single-lane hook runs under
    vmap (the coarse multistart of the JAX package's PairwiseRegistrar):
    three starts on one pair, against the JAX batch."""
    srcs, tgts = _icp_scene()
    src, tgt = srcs[0, :500], tgts[0, :500]
    x0s = np.zeros((3, 6))
    x0s[:, :3] = np.median(tgt, 0) - np.median(src, 0)
    x0s[1, 5], x0s[2, 5] = 0.05, -0.05
    cfg = dict(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    tsrc, ttgt = torch.as_tensor(src), torch.as_tensor(tgt)
    blk = _icp_block_with_searcher(tsrc, ttgt, make_searcher(ttgt, "xla", 1.0), max_corr_dist=1.0)
    res = tsol.levenberg_marquardt_batched(
        tres.problem(blk), torch.as_tensor(x0s), interop.config_from_fields(cfg), batch_data=False
    )
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    jblk = j_icp_block(jsrc, jtgt, lambda w: j_nn(w, jtgt, backend="xla"), max_corr_dist=1.0)
    j = jsol.levenberg_marquardt_batched(jres.problem(jblk), jnp.asarray(x0s), jsol.LMConfig(**cfg), batch_data=False)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j.x), atol=1e-9)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(j.status))
    np.testing.assert_allclose(res.x.numpy(), np.broadcast_to(ICP_X_TRUE[0], (3, 6)), atol=1e-6)


def test_batched_icp_point2point():
    """B = 3 known-correspondence alignments in one loop: each recovers its
    own transform, as in the JAX batch."""
    rng = np.random.default_rng(13)
    B, N = 3, 5000
    srcs = rng.uniform(0, 20, (B, N, 3))
    x_true = np.array(
        [
            [1.0, -0.5, 0.3, 0.1, -0.2, 0.15],
            [-0.4, 0.8, 0.05, -0.05, 0.1, 0.2],
            [0.2, 0.1, -0.6, 0.3, 0.02, -0.1],
        ]
    )
    tgts = []
    for i in range(B):
        T = np.asarray(jse3.transform_from_params6(jnp.asarray(x_true[i])))
        tgts.append(srcs[i] @ T[:3, :3].T + T[:3, 3])
    blk = point2point_block(torch.as_tensor(srcs), torch.as_tensor(np.stack(tgts)))
    res = tsol.levenberg_marquardt_batched(
        tres.problem(blk), torch.zeros(B, 6, dtype=torch.float64), tsol.LMConfig(max_iterations=20)
    )
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-8)
