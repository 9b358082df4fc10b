"""The port's Levenberg-Marquardt solver against the JAX package's.

Both packages solve the same problems, built from the same numpy inputs:
status and iteration count must be equal, the accept flags of the whole
trace equal, NaN slots in the same places, and costs, λ and ν within rtol
1e-9 (costs that end at roundoff, ≈1e-20, are held to atol 1e-15 × the first
cost, where a relative error means nothing).

The two packages sum a cost over N residuals in different orders, so the
costs differ by up to about N·ε ≈ 1e-12 relative. ρ = (y0 − yi)/pred divides
their difference, which magnifies that by |y0|/|y0 − yi|; ρ is held to
rtol 1e-9 + 1e-12·|y0|/|y0 − yi|.
Once a solve reaches its noise floor, where y0 − yi is itself roundoff, the
sign of ρ, and with it every later decision, is decided by the summation
order. Parity solves therefore stop before it (``rel_cost_tol``); the plain
configuration is compared up to the floor and by where it ends. Where it
ends is itself set by the floor: a move δ of x from the minimum changes the
cost by δᵀHδ, and a change below one ulp of the cost is invisible, so x is
fixed only to ``_floor_reach`` = √(ulp(y*)/λ_min(H)) (3.1e-9 for the curve
fit), and two solves that run into the floor end up to twice that apart,
by the host's BLAS as much as by the package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import GemanMcClure as JGemanMcClure
from moptimizer_0_tpu import Huber as JHuber
from moptimizer_0_tpu import Cauchy as JCauchy
from moptimizer_0_tpu import TrivialLoss as JTrivialLoss
from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_0_tpu.models.point2point import point2point_block as jp2p
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core import linearize as tlin
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.core.manifold import Euclidean
from moptimizer_0_tpu_torch.models.point2point import point2point_block as tp2p
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

FACHADA = "tests/data/fachada.txt"
CURVE_MINIMUM = [0.291861, 0.131439]  # the Ceres curve-fitting minimum


def _jax_result_to_numpy(res):
    def conv(v):
        return {k: conv(u) for k, u in v.items()} if isinstance(v, dict) else np.asarray(v)

    return {f.name: conv(getattr(res, f.name)) for f in dataclasses.fields(res)}


def _assert_trace_equal(t, j, rtol=1e-9, rows=slice(None), cost_rel=1e-12):
    y0 = j["cost"]
    # how much the difference y0 − yi magnifies a last-bit difference of a cost
    gain = np.abs(y0) / np.maximum(np.abs(y0 - j["cost_new"]), 1e-300)
    inner_gain = np.abs(y0)[:, None] / np.maximum(np.abs(y0[:, None] - j["inner"]["cost_new"]), 1e-300)

    def check(tv, jv, key, gain_of=None):
        tv, jv = tv[rows], jv[rows]
        if jv.dtype == bool:
            np.testing.assert_array_equal(tv, jv, err_msg=key)
            return
        np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv), err_msg=key)
        tol = rtol if gain_of is None else rtol + cost_rel * np.nan_to_num(gain_of[rows])
        scale = np.nanmax(np.abs(jv)) if np.isfinite(jv).any() else 1.0
        ok = np.isnan(jv) | (np.abs(tv - jv) <= tol * np.abs(jv) + 1e-15 * scale)
        assert ok.all(), f"{key}: {tv[~ok]} != {jv[~ok]}"

    assert sorted(t) == sorted(j) and sorted(t["inner"]) == sorted(j["inner"])
    for k in j:
        if k != "inner":
            check(t[k], j[k], k, gain if k == "rho" else None)
    for k in j["inner"]:
        check(t["inner"][k], j["inner"][k], "inner." + k, inner_gain if k == "rho" else None)


def _assert_same_solve(t_res, j_res, x_atol=1e-9, rtol=1e-9, cost_rel=1e-12):
    t = interop.result_to_numpy(t_res)
    j = _jax_result_to_numpy(j_res)
    assert int(t["status"]) == int(j["status"])
    assert int(t["iterations"]) == int(j["iterations"])
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=x_atol)
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=rtol, atol=1e-15 * abs(j["trace"]["cost"][0]))
    _assert_trace_equal(t["trace"], j["trace"], rtol, cost_rel=cost_rel)
    return t


def _floor_reach(block, x):
    """√(ulp(y)/λ_min(H)) at x: how far x can move along H's weakest
    direction while the cost Σ‖r‖² changes by less than its last bit."""
    y, H, _ = tlin.linearize(tres.problem(block), torch.as_tensor(np.array(x, dtype=np.float64)))
    return float(np.sqrt(np.spacing(float(y)) / float(torch.linalg.eigvalsh(H)[0])))


def _curve_blocks(data=CERES_CURVE_DATA):
    tb = tres.make_block(
        lambda x, d: torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])]), data=torch.as_tensor(data)
    )
    jb = jres.make_block(
        lambda x, d: jnp.array([d[1] - jnp.exp(x[0] * d[0] + x[1])]), data=jnp.asarray(data)
    )
    return tb, jb


def _solve_both(tb, jb, x0, cfg_fields):
    t = tsol.levenberg_marquardt(tres.problem(*tb), torch.as_tensor(x0), interop.config_from_fields(cfg_fields))
    j = jsol.levenberg_marquardt(jres.problem(*jb), jnp.asarray(x0), jsol.LMConfig(**cfg_fields))
    return t, j


# rel_cost_tol=1e-10 ends these solves before their noise floor (see above)
@pytest.mark.parametrize(
    "fields",
    [
        dict(rel_cost_tol=1e-10),
        dict(linear_solver="cholesky", rel_cost_tol=1e-10),
        dict(rel_cost_tol=1e-3, linear_solver="cholesky"),
        dict(grad_tol=1e-2, max_iterations=40),
        dict(trace_block_costs=True, inner_iterations=2, rel_cost_tol=1e-10),
    ],
    ids=["lu", "cholesky", "rel_cost_tol", "grad_tol", "block_costs"],
)
def test_curve_fit_matches_jax(fields):
    tb, jb = _curve_blocks()
    t_res, j_res = _solve_both((tb,), (jb,), np.zeros(2), fields)
    t = _assert_same_solve(t_res, j_res)
    if fields.get("rel_cost_tol", 1) < 1e-6:
        np.testing.assert_allclose(t["x"], CURVE_MINIMUM, atol=1e-4)


def test_curve_fit_fd_matches_jax():
    """fd divides residual differences by h ≈ 1.5e-8, so the last-bit
    differences of the two packages' residuals reach the Jacobian at ~1e-8:
    costs, λ and ν are held to rtol 1e-7, ρ to 1e-7·|y0|/|y0 − yi| and x
    to 1e-8."""
    tb, jb = _curve_blocks()
    fields = dict(diff_mode="fd", linear_solver="cholesky", rel_cost_tol=1e-10)
    t_res, j_res = _solve_both((tb,), (jb,), np.zeros(2), fields)
    _assert_same_solve(t_res, j_res, x_atol=1e-8, rtol=1e-7, cost_rel=1e-7)


@pytest.mark.parametrize("linear_solver", ["lu", "cholesky"])
def test_curve_fit_drive_recipe_matches_jax_up_to_the_noise_floor(linear_solver):
    """The plain configuration runs into the noise floor: the traces agree on
    every outer iteration before it, and both solves end at the same x."""
    tb, jb = _curve_blocks()
    t_res, j_res = _solve_both((tb,), (jb,), np.zeros(2), dict(linear_solver=linear_solver))
    t, j = interop.result_to_numpy(t_res), _jax_result_to_numpy(j_res)
    tr = j["trace"]
    floor = tr["accepted"] & (np.abs(tr["cost"] - tr["cost_new"]) <= 1e-12 * np.abs(tr["cost"]))
    first = int(np.argmax(floor))
    assert floor.any() and first >= 10
    _assert_trace_equal(t["trace"], j["trace"], rows=slice(0, first))
    for r in (t, j):
        assert int(r["status"]) in (tsol.Status.SMALL_DELTA, tsol.Status.MAXIMUM_ITERATIONS_REACHED)
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=2 * _floor_reach(tb, j["x"]))
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=1e-12)
    np.testing.assert_allclose(t["x"], CURVE_MINIMUM, atol=1e-4)


def test_two_block_problem_and_accum_dtype_match_jax():
    """Two blocks sum into one system; float32 model with float64 accumulation."""
    data = CERES_CURVE_DATA
    tb1, jb1 = _curve_blocks(data[:30])
    tb2, jb2 = _curve_blocks(data[30:])
    fields = dict(linear_solver="cholesky", trace_block_costs=True, rel_cost_tol=1e-10)
    t_res, j_res = _solve_both((tb1, tb2), (jb1, jb2), np.zeros(2), fields)
    _assert_same_solve(t_res, j_res)

    data32 = data.astype(np.float32)
    tb, jb = _curve_blocks(data32)
    # float32 residuals reach their noise floor at a relative decrease near
    # 1e-5; stop well above it
    fields = dict(linear_solver="cholesky", accum_dtype="float64", rel_cost_tol=1e-3)
    t_res = tsol.levenberg_marquardt(tb, torch.zeros(2), interop.config_from_fields(fields))
    j_res = jsol.levenberg_marquardt(jb, jnp.zeros(2, jnp.float32), jsol.LMConfig(**fields))
    assert t_res.x.dtype == torch.float32 and t_res.cost.dtype == torch.float64
    assert int(t_res.status) == int(j_res.status)
    assert int(t_res.iterations) == int(j_res.iterations)
    np.testing.assert_allclose(t_res.x.numpy(), np.asarray(j_res.x), atol=1e-6)


@pytest.mark.parametrize("analytic", [False, True])
def test_index_aligned_point2point_on_fachada_matches_jax(analytic):
    cloud = load_txt_cloud(FACHADA)[::16]
    x_true = np.array([0.4, -0.3, 0.2, 0.05, -0.04, 0.06])
    T = np.array(jse3.transform_from_params6(jnp.asarray(x_true)))
    tgt = cloud @ T[:3, :3].T + T[:3, 3] + np.random.default_rng(0).normal(0, 1e-3, cloud.shape)
    tb = tp2p(torch.as_tensor(cloud), torch.as_tensor(tgt), analytic=analytic, fused=not analytic)
    jb = jp2p(jnp.asarray(cloud), jnp.asarray(tgt), analytic=analytic, fused=not analytic)
    fields = dict(diff_mode="analytic" if analytic else "auto", linear_solver="cholesky",
                  rel_cost_tol=1e-10)
    t_res, j_res = _solve_both((tb,), (jb,), np.zeros(6), fields)
    t = _assert_same_solve(t_res, j_res)
    if not analytic:  # the analytic Jacobian is exact only at x = 0
        np.testing.assert_allclose(t["x"], x_true, atol=1e-3)


def test_nan_data_gives_numeric_error():
    data = CERES_CURVE_DATA.copy()
    data[5, 1] = np.nan
    tb, jb = _curve_blocks(data)
    t_res, j_res = _solve_both((tb,), (jb,), np.zeros(2), dict(linear_solver="cholesky"))
    assert int(t_res.status) == int(j_res.status) == tsol.Status.NUMERIC_ERROR
    assert int(t_res.iterations) == int(j_res.iterations)


def test_lm_step_matches_jax():
    tb, jb = _curve_blocks()
    cfg = dict(linear_solver="cholesky")
    t_out = tsol.lm_step(tb, torch.zeros(2), -1.0, interop.config_from_fields(cfg))
    j_out = jsol.lm_step(jres.problem(jb), jnp.zeros(2), -1.0, jsol.LMConfig(**cfg))
    np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]), rtol=1e-9)
    np.testing.assert_allclose(float(t_out[2]), float(j_out[2]), rtol=1e-9)
    assert t_out[3] == bool(j_out[3]) and int(t_out[4]) == int(j_out[4])


def test_validation_and_later_slices_raise():
    with pytest.raises(ValueError, match="No residual block"):
        tres.problem()
    with pytest.raises(ValueError):
        tsol.LMConfig(max_iterations=-1)
    with pytest.raises(ValueError):
        tsol.LMConfig(linear_solver="qr")
    tb, _ = _curve_blocks()
    with pytest.raises(ValueError, match="unknown diff mode"):
        tsol.levenberg_marquardt(tb, torch.zeros(2), tsol.LMConfig(diff_mode="bogus"))
    # manifolds are ported: Euclidean(2) takes the steps of no manifold, in
    # the single, the batched and the multistart solve, to the bit. The
    # batched lanes sum in another order than the single solve, and this
    # plain configuration runs into the noise floor: across the two they
    # agree to twice the floor's reach (module docstring).
    flat = tsol.levenberg_marquardt(tb, torch.zeros(2, dtype=torch.float64))
    with_manifold = tsol.levenberg_marquardt(tb, torch.zeros(2, dtype=torch.float64), manifold=Euclidean(2))
    assert torch.equal(flat.x, with_manifold.x) and int(flat.iterations) == int(with_manifold.iterations)
    reach = 2 * _floor_reach(tb, flat.x)
    starts = torch.zeros(3, 2, dtype=torch.float64)
    batched = tsol.levenberg_marquardt_batched(tb, starts, manifold=Euclidean(2), batch_data=False)
    batched_flat = tsol.levenberg_marquardt_batched(tb, starts, batch_data=False)
    assert torch.equal(batched.x, batched_flat.x) and torch.equal(batched.iterations, batched_flat.iterations)
    torch.testing.assert_close(batched.x, flat.x.expand(3, 2), rtol=0, atol=reach)
    best, _ = tsol.solve_multistart(tb, starts, manifold=Euclidean(2))
    best_flat, _ = tsol.solve_multistart(tb, starts)
    assert torch.equal(best.x, best_flat.x)
    torch.testing.assert_close(best.x, flat.x, rtol=0, atol=reach)
    with pytest.raises(ValueError, match="No cost function"):
        tsol.levenberg_marquardt_batched(tres.Problem(blocks=()), torch.zeros(3, 2))


def test_interop_round_trip():
    jcfg = jsol.LMConfig(max_iterations=7, inner_iterations=2, diff_mode=("auto", "fd"),
                         linear_solver="cholesky", rel_cost_tol=1e-4, grad_tol=1e-6,
                         accum_dtype=jnp.float64, trace_block_costs=True)
    tcfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    assert tcfg == tsol.LMConfig(max_iterations=7, inner_iterations=2, diff_mode=("auto", "fd"),
                                 linear_solver="cholesky", rel_cost_tol=1e-4, grad_tol=1e-6,
                                 accum_dtype=torch.float64, trace_block_costs=True)
    sq = np.linspace(0.0, 9.0, 11)
    for kind, jloss, params in [
        ("TrivialLoss", JTrivialLoss(), {}),
        ("GemanMcClure", JGemanMcClure(tau=jnp.asarray(1.0)), {"tau": np.asarray(1.0)}),
        ("Huber", JHuber(delta=jnp.asarray(0.7)), {"delta": np.asarray(0.7)}),
        ("Cauchy", JCauchy(c=jnp.asarray(2.0)), {"c": np.asarray(2.0)}),
    ]:
        tloss = interop.loss_from_numpy(kind, params)
        assert type(tloss).__name__ == kind
        np.testing.assert_allclose(tloss.weight(torch.as_tensor(sq)).numpy(),
                                   np.asarray(jloss.weight(jnp.asarray(sq))), rtol=1e-14)
    with pytest.raises(ValueError, match="unknown loss"):
        interop.loss_from_numpy("Tukey", {})
    tb, _ = _curve_blocks()
    out = interop.result_to_numpy(tsol.levenberg_marquardt(tb, torch.zeros(2), tcfg.__class__(max_iterations=3)))
    assert sorted(out) == ["cost", "iterations", "lam", "status", "trace", "x"]
    assert all(isinstance(v, np.ndarray) for v in out["trace"]["inner"].values())
    assert out["trace"]["inner"]["cost_new"].shape == (3, 3)
