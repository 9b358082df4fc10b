"""The port's matrix-free Schur-CG bundle adjustment against the JAX package's.

Mirrors tests/test_ba.py (without its sharding test: distribution is not
ported); the engine routing is in test_torch_ba_routing.py. Both packages
get the same problems, built
in numpy/JAX and carried across as numpy, in float64 on the CPU.
Tolerances and why:

* Jacobians, GN blocks and the damped step: the port's closed forms and
  segment sums against JAX's ``jacfwd`` and ``segment_sum``, the same
  algebra summed in another order: 1e-12 relative to the largest entry
  (the step, through 200 CG iterations, 1e-9);
* full solves: status, iterations and NaN slots equal; costs, λ and the
  final state to 1e-9 relative, ρ to 1e-9 + 1e-12·|y0|/|y0 − yi|. Parity
  solves stop on ``rel_cost_tol`` before the noise floor, where y0 − yi is
  roundoff and the sign of ρ, and every later decision, is the summation
  order's choice;
* the mirrors of tests/test_ba.py keep that file's own bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu.core.loss import GemanMcClure as JGemanMcClure
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.loss import GemanMcClure
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.ops.pcg import pcg

from test_ba import make_synthetic_ba

FIELDS = ("camera_params", "points", "cam_idx", "pt_idx", "pixels", "intrinsics")


def port(jprob, loss=None):
    """The port's copy of a JAX BAProblem."""
    arrays = {k: np.asarray(getattr(jprob, k)) for k in FIELDS}
    return interop.ba_problem_from_numpy(
        **arrays, n_fixed_cameras=jprob.n_fixed_cameras, loss=loss, device="cpu"
    )


# the JAX side's stages under jit: one XLA compile each instead of one per
# primitive
_j_linearize = jax.jit(jba._linearize)
_j_gn_blocks = jax.jit(jba._gn_blocks)
_j_solve_delta = jax.jit(jba._solve_delta, static_argnames=("config",))


def rel_err(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def dense_oracle(prob, J_blocks, r, lam, n_extra=0, extra=None):
    """The damped dense solve of the (6C + 3L [+ n_extra]) system with the
    first camera's rows removed (tests/test_ba.py's oracle)."""
    C, L = prob.camera_params.shape[0], prob.points.shape[0]
    A, B = J_blocks
    cam_idx, pt_idx = np.asarray(prob.cam_idx), np.asarray(prob.pt_idx)
    O = len(cam_idx)
    n = 6 * C + 3 * L + n_extra
    J = np.zeros((2 * O, n))
    for o in range(O):
        c, l = cam_idx[o], pt_idx[o]
        J[2 * o : 2 * o + 2, 6 * c : 6 * c + 6] = A[o]
        J[2 * o : 2 * o + 2, 6 * C + 3 * l : 6 * C + 3 * l + 3] = B[o]
        if n_extra:
            J[2 * o : 2 * o + 2, 6 * C + 3 * L :] = extra[o]
    H = J.T @ J
    b = J.T @ np.asarray(r).reshape(-1)
    Hd = H + lam * np.diag(np.diag(H))
    free = np.ones(n, bool)
    free[:6] = False
    delta = np.zeros(n)
    delta[free] = np.linalg.solve(Hd[np.ix_(free, free)], -b[free])
    return delta


def _solve_delta(prob, U, V, W, g, h, lam, cfg, plans):
    """One damped step of the CG engine, called as ``_outer_step`` calls it:
    with the rows that ``_linearize_shards`` gives the problem's one shard,
    whose W must be the W given."""
    mesh, shards = tba._shards(prob)
    rows, _ = tba._linearize_shards(mesh, shards, [plans], prob.camera_params, prob.points)
    assert torch.equal(rows[0][2], W)
    return tba._solve_delta(prob, U, V, g, h, lam, cfg, mesh, rows)


def test_schur_solve_matches_dense_oracle():
    """One damped Schur-CG step ≡ the dense (6C+3L) damped solve (the bounds
    of tests/test_ba.py)."""
    jprob, _ = make_synthetic_ba(C=3, L=12, n_fixed=1)
    prob = port(jprob)
    plans = tba._plans(prob)
    r, A, B = tba._linearize(prob)
    U, V, W, g, h = tba._gn_blocks(prob, r, A, B, plans)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    cfg = tba.BAConfig(cg_iterations=200, cg_tol=1e-14)
    d_cam, d_pt = _solve_delta(prob, U, V, W, g, h, lam, cfg, plans)
    delta = dense_oracle(jprob, (A.numpy(), B.numpy()), r.numpy(), 1e-4)
    C = 3
    np.testing.assert_allclose(d_cam.numpy().reshape(-1), delta[: 6 * C], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(d_pt.numpy().reshape(-1), delta[6 * C :], rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("robust", [False, True])
def test_linearize_blocks_and_step_match_jax(robust):
    """The closed-form A, B against JAX's jacfwd, the GN blocks against its
    segment_sums, and one damped step against its _solve_delta."""
    jprob = make_synthetic_ba(C=5, L=40, noise=0.3, seed=7)[0]
    prob = port(jprob)
    if robust:
        jprob = dataclasses.replace(jprob, loss=JGemanMcClure(tau=jnp.asarray(2.0)))
        prob = dataclasses.replace(prob, loss=GemanMcClure(tau=torch.tensor(2.0, dtype=torch.float64)))
    plans = tba._plans(prob)
    jr, jA, jB = _j_linearize(jprob)
    r, A, B = tba._linearize(prob)
    for t, j in ((r, jr), (A, jA), (B, jB)):
        assert rel_err(t, j) < 1e-12
    jblocks = _j_gn_blocks(jprob, jr, jA, jB)
    blocks = tba._gn_blocks(prob, r, A, B, plans)
    for name, t, j in zip("UVWgh", blocks, jblocks):
        assert rel_err(t, j) < 1e-12, name
    cfg = jba.BAConfig(cg_iterations=200, cg_tol=1e-14)
    jd = _j_solve_delta(jprob, *jblocks, 1e-4, config=cfg)
    td = _solve_delta(prob, *blocks, torch.tensor(1e-4, dtype=torch.float64),
                      interop.ba_config_from_fields(dataclasses.asdict(cfg)), plans)
    for t, j in zip(td, jd):
        assert rel_err(t, j) < 1e-9
    Vd = tba._damp_blocks(blocks[1], 0.5)
    assert rel_err(tba._inv3x3(Vd), jba._inv3x3(jnp.asarray(Vd.numpy()))) < 1e-12
    np.testing.assert_allclose((tba._inv3x3(Vd) @ Vd).numpy(), np.broadcast_to(np.eye(3), Vd.shape),
                               atol=1e-9)


def test_ba_step_matches_jax():
    jprob = make_synthetic_ba(C=5, L=40, noise=0.3, seed=7)[0]
    cfg = jba.BAConfig()
    j = jba.ba_step(jprob, -1.0, cfg)
    t = tba.ba_step(port(jprob), -1.0, interop.ba_config_from_fields(dataclasses.asdict(cfg)))
    assert rel_err(t[0], j[0]) < 1e-9 and rel_err(t[1], j[1]) < 1e-9
    assert abs(float(t[2]) / float(j[2]) - 1) < 1e-9
    assert t[3] == bool(j[3]) and int(t[4]) == int(j[4])
    for key in ("cost", "cost_new", "lam"):
        assert abs(float(t[5][key]) / float(j[5][key]) - 1) < 1e-9, key


def _assert_same_solve(t, j):
    assert int(t.status) == int(j.status)
    assert int(t.iterations) == int(j.iterations)
    assert rel_err(t.camera_params, j.camera_params) < 1e-9
    assert rel_err(t.points, j.points) < 1e-9
    assert abs(float(t.cost) / float(j.cost) - 1) < 1e-9
    y0 = np.asarray(j.trace["cost"])
    gain = np.abs(y0) / np.maximum(np.abs(y0 - np.asarray(j.trace["cost_new"])), 1e-300)
    for key in tba.TRACE_KEYS:
        tv, jv = t.trace[key].numpy(), np.asarray(j.trace[key])
        np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv), err_msg=key)
        tol = 1e-9 + (1e-12 * np.nan_to_num(gain) if key == "rho" else 0.0)
        ok = np.isnan(jv) | (np.abs(tv - jv) <= tol * np.abs(jv))
        assert ok.all(), f"{key}: {tv[~ok]} != {jv[~ok]}"


def test_solve_ba_matches_jax():
    """solve_ba on make_synthetic_ba(C=5, L=40, noise=0.2): the whole trace
    and the cameras, stopping on rel_cost_tol before the noise floor."""
    jprob = make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)[0]
    cfg = jba.BAConfig(max_iterations=20, rel_cost_tol=1e-10)
    j = jba.solve_ba(jprob, cfg)
    t = tba.solve_ba(port(jprob), interop.ba_config_from_fields(dataclasses.asdict(cfg)))
    assert int(j.status) == Status.CONVERGED and int(j.iterations) >= 4
    _assert_same_solve(t, j)
    assert t.trace["trials"].tolist()[: int(t.iterations) + 1] == [1] * (int(t.iterations) + 1)


def test_ba_converges_to_ground_truth():
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=3)
    res = tba.solve_ba(port(start), tba.BAConfig(max_iterations=30))
    assert float(res.cost) < 1e-12
    np.testing.assert_allclose(res.camera_params.numpy(), np.asarray(gt.camera_params), atol=1e-5)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(gt.points), atol=1e-5)


def test_ba_noisy_reaches_low_cost():
    start, _ = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=4, noise=0.5)
    res = tba.solve_ba(port(start), tba.BAConfig(max_iterations=30))
    assert float(res.cost) < 2 * 0.5**2 * 2 * len(start.cam_idx)
    assert int(res.status) in (Status.SMALL_DELTA, Status.MAXIMUM_ITERATIONS_REACHED, Status.CONVERGED)


def test_ba_fixed_cameras_stay_fixed():
    start, _ = make_synthetic_ba(C=4, L=25, n_fixed=2, seed=5)
    prob = port(start)
    res = tba.solve_ba(prob, tba.BAConfig(max_iterations=20))
    assert torch.equal(res.camera_params[:2], prob.camera_params[:2])


def test_ba_robust_loss_downweights_outliers():
    """tests/test_ba.py's outlier case: Geman-McClure stays near the ground
    truth, the plain solve is dragged off; and the robust solve equals
    JAX's up to its noise floor."""
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=7)
    rng = np.random.default_rng(8)
    pixels = np.array(start.pixels)
    bad = rng.choice(len(pixels), size=10, replace=False)
    pixels[bad] += 300.0
    start_noisy = dataclasses.replace(start, pixels=jnp.asarray(pixels))
    cfg = tba.BAConfig(max_iterations=30)
    res_plain = tba.solve_ba(port(start_noisy), cfg)
    res_robust = tba.solve_ba(port(start_noisy, GemanMcClure(tau=torch.tensor(4.0, dtype=torch.float64))), cfg)
    gt_pts = np.asarray(gt.points)
    err_plain = float(np.max(np.abs(res_plain.points.numpy() - gt_pts)))
    err_robust = float(np.max(np.abs(res_robust.points.numpy() - gt_pts)))
    assert err_robust < 0.01
    assert err_robust < err_plain / 5


def test_ba_host_loop_matches_device_loop():
    start, _ = make_synthetic_ba(C=4, L=25, n_fixed=2, seed=11)
    prob = port(start)
    cfg = tba.BAConfig(max_iterations=10)
    a = tba.solve_ba(prob, cfg)
    b = tba.solve_ba(prob, cfg, host_loop=True)
    assert torch.equal(a.camera_params, b.camera_params) and torch.equal(a.points, b.points)
    assert int(a.iterations) == int(b.iterations)


def test_ba_rel_cost_tol_stops_early():
    start, _ = make_synthetic_ba(C=5, L=50, noise=0.5, seed=7)
    prob = port(start)
    base = tba.solve_ba(prob, tba.BAConfig(max_iterations=30))
    fast = tba.solve_ba(prob, tba.BAConfig(max_iterations=30, rel_cost_tol=1e-8))
    assert int(fast.iterations) <= int(base.iterations)
    assert int(fast.status) == Status.CONVERGED
    np.testing.assert_allclose(float(fast.cost), float(base.cost), rtol=1e-4)


def _pcg_every_iteration(matvec, b, precond, iters, tol):
    """The JAX package's _pcg loop: the test before every iteration."""
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        if not bool(torch.sum(r * r) > tol * tol):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, tiny)
        p = z + beta * p
        rz = rz_new
    return x


@pytest.mark.parametrize("tol", [1e-30, 1e-6])
def test_pcg_masked_test_equals_every_iteration(tol):
    """Reading the stopping test every N iterations and masking the ones
    past it gives the x of a test at every iteration, bit for bit, at every
    N; with tol 1e-6 the test fails part-way through a window."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(40, 40))
    A = torch.as_tensor(M @ M.T + 0.5 * np.eye(40))
    d = torch.as_tensor(1.0 / np.diag(M @ M.T + 0.5 * np.eye(40)))
    b = torch.as_tensor(rng.normal(size=40))

    def matvec(u):
        return A @ u

    def precond(u):
        return d * u

    ref = _pcg_every_iteration(matvec, b, precond, 60, tol)
    reads = []
    for check in (1, 2, 3, 5, 7, 32, 64):
        x = pcg(matvec, b, precond, 60, tol, lambda t: reads.append(1) or t.tolist(), check=check)
        assert torch.equal(x, ref), check
    if tol == 1e-6:
        assert float(torch.sum((b - A @ ref) ** 2)) <= 1e-12  # it stopped on the test
    assert len(reads) > 0
