"""The port's self-calibrating BA against the JAX package's.

Mirrors tests/test_ba_intrinsics.py with that file's own bounds, and holds
the port's closed-form intrinsics Jacobian and ``solve_ba_selfcal`` against
the JAX package's in float64 on the CPU:

* K = ∂r/∂θ against JAX's ``jacfwd``, the 9 GN blocks against its segment
  sums: 1e-12 relative to the largest entry (the same algebra in another
  summation order);
* the damped (cams, pts, θ) step through 400 CG iterations: 1e-9;
* ``solve_ba_selfcal`` stops on ``rel_cost_tol`` before the noise floor
  (where the accept decisions are roundoff's choice): status and iterations
  equal, θ, cameras, points and cost to 1e-9 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_intrinsics as jbi
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_intrinsics as tbi
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.parallel.mesh import Mesh

from test_ba import make_synthetic_ba
from test_torch_ba_cg import dense_oracle, port, rel_err

WRONG = [8.0, -6.0, 3.0, -2.0]  # tests/test_ba_intrinsics.py's perturbation


def _lam(x):
    return torch.tensor(x, dtype=torch.float64)


def _solve_delta(prob, blocks, lam, cfg, plans):
    """``_solve_delta_full`` of an unsharded problem: its one shard's rows
    hold W, the other eight blocks are the mesh's sums."""
    U, V, W, *sums = blocks
    mesh = Mesh(devices=(prob.camera_params.device,))
    return tbi._solve_delta_full(prob, (U, V, *sums), lam, cfg, mesh, [(prob, plans, W)])


def test_selfcal_schur_matches_dense_oracle():
    """One damped (cams, pts, θ) solve ≡ the dense (6C+3L+4) damped solve."""
    jprob, _ = make_synthetic_ba(C=3, L=14, n_fixed=1)
    prob = port(jprob)
    plans = tba._plans(prob)
    r, A, B, K = tbi._linearize_full(prob)
    blocks = tbi._gn_blocks_full(prob, r, A, B, K, plans)
    cfg = tba.BAConfig(cg_iterations=400, cg_tol=1e-14)
    d_cam, d_pt, d_t = _solve_delta(prob, blocks, _lam(1e-4), cfg, plans)
    delta = dense_oracle(jprob, (A.numpy(), B.numpy()), r.numpy(), 1e-4, n_extra=4, extra=K.numpy())
    C, L = 3, 14
    np.testing.assert_allclose(d_cam.numpy().reshape(-1), delta[: 6 * C], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(d_pt.numpy().reshape(-1), delta[6 * C : 6 * C + 3 * L], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(d_t.numpy(), delta[6 * C + 3 * L :], rtol=1e-5, atol=1e-9)


def test_selfcal_linearization_blocks_and_step_match_jax():
    jprob, gt = make_synthetic_ba(C=4, L=20, noise=0.3, seed=2)
    jprob = dataclasses.replace(jprob, intrinsics=gt.intrinsics + jnp.asarray(WRONG))
    prob = port(jprob)
    plans = tba._plans(prob)
    jlin = jax.jit(jbi._linearize_full)(jprob)
    lin = tbi._linearize_full(prob)
    for t, j in zip(lin, jlin):
        assert rel_err(t, j) < 1e-12
    jblocks = jax.jit(jbi._gn_blocks_full)(jprob, *jlin)
    blocks = tbi._gn_blocks_full(prob, *lin, plans)
    for name, t, j in zip(("U", "V", "W", "P", "Y", "Z", "g", "h", "g_t"), blocks, jblocks):
        assert rel_err(t, j) < 1e-12, name
    cfg = jba.BAConfig(cg_iterations=400, cg_tol=1e-14)
    jd = jax.jit(jbi._solve_delta_full, static_argnames=("config",))(jprob, jblocks, 1e-3, config=cfg)
    td = _solve_delta(prob, blocks, _lam(1e-3), interop.ba_config_from_fields(dataclasses.asdict(cfg)), plans)
    for t, j in zip(td, jd):
        assert rel_err(t, j) < 1e-9


def test_selfcal_recovers_perturbed_intrinsics():
    """Wrong focal lengths and principal point: self-calibrating BA recovers
    the true intrinsics and geometry (noise-free observations)."""
    start, gt = make_synthetic_ba(C=6, L=60, n_fixed=2, seed=13)
    start = dataclasses.replace(start, intrinsics=gt.intrinsics + jnp.asarray(WRONG))
    res, intr = tbi.solve_ba_selfcal(port(start), tba.BAConfig(max_iterations=40))
    assert float(res.cost) < 1e-9
    np.testing.assert_allclose(intr.numpy(), np.asarray(gt.intrinsics), atol=1e-2)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(gt.points), atol=1e-4)
    assert res.trace == {}


def test_selfcal_fixed_intrinsics_consistency():
    """With the intrinsics already exact, self-cal matches plain BA."""
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=14)
    prob = port(start)
    res_plain = tba.solve_ba(prob, tba.BAConfig(max_iterations=30))
    res_cal, intr = tbi.solve_ba_selfcal(prob, tba.BAConfig(max_iterations=30))
    assert float(res_cal.cost) < 1e-10
    np.testing.assert_allclose(intr.numpy(), np.asarray(gt.intrinsics), atol=1e-4)
    np.testing.assert_allclose(res_cal.points.numpy(), res_plain.points.numpy(), atol=1e-5)


def test_solve_ba_selfcal_matches_jax():
    jprob, gt = make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)
    jprob = dataclasses.replace(jprob, intrinsics=gt.intrinsics + jnp.asarray(WRONG))
    cfg = jba.BAConfig(max_iterations=20, rel_cost_tol=1e-10)
    jres, jintr = jbi.solve_ba_selfcal(jprob, cfg)
    tres, tintr = tbi.solve_ba_selfcal(port(jprob), interop.ba_config_from_fields(dataclasses.asdict(cfg)))
    assert int(jres.status) == Status.CONVERGED and int(jres.iterations) >= 4
    assert int(tres.status) == int(jres.status)
    assert int(tres.iterations) == int(jres.iterations)
    assert rel_err(tintr, jintr) < 1e-9
    assert rel_err(tres.camera_params, jres.camera_params) < 1e-9
    assert rel_err(tres.points, jres.points) < 1e-9
    assert abs(float(tres.cost) / float(jres.cost) - 1) < 1e-9
    assert tres.trace == jres.trace == {}
    j = jbi.ba_step_selfcal(jprob, -1.0, cfg)
    t = tbi.ba_step_selfcal(port(jprob), -1.0, interop.ba_config_from_fields(dataclasses.asdict(cfg)))
    for tv, jv in zip(t[:3], j[:3]):
        assert rel_err(tv, jv) < 1e-9
    assert t[4] == bool(j[4]) and int(t[5]) == int(j[5])
