"""The port's examples (``moptimizer_0_tpu_torch/examples``) on the CPU, against
the JAX package's ``examples/`` scripts and solves of the same inputs.

Each example runs through its ``main``/``run`` with ``device="cpu"``, in
float64 where the JAX side runs in float64 here (the suite's x64 mode), at
the JAX script's sizes unless said. Tolerances and why:

* the curve fit: x and the cost against JAX's solve of the same residual
  to 1e-9 relative (the single solver's parity bound); the example runs to
  the noise floor, where the stop (SMALL_DELTA or CONVERGED) and its
  iteration are roundoff's choice, so they are not compared;
* ``bundle_adjustment``: the start against the JAX script's (its numpy
  draws in its order, its projection) at 1e-12, the printed initial and
  final costs as JAX computes them, and the CG solve against the JAX
  package's at 1e-8 absolute (``tests/test_ba.py``'s sharding bound; both
  stop at the noise floor, where the last steps are roundoff); the
  ``"auto"`` route's dense solve at the same minimum, its cost to 1e-9
  relative;
* ``cross_check_scipy``: its three checks against SciPy, at the JAX
  script's tolerances;
* ``icp_registration``: every 10th point of fachada (2,931), written to a
  file and passed as the path: x within 2e-3 of the truth (the smoke's ICP
  bound on the card);
* ``fleet_and_fixed_lag``: its three asserts, at B = 4 × 500 points and 6
  scans of 1,024 points (window 3) to keep the file short;
* ``sfm_reconstruct``: ``run(C=5, L=120, seed=3)`` to
  ``tests/test_sfm_example.py``'s bounds (aligned RMS < 0.08, reprojection
  RMS < 1 px); the scene's pixels against JAX's projection plus the same
  noise draws, and the numpy stages against the JAX script's, at 1e-12;
  ``resect_camera`` at 1e-9.
"""

import contextlib
import io
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import levenberg_marquardt as j_lm
from moptimizer_0_tpu.core.residual import make_block as j_make_block
from moptimizer_0_tpu.core.residual import problem as j_problem
from moptimizer_0_tpu.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.examples import (
    bundle_adjustment,
    cross_check_scipy,
    curve_fitting,
    fleet_and_fixed_lag,
    icp_registration,
    sfm_reconstruct,
)

from test_torch_ba_cg import FIELDS

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))


def _quiet(fn, *args, **kwargs):
    """fn's result and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def test_curve_fitting_matches_jax():
    res, text = _quiet(curve_fitting.main, device="cpu", dtype=torch.float64)
    blk = j_make_block(lambda x, d: jnp.array([d[1] - jnp.exp(x[0] * d[0] + x[1])]),
                       data=jnp.asarray(CERES_CURVE_DATA))
    ref = j_lm(j_problem(blk), jnp.zeros(2), JLMConfig())
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=1e-9)
    assert float(res.cost) == pytest.approx(float(ref.cost), rel=1e-9)
    assert Status(int(res.status)) in (Status.SMALL_DELTA, Status.CONVERGED)
    assert "it | prev_cost | new_cost" in text and "status = " in text


@pytest.mark.parametrize("check", ["curve_fitting", "powell", "rational"])
def test_cross_check_scipy(check):
    ok, text = _quiet(getattr(cross_check_scipy, check), torch.device("cpu"))
    assert ok, text


def test_cross_check_scipy_main():
    code, text = _quiet(cross_check_scipy.main, device="cpu")
    assert code == 0 and "ALL OK" in text


def test_icp_registration_on_a_subsample(tmp_path):
    cloud = np.loadtxt(ROOT / "tests" / "data" / "fachada.txt")[::10]
    path = tmp_path / "fachada_every_10th.txt"
    np.savetxt(path, cloud)
    (res, x_true), text = _quiet(icp_registration.main, str(path), device="cpu")
    assert f"loaded {len(cloud)} points" in text and len(cloud) == 2931
    assert Status(int(res.status)) != Status.NUMERIC_ERROR
    assert float((res.x - x_true).abs().max()) < 2e-3


def _jax_ba_start(C=8, L=200):
    """The JAX script's start, rebuilt from its numpy draws in its order
    (landmarks, cameras, pixel noise, camera and landmark perturbations)
    and its projection (``examples/bundle_adjustment.py``)."""
    import jax

    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(L, 3)) + np.array([0.0, 0.0, 10.0])
    cams = np.stack([np.concatenate([[2.0 * i - (C - 1), 0.3 * rng.normal(), 0.0], 0.05 * rng.normal(size=3)])
                     for i in range(C)])
    cam_idx, pt_idx = np.repeat(np.arange(C), L), np.tile(np.arange(L), C)
    intr = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    pixels = jax.vmap(jba._project, (0, 0, None))(jnp.asarray(cams)[cam_idx], jnp.asarray(pts)[pt_idx], intr)
    pixels = pixels + 0.3 * rng.normal(size=pixels.shape)
    return jba.BAProblem(
        camera_params=jnp.asarray(cams + np.concatenate([np.zeros((2, 6)), 0.02 * rng.normal(size=(C - 2, 6))])),
        points=jnp.asarray(pts + 0.1 * rng.normal(size=pts.shape)), cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx), pixels=jnp.asarray(pixels), intrinsics=intr, n_fixed_cameras=2,
    ), pts


def test_bundle_adjustment_matches_jax():
    (start, gt_points, res, res_auto), text = _quiet(bundle_adjustment.main, device="cpu", dtype=torch.float64)
    j_start, j_gt = _jax_ba_start()
    for k in FIELDS:
        np.testing.assert_allclose(getattr(start, k).numpy(), np.asarray(getattr(j_start, k)), rtol=1e-12)
    np.testing.assert_array_equal(gt_points.numpy(), j_gt)
    assert f"initial reprojection cost: {float(jba.compute_cost(j_start)):.1f}" in text
    ref = jba.solve_ba(j_start, jba.BAConfig(max_iterations=30))
    np.testing.assert_allclose(res.camera_params.numpy(), np.asarray(ref.camera_params), atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(ref.points), atol=1e-8)
    assert float(res.cost) == pytest.approx(float(ref.cost), rel=1e-9)
    assert f"final cost: {float(ref.cost):.3f}" in text
    # "auto" routes this scene to the dense engine, which reaches the same
    # minimum
    assert bundle_adjustment.ba.select_engine(start) == "dense"
    assert float(res_auto.cost) == pytest.approx(float(ref.cost), rel=1e-9)
    assert f"engine='auto' final cost: {float(ref.cost):.3f}" in text


def test_fleet_and_fixed_lag_small():
    (err, best_x, drift), text = _quiet(fleet_and_fixed_lag.main, B=4, N=500, k_scans=6, n_scan=1024, window=3,
                                        device="cpu")
    assert "ALL OK" in text
    assert err < 1e-3 and drift < 0.05
    np.testing.assert_allclose(best_x, [0.362, 0.556], atol=0.01)


def test_sfm_run_small():
    err, rms_px = sfm_reconstruct.run(C=5, L=120, seed=3, verbose=False, device="cpu", dtype=torch.float64)
    assert err < 0.08, err
    assert rms_px < 1.0, rms_px


def test_sfm_stages_match_jax():
    import jax

    import sfm_reconstruct as j_example

    C, L = 5, 120
    cams, pts, intr, obs_px = sfm_reconstruct.make_scene(np.random.default_rng(3), C, L)
    # the JAX script's draws: landmarks, one normal a camera, then the noise
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(pts, rng.uniform(-4, 4, size=(L, 3)) + np.array([0.0, 0.0, 12.0]))
    for _ in range(C):
        rng.normal()
    noise = 0.4 * rng.normal(size=(C, L, 2))
    proj = jax.vmap(jax.vmap(jba._project, (None, 0, None)), (0, None, None))(
        jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(intr))
    np.testing.assert_allclose(obs_px, np.asarray(proj) + noise, rtol=1e-12)

    fx, fy, cx, cy = intr
    x1, x2 = [np.stack([(p[:, 0] - cx) / fx, (p[:, 1] - cy) / fy], axis=1) for p in obs_px[:2]]
    E = sfm_reconstruct.essential_8pt(x1, x2)
    np.testing.assert_allclose(E, j_example.essential_8pt(x1, x2), rtol=1e-12, atol=1e-14)
    (R, t), (j_R, j_t) = sfm_reconstruct.decompose_essential(E, x1, x2), j_example.decompose_essential(E, x1, x2)
    np.testing.assert_allclose(R, j_R, atol=1e-12)
    np.testing.assert_allclose(t, j_t, atol=1e-12)
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    X = sfm_reconstruct.triangulate_dlt(P1, P2, x1, x2)
    np.testing.assert_allclose(X, j_example.triangulate_dlt(P1, P2, x1, x2), rtol=1e-12)
    track = sfm_reconstruct.triangulate_multi(None, intr, cams[:3], obs_px[:3, 7])
    np.testing.assert_allclose(track, j_example.triangulate_multi(None, intr, cams[:3], obs_px[:3, 7]), rtol=1e-9)
    assert np.abs(track - pts[7]).max() < 0.05

    x0 = cams[2] + 0.01
    r = sfm_reconstruct.resect_camera(pts, obs_px[2], intr, x0, device="cpu", dtype=torch.float64)
    j_r = j_example.resect_camera(pts, obs_px[2], intr, x0)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(j_r.x), rtol=1e-9, atol=1e-12)
    assert (int(r.status), int(r.iterations)) == (int(j_r.status), int(j_r.iterations))
    assert np.abs(r.x.numpy() - cams[2]).max() < 1e-2
