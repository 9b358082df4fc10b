"""The SLAM pipeline as a whole: the port against the JAX package on a short
sequence of ``tests/test_slam_sequence.py``'s world, and the chip smoke's
numpy copy of the bench's sequence.

* 8 scans × 2,048 points of the courtyard world (the first 8 poses of the
  test's 24-scan loop, 15° and 2.1 m apart, 1 cm sensor noise), float64,
  through ``scan_odometry`` with the bench's settings (grid search, a 0.5 m
  gate, the noise-floor stopping rule): relative poses to 1e-6 of JAX's,
  and the trajectory within the test's odometry bound;
* the same sequence through ``scan_slam`` with loop closures (0, 7) and
  (0, 6), for ICP and GICP: odometry and PGO poses to 1e-5 of JAX's (the
  PGO stops at its noise floor, where roundoff picks the iteration), ATE to
  rtol 1e-4 and within the test's SLAM bound; and through
  ``scan_slam_fixed_lag`` with a window of 4.
* ``chip_smoke.make_sequence`` gives ``benchmarks.slam_sequence_bench``'s
  scans and ground truth to 1e-12 in float64; ``chip_smoke`` imports no jax
  and builds nothing on import.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import slam_sequence_bench as bench
from moptimizer_0_tpu.core.solver import LMConfig as JLMConfig
from moptimizer_0_tpu.evaluation import ate_rmse as j_ate
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu import odometry as JO
from moptimizer_0_tpu import pose_graph as JP
from moptimizer_0_tpu.odometry import scan_odometry as j_scan_odometry
from moptimizer_0_tpu_torch import odometry as PO
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.core.solver import Status as P_STATUS
from moptimizer_0_tpu_torch.evaluation import ate_rmse, rpe
from moptimizer_0_tpu_torch.odometry import scan_odometry
from test_slam_sequence import ATE_ODOMETRY_BOUND, ATE_SLAM_BOUND, SENSOR_NOISE, loop_poses, make_world

K, N = 8, 2048
REL_ATOL = 1e-6
CFG = dict(diff_mode="auto", max_iterations=40, linear_solver="cholesky", rel_cost_tol=1e-6)


@pytest.fixture(scope="module")
def sequence():
    rng = np.random.default_rng(42)
    world = make_world(rng, N)
    Ts = [np.asarray(jse3.transform_from_params6(p)) for p in loop_poses()[:K]]
    scans = []
    for T in Ts:
        Tinv = np.linalg.inv(T)
        scans.append(world @ Tinv[:3, :3].T + Tinv[:3, 3] + SENSOR_NOISE * rng.normal(size=world.shape))
    T0inv = np.linalg.inv(Ts[0])
    gt = []
    for T in Ts:
        Tr = T0inv @ T
        gt.append(np.concatenate([Tr[:3, 3], np.asarray(jse3.se3_log(jnp.asarray(Tr)))[3:]]))
    return scans, np.stack(gt)


def test_sequence_front_end_matches_jax(sequence):
    scans, gt = sequence
    kw = dict(nn_backend="grid", max_corr_dist=0.5)
    jp, jrel = j_scan_odometry([jnp.asarray(s) for s in scans], config=JLMConfig(**CFG), **kw)
    tp, trel = scan_odometry([torch.as_tensor(s) for s in scans], config=LMConfig(**CFG), **kw)
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), rtol=0, atol=REL_ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=10 * REL_ATOL)
    ate = float(ate_rmse(tp, torch.as_tensor(gt), align=False))
    np.testing.assert_allclose(ate, float(j_ate(jp, jnp.asarray(gt), align=False)), rtol=1e-4)
    assert 1e-5 < ate < ATE_ODOMETRY_BOUND  # noise drifts the trajectory, within the bound
    assert float(rpe(tp, torch.as_tensor(gt))[0]) < 10 * SENSOR_NOISE


@pytest.mark.parametrize("method", ["icp", "gicp"])
def test_scan_slam_matches_jax(sequence, method):
    scans, gt = sequence
    kw = dict(method=method, loop_closures=[(0, K - 1), (0, K - 2)], nn_backend="grid", max_corr_dist=0.5)
    jres, jodo = JO.scan_slam([jnp.asarray(s) for s in scans], config=JLMConfig(**CFG), **kw)
    tres, todo = PO.scan_slam([torch.as_tensor(s) for s in scans], config=LMConfig(**CFG), **kw)
    np.testing.assert_allclose(todo.numpy(), np.asarray(jodo), rtol=0, atol=10 * REL_ATOL)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses), rtol=0, atol=10 * REL_ATOL)
    assert int(tres.status) == int(jres.status) != int(P_STATUS.NUMERIC_ERROR)
    ate_odo = float(ate_rmse(todo, torch.as_tensor(gt), align=False))
    ate = float(ate_rmse(tres.poses, torch.as_tensor(gt), align=False))
    np.testing.assert_allclose(ate, float(j_ate(jres.poses, jnp.asarray(gt), align=False)), rtol=1e-4)
    assert ate < ATE_SLAM_BOUND and ate_odo < ATE_ODOMETRY_BOUND


@pytest.fixture(scope="module")
def _jitted_jax_linearization():
    """The JAX package's marginalize_oldest runs eagerly, and its eager
    vmap(jacfwd) compiles each operation on first use: its _linearize and
    _assemble run jitted here, the same operations in one program."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "_linearize", jax.jit(JP._linearize))
        mp.setattr(JP, "_assemble", jax.jit(JP._assemble))
        yield


def test_scan_slam_fixed_lag_matches_jax(sequence, _jitted_jax_linearization):
    scans, gt = sequence
    kw = dict(window=4, method="icp", nn_backend="grid", max_corr_dist=0.5)
    jp = JO.scan_slam_fixed_lag([jnp.asarray(s) for s in scans], config=JLMConfig(**CFG), **kw)
    tp = PO.scan_slam_fixed_lag([torch.as_tensor(s) for s in scans], config=LMConfig(**CFG), **kw)
    assert tp.shape == (K, 6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=10 * REL_ATOL)
    ate = float(ate_rmse(tp, torch.as_tensor(gt), align=False))
    np.testing.assert_allclose(ate, float(j_ate(jp, jnp.asarray(gt), align=False)), rtol=1e-4)
    assert ate < ATE_ODOMETRY_BOUND


def test_chip_smoke_sequence_is_the_bench_sequence():
    import chip_smoke

    scans, gt = chip_smoke.make_sequence(3, 2048, dtype=torch.float64)
    b_scans, b_gt = bench.make_sequence(3, 2048, dtype=jnp.float64)
    assert len(scans) == len(b_scans) == 3
    for a, b in zip(scans, b_scans):
        assert a.dtype == torch.float64 and a.shape == (2048, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(b_gt), rtol=0, atol=1e-12)


def test_chip_smoke_imports_no_jax_and_builds_nothing():
    code = (
        "import sys, chip_smoke; from moptimizer_0_tpu_torch.kernels import nn_search, nn_expand, schur; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('moptimizer_0_tpu.') or m == 'moptimizer_0_tpu'); "
        "built = [k.NAME for k in (nn_search, nn_expand, schur) if k._launcher.cache_info().currsize]; "
        "print(bad, built); sys.exit(1 if bad or built else 0)"
    )
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
