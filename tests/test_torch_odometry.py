"""The port's scan odometry (``odometry.py``) against the JAX package's,
float64 on ``tests/test_odometry.py``'s scene: chain_poses, register_pair
(with each method) and scan_odometry through brute force ("xla") and through
the grid, poses to 1e-9; the lag-W overflow window; and an import that pulls
in the port's pose_graph and no jax."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import odometry as J
from moptimizer_0_tpu.core.solver import LMConfig as JLMConfig
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.lie import so3 as jso3
from moptimizer_0_tpu_torch import odometry as P
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.evaluation import ate_rmse
from moptimizer_0_tpu_torch.registration import PairwiseRegistrar
from test_odometry import _structured_scene

POSE_ATOL = 1e-9


@pytest.fixture(scope="module")
def scene():
    """tests/test_odometry.py's trajectory: 5 poses, scan k the scene in the
    sensor frame of pose k."""
    rng = np.random.default_rng(0)
    pts = _structured_scene(rng)
    poses, cur = [], np.zeros(6)
    step = np.array([0.4, 0.1, 0.02, 0.01, 0.03, 0.05])
    for _ in range(5):
        poses.append(cur.copy())
        Tn = np.asarray(jse3.transform_from_params6(jnp.asarray(cur))) @ np.asarray(
            jse3.transform_from_params6(jnp.asarray(step))
        )
        cur = np.concatenate([Tn[:3, 3], np.asarray(jso3.log(jnp.asarray(Tn[:3, :3])))])
    scans = []
    for p in poses:
        Tinv = np.linalg.inv(np.asarray(jse3.transform_from_params6(jnp.asarray(p))))
        scans.append(pts @ Tinv[:3, :3].T + Tinv[:3, 3])
    return scans, np.stack(poses)


def test_chain_poses_and_compose_match_jax():
    rels = 0.3 * np.random.default_rng(1).normal(size=(7, 6))
    np.testing.assert_allclose(
        P.chain_poses(torch.as_tensor(rels)).numpy(), np.asarray(J.chain_poses(jnp.asarray(rels))), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        P._compose(torch.as_tensor(rels[0]), torch.as_tensor(rels[1])).numpy(),
        np.asarray(J._compose(jnp.asarray(rels[0]), jnp.asarray(rels[1]))), rtol=0, atol=1e-12,
    )
    assert P.chain_poses(torch.zeros(0, 6, dtype=torch.float64)).shape == (1, 6)


@pytest.mark.parametrize("gate", [None, 1.0], ids=["seeded", "gated_unseeded"])
def test_register_pair_matches_jax(scene, gate):
    scans, _ = scene
    x0 = None if gate else np.zeros(6)
    kw = dict(nn_backend="xla", max_corr_dist=gate)
    jx, jr = J.register_pair(jnp.asarray(scans[1]), jnp.asarray(scans[0]),
                             x0=None if x0 is None else jnp.asarray(x0), **kw)
    tx, tr = P.register_pair(torch.as_tensor(scans[1]), torch.as_tensor(scans[0]),
                             x0=None if x0 is None else torch.as_tensor(x0), **kw)
    assert int(tr.status) == int(jr.status) and int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=POSE_ATOL)


def test_register_pair_checks_its_registrar_and_methods(scene):
    scans = [torch.as_tensor(s) for s in scene[0][:2]]
    reg = PairwiseRegistrar(nn_backend="xla")
    with pytest.raises(ValueError, match="kwargs"):
        P.register_pair(scans[1], scans[0], registrar=reg, max_corr_dist=1.0)
    with pytest.raises(ValueError, match="LMConfig"):
        P.register_pair(scans[1], scans[0], registrar=reg, config=LMConfig(max_iterations=3))
    with pytest.raises(ValueError, match="method"):
        P.register_pair(scans[1], scans[0], registrar=reg, method="bogus")
    with pytest.raises(ValueError, match="method"):
        P.register_pair(scans[1], scans[0], method="bogus")
    assert P.make_registrar("bogus", None) is None
    for method in ("gicp", "point2plane"):  # ported: register_pair and scan_odometry take them, as JAX's do
        jx, jr = J.register_pair(jnp.asarray(scene[0][1]), jnp.asarray(scene[0][0]), x0=jnp.zeros(6),
                                 method=method, nn_backend="xla")
        tx, tr = P.register_pair(scans[1], scans[0], x0=torch.zeros(6, dtype=torch.float64), method=method,
                                 nn_backend="xla")
        assert int(tr.status) == int(jr.status) and int(tr.iterations) == int(jr.iterations)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=POSE_ATOL)
        mreg = P.make_registrar(method, None, nn_backend="xla")
        assert isinstance(mreg, PairwiseRegistrar) and mreg.method == method
        poses, rels = P.scan_odometry(scans, method=method, registrar=mreg)
        np.testing.assert_allclose(rels[0].numpy(), scene[1][1], rtol=0, atol=1e-9)  # the seeded pose of scan 1
        assert poses.shape == (2, 6)
    assert isinstance(P.make_registrar("icp", None, nn_backend="xla"), PairwiseRegistrar)
    x, res = P.register_pair(scans[1], scans[0], x0=torch.zeros(6, dtype=torch.float64), registrar=reg)
    assert x is res.x


@pytest.mark.parametrize(
    "kw",
    [dict(nn_backend="xla"), dict(nn_backend="grid", max_corr_dist=1.0)],
    ids=["xla", "grid_gated"],
)
def test_scan_odometry_matches_jax(scene, kw):
    scans, gt = scene
    if "max_corr_dist" in kw:  # every 2nd point: the unseeded first pair's 8-start search is O(8·N²)
        scans = [s[::2] for s in scans]
    cfg = dict(diff_mode="auto", max_iterations=40)
    jp, jrel = J.scan_odometry([jnp.asarray(s) for s in scans], method="icp", config=JLMConfig(**cfg), **kw)
    tp, trel = P.scan_odometry([torch.as_tensor(s) for s in scans], method="icp", config=LMConfig(**cfg), **kw)
    assert tp.shape == (5, 6) and trel.shape == (4, 6)
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=POSE_ATOL)
    assert float(ate_rmse(tp, torch.as_tensor(gt), align=False)) < 1e-3


def test_scan_odometry_of_one_scan_is_empty():
    poses, rels = P.scan_odometry([torch.zeros(10, 3, dtype=torch.float64)])
    assert poses.shape == (1, 6) and rels.shape == (0, 6) and poses.dtype == torch.float64


class _FlaggingRegistrar:
    """Stands in for a PairwiseRegistrar: x is the pair's index, and the
    deferred flag of pair ``bad`` is True the first time."""

    method = "icp"

    def __init__(self, bad):
        self.bad = bad
        self.calls = []

    def register(self, src, tgt, x0=None, *, defer_overflow=False):
        k = int(src[0, 0])
        self.calls.append((k, defer_overflow, None if x0 is None else float(x0[0])))
        res = type("R", (), {"x": torch.full((6,), float(k) + (0.5 if not defer_overflow else 0.0))})()
        if defer_overflow:
            return res, torch.tensor(k == self.bad)
        return res


@pytest.mark.parametrize("bad", [3, 17])
def test_overflow_window_redoes_the_flagged_pair_and_every_later_one(bad):
    """Flags are read in windows of W = 8 once 2W pairs are in flight; a
    True flag redoes its pair and every pair dispatched after it, with no
    deferral, each seeded by the redone pair before it."""
    scans = [torch.full((2, 3), float(k)) for k in range(21)]
    reg = _FlaggingRegistrar(bad)
    poses, rels = P.scan_odometry(scans, registrar=reg)
    deferred = [k for k, d, _ in reg.calls if d]
    redone = [(k, x0) for k, d, x0 in reg.calls if not d]
    assert deferred == list(range(1, 21))
    last = 16 if bad <= 8 else 20  # the end of the window holding the flag
    assert [k for k, _ in redone] == list(range(bad, last + 1))
    assert redone[0][1] == (bad - 1 if bad > 1 else None)  # the seed the flagged pair had
    assert [x0 for _, x0 in redone[1:]] == [k + 0.5 for k in range(bad, last)]
    want = [k + (0.5 if bad <= k <= last else 0.0) for k in range(1, 21)]
    np.testing.assert_array_equal(rels[:, 0].numpy(), want)
    assert poses.shape == (21, 6)


def test_odometry_import_leaves_jax_and_pose_graph_out():
    """The back end now lives in the module: importing it pulls in the
    port's pose_graph, and neither jax nor the JAX package's pose_graph."""
    code = (
        "import sys, moptimizer_0_tpu_torch.odometry, moptimizer_0_tpu_torch.evaluation; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('moptimizer_0_tpu.') or m == 'moptimizer_0_tpu'); "
        "ok = 'moptimizer_0_tpu_torch.pose_graph' in sys.modules; "
        "print(bad, ok); sys.exit(1 if bad or not ok else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
