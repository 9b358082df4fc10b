"""API tour: batched fleet registration and streaming fixed-lag SLAM.

Self-checking (asserts):

    python -m moptimizer_0_tpu_torch.examples.fleet_and_fixed_lag

1. ``registration.icp_batched`` — B full ICP solves (per-iteration
   correspondence updates) in one batched LM loop, with one lane-batched
   nearest-neighbour search a pass (the hand-written expansion kernel on the
   card).
2. ``solve_multistart`` — best-of-B starts at about the cost of one solve.
3. ``odometry.scan_slam_fixed_lag`` — streaming SLAM with bounded memory:
   the oldest pose is Schur-marginalized into a square-root prior instead
   of being discarded (``core/prior.py``, ``pose_graph.marginalize_oldest``).
"""

import numpy as np
import torch

from moptimizer_0_tpu_torch import LMConfig, solve_multistart
from moptimizer_0_tpu_torch.core.residual import problem
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_0_tpu_torch.odometry import scan_slam_fixed_lag
from moptimizer_0_tpu_torch.registration import icp_batched
from moptimizer_0_tpu_torch.utils.device import require

GATE = 0.5  # the fixed-lag registrar's max_corr_dist (m)


def _transform(x):
    """The 4×4 transform of params6 x (numpy float32, computed on the CPU)."""
    return se3.transform_from_params6(torch.as_tensor(x, dtype=torch.float32)).numpy()


def make_fleet(rng, B=4, N=2000):
    """B source clouds of N points (numpy float32), their targets under small
    random transforms, and those transforms (B, 6)."""
    srcs = rng.uniform(0, 10, (B, N, 3)).astype(np.float32)
    x_true = (0.05 * rng.normal(size=(B, 6))).astype(np.float32)
    tgts = np.stack([srcs[i] @ _transform(x_true[i])[:3, :3].T + _transform(x_true[i])[:3, 3] for i in range(B)])
    return srcs, tgts, x_true


def make_scans(rng, k_scans=10, n=2048):
    """k_scans noisy scans (numpy float32) of a walled room seen from a
    drifting sensor, and their ground-truth poses relative to scan 0."""
    per = n // 5
    s = 12.0
    u = rng.uniform(-s, s, size=(4, per))
    v = rng.uniform(0.0, 5.0, size=(4, per))
    walls = [
        np.column_stack([u[0], np.full(per, -s), v[0]]),
        np.column_stack([u[1], np.full(per, s), v[1]]),
        np.column_stack([np.full(per, -s), u[2], v[2]]),
        np.column_stack([np.full(per, s), u[3], v[3]]),
    ]
    g = rng.uniform(-s, s, size=(n - 4 * per, 2))
    world = np.vstack(walls + [np.column_stack([g, np.zeros(len(g))])])
    scans, Ts = [], []
    for k in range(k_scans):
        t = np.array([0.5 * k, 0.1 * k, 1.0])
        w = np.array([0.0, 0.0, 0.03 * k])
        T = _transform(np.concatenate([t, w]))
        Ti = np.linalg.inv(T)
        local = world @ Ti[:3, :3].T + Ti[:3, 3]
        scans.append((local + 0.005 * rng.normal(size=local.shape)).astype(np.float32))
        Ts.append(T)
    # odometry convention: poses relative to scan 0 (P0 = I)
    T0i = np.linalg.inv(Ts[0])
    gts = []
    for T in Ts:
        Tr = T0i @ T
        gts.append(np.concatenate([Tr[:3, 3], so3.log(torch.as_tensor(Tr[:3, :3], dtype=torch.float32)).numpy()]))
    return scans, np.stack(gts)


def main(B=4, N=2000, k_scans=10, n_scan=2048, window=4, device="cuda"):
    """The three parts on ``device``, each with its assert; returns
    (fleet max|x − x*|, multistart best x, fixed-lag final-pose drift)."""
    dev = require(device)
    rng = np.random.default_rng(0)

    # --- 1. fleet registration: B scan pairs, one batched loop
    srcs, tgts, x_true = make_fleet(rng, B, N)
    res = icp_batched(torch.as_tensor(srcs, device=dev), torch.as_tensor(tgts, device=dev), max_corr_dist=1.0)
    err = np.abs(res.x.cpu().numpy() - x_true).max()
    print(f"[1] fleet ICP: {B} pairs in one batched loop, max|x−x*| = {err:.2e}")
    assert err < 1e-3

    # --- 2. multistart: escape the wrong basin
    f32 = dict(dtype=torch.float32, device=dev)
    blk = rational_block(torch.tensor(SIMPLE_X, **f32), torch.tensor(SIMPLE_Y, **f32), analytic=True)
    x0s = torch.tensor([[0.9, 0.2], [50.0, -40.0], [-3.0, 0.01]], **f32)
    best, _ = solve_multistart(problem(blk), x0s, LMConfig(max_iterations=40))
    best_x = best.x.cpu().numpy()
    print(f"[2] multistart best x = {best_x} (expect ≈ [0.362, 0.556])")
    assert np.allclose(best_x, [0.362, 0.556], atol=0.01)

    # --- 3. streaming fixed-lag SLAM
    scans, gt = make_scans(rng, k_scans, n_scan)
    poses = scan_slam_fixed_lag(
        [torch.as_tensor(s, device=dev) for s in scans], window=window,
        config=LMConfig(diff_mode="auto", max_iterations=30), max_corr_dist=GATE,
    )
    drift = np.abs(poses[-1][:3].cpu().numpy() - gt[-1][:3]).max()
    print(f"[3] fixed-lag SLAM over {len(scans)} scans (window {window}): final-pose drift {drift:.3f} m")
    assert drift < 0.05

    print("fleet_and_fixed_lag: ALL OK")
    return float(err), best_x, float(drift)


if __name__ == "__main__":
    main()
