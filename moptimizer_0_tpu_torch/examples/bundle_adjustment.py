"""Example: Schur-complement bundle adjustment on a synthetic scene.

    python -m moptimizer_0_tpu_torch.examples.bundle_adjustment
"""

import dataclasses

import numpy as np
import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.evaluation import ate_rmse
from moptimizer_0_tpu_torch.utils.device import require


def make_problem(C=8, L=200, noise_px=0.3, device="cuda", dtype=torch.float32):
    """The scene: C cameras on a line, L landmarks, every camera sees every
    landmark, two cameras fixed; (start, ground-truth points)."""
    dev = require(device)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(L, 3)) + np.array([0.0, 0.0, 10.0])
    cams = np.stack(
        [np.concatenate([[2.0 * i - (C - 1), 0.3 * rng.normal(), 0.0], 0.05 * rng.normal(size=3)]) for i in range(C)]
    )

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    prob = ba.BAProblem(
        camera_params=t(cams),
        points=t(pts),
        cam_idx=torch.as_tensor(np.repeat(np.arange(C), L), device=dev),
        pt_idx=torch.as_tensor(np.tile(np.arange(L), C), device=dev),
        pixels=t(np.zeros((C * L, 2))),
        intrinsics=t([500.0, 500.0, 320.0, 240.0]),
        n_fixed_cameras=2,
    )
    pixels = ba._project(prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics)
    pixels = pixels + t(noise_px * rng.normal(size=pixels.shape))
    start = dataclasses.replace(
        prob,
        pixels=pixels,
        camera_params=t(cams + np.concatenate([np.zeros((2, 6)), 0.02 * rng.normal(size=(C - 2, 6))])),
        points=t(pts + 0.1 * rng.normal(size=pts.shape)),
    )
    return start, prob.points


def main(C=8, L=200, max_iterations=30, device="cuda", dtype=torch.float32):
    """Solve the scene by the CG engine, then by engine="auto"; returns
    (start, ground-truth points, CG result, auto result)."""
    start, gt_points = make_problem(C, L, device=device, dtype=dtype)
    print(f"initial reprojection cost: {float(ba.compute_cost(start)):.1f}")
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=max_iterations))
    print(f"final cost: {float(res.cost):.3f}  status = {Status(int(res.status)).name}")
    print(f"landmark ATE vs ground truth: {float(ate_rmse(res.points, gt_points)):.5f}")

    # At production scale prefer engine="auto": it routes to the dense-Schur
    # engine (S built explicitly, by the hand-written Schur kernel on the
    # card, and one Cholesky) while the camera count, the grid's shape and
    # the memory allow, and to the matrix-free Schur-CG engine past them.
    res_auto = ba.solve_ba(start, ba.BAConfig(max_iterations=max_iterations), engine="auto")
    print(f"engine='auto' final cost: {float(res_auto.cost):.3f}")
    return start, gt_points, res, res_auto


if __name__ == "__main__":
    main()
