"""Example: incremental structure from motion on top of the BA engine.

Counterpart of the reference's experimental OpenCV SfM program, which
hands image paths to ``cv::sfm::reconstruct``; this one runs the same
pipeline stages from feature matches (the engine's domain starts where the
feature extractor ends), each stage built on this library:

1. two-view bootstrap: essential matrix from the normalized 8-point
   system, decomposed into (R, t) with the cheirality check;
2. triangulation: per-track DLT least squares;
3. incremental resection (PnP): each new camera's pose from its 2D-3D
   matches by the library's LM solver (a reprojection residual block);
4. global refinement: Schur-complement bundle adjustment (``ba.solve_ba``)
   after every few cameras and at the end.

Synthetic scene with pixel noise; prints per-stage stats and the final
similarity-aligned reconstruction error against the ground truth.

    python -m moptimizer_0_tpu_torch.examples.sfm_reconstruct
"""

import numpy as np
import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.utils.device import require

# ---- classical two-view geometry (host-side numpy; runs once) ------------


def essential_8pt(x1, x2):
    """Essential matrix from ≥8 normalized correspondences (x1 ↔ x2): the
    linear 8-point system, projected onto the essential manifold (singular
    values (s, s, 0))."""
    A = np.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], np.ones(len(x1)),
        ],
        axis=1,
    )
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt = np.linalg.svd(E)
    s = (S[0] + S[1]) / 2.0
    return U @ np.diag([s, s, 0.0]) @ Vt


def decompose_essential(E, x1, x2):
    """(R, t) with the cheirality check: of the four decompositions, the one
    that triangulates the most points in front of both cameras."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    best, best_count = None, -1
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
            P2 = np.hstack([R, t[:, None]])
            X = triangulate_dlt(P1, P2, x1, x2)
            z1 = X[:, 2]
            z2 = (X @ R.T + t)[:, 2]
            count = int(((z1 > 0) & (z2 > 0)).sum())
            if count > best_count:
                best, best_count = (R, t), count
    return best


def triangulate_dlt(P1, P2, x1, x2):
    """DLT triangulation of correspondences under projections P1, P2
    (normalized coordinates), one 4×4 SVD a track."""
    n = len(x1)
    A = np.zeros((n, 4, 4))
    A[:, 0] = x1[:, 0, None] * P1[2] - P1[0]
    A[:, 1] = x1[:, 1, None] * P1[2] - P1[1]
    A[:, 2] = x2[:, 0, None] * P2[2] - P2[0]
    A[:, 3] = x2[:, 1, None] * P2[2] - P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1]
    return X[:, :3] / X[:, 3:4]


def _transform(x):
    """The 4×4 world→camera transform of params6 x, in float64 numpy."""
    return se3.transform_from_params6(torch.as_tensor(np.asarray(x, dtype=np.float64))).numpy()


def _log(R):
    return so3.log(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()


def triangulate_multi(cam_params, intr, obs_cam, obs_px):
    """Triangulate one track from ≥2 observations (a list of params6)."""
    fx, fy, cx, cy = intr
    rows = []
    for c, px in zip(obs_cam, obs_px):
        P = _transform(c)[:3, :]  # normalized projection (world → cam)
        xn = np.array([(px[0] - cx) / fx, (px[1] - cy) / fy])
        rows.append(xn[0] * P[2] - P[0])
        rows.append(xn[1] * P[2] - P[1])
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]


# ---- resection (PnP) through the library's LM solver ----------------------


def resect_camera(points3d, pixels, intrinsics, x0, device="cuda", dtype=torch.float32):
    """Camera pose from 2D-3D matches: minimize the reprojection error over
    the 6-DoF params with the library's LM (the reference camera-calibration
    residual, generalized to any point set). Returns the LMResult."""
    dev = require(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    intr = t(intrinsics)

    def residual(x, d):
        return ba._residual(x, d["pt"], d["px"], intr)

    blk = make_block(residual, data=dict(pt=t(points3d), px=t(pixels)), name="resection")
    cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", max_iterations=20)
    return levenberg_marquardt(problem(blk), t(x0), cfg)


# ---- the pipeline ---------------------------------------------------------


def _yaw_pitch(th):
    c, s = np.cos(-th * 0.8), np.sin(-th * 0.8)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def make_scene(rng, C=8, L=300, noise_px=0.4):
    """Cameras on an arc looking at a landmark cloud; full visibility. Host
    numpy in float64: (cams (C, 6), points (L, 3), intrinsics, pixels (C, L, 2))."""
    pts = rng.uniform(-4, 4, size=(L, 3)) + np.array([0.0, 0.0, 12.0])
    cams = []
    for i in range(C):
        th = 0.12 * (i - C / 2)
        t = np.array([6.0 * np.sin(th), 0.4 * rng.normal(), 12.0 * (1 - np.cos(th))])
        # world→camera params: the camera at pose (R, t) in the world is T_wc⁻¹
        T = np.eye(4)
        T[:3, :3] = _yaw_pitch(th)
        T[:3, 3] = t
        Ti = np.linalg.inv(T)
        cams.append(np.concatenate([Ti[:3, 3], _log(Ti[:3, :3])]))
    cams = np.stack(cams)
    intr = np.array([520.0, 520.0, 320.0, 240.0])

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64)

    obs_px = ba._project(t64(cams)[:, None], t64(pts)[None], t64(intr)).numpy()
    obs_px += noise_px * rng.normal(size=obs_px.shape)
    return cams, pts, intr, obs_px


def aligned_error(est_pts, gt_pts):
    """RMS landmark error after similarity (Umeyama) alignment: the gauge
    (scale and global pose) is unobservable in SfM."""
    mu_e, mu_g = est_pts.mean(0), gt_pts.mean(0)
    E0, G0 = est_pts - mu_e, gt_pts - mu_g
    U, S, Vt = np.linalg.svd(G0.T @ E0 / len(E0))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / (E0**2).mean(0).sum()
    aligned = scale * E0 @ R.T + mu_g
    return float(np.sqrt(((aligned - gt_pts) ** 2).sum(1).mean()))


def run(C=8, L=300, seed=0, refine_every=3, verbose=True, device="cuda", dtype=torch.float32):
    """The pipeline on a C-camera, L-landmark scene; the LM and BA solves run
    on ``device`` in ``dtype``. Returns (aligned landmark RMS, reprojection
    RMS in px)."""
    dev = require(device)
    rng = np.random.default_rng(seed)
    cams_gt, pts_gt, intr, obs_px = make_scene(rng, C, L)
    fx, fy, cx, cy = intr

    def norm_px(px):
        return np.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy], axis=1)

    # --- stage 1: two-view bootstrap (cameras 0, 1)
    x1, x2 = norm_px(obs_px[0]), norm_px(obs_px[1])
    E = essential_8pt(x1, x2)
    R, t = decompose_essential(E, x1, x2)
    # camera 0 at identity; camera 1 = (R, t) up to scale
    cam_est = [np.zeros(6), np.concatenate([t, _log(R)])]
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    pts_est = triangulate_dlt(P1, P2, x1, x2)
    if verbose:
        print(f"bootstrap: {len(pts_est)} landmarks triangulated from views 0-1")

    def tt(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def run_ba(n_cams):
        prob = ba.BAProblem(
            camera_params=tt(np.stack(cam_est)),
            points=tt(pts_est),
            cam_idx=torch.as_tensor(np.repeat(np.arange(n_cams), L), device=dev),
            pt_idx=torch.as_tensor(np.tile(np.arange(L), n_cams), device=dev),
            pixels=tt(obs_px[:n_cams].reshape(-1, 2)),
            intrinsics=tt(intr),
            n_fixed_cameras=1,
        )
        res = ba.solve_ba(prob, ba.BAConfig(max_iterations=20))
        return res.camera_params.cpu().double().numpy(), res.points.cpu().double().numpy(), res

    # refine the two-view seed
    cams_np, pts_est, res = run_ba(2)
    cam_est = list(cams_np)

    # --- stages 2-3: incremental resection + periodic refinement
    for c in range(2, C):
        x0 = cam_est[-1]  # the previous camera seeds the next
        r = resect_camera(pts_est, obs_px[c], intr, x0, device=dev, dtype=dtype)
        cam_est.append(r.x.cpu().double().numpy())
        if verbose:
            print(f"resected camera {c}: reprojection cost {float(r.cost) / L:.3f} px² /obs")
        if (c + 1) % refine_every == 0 or c == C - 1:
            cams_np, pts_est, res = run_ba(c + 1)
            cam_est = list(cams_np)
            if verbose:
                print(f"  BA over {c + 1} cams: cost/obs {float(res.cost) / ((c + 1) * L):.4f} px², "
                      f"{int(res.iterations)} iters")

    err = aligned_error(pts_est, pts_gt)
    rms_px = float(np.sqrt(float(res.cost) / (C * L * 2)))
    if verbose:
        print(f"final: {C} cameras, {L} landmarks — aligned landmark RMS {err:.4f} (scene extent ~8), "
              f"reprojection RMS {rms_px:.3f} px")
    return err, rms_px


def main(device="cuda"):
    """The pipeline at its default size on ``device``, with its checks;
    returns (aligned landmark RMS, reprojection RMS)."""
    err, rms_px = run(device=device)
    assert err < 0.05, err  # about 6e-3 at 0.4 px observation noise
    assert rms_px < 1.0, rms_px
    print("OK")
    return err, rms_px


if __name__ == "__main__":
    main()
