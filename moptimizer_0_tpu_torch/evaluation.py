"""Trajectory evaluation: ATE / RPE metrics and Umeyama alignment.

PyTorch counterpart of ``moptimizer_0_tpu.evaluation``: absolute trajectory
error after an optional SE(3)/Sim(3) alignment (Umeyama), and relative pose
error over a fixed frame delta.
"""

import torch

from moptimizer_0_tpu_torch.lie import se3, so3


def umeyama_alignment(src, tgt, with_scale=False):
    """Least-squares similarity transform aligning src → tgt ((N, 3) each).

    Returns (s, R, t) with tgt ≈ s·R·src + t (Umeyama 1991, one SVD)."""
    mu_s = torch.mean(src, dim=0)
    mu_t = torch.mean(tgt, dim=0)
    xs = src - mu_s
    xt = tgt - mu_t
    cov = (xt.T @ xs) / src.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    one = torch.ones_like(det)
    S = torch.diag(torch.stack([one, one, torch.where(det < 0, -one, one)]))
    R = U @ S @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(xs * xs, dim=1))
        s = torch.sum(D * torch.diagonal(S)) / var_s
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_t - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated, ground_truth, align=True, with_scale=False):
    """Absolute trajectory error (RMSE of position residuals).

    estimated / ground_truth: (N, 3) positions or (N, 6) params6 poses
    (positions taken from the translation part)."""
    est = estimated[..., :3]
    gt = ground_truth[..., :3]
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale=with_scale)
        est = s * est @ R.T + t
    err = est - gt
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))


def rpe(estimated_poses, ground_truth_poses, delta=1):
    """Relative pose error over frame pairs (i, i+delta): (trans_rmse,
    rot_rmse_rad). Inputs: (N, 6) params6 poses."""

    def rel(poses):
        Ta = se3.transform_from_params6(poses[:-delta])
        Tb = se3.transform_from_params6(poses[delta:])
        Ra = Ta[..., :3, :3].transpose(-1, -2)
        dt = torch.einsum("nij,nj->ni", Ra, Tb[..., :3, 3] - Ta[..., :3, 3])
        dR = torch.einsum("nij,njk->nik", Ra, Tb[..., :3, :3])
        return dt, dR

    dt_e, dR_e = rel(estimated_poses)
    dt_g, dR_g = rel(ground_truth_poses)
    t_err = dt_e - dt_g
    rot_err = torch.einsum("nij,njk->nik", dR_g.transpose(-1, -2), dR_e)
    ang = torch.linalg.norm(so3.log(rot_err), dim=-1)
    return (
        torch.sqrt(torch.mean(torch.sum(t_err * t_err, dim=-1))),
        torch.sqrt(torch.mean(ang * ang)),
    )
