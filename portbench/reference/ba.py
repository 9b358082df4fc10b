"""Plain bundle adjustment: the reference of the BAL configurations.

The same problem and the same method as the port's CG engine, written from
the published equations: pinhole reprojection through world→camera poses
[t, ω] (R = exp(ω)), residual r = pixel − π(R p + t); Levenberg-Marquardt
with the reference's λ/ν/ρ schedule (moptimizer src/levenberg_marquadt_dyn.cpp:
λ seeded as factor · max diag, a rejected trial multiplies λ by ν and doubles
ν, an accepted one multiplies λ by max(1/3, 1 − (2ρ − 1)³), ρ = (y0 − y) /
δ·(λδ − b)); each damped step solved by eliminating the landmarks (Schur
complement) and running block-Jacobi preconditioned CG on the cameras for a
fixed number of iterations, then back-substituting. Sums over cameras and
landmarks are ``index_add_`` in the reference's float64, whose order does not
matter there. Every matrix product goes through ``Precision``, so the same
code is the float32-TF32 control.
"""

import math

import torch

from portbench.reference.precision import REFERENCE


def hat(w):
    """(..., 3) → (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    x, y, q = w.unbind(-1)
    return torch.stack([
        torch.stack([z, -q, y], -1),
        torch.stack([q, z, -x], -1),
        torch.stack([-y, x, z], -1),
    ], -2)


def _series(w):
    """sin θ/θ, (1 − cos θ)/θ², (θ − sin θ)/θ³ of |w| = θ, with their Taylor
    series near 0."""
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    small = t2 < 1e-4
    ts = torch.where(small, torch.ones_like(t), t)
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720, (1 - torch.cos(ts)) / (ts * ts))
    c = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040, (ts - torch.sin(ts)) / (ts * ts * ts))
    return a, b, c


def so3_exp(w):
    """Rodrigues: R = I + a K + b K², K = hat(w)."""
    a, b, _ = _series(w)
    K = hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def right_jacobian(w):
    """Jr(w) = I − b K + c K², so that ∂(exp(w) p)/∂w = −exp(w) [p]× Jr(w)."""
    _, b, c = _series(w)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - b[..., None, None] * K + c[..., None, None] * (K @ K)


def _camera_points(cams, pts, obs, prec):
    """Per observation: R (O, 3, 3), the point (O, 3) and pc = R p + t."""
    R = so3_exp(cams[:, 3:])[obs["cam_idx"]]
    p = pts[obs["pt_idx"]]
    return R, p, prec.bmv(R, p) + cams[:, :3][obs["cam_idx"]]


def _pi(pc, intr):
    fx, fy, cx, cy = intr.unbind(0)
    return torch.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], dim=-1)


def residuals(cams, pts, obs, prec=REFERENCE):
    """r = pixel − π(R p + t), (O, 2), in ``prec``'s dtype."""
    cams, pts = cams.to(prec.dtype), pts.to(prec.dtype)
    intr = obs["intrinsics"].to(prec.dtype)
    _, _, pc = _camera_points(cams, pts, obs, prec)
    return obs["pixels"].to(prec.dtype) - _pi(pc, intr)


def cost(cams, pts, obs, prec=REFERENCE):
    """Σ‖r‖² over every observation."""
    r = residuals(cams, pts, obs, prec)
    return torch.sum(r * r)


def _linearize(cams, pts, obs, prec):
    """r, and the Gauss-Newton blocks U (C,6,6), V (L,3,3), W (O,6,3), g (C,6),
    h (L,3) and y = Σ‖r‖²."""
    ci, pi = obs["cam_idx"], obs["pt_idx"]
    intr = obs["intrinsics"].to(prec.dtype)
    fx, fy = intr[0], intr[1]
    R, p, pc = _camera_points(cams, pts, obs, prec)
    r = obs["pixels"].to(prec.dtype) - _pi(pc, intr)
    x, y, z = pc.unbind(-1)
    zero = torch.zeros_like(z)
    Jpi = torch.stack([
        torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
        torch.stack([zero, fy / z, -fy * y / (z * z)], -1),
    ], -2)
    dpc_dw = -prec.small_mm(R, prec.small_mm(hat(p), right_jacobian(cams[:, 3:])[ci]))
    eye = torch.eye(3, dtype=prec.dtype, device=z.device).expand_as(R)
    A = -prec.small_mm(Jpi, torch.cat([eye, dpc_dw], dim=-1))
    B = -prec.small_mm(Jpi, R)
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    C, L = cams.shape[0], pts.shape[0]
    U = torch.zeros(C, 6, 6, dtype=prec.dtype, device=z.device).index_add_(0, ci, prec.small_mm(At, A))
    V = torch.zeros(L, 3, 3, dtype=prec.dtype, device=z.device).index_add_(0, pi, prec.small_mm(Bt, B))
    W = prec.small_mm(At, B)
    g = torch.zeros(C, 6, dtype=prec.dtype, device=z.device).index_add_(0, ci, prec.bmv(At, r))
    h = torch.zeros(L, 3, dtype=prec.dtype, device=z.device).index_add_(0, pi, prec.bmv(Bt, r))
    return U, V, W, g, h, torch.sum(r * r)


def _damp(M, lam):
    return M + lam * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))


def pcg(matvec, b, precond, iterations, tol):
    """Preconditioned CG from x = 0, stopping once ‖r‖² ≤ tol²."""
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iterations):
        if float(torch.sum(r * r)) <= tol * tol:
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp_min(rz, tiny) * p
        rz = rz_new
    return x


def _step(blocks, lam, obs, mask, prec, cg_iterations, cg_tol):
    """The damped step (δcam, δpt): the Schur complement on the cameras by
    PCG, then the landmarks by back-substitution."""
    U, V, W, g, h, _ = blocks
    ci, pi = obs["cam_idx"], obs["pt_idx"]
    C, L = U.shape[0], V.shape[0]
    dev, dt = U.device, prec.dtype
    Wt = W.transpose(-1, -2)
    Vinv = torch.linalg.inv(_damp(V, lam) + 1e-12 * torch.eye(3, dtype=dt, device=dev))
    Ud = _damp(U, lam)
    Uinv = torch.linalg.inv(Ud + 1e-12 * torch.eye(6, dtype=dt, device=dev))

    def to_points(u):  # Σ_o Wᵀ u[cam] per landmark
        return torch.zeros(L, 3, dtype=dt, device=dev).index_add_(0, pi, prec.bmv(Wt, u[ci]))

    def to_cameras(s):  # Σ_o W s[point] per camera
        return torch.zeros(C, 6, dtype=dt, device=dev).index_add_(0, ci, prec.bmv(W, s[pi]))

    def matvec(u):
        u = u * mask
        return (prec.bmv(Ud, u) - to_cameras(prec.bmv(Vinv, to_points(u)))) * mask

    rhs = -(g - to_cameras(prec.bmv(Vinv, h))) * mask
    d_cam = pcg(matvec, rhs, lambda u: prec.bmv(Uinv, u) * mask, cg_iterations, cg_tol) * mask
    return d_cam, prec.bmv(Vinv, -h - to_points(d_cam))


def solve(cams0, pts0, obs, *, n_fixed=2, max_iterations=15, inner_iterations=3, init_lambda_factor=1e-9,
          cg_iterations=50, cg_tol=1e-8, prec=REFERENCE):
    """LM from (cams0, pts0): (cams, pts, final Σ‖r‖², [Σ‖r‖² at the start of
    each outer iteration]), all in ``prec``'s dtype."""
    dt = prec.dtype
    eps = torch.finfo(dt).eps
    cams, pts = cams0.to(dt).clone(), pts0.to(dt).clone()
    mask = (torch.arange(cams.shape[0], device=cams.device) >= n_fixed).to(dt)[:, None]
    lam, costs = None, []
    for _ in range(max_iterations):
        blocks = _linearize(cams, pts, obs, prec)
        U, V, _, g, h, y0 = blocks
        costs.append(float(y0))
        if abs(float(y0)) < 8 * eps:
            break
        if lam is None:
            diag = torch.cat([torch.diagonal(U, dim1=-2, dim2=-1).reshape(-1),
                              torch.diagonal(V, dim1=-2, dim2=-1).reshape(-1)])
            lam = init_lambda_factor * float(torch.max(torch.abs(diag)))
        b = torch.cat([g.reshape(-1), h.reshape(-1)])
        nu, terminal = 2.0, False
        for _ in range(inner_iterations):
            d_cam, d_pt = _step(blocks, lam, obs, mask, prec, cg_iterations, cg_tol)
            cams_i, pts_i = cams + d_cam, pts + d_pt
            yi = float(cost(cams_i, pts_i, obs, prec))
            delta = torch.cat([d_cam.reshape(-1), d_pt.reshape(-1)])
            denom = float(torch.dot(delta, lam * delta - b))
            rho = (float(y0) - yi) / denom if denom != 0 else math.nan
            if math.isnan(yi):
                terminal = True
                break
            if rho < 0.0:
                if float(torch.max(torch.abs(delta))) < math.sqrt(eps):
                    terminal = True
                    break
                lam, nu = nu * lam, 2.0 * nu
                continue
            cams, pts = cams_i, pts_i
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3) if not math.isnan(rho) else lam
            break
        del blocks, U, V, g, h, b
        if terminal:
            break
    return cams, pts, float(cost(cams, pts, obs, prec)), costs
