"""SO(3): hat/vee, Rodrigues exp/log, left/right Jacobians and their inverses.

PyTorch counterpart of ``moptimizer_0_tpu.lie.so3``. Small angles use Taylor
series under ``torch.where`` with the argument of every square root clamped
away from 0 (``_safe_theta``), so ``torch.func.jacfwd`` through ``exp`` stays
finite at θ = 0: ``torch.where`` alone does not stop the untaken branch's
infinite derivative of √θ² from poisoning the tangent.
"""

import torch

# Taylor switch-over: the two-term series is exact to working precision below
# this angle for both float32 and float64.
_SMALL = 1e-5


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def hat(w):
    """Skew-symmetric matrix from a 3-vector."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([z, -w2, w1], dim=-1),
            torch.stack([w2, z, -w0], dim=-1),
            torch.stack([-w1, w0, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of `hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_sq(w):
    # (..., 1), never 0-dim: forward AD turns the tangent of a 0-dim float32
    # tensor scaled by a Python float into float64, which then fails the
    # float32 products downstream of jacfwd
    return torch.sum(w * w, dim=-1, keepdim=True)


def _safe_theta(t_sq):
    """(small, t_safe): t_safe = √t_sq with the argument clamped to 1 where
    the angle is small, so that the derivative of the square root is finite."""
    small = t_sq < _SMALL * _SMALL
    t_safe = torch.sqrt(torch.where(small, torch.ones_like(t_sq), t_sq))
    return small, t_safe


def _sin_t_over_t(t_sq):
    # sin(θ)/θ, Taylor: 1 − θ²/6 + θ⁴/120
    small, t = _safe_theta(t_sq)
    return torch.where(small, 1.0 - t_sq / 6.0 + t_sq * t_sq / 120.0, torch.sin(t) / t)


def _one_minus_cos_over_t_sq(t_sq):
    # (1 − cos θ)/θ², Taylor: 1/2 − θ²/24 + θ⁴/720
    small, t = _safe_theta(t_sq)
    return torch.where(
        small, 0.5 - t_sq / 24.0 + t_sq * t_sq / 720.0, (1.0 - torch.cos(t)) / (t * t)
    )


def _t_minus_sin_over_t_cubed(t_sq):
    # (θ − sin θ)/θ³, Taylor: 1/6 − θ²/120 + θ⁴/5040
    small, t = _safe_theta(t_sq)
    return torch.where(
        small, 1.0 / 6.0 - t_sq / 120.0 + t_sq * t_sq / 5040.0, (t - torch.sin(t)) / (t * t * t)
    )


def exp(w):
    """Rodrigues: R = I + sin(θ)/θ·K + (1−cos θ)/θ²·K², K = hat(w)."""
    t_sq = _theta_sq(w)
    K = hat(w)
    K2 = K @ K
    a = _sin_t_over_t(t_sq)[..., None]
    b = _one_minus_cos_over_t_sq(t_sq)[..., None]
    return _eye_like(K) + a * K + b * K2


def exp_dt(ang_vel, dt):
    """Angular-velocity integration: R = exp(ω·dt), the one-step rigid-body
    integrator (the reference's two-argument ``so3::Exp(ang_vel, dt)``), with
    the small-angle Taylor branch of :func:`exp` in place of a snap to the
    identity, so it stays differentiable in ω and dt."""
    dt = torch.as_tensor(dt, dtype=ang_vel.dtype, device=ang_vel.device)
    return exp(ang_vel * dt[..., None])


def log(R):
    """Axis-angle from a rotation matrix over the full range [0, π].

    Goes through a unit quaternion with Shepperd's pivot (the largest of
    4w², 4x², 4y², 4z²), then w = θ·axis with θ = 2·atan2(‖q_v‖, q_w): well
    conditioned at θ ≈ 0 and at θ ≈ π, where θ/(2 sin θ)·vee(R − Rᵀ) is 0/0.
    """
    # every entry as (..., 1), never 0-dim (see _theta_sq): jacfwd of a
    # float32 log then stays float32
    m00, m01, m02 = R[..., 0, 0:1], R[..., 0, 1:2], R[..., 0, 2:3]
    m10, m11, m12 = R[..., 1, 0:1], R[..., 1, 1:2], R[..., 1, 2:3]
    m20, m21, m22 = R[..., 2, 0:1], R[..., 2, 1:2], R[..., 2, 2:3]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = torch.cat([qw2, qx2, qy2, qz2], dim=-1)
    pivot = torch.argmax(cands, dim=-1)
    # the candidates sum to 4, so the largest is ≥ 1 and s is nonzero
    s = torch.sqrt(torch.clamp_min(torch.amax(cands, dim=-1, keepdim=True), 1.0))  # 2·|pivot component|
    d = 0.5 / s
    q_by_pivot = torch.stack(
        [
            torch.cat([0.5 * s, (m21 - m12) * d, (m02 - m20) * d, (m10 - m01) * d], dim=-1),
            torch.cat([(m21 - m12) * d, 0.5 * s, (m10 + m01) * d, (m02 + m20) * d], dim=-1),
            torch.cat([(m02 - m20) * d, (m10 + m01) * d, 0.5 * s, (m21 + m12) * d], dim=-1),
            torch.cat([(m10 - m01) * d, (m02 + m20) * d, (m21 + m12) * d, 0.5 * s], dim=-1),
        ],
        dim=-2,
    )
    q = torch.take_along_dim(q_by_pivot, pivot[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # hemisphere: θ ∈ [0, π]
    qw = q[..., :1]
    v = q[..., 1:]
    nv_sq = _theta_sq(v)
    small, nv = _safe_theta(nv_sq)  # ‖q_v‖ = sin(θ/2)
    # θ/‖q_v‖ = 2·atan2(nv, qw)/nv; Taylor at nv → 0: 2/qw · (1 − nv²/(3qw²))
    qw_t = torch.where(small, torch.clamp_min(qw, 0.5), torch.ones_like(qw))
    factor = torch.where(
        small,
        (2.0 / qw_t) * (1.0 - nv_sq / (3.0 * qw_t * qw_t)),
        2.0 * torch.atan2(nv, qw) / nv,
    )
    return factor * v


def left_jacobian(w):
    """J_l = I + (1−cosθ)/θ²·K + (θ−sinθ)/θ³·K²."""
    t_sq = _theta_sq(w)
    K = hat(w)
    K2 = K @ K
    b = _one_minus_cos_over_t_sq(t_sq)[..., None]
    c = _t_minus_sin_over_t_cubed(t_sq)[..., None]
    return _eye_like(K) + b * K + c * K2


def right_jacobian(w):
    """J_r(w) = J_l(−w)."""
    return left_jacobian(-w)


def inverse_left_jacobian(w):
    """J_l⁻¹ = I − K/2 + (1/θ² − 1/(2θ·tan(θ/2)))·K², finite at θ = π."""
    t_sq = _theta_sq(w)
    small, t = _safe_theta(t_sq)
    K = hat(w)
    K2 = K @ K
    safe_t_sq = torch.where(small, torch.ones_like(t_sq), t_sq)
    # Taylor: 1/12 + θ²/720 + θ⁴/30240
    factor = torch.where(
        small,
        1.0 / 12.0 + t_sq / 720.0 + t_sq * t_sq / 30240.0,
        1.0 / safe_t_sq - 1.0 / (2.0 * t * torch.tan(0.5 * t)),
    )
    return _eye_like(K) - 0.5 * K + factor[..., None] * K2


def inverse_right_jacobian(w):
    """J_r⁻¹(w) = J_l⁻¹(−w)."""
    return inverse_left_jacobian(-w)
