"""Closed-form (moment-based) point-to-point linearization.

For r_i = R s_i + t − q_i in the params6 convention, J_i = [I₃ | −[y_i]ₓ J_l(ω)]
with y_i = R s_i, and the weighted Gauss-Newton sums collapse to moments:

    H_tt = (Σ wᵢ) I₃
    H_tω = −hat(Σ wᵢ yᵢ) · J_l
    H_ωω = J_lᵀ (tr(M)·I₃ − M) J_l,   M = Σ wᵢ yᵢ yᵢᵀ
    b_t  = Σ wᵢ rᵢ
    b_ω  = J_lᵀ Σ wᵢ (yᵢ × rᵢ)

so the (N, 3, 6) Jacobian is never built. w = loss(‖r‖²) on valid rows and
0 elsewhere scales H, b only; the cost is the unweighted Σ valid ‖r‖².

Plain PyTorch here; a fused kernel for the moment pass is queued (ROADMAP K8).
The batched solver runs it under ``torch.func.vmap``: for a fleet of B lanes
each moment is one reduction over (B, N), one pass a fleet step.
"""

import torch

from moptimizer_0_tpu_torch.lie import so3


def icp_moments(src, tgt, R, t, loss, valid=None):
    """Weighted moments over the cloud. src/tgt: (N, 3); R (3, 3), t (3,).

    Returns dict(Sw, Sy (3,), Sr (3,), Sxr (3,), M (3, 3), cost)."""
    s0, s1, s2 = src[:, 0], src[:, 1], src[:, 2]
    y = [R[j, 0] * s0 + R[j, 1] * s1 + R[j, 2] * s2 for j in range(3)]
    r = [y[j] + t[j] - tgt[:, j] for j in range(3)]
    sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    w = loss.weight(sq)
    if valid is not None:
        # a select, as XLA makes of the JAX package's product with the cast
        # mask: a masked row with a NaN residual adds 0, not NaN
        w = torch.where(valid, w, 0.0)
        cost = torch.sum(torch.where(valid, sq, 0.0))
    else:
        cost = torch.sum(sq)

    cross = [
        y[1] * r[2] - y[2] * r[1],
        y[2] * r[0] - y[0] * r[2],
        y[0] * r[1] - y[1] * r[0],
    ]
    M = torch.stack(
        [torch.stack([torch.sum(w * y[j] * y[k]) for k in range(3)]) for j in range(3)]
    )
    return dict(
        Sw=torch.sum(w),
        Sy=torch.stack([torch.sum(w * y[j]) for j in range(3)]),
        Sr=torch.stack([torch.sum(w * r[j]) for j in range(3)]),
        Sxr=torch.stack([torch.sum(w * cross[j]) for j in range(3)]),
        cost=cost,
        M=M,
    )


def assemble_icp_system(m, x):
    """(cost, H (6, 6), b (6,)) from the moments and the state (for J_l(ω))."""
    Jl = so3.left_jacobian(x[3:6])
    eye = torch.eye(3, dtype=x.dtype, device=x.device)

    H_tt = m["Sw"] * eye
    H_tw = -so3.hat(m["Sy"]) @ Jl
    Mw = torch.trace(m["M"]) * eye - m["M"]
    H_ww = Jl.T @ Mw @ Jl
    H = torch.cat(
        [torch.cat([H_tt, H_tw], dim=1), torch.cat([H_tw.T, H_ww], dim=1)], dim=0
    )
    b = torch.cat([m["Sr"], Jl.T @ m["Sxr"]])
    return m["cost"], H, b


def icp_linearize(src, tgt, x, loss, valid=None):
    """linearize(point2point_block(src, tgt, loss=loss), x, mode="auto"),
    through the moments. src/tgt: (N, 3)."""
    R = so3.exp(x[3:6])
    t = x[0:3]
    m = icp_moments(src, tgt, R, t, loss, valid=valid)
    return assemble_icp_system(m, x)


def fused_point2point_linearizer(block, x):
    """`linearize_fn` for point-to-point and ICP blocks, whose data holds
    src and tgt (or matched), and optionally valid. Sees through the
    ``{_inner, _valid}`` wrapping of ``parallel.mesh.pad_block_to``: the
    padding mask joins valid."""
    d = block.data
    pad_valid = None
    if "_inner" in d:
        pad_valid, d = d["_valid"], d["_inner"]
    valid = d.get("valid")
    if pad_valid is not None:
        valid = pad_valid if valid is None else (valid & pad_valid)
    tgt = d.get("tgt", d.get("matched"))
    return icp_linearize(d["src"], tgt, x, block.loss, valid=valid)
