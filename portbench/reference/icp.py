"""Plain point-to-point ICP: the reference of the scan configurations.

The same problem as the port's ``registration.icp``: find x = [t, ω]
(R = exp(ω)) minimising Σ‖R s + t − q(s)‖² over the source points s, q(s)
the target point nearest to R s + t, searched anew at every iteration,
every point kept (no gate, the trivial loss). Solved by alternating the
exhaustive nearest-neighbour search with the closed-form minimiser for fixed
matches (Kabsch / Umeyama, by an SVD) until the matches stop changing, at
which point x is the exact minimiser for its own matches: the fixed point
every convergent point-to-point ICP shares. Starts from the median-centroid
translation. Distances are |q|² + |p|² − 2 q·p through ``Precision.mm``, in
blocks of queries.
"""

import torch

from portbench.reference.precision import REFERENCE


def nearest(query, points, prec=REFERENCE, block=4096):
    """Index of each query's nearest point (first of ties)."""
    q, p = query.to(prec.dtype), points.to(prec.dtype)
    pn = torch.sum(p * p, dim=1)
    out = []
    for i in range(0, q.shape[0], block):
        qb = q[i:i + block]
        d2 = torch.sum(qb * qb, dim=1)[:, None] + pn[None, :] - 2.0 * prec.mm(qb, p.T)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out)


def _median(a):
    s = torch.sort(a, dim=0).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _kabsch(src, matched, prec):
    """(R, t) minimising Σ‖R s + t − m‖²."""
    ms, mm = src.mean(0), matched.mean(0)
    H = prec.mm((src - ms).T, matched - mm).to(torch.float64)
    Uh, _, Vh = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vh.T @ Uh.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = (Vh.T @ D @ Uh.T).to(prec.dtype)
    return R, mm - R @ ms


def so3_log(R):
    """Axis-angle of a rotation (angles well below π)."""
    c = torch.clamp((torch.trace(R) - 1) / 2, -1.0, 1.0)
    th = torch.arccos(c)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    scale = torch.where(th < 1e-8, torch.full_like(th, 0.5), th / (2 * torch.sin(torch.clamp_min(th, 1e-8))))
    return scale * v


def align(src, tgt, prec=REFERENCE, max_iterations=200):
    """x = [t, ω] aligning src onto tgt, and the iterations taken."""
    src, tgt = src.to(prec.dtype), tgt.to(prec.dtype)
    R = torch.eye(3, dtype=prec.dtype, device=src.device)
    t = _median(tgt) - _median(src)
    prev = None
    for k in range(max_iterations):
        idx = nearest(prec.mm(src, R.T) + t, tgt, prec)
        if prev is not None and torch.equal(idx, prev):
            break
        R, t = _kabsch(src, tgt[idx], prec)
        prev = idx
    return torch.cat([t, so3_log(R.to(torch.float64)).to(prec.dtype)]), k
