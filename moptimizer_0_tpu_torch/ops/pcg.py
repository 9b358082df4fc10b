"""Preconditioned conjugate gradients with a stopping test read every few
iterations.

The JAX package's ``_pcg`` is a ``lax.while_loop`` that tests ‖r‖² > tol²
before every iteration. Read on the host at every iteration, that test
would stop the device once an iteration. Here it is read every ``check``
iterations; once it fails, the iterations up to the next read are computed
and discarded (x, r, p and rz are frozen by ``torch.where``), so x is what a
test at every iteration gives. The BA CG engines and the pose graph's CG
solve share it.
"""

import torch

# iterations between two host reads of the stopping test
CHECK = 32


def pcg(matvec, b, precond, iters, tol, read, check=CHECK):
    """x ≈ A⁻¹ b from x = 0 by at most ``iters`` iterations, stopping when
    ‖r‖² ≤ tol². matvec(u) = A·u and precond(u) = M⁻¹·u on tensors shaped
    like b; ``read(flag)`` brings a 0-dim bool to the host (the caller
    counts it). Both divisions are guarded by the dtype's ``tiny``."""
    tiny = torch.full((), torch.finfo(b.dtype).tiny, dtype=b.dtype, device=b.device)
    tol_sq = tol * tol
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    active = torch.sum(r * r) > tol_sq
    for k in range(iters):
        if k % check == 0 and not read(active):
            break
        Ap = matvec(p)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.maximum(rz, tiny)
        p_n = z + beta * p
        x, r, p, rz = (
            torch.where(active, new, old) for new, old in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz))
        )
        active = active & (torch.sum(r * r) > tol_sq)
    return x
