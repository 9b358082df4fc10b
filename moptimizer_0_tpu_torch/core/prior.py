"""Gaussian prior factors and square-root marginalization.

PyTorch counterpart of ``moptimizer_0_tpu.core.prior``. At linearization
point x̄ a window's Gauss-Newton system is ½ δᵀHδ + bᵀδ (δ = x − x̄). Split
δ = (δk, δm) into kept and marginalized entries:

    H' = Hkk − Hkm Hmm⁻¹ Hmk        b' = bk − Hkm Hmm⁻¹ bm

and with H' = SᵀS (Cholesky, S upper triangular) the marginal cost is the
one least-squares residual

    r(xk) = S (xk − x̄k) + S⁻ᵀ b'

which the LM engine consumes like any other block. The factorizations are
``cholesky_ex``: a non-PD Hmm or H' gives NaN, not an exception, as XLA does.
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block


def _cholesky_or_nan(A):
    """Lower Cholesky factor of A; where the factorization failed, NaN in
    the lower triangle and 0 above it, as ``jnp.linalg.cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.tril(torch.where(info[..., None, None] != 0, torch.full_like(L, torch.nan), L))


def prior_block(x_ref, sqrt_info, offset=None, *, indices=None, name="prior"):
    """Residual block r = S·(x[idx] − x_ref) + offset.

    x_ref: (P',) reference value; sqrt_info: (P', P') square-root
    information S (any matrix with SᵀS = Λ, e.g. from ``marginalize``);
    offset: (P',) constant term (S⁻ᵀ b' from marginalization; None = zero, a
    plain Gaussian prior centred at x_ref); indices: the entries of the
    state the prior touches (None = the whole state)."""
    x_ref = torch.as_tensor(x_ref)
    sqrt_info = torch.as_tensor(sqrt_info)
    off = None if offset is None else torch.as_tensor(offset)
    idx = None if indices is None else torch.as_tensor(indices).long()

    def residual(x, _):
        xs = x if idx is None else x[idx]
        r = sqrt_info @ (xs - x_ref)
        return r if off is None else r + off

    return make_block(residual, data=None, name=name)


def marginalize(H, b, x_bar, keep, *, reg=0.0):
    """Schur-marginalize a Gauss-Newton system onto the kept indices.

    H (P, P), b (P,): the window system at linearization point x_bar (P,).
    keep: index tensor of the surviving entries (the others are eliminated).
    reg: diagonal added to the eliminated block before its solve.

    Returns (x_ref, sqrt_info, offset) for ``prior_block(x_ref, sqrt_info,
    offset, indices=keep)``: the exact marginal of the quadratic model."""
    H = torch.as_tensor(H)
    b = torch.as_tensor(b)
    x_bar = torch.as_tensor(x_bar)
    keep = torch.as_tensor(keep, device=H.device).long()
    P = H.shape[0]
    mask = torch.zeros(P, dtype=torch.bool, device=H.device)
    mask[keep] = True
    marg = torch.nonzero(~mask)[:, 0]

    Hkk = H[keep[:, None], keep[None, :]]
    Hkm = H[keep[:, None], marg[None, :]]
    Hmm = H[marg[:, None], marg[None, :]] + reg * torch.eye(marg.shape[0], dtype=H.dtype, device=H.device)

    # Hmm is SPD (Gauss-Newton + reg): eliminate through its Cholesky factor
    Lm = _cholesky_or_nan(Hmm)
    Hmm_inv_Hmk = torch.cholesky_solve(Hkm.T, Lm)
    Hmm_inv_bm = torch.cholesky_solve(b[marg][:, None], Lm)[:, 0]
    H_marg = Hkk - Hkm @ Hmm_inv_Hmk
    b_marg = b[keep] - Hkm @ Hmm_inv_bm

    # H' = SᵀS with S = Lᵀ upper triangular; offset = S⁻ᵀ b' = L⁻¹ b'
    L = _cholesky_or_nan(H_marg)
    offset = torch.linalg.solve_triangular(L, b_marg[:, None], upper=False)[:, 0]
    return x_bar[keep], L.T, offset
