"""Dense SPD solves of the dense-Schur engine's (6C)² camera system, and the
blocked Cholesky recursion.

PyTorch counterpart of ``moptimizer_0_tpu.ops.block_cholesky``. ``spd_solve``
factors once with ``torch.linalg.cholesky_ex`` by default; ``"blocked"`` runs
the JAX module's divide-and-conquer recursion, which also gives L⁻¹:

    A = [[A11, A21ᵀ],  →  L = [[L11,  0 ],   L11 = chol(A11)
         [A21, A22]]         [L21, L22]]    L21 = A21·L11⁻ᵀ
                                            L22 = chol(A22 − L21·L21ᵀ)

    L⁻¹ = [[L11⁻¹, 0], [−L22⁻¹·L21·L11⁻¹, L22⁻¹]]

with the JAX module's split points and base size: the panels are plain
matrix products, and blocks of at most ``base`` rows are factored by
``cholesky_ex`` and inverted by a triangular solve. A matrix that is not
positive definite gives NaN rather than an exception, with no host read.
"""

import torch


def _split_point(n, base):
    """First-block size: half of n, rounded up to a multiple of base."""
    half = -(-n // 2)
    return base * (-(-half // base))


def _cholesky(A):
    """Lower factor of the symmetrized A (as ``jnp.linalg.cholesky``), NaN
    where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.mT))
    return torch.where(info != 0, torch.full_like(L, torch.nan), L)


def _chol_inv_rec(A, base):
    """(L, L⁻¹) of SPD A by the co-recursion above."""
    n = A.shape[0]
    if n <= base:
        L = _cholesky(A)
        return L, torch.linalg.solve_triangular(L, torch.eye(n, dtype=A.dtype, device=A.device), upper=False)
    n1 = _split_point(n, base)
    L11, iL11 = _chol_inv_rec(A[:n1, :n1], base)
    L21 = A[n1:, :n1] @ iL11.T
    L22, iL22 = _chol_inv_rec(A[n1:, n1:] - L21 @ L21.T, base)
    iL21 = -(iL22 @ (L21 @ iL11))
    z = A.new_zeros((n1, n - n1))
    return torch.cat([torch.cat([L11, z], 1), torch.cat([L21, L22], 1)]), torch.cat(
        [torch.cat([iL11, z], 1), torch.cat([iL21, iL22], 1)]
    )


def blocked_cholesky_and_inverse(A, base=256):
    """(L, L⁻¹) of SPD A by the blocked recursion."""
    return _chol_inv_rec(A, base)


def blocked_cholesky(A, base=256):
    """Lower Cholesky factor of SPD A by the blocked recursion."""
    return blocked_cholesky_and_inverse(A, base)[0]


def spd_solve_blocked(A, b, base=256):
    """Solve A x = b through the blocked factorization: x = L⁻ᵀ(L⁻¹ b), two
    products and no triangular substitution."""
    _, iL = blocked_cholesky_and_inverse(A, base)
    return iL.T @ (iL @ b)


def spd_solve(A, b, method="auto", base=256):
    """Solve A x = b for SPD A (n, n) and b (n,) or (n, k).

    method:
      "auto", "xla" — one ``torch.linalg.cholesky_ex`` and
                      ``torch.cholesky_solve`` (the JAX package routes
                      "auto" to its one-factorization path at every size);
      "blocked"     — ``spd_solve_blocked`` with block size ``base``.

    A matrix that is not positive definite gives a NaN solution rather than
    an exception, as ``jax.scipy.linalg.cho_factor`` does; the LM loop turns
    it into NUMERIC_ERROR. No host synchronisation.
    """
    if method == "blocked":
        return spd_solve_blocked(A, b, base=base)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown SPD solve method {method!r}")
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b.reshape(b.shape[0], -1), L).reshape(b.shape)
    return torch.where(info != 0, torch.full_like(x, torch.nan), x)
