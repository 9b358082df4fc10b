"""Dense SPD solve of the dense-Schur engine's (6C)² camera system.

PyTorch counterpart of ``moptimizer_0_tpu.ops.block_cholesky.spd_solve``.
The JAX module's blocked matmul recursion is a TPU experiment that its own
measurement refuted; it is not ported (ROADMAP.md, "Not ported").
"""

import torch


def spd_solve(A, b, method="auto"):
    """Solve A x = b for SPD A (n, n) and b (n,) or (n, k).

    method "auto" and "xla" (the names of the JAX package) both factor with
    ``torch.linalg.cholesky_ex`` and solve with ``torch.cholesky_solve``. A
    matrix that is not positive definite gives a NaN solution rather than an
    exception, as ``jax.scipy.linalg.cho_factor`` does; the LM loop turns it
    into NUMERIC_ERROR. No host synchronisation.
    """
    if method == "blocked":
        raise NotImplementedError(
            'spd_solve(method="blocked") is not ported (ROADMAP.md, "Not ported"); use "auto"'
        )
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown SPD solve method {method!r}")
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b.reshape(b.shape[0], -1), L).reshape(b.shape)
    return torch.where(info != 0, torch.full_like(x, torch.nan), x)
