"""Fully unrolled Cholesky solve for tiny systems, over any leading lane axes.

PyTorch counterpart of ``moptimizer_0_tpu.ops.small_solve``: the LM damped
solve is a P×P SPD system with P ≤ 15 for every model of the reference, and
writing the factorization out as P(P+1)/2 scalar steps on (...)-shaped
tensors solves every lane of a batched solve at once, in the JAX package's
order of operations. ``capturable_linalg`` keeps PyTorch's own
factorizations on routes that a CUDA graph can capture.
"""

import contextlib

import torch


@contextlib.contextmanager
def capturable_linalg(device):
    """Within it, PyTorch's dense factorizations and solves on a CUDA device
    go to cuSOLVER and cuBLAS. PyTorch's default sends a batched
    ``cholesky_solve`` (a fleet's (B, 6, 6) damped solves) to MAGMA, which
    cannot be captured into a CUDA graph (it synchronises and allocates),
    and no capturable route gives MAGMA's bits. The LM loops capture their
    step inside this; an eager run that must equal a graph bit for bit runs
    inside it too. Nothing changes for another device."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def cholesky_solve_unrolled(A, b):
    """x with A x = b for SPD A (..., P, P), b (..., P), P ≤ 16. NaN on a
    non-SPD input (it reaches the solver's NUMERIC_ERROR path, like a failed
    LDLT)."""
    P = A.shape[-1]
    if P > 16:
        raise ValueError("cholesky_solve_unrolled is for small static P (≤16)")

    # L Lᵀ = A, row by row
    L = [[None] * P for _ in range(P)]
    for i in range(P):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]

    # forward substitution L y = b
    y = [None] * P
    for i in range(P):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    # back substitution Lᵀ x = y
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]

    return torch.stack(x, dim=-1)
