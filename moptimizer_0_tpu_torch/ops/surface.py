"""Local surface statistics: normals and GICP covariances.

PyTorch counterpart of ``moptimizer_0_tpu.ops.surface``. For each point, PCA
over its k nearest neighbours (``ops.nn_search.knn``) gives the local
surface frame: the normal is the smallest-eigenvalue direction, and the GICP
covariance replaces the eigenvalues with (ε, 1, 1), confident along the
surface and uncertain along the normal (Segal et al.'s plane-to-plane
model). Plain PyTorch on either device.

The eigendecomposition is batched cyclic Jacobi on the 3×3 scatter
matrices (``_eigh_sym3``), not ``torch.linalg.eigh``: on the card, cuSOLVER's
batched solver refuses a batch of 32,768 (CUSOLVER_STATUS_INVALID_VALUE from
``cusolverDnXsyevBatched_bufferSize``, torch 2.11 with CUDA 12.8), and
``eigh`` reads its info flag back to the host. Jacobi is backward stable:
eigenvalues to a few ε·‖C‖ of LAPACK's.

An eigenvector's sign is the solver's choice, and LAPACK, Jacobi and XLA
choose differently: a normal without ``orient_to`` is defined up to sign.
Point-to-plane's cost, H and b and the covariance U diag(ε,1,1) Uᵀ do not
depend on it.
"""

import torch

from moptimizer_0_tpu_torch.ops.nn_search import knn

# Jacobi sweeps: convergence is quadratic, and four sweeps take the
# off-diagonal of a 3×3 to roundoff in float64 (measured on 20,000 random
# and degenerate scatter matrices); two more for margin.
_SWEEPS = 6
_PAIRS = ((0, 1), (0, 2), (1, 2))


def _eigh_sym3(A):
    """(eigenvalues (..., 3) ascending, eigenvectors (..., 3, 3) as columns)
    of symmetric 3×3 matrices by cyclic Jacobi: each rotation zeroes one
    off-diagonal pair (Golub and Van Loan's symmetric Schur 2×2), A ← JᵀAJ,
    V ← VJ. A fixed number of sweeps: no host read."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    V = eye
    for _ in range(_SWEEPS):
        for p, q in _PAIRS:
            apq, app, aqq = A[..., p, q], A[..., p, p], A[..., q, q]
            zero = apq == 0
            tau = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            J = eye.clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return torch.gather(w, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def neighborhood_pca(cloud, k=10):
    """(eigvals (N, 3) ascending, eigvecs (N, 3, 3) columns) of the k-NN
    scatter, in the cloud's dtype (the neighbours are found in float32)."""
    idx, _ = knn(cloud, cloud, k)
    neigh = cloud[idx.long()]  # (N, k, 3)
    centered = neigh - torch.mean(neigh, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    return _eigh_sym3(cov)


def estimate_normals(cloud, k=10, orient_to=None):
    """Unit normals from k-NN PCA. ``orient_to``: an optional viewpoint (3,)
    the normals are flipped to face."""
    _, eigvecs = neighborhood_pca(cloud, k)
    normals = eigvecs[:, :, 0]  # the smallest-eigenvalue direction
    if orient_to is not None:
        to_vp = torch.as_tensor(orient_to, dtype=cloud.dtype, device=cloud.device)[None, :] - cloud
        sign = torch.sign(torch.sum(normals * to_vp, dim=-1, keepdim=True))
        normals = normals * torch.where(sign == 0, 1.0, sign)
    return normals


def gicp_covariances(cloud, k=10, epsilon=1e-3):
    """Per-point GICP covariance C = U diag(ε,1,1) Uᵀ (N, 3, 3)."""
    _, eigvecs = neighborhood_pca(cloud, k)
    d = torch.ones(3, dtype=cloud.dtype, device=cloud.device)
    d[0] = epsilon  # filled on the device: a host copy would synchronise
    return torch.einsum("nij,j,nkj->nik", eigvecs, d, eigvecs)
