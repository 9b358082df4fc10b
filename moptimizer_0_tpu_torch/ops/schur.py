"""Explicit Schur complement of the dense bundle-adjustment step.

PyTorch counterpart of ``moptimizer_0_tpu.ba_dense._build_schur`` and of the
TPU kernel that computes its correction sum, K11
(``benchmarks/schur_pallas_ab.py::build_schur_pallas`` → ``_syrk_kernel``):

    S = blockdiag(U′) − Σ_l A2_lᵀA2_l,   then identity rows for fixed cameras,

in the permuted component-major order of the JAX package: camera c's
component i is row/column i·C + c. A2_l (3, 6C) is the one-hot camera fold
of G_l = W_l·L_l⁻ᵀ, the landmark's camera blocks folded with the inverse of
its damped V′'s Cholesky factor.

``schur_correction`` routes the correction sum S_corr by backend, like
``ops.nn_search.nearest_neighbors``:

* ``"cuda"``  — the hand-written Hopper kernel (``kernels.schur``), which sums
  the per-landmark slot pairs with float32 atomics; CUDA float32 tensors only;
* ``"torch"`` — ``_schur_corr_torch``, its plain version: A2 built chunk by
  chunk with ``index_add_`` and multiplied out with a matmul;
* ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors.
"""

import torch

from moptimizer_0_tpu_torch.kernels.schur import schur_corr_cuda

BACKENDS = ("auto", "cuda", "torch")


def fold_linv(W, Linv):
    """G = W·Linvᵀ per slot: W (L, K, 6, 3), Linv (L, 3, 3) → (L, K, 6, 3)."""
    return torch.sum(W[..., :, None, :] * Linv[:, None, None, :, :], dim=-1)


def _schur_corr_torch(segments, C, chunk=512):
    """Plain version of the kernel: S_corr = Σ_l A2_lᵀA2_l over the
    segments' (G, cam_ids, mask) triples, with A2 (3·chunk, 6C) built for
    ``chunk`` landmarks at a time by a scatter (never a one-hot). A slot
    whose camera id is outside [0, C) adds nothing, as in the one-hot fold."""
    G0 = segments[0][0]
    S = torch.zeros((6 * C, 6 * C), dtype=G0.dtype, device=G0.device)
    for G, cam_ids, mask in segments:
        for s in range(0, cam_ids.shape[0], chunk):
            Gc, cc, mc = G[s : s + chunk], cam_ids[s : s + chunk], mask[s : s + chunk]
            n, K = cc.shape
            if n * K == 0:
                continue
            real = (mc != 0) & (cc >= 0) & (cc < C)
            # flat index of A2[q, m, i, c] in the (n, 3, 6, C) panel
            q = torch.arange(n, device=G.device)[:, None, None, None]
            i = torch.arange(6, device=G.device)[None, None, :, None]
            m = torch.arange(3, device=G.device)[None, None, None, :]
            cam = torch.where(real, cc, 0).to(torch.int64)[:, :, None, None]
            idx = ((q * 3 + m) * 6 + i) * C + cam  # (n, K, 6, 3), like Gc
            vals = torch.where(real[..., None, None], Gc * mc[..., None, None], 0.0)
            A2 = torch.zeros(n * 18 * C, dtype=G.dtype, device=G.device)
            A2.index_add_(0, idx.reshape(-1), vals.reshape(-1))
            A2 = A2.reshape(n * 3, 6 * C)
            S.addmm_(A2.T, A2)
    return S


def schur_correction(segments, C, *, backend="auto", chunk=512):
    """S_corr (6C, 6C) = Σ_l A2_lᵀA2_l over ``segments``, a list of
    (G (L_s, K_s, 6, 3), cam_ids (L_s, K_s) int32, mask (L_s, K_s)) triples.
    ``chunk`` is the plain version's landmarks per panel."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown Schur backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        backend = "cuda" if segments[0][0].is_cuda else "torch"
    if backend == "cuda":
        return schur_corr_cuda(segments, C)
    return _schur_corr_torch(segments, C, chunk)


def build_schur(U_d, Linv, W_segs, views, fixed_mask, *, backend="auto", chunk=512):
    """S (6C, 6C) in i·C + c order from the damped camera blocks U_d (C, 6, 6),
    the landmarks' Linv (L, 3, 3) in grid-row order, and per segment its W
    grid with its (row_slice, grid view) from ``ba_dense._seg_views``.
    fixed_mask (C,) is 1.0 for free cameras, 0.0 for fixed ones."""
    C = U_d.shape[0]
    segments = [
        (fold_linv(W_s, Linv[sl]), view.cam_ids, view.mask)
        for (sl, view), W_s in zip(views, W_segs)
    ]
    S = schur_correction(segments, C, backend=backend, chunk=chunk).to(U_d.dtype).neg_()
    # U′ on the camera diagonal blocks: entry (c, i, j) lands at row i·C + c,
    # column j·C + c
    c = torch.arange(C, device=U_d.device)[:, None, None]
    i6 = C * torch.arange(6, device=U_d.device)
    rows = (c + i6[None, :, None]).expand(C, 6, 6).reshape(-1)
    cols = (c + i6[None, None, :]).expand(C, 6, 6).reshape(-1)
    S.index_put_((rows, cols), U_d.reshape(-1), accumulate=True)
    # gauge fixing: identity rows and columns for fixed cameras; flat index
    # i·C + c belongs to camera c, so the mask is tiled, not repeated
    free = fixed_mask.repeat(6)
    S.mul_(free[:, None]).mul_(free[None, :])
    S.diagonal().add_(1.0 - free)
    return S
