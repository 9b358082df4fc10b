"""Explicit Schur complement of the dense bundle-adjustment step.

PyTorch counterpart of ``moptimizer_0_tpu.ba_dense._build_schur`` and of the
TPU kernel that computes its correction sum, K11
(``benchmarks/schur_pallas_ab.py::build_schur_pallas`` → ``_syrk_kernel``):

    S = blockdiag(U′) − Σ_l A2_lᵀA2_l,   then identity rows for fixed cameras,

in the permuted component-major order of the JAX package: camera c's
component i is row/column i·C + c. A2_l (3, 6C) is the one-hot camera fold
of G_l = W_l·L_l⁻ᵀ, the landmark's camera blocks folded with the inverse of
its damped V′'s Cholesky factor.

``build_schur`` (and ``schur_correction``, for callers that hold the
segments) routes the correction sum S_corr by backend, like
``ops.nn_search.nearest_neighbors``:

* ``"cuda"``  — the hand-written Hopper kernel (``kernels.schur``), which
  gathers the 6×6 block of each camera pair from the slot pairs of a
  ``PairPlan``, no atomics; CUDA float32 tensors only;
* ``"torch"`` — ``_schur_corr_torch``, its plain version: A2 built chunk by
  chunk with ``index_add_`` and multiplied out with a matmul;
* ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors.

``_schur_corr_pairs_torch`` is the plain gather over the same plan as the
kernel, for the tests; no route takes it.
"""

import dataclasses

import numpy as np
import torch

from moptimizer_0_tpu_torch.kernels.schur import schur_corr_cuda

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True, eq=False)
class PairPlan:
    """Which slot pairs add into which 6×6 block of S_corr: index
    bookkeeping that depends only on the camera ids and masks, which do not
    change during a solve, so it is built once per grouped layout.

    Every ordered pair (k, k′) of real slots of one landmark (mask ≠ 0,
    camera id in [0, C)) with cam_k ≤ cam_k′ is an entry; the block
    (cam_k′, cam_k) of a pair with cam_k < cam_k′ is the transpose of
    (cam_k, cam_k′) and is written from it. Entries are sorted stably by
    (cam_k, cam_k′), so within a block they run in (landmark, k, k′) order,
    landmarks numbered through the segments in turn.

    C:         cameras.
    n_slots:   Σ L_s·K_s. Slot (l, k) of segment s is flat slot
               Σ_{s′<s} L_s′·K_s′ + l·K_s + k of the (n_slots, 6, 3) G
               buffer (``fold_segments``).
    pairs:    (E, 2) int32 flat slots (k, k′) of each entry.
    weight:    (E,) mask_k·mask_k′, in the masks' dtype.
    block_ptr: (P + 1,) int32; block p holds entries [block_ptr[p], block_ptr[p + 1]).
    block_cam: (P, 2) int32 (c, c′) of each non-empty block, c ≤ c′.
    order:     (P,) int32 blocks by descending entry count (the kernel's
               schedule: the longest blocks start first).
    """

    C: int
    n_slots: int
    pairs: torch.Tensor
    weight: torch.Tensor
    block_ptr: torch.Tensor
    block_cam: torch.Tensor
    order: torch.Tensor

    @property
    def nbytes(self):
        """Bytes of the plan's tensors."""
        ts = (self.pairs, self.weight, self.block_ptr, self.block_cam, self.order)
        return sum(t.numel() * t.element_size() for t in ts)


def pair_plan(segments, C):
    """The ``PairPlan`` of ``segments``, a list of (cam_ids (L_s, K_s) int,
    mask (L_s, K_s)) pairs on one device, for C cameras. Tensor operations
    on that device, few kinds of them (the first use of each kind in a
    process loads its CUDA module); it reads the entry and block counts
    back to the host."""
    if not segments:
        raise ValueError("pair_plan: no segments")
    if not 0 < C < 2**31 // 6:
        raise ValueError(f"pair_plan: need 1 <= C < {2**31 // 6}, got {C}")
    n_slots = sum(cam_ids.numel() for cam_ids, _ in segments)
    if n_slots >= 2**31:
        raise ValueError(f"pair_plan: {n_slots} slots; need fewer than 2**31")
    dev = segments[0][0].device
    keys, a_l, b_l, w_l = [], [], [], []
    off = 0
    for cam_ids, mask in segments:
        L, K = cam_ids.shape
        cam = cam_ids.long()
        real = (mask != 0) & (cam >= 0) & (cam < C)
        # every ordered pair (k, k′) of one landmark's slots, in (landmark,
        # k, k′) order; the real ones with cam_k ≤ cam_k′ are entries
        keep = real[:, :, None] & real[:, None, :] & (cam[:, :, None] <= cam[:, None, :])
        at = torch.nonzero(keep.reshape(-1)).squeeze(1)
        slot = off + torch.arange(L * K, device=dev).reshape(L, K)
        keys.append((cam[:, :, None] * C + cam[:, None, :]).reshape(-1)[at])
        a_l.append(slot[:, :, None].expand(L, K, K).reshape(-1)[at])
        b_l.append(slot[:, None, :].expand(L, K, K).reshape(-1)[at])
        w_l.append((mask[:, :, None] * mask[:, None, :]).reshape(-1)[at])
        off += L * K
    key, perm = torch.sort(torch.cat(keys), stable=True)
    E = key.shape[0]
    if E >= 2**31:
        raise ValueError(f"pair_plan: {E} slot pairs; need fewer than 2**31")
    # a block starts where the sorted key changes
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(new).squeeze(1)
    block_ptr = torch.cat([starts, torch.full((1,), E, dtype=starts.dtype, device=dev)])
    # each block's key and size, on the host (P values)
    blocks, counts = torch.stack([key[starts], block_ptr[1:] - block_ptr[:-1]]).cpu().numpy()

    def on_dev(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    return PairPlan(
        C=C,
        n_slots=n_slots,
        pairs=torch.stack([torch.cat(a_l)[perm], torch.cat(b_l)[perm]], 1).to(torch.int32),
        weight=torch.cat(w_l)[perm],
        block_ptr=block_ptr.to(torch.int32),
        block_cam=on_dev(np.stack([blocks // C, blocks % C], 1)),
        order=on_dev(np.argsort(-counts, kind="stable")),
    )


def fold_linv(W, Linv, out=None):
    """G = W·Linvᵀ per slot: W (L, K, 6, 3), Linv (L, 3, 3) → (L, K, 6, 3)."""
    return torch.sum(W[..., :, None, :] * Linv[:, None, None, :, :], dim=-1, out=out)


def fold_segments(W_segs, Linv, views):
    """G of every segment, written into one flat (Σ L_s·K_s, 6, 3) buffer:
    (G_flat, [(G_s, cam_ids, mask)]) with each G_s a view of G_flat, in the
    flat slot layout of ``PairPlan``. Linv (L, 3, 3) in grid-row order;
    ``views`` as ``GroupedBA.views`` gives them."""
    n_slots = sum(view.cam_ids.numel() for _, view in views)
    W0 = W_segs[0]
    G = torch.empty((n_slots, 6, 3), dtype=W0.dtype, device=W0.device)
    segments, off = [], 0
    for (sl, view), W_s in zip(views, W_segs):
        L, K = view.cam_ids.shape
        G_s = fold_linv(W_s, Linv[sl], out=G[off : off + L * K].view(L, K, 6, 3))
        segments.append((G_s, view.cam_ids, view.mask))
        off += L * K
    return G, segments


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
    # A2ᵀA2 is symmetric, but a BLAS need not sum (i, j) and (j, i) in one
    # order: keep the upper triangle and mirror it, so S is symmetric to the
    # bit, as the kernel's build is
    i = torch.arange(6 * C, device=S.device)
    return torch.where(i[:, None] <= i[None, :], S, S.mT)


def _schur_corr_pairs_torch(plan, G, chunk=1 << 16):
    """The kernel's gather written plainly: each plan entry's 6×6 block
    weight·G_k·G_k′ᵀ, summed per camera pair, written at rows i·C + c,
    columns j·C + c′ and, for c < c′, transposed at (c′, c). G is the flat
    (plan.n_slots, 6, 3) buffer; ``chunk`` entries at a time."""
    C, P = plan.C, plan.block_cam.shape[0]
    S = torch.zeros((6 * C, 6 * C), dtype=G.dtype, device=G.device)
    blocks = torch.zeros((P, 6, 6), dtype=G.dtype, device=G.device)
    ptr = plan.block_ptr.long()
    block_of = torch.repeat_interleave(torch.arange(P, device=G.device), ptr[1:] - ptr[:-1])
    pairs = plan.pairs.long()
    for s in range(0, pairs.shape[0], chunk):
        a, b = pairs[s : s + chunk, 0], pairs[s : s + chunk, 1]
        w = plan.weight[s : s + chunk].to(G.dtype)
        blocks.index_add_(0, block_of[s : s + chunk], (G[a] * w[:, None, None]) @ G[b].transpose(1, 2))
    c, c2 = plan.block_cam[:, 0].long(), plan.block_cam[:, 1].long()
    i6 = C * torch.arange(6, device=G.device)
    rows = (c[:, None, None] + i6[None, :, None]).expand(P, 6, 6)
    cols = (c2[:, None, None] + i6[None, None, :]).expand(P, 6, 6)
    S[rows, cols] = blocks
    off = c != c2
    S[cols[off], rows[off]] = blocks[off]
    return S


def resolve_backend(backend, t):
    """"cuda" or "torch" for a Schur backend name and a tensor of the build."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown Schur backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "torch"
    return backend


def schur_correction(segments, C, *, backend="auto", chunk=512, plan=None, G=None):
    """S_corr (6C, 6C) = Σ_l A2_lᵀA2_l over ``segments``, a list of
    (G (L_s, K_s, 6, 3), cam_ids (L_s, K_s) int32, mask (L_s, K_s)) triples.
    ``chunk`` is the plain version's landmarks per panel. The kernel's route
    needs ``plan``, the segments' ``pair_plan``, and ``G``, their G in one
    flat buffer (``fold_segments``), and raises without them."""
    if resolve_backend(backend, segments[0][0]) == "torch":
        return _schur_corr_torch(segments, C, chunk)
    if plan is None or G is None:
        raise ValueError("schur_correction: the kernel needs the segments' pair_plan and flat G")
    return schur_corr_cuda(plan, G)


def build_schur(U_d, Linv, W_segs, grouped, fixed_mask, *, backend="auto", chunk=512):
    """S (6C, 6C) in i·C + c order from the damped camera blocks U_d (C, 6, 6),
    the landmarks' Linv (L, 3, 3) in grid-row order, and W_segs, the W grid
    of each segment of ``grouped`` (a ``ba_dense.GroupedBA``: its ``views``,
    and for the kernel its cached ``schur_plan(C)``). fixed_mask (C,) is 1.0
    for free cameras, 0.0 for fixed ones."""
    S_corr = grouped_correction(Linv, W_segs, grouped, U_d.shape[0], backend=backend, chunk=chunk)
    return assemble_schur(S_corr, U_d, fixed_mask)


def grouped_correction(Linv, W_segs, grouped, C, *, backend="auto", chunk=512):
    """S_corr (6C, 6C) of one ``ba_dense.GroupedBA`` layout: its segments' G
    folded into one flat buffer, then the kernel over the layout's cached
    ``schur_plan(C)`` or the plain version, by ``backend``."""
    G, segments = fold_segments(W_segs, Linv, grouped.views)
    if resolve_backend(backend, G) == "cuda":
        return schur_corr_cuda(grouped.schur_plan(C), G)
    return _schur_corr_torch(segments, C, chunk)


def assemble_schur(S_corr, U_d, fixed_mask):
    """S = blockdiag(U_d) − S_corr in i·C + c order, with identity rows and
    columns for the fixed cameras (fixed_mask 0.0). Writes S over S_corr
    when it has U_d's dtype."""
    C = U_d.shape[0]
    S = S_corr.to(U_d.dtype).neg_()
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
