"""Brute-force nearest-neighbour correspondence search.

``nearest_neighbors`` routes by backend:

* ``"cuda"``  — the hand-written Hopper kernel (``kernels.nn_search.nn_cuda``,
  the port of the TPU kernel ``_nn_vpu_kernel``); CUDA tensors only;
* ``"torch"`` — ``_nn_torch``, its plain PyTorch version;
* ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors.

Both compute d² = (qx−px)² + (qy−py)² + (qz−pz)² in float32 with every
operation rounded on its own, take the first index on ties, and let a NaN d²
never win, so they agree bit for bit.
"""

import torch

from moptimizer_0_tpu_torch.kernels.nn_search import nn_cuda

# Elements of the (queries × targets) block that _nn_torch holds per chunk.
_CHUNK_ELEMS = 1 << 25


def _nn_torch(query, points):
    """Plain version of the kernel: exact direct differences, chunked over
    queries so that the whole (Q, M) distance block is never in memory."""
    q = query.to(torch.float32)
    p = points.to(torch.float32)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    chunk = max(1, _CHUNK_ELEMS // p.shape[0])
    idx, dist = [], []
    for s in range(0, q.shape[0], chunk):
        qc = q[s : s + chunk]
        dx = qc[:, 0:1] - px
        dy = qc[:, 1:2] - py
        dz = qc[:, 2:3] - pz
        d2 = dx * dx + dy * dy + dz * dz
        d2.masked_fill_(torch.isnan(d2), torch.inf)
        best, arg = torch.min(d2, dim=1)  # first index of the minimum
        idx.append(arg.to(torch.int32))
        dist.append(best)
    return torch.cat(idx), torch.cat(dist)


def nearest_neighbors(query, points, *, backend="auto"):
    """For each query point, the index of (int32) and squared distance to
    (float32) its nearest point in ``points``. Returns (indices (Q,),
    sq_dists (Q,)); any float dtype is searched in float32."""
    if query.shape[0] == 0 or points.shape[0] == 0:
        raise ValueError(
            f"nearest_neighbors needs non-empty clouds; got query {tuple(query.shape)}, "
            f"points {tuple(points.shape)}"
        )
    if backend == "auto":
        backend = "cuda" if query.is_cuda else "torch"
    if backend == "cuda":
        return nn_cuda(query.to(torch.float32).contiguous(), points.to(torch.float32).contiguous())
    if backend == "torch":
        return _nn_torch(query, points)
    if backend == "pallas_mxu":
        raise NotImplementedError(
            "the expansion kernel K6 (pallas_mxu) is not ported yet; see ROADMAP.md"
        )
    raise ValueError(f"unknown nearest-neighbour backend {backend!r}")
