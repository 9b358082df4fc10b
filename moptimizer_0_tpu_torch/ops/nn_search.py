"""Brute-force nearest-neighbour correspondence search.

``nearest_neighbors`` routes by backend, with the JAX package's names where
it has them:

* ``"cuda"``       — the hand-written Hopper kernel K5
  (``kernels.nn_search.nn_cuda``, the port of ``_nn_vpu_kernel``); CUDA
  tensors only;
* ``"pallas"``     — the JAX package's name for K5: the same as ``"cuda"``;
* ``"torch"``      — ``_nn_torch``, its plain PyTorch version;
* ``"auto"``       — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors;
* ``"pallas_mxu"`` — the hand-written Hopper kernel K6
  (``kernels.nn_expand.nn_expand_cuda``, the port of ``_nn_kernel``); CUDA
  tensors only;
* ``"xla"``        — the expansion routed by device: K6 for CUDA tensors,
  ``_nn_expand_torch``, its plain version, for CPU tensors.

K5 and ``_nn_torch`` compute d² = (qx−px)² + (qy−py)² + (qz−pz)²; K6 and
``_nn_expand_torch`` the expansion d² = (‖q‖² − 2q·p) + ‖p‖², whose error is
about ε·(‖q‖² + ‖p‖²) and is not clamped at 0. Each pair of kernel and plain
version rounds every float32 operation on its own in one fixed order, takes
the first index on ties and lets a NaN d² never win (a NaN query gives
(0, +inf)), so the two agree bit for bit. The expansion backends take a
leading lane axis: query (..., Q, 3) against points (..., M, 3), each lane
searching only its own points.
"""

import torch

from moptimizer_0_tpu_torch.kernels.nn_expand import nn_expand_cuda
from moptimizer_0_tpu_torch.kernels.nn_search import nn_cuda

# Elements of the (queries × targets) block that a plain version holds per chunk.
_CHUNK_ELEMS = 1 << 25


def _chunk_rows(lanes, n_points, chunk):
    """Queries a plain version's chunk holds: at most ``chunk`` (None: no
    limit) and at most ``_CHUNK_ELEMS`` distances in all."""
    rows = max(1, _CHUNK_ELEMS // (lanes * n_points))
    return rows if chunk is None else max(1, min(rows, int(chunk)))


def _nn_torch(query, points, chunk=None):
    """Plain version of K5: exact direct differences, chunked over queries
    (``_chunk_rows``) so that the whole (Q, M) distance block is never in
    memory. Each query's row is its own, so the chunks change no bit."""
    q = query.to(torch.float32)
    p = points.to(torch.float32)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    chunk = _chunk_rows(1, p.shape[0], chunk)
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


def _sq_norm(a):
    """(ax·ax + ay·ay) + az·az of (..., 3) in that order."""
    return (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]


def _nn_expand_torch(query, points, chunk=None):
    """Plain version of K6: d² = (qn − 2·cross) + pn with qn = ‖q‖², pn = ‖p‖²
    and cross = (qx·px + qy·py) + qz·pz, every float32 operation rounded on
    its own (no matmul, no ``sum``: their order is not fixed). query
    (..., Q, 3), points (..., M, 3) with the same leading lane axes; chunked
    over queries (``_chunk_rows``) so that the whole (..., Q, M) block is
    never in memory."""
    q = query.to(torch.float32)
    p = points.to(torch.float32)
    pn = _sq_norm(p)[..., None, :]  # (..., 1, M)
    px, py, pz = (p[..., None, :, c] for c in range(3))
    chunk = _chunk_rows(q[..., 0, 0].numel(), p.shape[-2], chunk)
    idx, dist = [], []
    for s in range(0, q.shape[-2], chunk):
        qc = q[..., s : s + chunk, :]
        qn = _sq_norm(qc)[..., None]  # (..., chunk, 1)
        cross = (qc[..., 0:1] * px + qc[..., 1:2] * py) + qc[..., 2:3] * pz
        d2 = (qn - 2.0 * cross) + pn
        d2.masked_fill_(torch.isnan(d2), torch.inf)
        best, arg = torch.min(d2, dim=-1)  # first index of the minimum
        idx.append(arg.to(torch.int32))
        dist.append(best)
    return torch.cat(idx, dim=-1), torch.cat(dist, dim=-1)


def knn(query, points, k, chunk=1024):
    """The k nearest points of each query, nearest first: (idx (Q, k) int32,
    d² (Q, k) float32), d² the expansion of ``_nn_expand_torch`` in float32
    (the JAX package's ``knn`` form), chunked over queries. Plain PyTorch on
    either device. ``torch.topk`` may order exact ties other than
    ``lax.top_k``; its one caller here, ``grid_nn.estimate_spacing``, uses
    only d²."""
    q = query.to(torch.float32)
    p = points.to(torch.float32)
    pn = _sq_norm(p)[None, :]
    idx, dist = [], []
    for s in range(0, q.shape[0], chunk):
        qc = q[s : s + chunk]
        cross = (qc[:, 0:1] * p[:, 0] + qc[:, 1:2] * p[:, 1]) + qc[:, 2:3] * p[:, 2]
        d2 = (_sq_norm(qc)[:, None] - 2.0 * cross) + pn
        neg, i = torch.topk(-d2, k, dim=1)
        idx.append(i.to(torch.int32))
        dist.append(-neg)
    return torch.cat(idx), torch.cat(dist)


def nearest_neighbors(query, points, *, backend="auto", block_q=None, block_p=None, chunk=1024):
    """For each query point, the index of (int32) and squared distance to
    (float32) its nearest point in ``points``. Returns (indices, sq_dists)
    of shape query.shape[:-1]; any float dtype is searched in float32.
    query (Q, 3) against points (M, 3); the expansion backends ("xla",
    "pallas_mxu") also take lanes, (..., Q, 3) against (..., M, 3).

    The JAX package's tuning keywords: ``block_q`` and ``block_p`` (its
    Pallas tiles) are ignored, since K5 and K6 choose their own blocks and
    target splits; ``chunk`` caps the queries a chunk of the plain versions
    holds (a lane's, on the CPU), which changes no result."""
    del block_q, block_p
    if query.shape[-2] == 0 or points.shape[-2] == 0:
        raise ValueError(
            f"nearest_neighbors needs non-empty clouds; got query {tuple(query.shape)}, "
            f"points {tuple(points.shape)}"
        )
    if backend == "auto":
        backend = "cuda" if query.is_cuda else "torch"
    if backend == "xla":
        if not query.is_cuda:
            return _nn_expand_torch(query, points, chunk)
        backend = "pallas_mxu"
    if backend in ("cuda", "pallas"):
        return nn_cuda(query.to(torch.float32).contiguous(), points.to(torch.float32).contiguous())
    if backend == "torch":
        return _nn_torch(query, points, chunk)
    if backend == "pallas_mxu":
        return nn_expand_cuda(
            query.to(torch.float32).contiguous(), points.to(torch.float32).contiguous()
        )
    raise ValueError(f"unknown nearest-neighbour backend {backend!r}")
