"""ICP registration: correspondence search wired into the LM loop.

* per outer iteration (``update_fn``): warp the source cloud with the current
  estimate, find each warped point's nearest target, gather the matches, and
  mask those beyond ``max_corr_dist``;
* per evaluation (``prepare_fn``): params6 → 4×4 transform.

``icp`` solves one pair; ``icp_batched`` solves a fleet of B same-shape pairs
in one batched LM loop, whose ``batch_update_fn`` searches every lane's
correspondences with one launch of the expansion kernel K6. Inputs that are
not tensors go to the card (``utils.device``). Only brute-force search is
ported; the hash-grid searcher comes with the SLAM front-end slice
(ROADMAP.md).
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import (
    LMConfig,
    levenberg_marquardt,
    levenberg_marquardt_batched,
)
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops.icp_linearize import fused_point2point_linearizer
from moptimizer_0_tpu_torch.ops.nn_search import nearest_neighbors
from moptimizer_0_tpu_torch.utils.device import as_input

# Target-cloud size from which nn_backend="auto" with a gate would route to
# the hash grid (the JAX package's threshold); until the grid is ported such
# a search raises instead of silently running brute force.
GRID_AUTO_MIN_TARGETS = 50_000


def default_pipeline_config():
    """The reference LM schedule plus the noise-floor stopping rule
    (``rel_cost_tol``): real sensor data never trips cost < 8ε or |δ| < √ε."""
    return LMConfig(
        diff_mode="auto",
        max_iterations=40,
        linear_solver="cholesky",
        rel_cost_tol=1e-6,
    )


def _icp_config():
    return LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")


def make_searcher(tgt_cloud, nn_backend, max_corr_dist):
    """Correspondence searcher over a fixed target cloud: warped → (idx, d²).

    nn_backend: "auto", "cuda", "pallas" (K5, as "cuda"), "torch",
    "pallas_mxu" or "xla" (brute force, see
    ``ops.nn_search.nearest_neighbors``). "grid", and "auto" on a target
    of GRID_AUTO_MIN_TARGETS points or more with a gate, raise
    NotImplementedError until the hash grid is ported.
    """
    if nn_backend == "auto":
        if tgt_cloud.shape[0] >= GRID_AUTO_MIN_TARGETS and max_corr_dist is not None:
            nn_backend = "grid"
    if nn_backend == "grid":
        raise NotImplementedError(
            "the hash-grid searcher (ops/grid_nn.py) is not ported yet; see ROADMAP.md"
        )
    return lambda warped: nearest_neighbors(warped, tgt_cloud, backend=nn_backend)


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    return warped - d["matched"], d["valid"]


def _gate(d2, max_corr_dist):
    """Valid matches: within max_corr_dist, or with a finite d² without one."""
    if max_corr_dist is None:
        return torch.isfinite(d2)
    # filled on the device: a host copy would synchronise on every update
    return d2 < torch.full((), max_corr_dist, dtype=d2.dtype, device=d2.device) ** 2


def _placeholder(src, tgt_cloud):
    """The correspondences before the first update: the first n targets, or
    the source itself when the target is smaller."""
    n = src.shape[-2]
    matched = tgt_cloud[..., :n, :] if tgt_cloud.shape[-2] >= n else src
    return dict(
        src=src,
        matched=matched,
        valid=torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device),
    )


def _icp_block_with_searcher(
    src, tgt_cloud, searcher, *, loss=None, max_corr_dist=None, weight_matrix=None
):
    """Build the ICP block around a given searcher."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)

    def update_fn(x, data):
        T = se3.transform_from_params6(x)
        warped = data["src"] @ T[:3, :3].T + T[:3, 3]
        idx, d2 = searcher(warped)
        matched = tgt_cloud.index_select(0, idx)
        return dict(data, matched=matched, valid=_gate(d2, max_corr_dist))

    return make_block(
        _residual,
        data=_placeholder(src, tgt_cloud),
        prepare_fn=_prepare,
        update_fn=update_fn,
        loss=loss,
        weight_matrix=weight_matrix,
        linearize_fn=fused_point2point_linearizer if weight_matrix is None else None,
        name="icp",
    )


def icp_block(src, tgt_cloud, *, loss=None, max_corr_dist=None, nn_backend="auto", weight_matrix=None):
    """Point-to-point ICP block with a correspondence search per outer iteration.

    src: (N, 3) source points; tgt_cloud: (M, 3) target cloud (unaligned)."""
    tgt_cloud = torch.as_tensor(tgt_cloud)
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)
    return _icp_block_with_searcher(
        src, tgt_cloud, searcher, loss=loss, max_corr_dist=max_corr_dist, weight_matrix=weight_matrix
    )


def _icp_fleet_block(srcs, tgt_clouds, *, loss=None, max_corr_dist=None):
    """The ICP block of B lanes: srcs (B, N, 3), tgt_clouds (B, M, 3).

    Its ``batch_update_fn`` warps every lane's source with that lane's
    estimate and searches all lanes together with the expansion ("xla":
    K6 for CUDA tensors, its plain version for CPU tensors)."""

    def batch_update_fn(x, data):
        T = se3.transform_from_params6(x)  # (B, 4, 4)
        warped = data["src"] @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        idx, d2 = nearest_neighbors(warped, tgt_clouds, backend="xla")
        matched = torch.gather(tgt_clouds, 1, idx.long()[..., None].expand(-1, -1, 3))
        return dict(data, matched=matched, valid=_gate(d2, max_corr_dist))

    return make_block(
        _residual,
        data=_placeholder(srcs, tgt_clouds),
        prepare_fn=_prepare,
        batch_update_fn=batch_update_fn,
        loss=loss,
        linearize_fn=fused_point2point_linearizer,
        name="icp",
    )


def _median(a, dim=0):
    """Median along ``dim``, averaging the two middle values on an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(a, dim=dim).values
    n = s.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def icp(
    src,
    tgt_cloud,
    x0=None,
    *,
    config=None,
    loss=None,
    max_corr_dist=None,
    nn_backend="auto",
    init="centroid",
):
    """Full ICP: the LMResult whose x ([t, ω]) aligns src onto tgt_cloud.

    Tensors stay on their device; numpy arrays and lists go to the card.
    init="centroid" (when x0 is None): seed the translation with
    median(tgt) − median(src), robust to outliers; correspondence search
    cannot recover large offsets from identity. init="identity" starts at 0.
    """
    src = as_input(src)
    tgt_cloud = as_input(tgt_cloud)
    if x0 is None:
        x0 = torch.zeros(6, dtype=src.dtype, device=src.device)
        if init == "centroid":
            x0[0:3] = _median(tgt_cloud.to(src.dtype)) - _median(src)
    else:
        x0 = as_input(x0, src.device)
    if config is None:
        config = _icp_config()
    blk = icp_block(src, tgt_cloud, loss=loss, max_corr_dist=max_corr_dist, nn_backend=nn_backend)
    return levenberg_marquardt(problem(blk), x0, config)


def icp_batched(
    srcs,
    tgt_clouds,
    x0s=None,
    *,
    config=None,
    loss=None,
    max_corr_dist=None,
    mesh=None,
    mesh_axis=None,
):
    """B full ICP solves (the per-iteration correspondence update included)
    in one batched LM loop: fleet registration.

    srcs (B, N, 3), tgt_clouds (B, M, 3), x0s (B, 6) or None (each lane
    seeded with median(tgt) − median(src)). Tensors stay on their device;
    numpy arrays and lists go to the card. Every pass of the outer loop
    searches all lanes with one expansion search (K6 on the card).

    Returns an LMResult with a leading B on every field; each lane matches
    its own ``icp(..., nn_backend="xla")`` solve. ``mesh``/``mesh_axis``
    (sharding the lanes over devices) come with the ``parallel/`` slice.
    """
    if mesh is not None or mesh_axis is not None:
        raise NotImplementedError(
            "icp_batched over a device mesh comes with the parallel/ slice; see ROADMAP.md"
        )
    srcs = as_input(srcs)
    tgt_clouds = as_input(tgt_clouds)
    if config is None:
        config = _icp_config()
    if x0s is None:
        t0 = _median(tgt_clouds.to(srcs.dtype), dim=1) - _median(srcs, dim=1)
        x0s = torch.cat([t0, torch.zeros_like(t0)], dim=1)
    else:
        x0s = as_input(x0s, srcs.device)
    blk = _icp_fleet_block(srcs, tgt_clouds, loss=loss, max_corr_dist=max_corr_dist)
    return levenberg_marquardt_batched(problem(blk), x0s, config)
