"""ICP registration: correspondence search wired into the LM loop.

* per outer iteration (``update_fn``): warp the source cloud with the current
  estimate, find each warped point's nearest target (the CUDA kernel for
  CUDA tensors), gather the matches, and mask those beyond ``max_corr_dist``;
* per evaluation (``prepare_fn``): params6 → 4×4 transform.

Only brute-force search is ported; the hash-grid searcher comes with the
grid slice (ROADMAP.md).
"""

import torch

from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops.icp_linearize import fused_point2point_linearizer
from moptimizer_0_tpu_torch.ops.nn_search import nearest_neighbors

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


def make_searcher(tgt_cloud, nn_backend, max_corr_dist):
    """Correspondence searcher over a fixed target cloud: warped → (idx, d²).

    nn_backend: "auto", "cuda" or "torch" (brute force, see
    ``ops.nn_search.nearest_neighbors``). "grid", and "auto" on a target of
    GRID_AUTO_MIN_TARGETS points or more with a gate, raise
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


def _icp_block_with_searcher(
    src, tgt_cloud, searcher, *, loss=None, max_corr_dist=None, weight_matrix=None
):
    """Build the ICP block around a given searcher."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)
    n = src.shape[0]

    def prepare_fn(x):
        return se3.transform_from_params6(x)

    def residual_fn(T, d):
        warped = T[:3, :3] @ d["src"] + T[:3, 3]
        return warped - d["matched"], d["valid"]

    def update_fn(x, data):
        T = se3.transform_from_params6(x)
        warped = data["src"] @ T[:3, :3].T + T[:3, 3]
        idx, d2 = searcher(warped)
        matched = tgt_cloud.index_select(0, idx)
        if max_corr_dist is not None:
            valid = d2 < torch.tensor(max_corr_dist, dtype=d2.dtype, device=d2.device) ** 2
        else:
            valid = torch.isfinite(d2)
        return dict(data, matched=matched, valid=valid)

    # placeholder correspondences, replaced by the first update
    data = dict(
        src=src,
        matched=tgt_cloud[:n] if tgt_cloud.shape[0] >= n else src,
        valid=torch.ones((n,), dtype=torch.bool, device=src.device),
    )
    return make_block(
        residual_fn,
        data=data,
        prepare_fn=prepare_fn,
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


def _median(a):
    """Median along dim 0, averaging the two middle values on an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(a, dim=0).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


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

    init="centroid" (when x0 is None): seed the translation with
    median(tgt) − median(src), robust to outliers; correspondence search
    cannot recover large offsets from identity. init="identity" starts at 0.
    """
    src = torch.as_tensor(src)
    if x0 is None:
        x0 = torch.zeros(6, dtype=src.dtype, device=src.device)
        if init == "centroid":
            tgt = torch.as_tensor(tgt_cloud).to(src.dtype)
            x0[0:3] = _median(tgt) - _median(src)
    if config is None:
        config = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    blk = icp_block(src, tgt_cloud, loss=loss, max_corr_dist=max_corr_dist, nn_backend=nn_backend)
    return levenberg_marquardt(problem(blk), x0, config)
