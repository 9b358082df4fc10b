"""Registration: correspondence search wired into the LM loop.

* per outer iteration (``update_fn``): warp the source cloud with the current
  estimate, find each warped point's nearest target, gather the matches, and
  mask those beyond ``max_corr_dist``;
* per evaluation (``prepare_fn``): params6 → 4×4 transform.

``icp`` solves one pair point to point; ``point2plane`` and ``gicp`` solve it
against the surface statistics of ``ops.surface`` (target normals; both
clouds' GICP covariances). ``icp_batched`` solves a fleet of B same-shape
pairs in one batched LM loop, whose ``batch_update_fn`` searches every lane's
correspondences with one launch of the expansion kernel K6.
``PairwiseRegistrar`` registers the pairs of a scan stream (the SLAM front
end) with any of the three methods, searching through the hash grid
(``ops.grid_nn``) or brute force. Inputs that are not tensors go to the card
(``utils.device``).
"""

import math

import torch

from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import (
    LMConfig,
    Status,
    levenberg_marquardt,
    levenberg_marquardt_batched,
)
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.models.gicp import gicp_block
from moptimizer_0_tpu_torch.ops.grid_nn import (
    build_hash_grid,
    build_hash_grid_device,
    build_hash_grid_fixed,
    estimate_spacing,
    grid_nearest_neighbors,
)
from moptimizer_0_tpu_torch.ops.icp_linearize import fused_point2point_linearizer
from moptimizer_0_tpu_torch.ops.nn_search import nearest_neighbors
from moptimizer_0_tpu_torch.ops.surface import estimate_normals, gicp_covariances
from moptimizer_0_tpu_torch.utils.device import as_input
from moptimizer_0_tpu_torch.utils.stats import median as _median

# Target-cloud size from which nn_backend="auto" with a gate routes to the
# hash grid (the JAX package's brute-vs-grid crossover).
GRID_AUTO_MIN_TARGETS = 50_000

# Target-cloud size from which a grid is built on the device (the host build
# ships the whole (S, K) table to the card).
GRID_DEVICE_BUILD_MIN_TARGETS = 100_000

# Points a cloud keeps for a coarse seeding pass (a deterministic stride).
COARSE_MAX_POINTS = 4096

# The registration methods of PairwiseRegistrar and the odometry entry points.
METHODS = ("icp", "gicp", "point2plane")


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


def _coarse_subsample(cloud, cap=COARSE_MAX_POINTS):
    """Deterministic stride subsample for coarse seeding passes."""
    n = cloud.shape[0]
    if n <= cap:
        return cloud
    return cloud[:: -(-n // cap)]


def _grid_cell(tgt_cloud, max_corr_dist):
    """The grid's voxel edge: the gate, or without one 5× the estimated point
    spacing (matches farther than that are no useful correspondences)."""
    if max_corr_dist is not None:
        return float(max_corr_dist)
    return 5.0 * estimate_spacing(tgt_cloud)


def make_searcher(tgt_cloud, nn_backend, max_corr_dist):
    """Correspondence searcher over a fixed target cloud: warped → (idx, d²).

    nn_backend: "auto", "cuda", "pallas" (K5, as "cuda"), "torch",
    "pallas_mxu" or "xla" (brute force, see
    ``ops.nn_search.nearest_neighbors``), or "grid": a voxel hash grid built
    once here with cell = max_corr_dist (or 5× the estimated spacing) and
    queried per iteration; it gives (−1, +inf) beyond the cell.

    "auto" routes to the grid on a target of GRID_AUTO_MIN_TARGETS points or
    more when a gate is set: with cell = max_corr_dist the gated grid makes
    the correspondence decisions of gated brute force. Ungated searches stay
    brute force.
    """
    if nn_backend == "auto":
        if tgt_cloud.shape[0] >= GRID_AUTO_MIN_TARGETS and max_corr_dist is not None:
            nn_backend = "grid"
    if nn_backend != "grid":
        return lambda warped: nearest_neighbors(warped, tgt_cloud, backend=nn_backend)
    big = tgt_cloud.shape[0] >= GRID_DEVICE_BUILD_MIN_TARGETS
    build = build_hash_grid_device if big else build_hash_grid
    grid = build(tgt_cloud, _grid_cell(tgt_cloud, max_corr_dist))
    return lambda warped: grid_nearest_neighbors(warped, grid)


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    return warped - d["matched"], d["valid"]


def _warp(x, src):
    """src (N, 3) under the transform of params6 x."""
    T = se3.transform_from_params6(x)
    return src @ T[:3, :3].T + T[:3, 3]


def _gate(d2, max_corr_dist):
    """Valid matches: within max_corr_dist, or with a finite d² without one."""
    if max_corr_dist is None:
        return torch.isfinite(d2)
    # filled on the device: a host copy would synchronise on every update
    return d2 < torch.full((), max_corr_dist, dtype=d2.dtype, device=d2.device) ** 2


def _wrap(idx, m):
    """idx as int64 with the JAX package's indexing: the grid's idx −1
    ("nothing within the cell") wraps to the last of m rows, a row that the
    gate marks invalid."""
    idx = idx.long()
    return torch.where(idx < 0, idx + m, idx)


def _take(cloud, idx):
    """cloud[..., idx, :] with idx −1 wrapped to the last point (``_wrap``).
    cloud (..., M, 3), idx (..., N)."""
    idx = _wrap(idx, cloud.shape[-2])
    return torch.gather(cloud, -2, idx[..., None].expand(*idx.shape, 3))


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
        idx, d2 = searcher(_warp(x, data["src"]))
        return dict(data, matched=_take(tgt_cloud, idx), valid=_gate(d2, max_corr_dist))

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


def _point2plane_residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    return torch.dot(d["normal"], warped - d["matched"])[None], d["valid"]


def _point2plane_block_with_searcher(src, tgt_cloud, tgt_normals, searcher, *, loss=None, max_corr_dist=None):
    """Point-to-plane ICP block, r = n·(T·s − q): the matched target point q
    and its normal n gathered again at every outer iteration."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)
    tgt_normals = torch.as_tensor(tgt_normals).to(src.dtype)
    n = src.shape[0]

    def update_fn(x, data):
        idx, d2 = searcher(_warp(x, data["src"]))
        return dict(data, matched=_take(tgt_cloud, idx), normal=_take(tgt_normals, idx),
                    valid=_gate(d2, max_corr_dist))

    data = _placeholder(src, tgt_cloud)
    data["normal"] = tgt_normals[:n] if tgt_cloud.shape[0] >= n else tgt_normals[:1].expand(n, 3)
    return make_block(
        _point2plane_residual, data=data, prepare_fn=_prepare, update_fn=update_fn, loss=loss, name="point2plane"
    )


def _gicp_block_with_searcher(src, tgt_cloud, src_cov, tgt_cov, searcher, *, loss=None, max_corr_dist=None):
    """GICP block (``models.gicp``) whose matches, and the matches'
    covariances, are gathered again at every outer iteration."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)
    n = src.shape[0]

    def update_fn(x, data):
        idx, d2 = searcher(_warp(x, data["src"]))
        return dict(data, matched=_take(tgt_cloud, idx), matched_cov=tgt_cov[_wrap(idx, tgt_cov.shape[0])],
                    valid=_gate(d2, max_corr_dist))

    big = tgt_cloud.shape[0] >= n
    return gicp_block(
        src,
        tgt_cloud[:n] if big else src,
        src_cov,
        tgt_cov[:n] if big else src_cov,
        loss=loss,
        update_fn=update_fn,
        valid=torch.ones(n, dtype=torch.bool, device=src.device),
    )


def _icp_fleet_block(srcs, tgt_clouds, *, loss=None, max_corr_dist=None):
    """The ICP block of B lanes: srcs (B, N, 3) and tgt_clouds (B, M, 3), or
    one src (N, 3) and target (M, 3) shared by the lanes of a multistart
    (solved with ``batch_data=False``).

    Its ``batch_update_fn`` warps every lane's source with that lane's
    estimate and searches all lanes together with the expansion ("xla":
    K6 for CUDA tensors, its plain version for CPU tensors)."""

    def batch_update_fn(x, data):
        T = se3.transform_from_params6(x)  # (B, 4, 4)
        warped = data["src"] @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        tgts = tgt_clouds.expand(x.shape[0], *tgt_clouds.shape[-2:])
        idx, d2 = nearest_neighbors(warped, tgts, backend="xla")
        return dict(data, matched=_take(tgts, idx), valid=_gate(d2, max_corr_dist))

    return make_block(
        _residual,
        data=_placeholder(srcs, tgt_clouds),
        prepare_fn=_prepare,
        batch_update_fn=batch_update_fn,
        loss=loss,
        linearize_fn=fused_point2point_linearizer,
        name="icp",
    )


def _yaw_starts(src, tgt_cloud, B):
    """The coarse multistart's B seeds (B, 6): yaw θ = 2πb/B about the source
    centroid, then the centroid offset: t = t0 + c − R c, ω = (0, 0, θ)."""
    dt = src.dtype
    c_src = _median(src)
    t0 = _median(tgt_cloud.to(dt)) - c_src
    ang = 2.0 * math.pi * torch.arange(B, dtype=dt, device=src.device) / B
    ca, sa = torch.cos(ang), torch.sin(ang)
    Rc = torch.stack(
        [ca * c_src[0] - sa * c_src[1], sa * c_src[0] + ca * c_src[1], c_src[2].expand(B)], dim=1
    )
    zero = torch.zeros_like(ang)
    return torch.cat([t0[None, :] + c_src[None, :] - Rc, torch.stack([zero, zero, ang], dim=1)], dim=1)


class PairwiseRegistrar:
    """Pairwise registration for scan streams: the SLAM front end.

    The JAX package's registrar exists to trace its solve once per stream;
    eager PyTorch has nothing to compile, and the registrar keeps the rest
    of its contract:

    * an unseeded pair with a gate is seeded by a coarse ungated pass on
      clouds stride-subsampled to COARSE_MAX_POINTS: ``coarse_multistart``
      yaw starts (8 with "auto" when a gate is set) solved batched, all B
      starts searched against the shared target in one expansion search per
      pass (K6 on the card), the lowest cost not in NUMERIC_ERROR kept; or,
      with ``coarse_multistart=0``, one start;
    * grid search (``nn_backend="grid"``, or "auto" on a gated target of
      GRID_AUTO_MIN_TARGETS points or more), with a capacity policy: the
      first pair's adaptive build learns (S, K, cell occupancy), and later
      pairs build at those capacities with no host read
      (``build_hash_grid_fixed``); an overflow rebuilds adaptively with the
      old capacities as floors, so the policy only grows;
    * brute force otherwise: K5 for CUDA tensors, the expansion's plain
      version for CPU tensors (the JAX package's "pallas" on a TPU, "xla"
      elsewhere).

    ``method``: "icp" (point-to-point), "point2plane" (the target's normals
    from ``k``-NN PCA, made once a pair) or "gicp" (both clouds' GICP
    covariances with ``epsilon``, made once a pair). The coarse multistart is
    point-to-point for every method.

    Usage::

        reg = PairwiseRegistrar(max_corr_dist=0.5)
        for k in range(1, len(scans)):
            res = reg.register(scans[k], scans[k-1], x0=prev)
    """

    def __init__(self, *, config=None, loss=None, max_corr_dist=None, nn_backend="auto",
                 method="icp", k=10, epsilon=1e-3, coarse_multistart="auto"):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.config = default_pipeline_config() if config is None else config
        self.loss = loss
        self.max_corr_dist = max_corr_dist
        self.nn_backend = nn_backend
        self.method = method
        self.k = k
        self.epsilon = epsilon
        if coarse_multistart == "auto":
            coarse_multistart = 8 if max_corr_dist is not None else 0
        self.coarse_multistart = int(coarse_multistart)
        self._coarse = None  # the ungated single-start registrar, made on first use
        # running maxima of (n_slots, bucket K, cell occupancy) over the stream
        self._grid_policy = None
        self._grid_overflow = None

    def _use_grid(self, m):
        if self.nn_backend == "grid":
            return True
        if self.nn_backend == "auto":
            return m >= GRID_AUTO_MIN_TARGETS and self.max_corr_dist is not None
        return False

    def _solve(self, src, tgt_cloud, searcher, x0, covs):
        """The method's block around ``searcher``, solved from x0. ``covs``:
        ``_covs_for``'s surface statistics of the pair."""
        kw = dict(loss=self.loss, max_corr_dist=self.max_corr_dist)
        if self.method == "icp":
            blk = _icp_block_with_searcher(src, tgt_cloud, searcher, **kw)
        elif self.method == "point2plane":
            blk = _point2plane_block_with_searcher(src, tgt_cloud, covs, searcher, **kw)
        else:
            blk = _gicp_block_with_searcher(src, tgt_cloud, *covs, searcher, **kw)
        return levenberg_marquardt(problem(blk), x0, self.config)

    def _solve_grid(self, src, tgt_cloud, grid, x0, covs):
        return self._solve(src, tgt_cloud, lambda warped: grid_nearest_neighbors(warped, grid), x0, covs)

    def _solve_grid_fused(self, src, tgt_cloud, x0, covs, S, K, occ):
        """Build at fixed capacities and solve, with no host read for the
        build: (result, device overflow flag)."""
        grid, overflow = build_hash_grid_fixed(tgt_cloud, self.max_corr_dist, S, K, occ)
        return self._solve_grid(src, tgt_cloud, grid, x0, covs), overflow

    def _solve_brute(self, src, tgt_cloud, x0, covs):
        backend = "pallas" if tgt_cloud.is_cuda else "xla"
        return self._solve(
            src, tgt_cloud, lambda warped: nearest_neighbors(warped, tgt_cloud, backend=backend), x0, covs
        )

    def _covs_for(self, src, tgt_cloud):
        """The pair's surface statistics: (source, target) GICP covariances,
        the target's normals, or None for "icp"."""
        if self.method == "gicp":
            return tuple(gicp_covariances(c, k=self.k, epsilon=self.epsilon).to(src.dtype) for c in (src, tgt_cloud))
        if self.method == "point2plane":
            return estimate_normals(tgt_cloud, k=self.k).to(src.dtype)
        return None

    def register(self, src, tgt_cloud, x0=None, *, defer_overflow=False):
        """Align src onto tgt_cloud; returns the LMResult.

        x0=None seeds with the median-centroid offset and, when a gate is
        set, runs the coarse ungated pass first (a gate tighter than the
        initial misalignment would reject every correspondence).

        defer_overflow=True returns ``(result, overflow)`` with no host read
        of the flag: ``overflow`` is the fixed-capacity build's device bool
        (None on paths that resolve capacity themselves). The caller reads
        it later and calls :meth:`redo_overflow` on a True."""
        src = as_input(src)
        tgt_cloud = as_input(tgt_cloud)
        if x0 is None:
            x0 = _centroid_seed(src, tgt_cloud)
            if self.max_corr_dist is not None:
                src_c = _coarse_subsample(src)
                tgt_c = _coarse_subsample(tgt_cloud)
                if self.coarse_multistart > 0:
                    x0 = self._coarse_multistart_seed(src_c, tgt_c)
                else:
                    if self._coarse is None:
                        self._coarse = PairwiseRegistrar(
                            config=self.config, loss=self.loss, max_corr_dist=None,
                            nn_backend=self.nn_backend, method=self.method, k=self.k, epsilon=self.epsilon,
                        )
                    x0 = self._coarse.register(src_c, tgt_c, x0).x
        else:
            x0 = as_input(x0, src.device)
        covs = self._covs_for(src, tgt_cloud)
        if self._use_grid(tgt_cloud.shape[0]):
            if self._grid_policy is None and self.max_corr_dist is not None:
                # the stream's first pair: one adaptive build learns the
                # capacities, and the solve runs as every later pair's does
                self._build_grid(tgt_cloud)
            if self._grid_policy is not None and self.max_corr_dist is not None:
                res, overflow = self._solve_grid_fused(src, tgt_cloud, x0, covs, *self._grid_policy)
                if defer_overflow:
                    return res, overflow
                if not bool(overflow):
                    return res
                # a denser scan outgrew the capacities
                return self._redo_overflow(src, tgt_cloud, x0, covs)
            grid = self._build_grid(tgt_cloud)
            res = self._solve_grid(src, tgt_cloud, grid, x0, covs)
            if self._grid_overflow is not None and bool(self._grid_overflow):
                grid = self._build_grid(tgt_cloud, force_adaptive=True)
                res = self._solve_grid(src, tgt_cloud, grid, x0, covs)
            return (res, None) if defer_overflow else res
        res = self._solve_brute(src, tgt_cloud, x0, covs)
        return (res, None) if defer_overflow else res

    def redo_overflow(self, src, tgt_cloud, x0):
        """Redo a registration whose deferred overflow flag came back True:
        an adaptive rebuild (the old capacities as floors) and a solve.
        Returns the LMResult."""
        src = as_input(src)
        tgt_cloud = as_input(tgt_cloud)
        return self._redo_overflow(src, tgt_cloud, as_input(x0, src.device), self._covs_for(src, tgt_cloud))

    def _redo_overflow(self, src, tgt_cloud, x0, covs):
        grid = self._build_grid(tgt_cloud, force_adaptive=True)
        return self._solve_grid(src, tgt_cloud, grid, x0, covs)

    def _coarse_multistart_seed(self, src, tgt_cloud):
        """Best of B yaw starts about the source centroid, solved ungated in
        one batched loop; the lowest final cost not in NUMERIC_ERROR wins.
        Always point-to-point."""
        x0s = _yaw_starts(src, tgt_cloud, self.coarse_multistart)
        blk = _icp_fleet_block(src, tgt_cloud)
        res = levenberg_marquardt_batched(problem(blk), x0s, self.config, batch_data=False)
        cost = torch.where(res.status == int(Status.NUMERIC_ERROR), torch.inf, res.cost)
        return res.x[torch.argmin(cost)]

    def _build_grid(self, tgt_cloud, force_adaptive=False):
        cell = _grid_cell(tgt_cloud, self.max_corr_dist)
        M = tgt_cloud.shape[0]
        if self._grid_policy is not None and not force_adaptive:
            grid, self._grid_overflow = build_hash_grid_fixed(tgt_cloud, cell, *self._grid_policy)
            return grid
        self._grid_overflow = None
        floors = {}
        if self._grid_policy is not None:  # monotonic growth on overflow
            S0, K0, occ0 = self._grid_policy
            floors = dict(min_slots=S0, min_bucket=K0 + 16, min_cell_occupancy=occ0)
        use_device = M >= GRID_DEVICE_BUILD_MIN_TARGETS or (M >= 20_000 and tgt_cloud.is_cuda)
        build = build_hash_grid_device if use_device else build_hash_grid
        grid = build(tgt_cloud, cell, **floors)
        self._grid_policy = (grid.n_slots, grid.bucket_size, grid.max_cell_occupancy)
        return grid


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
        x0 = _centroid_seed(src, tgt_cloud) if init == "centroid" else src.new_zeros(6)
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


def _centroid_seed(src, tgt_cloud):
    """x0 = [median(tgt) − median(src), 0]."""
    x0 = torch.zeros(6, dtype=src.dtype, device=src.device)
    x0[0:3] = _median(tgt_cloud.to(src.dtype)) - _median(src)
    return x0


def point2plane(src, tgt_cloud, x0=None, *, k=10, config=None, loss=None, max_corr_dist=None, nn_backend="auto"):
    """Point-to-plane ICP: r = n·(T·s − q) with the target's normals from
    k-NN PCA (``ops.surface.estimate_normals``), the match and its normal
    found again at every outer iteration. Returns the LMResult; x0=None
    seeds with the median-centroid offset."""
    src = as_input(src)
    tgt_cloud = as_input(tgt_cloud)
    x0 = _centroid_seed(src, tgt_cloud) if x0 is None else as_input(x0, src.device)
    if config is None:
        config = _icp_config()
    normals = estimate_normals(tgt_cloud, k=k).to(src.dtype)
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)
    blk = _point2plane_block_with_searcher(src, tgt_cloud, normals, searcher, loss=loss, max_corr_dist=max_corr_dist)
    return levenberg_marquardt(problem(blk), x0, config)


def gicp(src, tgt_cloud, x0=None, *, k=10, epsilon=1e-3, config=None, loss=None, max_corr_dist=None,
         nn_backend="auto"):
    """Generalized (plane-to-plane) ICP: per-point GICP covariances from
    k-NN PCA, the match found again at every outer iteration, and the
    state-dependent information Ω = (C_q + R C_s Rᵀ)⁻¹ per match. Returns
    the LMResult; x0=None seeds with the median-centroid offset."""
    src = as_input(src)
    tgt_cloud = as_input(tgt_cloud)
    x0 = _centroid_seed(src, tgt_cloud) if x0 is None else as_input(x0, src.device)
    if config is None:
        config = _icp_config()
    src_cov = gicp_covariances(src, k=k, epsilon=epsilon).to(src.dtype)
    tgt_cov = gicp_covariances(tgt_cloud, k=k, epsilon=epsilon).to(src.dtype)
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)
    blk = _gicp_block_with_searcher(src, tgt_cloud, src_cov, tgt_cov, searcher, loss=loss, max_corr_dist=max_corr_dist)
    return levenberg_marquardt(problem(blk), x0, config)
