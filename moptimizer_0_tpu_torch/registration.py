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

import collections
import dataclasses
import math
from typing import Any

import torch

from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import (
    LMConfig,
    LMResult,
    Status,
    levenberg_marquardt,
    levenberg_marquardt_batched,
)
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.models.gicp import gicp_block
from moptimizer_0_tpu_torch.ops import device_loop
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
from moptimizer_0_tpu_torch.utils import tracing
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


def _search_plan(tgt_cloud, nn_backend, max_corr_dist):
    """(backend, grid): the brute-force backend to search tgt_cloud with, or
    "grid" and the voxel hash grid built here (``make_searcher``)."""
    if nn_backend == "auto":
        if tgt_cloud.shape[0] >= GRID_AUTO_MIN_TARGETS and max_corr_dist is not None:
            nn_backend = "grid"
    if nn_backend != "grid":
        return nn_backend, None
    big = tgt_cloud.shape[0] >= GRID_DEVICE_BUILD_MIN_TARGETS
    build = build_hash_grid_device if big else build_hash_grid
    return "grid", build(tgt_cloud, _grid_cell(tgt_cloud, max_corr_dist))


_GRID_TENSORS = ("table_idx", "table_pts", "cell_size")


@dataclasses.dataclass(frozen=True, eq=False)
class _Search:
    """warped → (idx, d²) against a fixed target: the grid's query, or the
    brute-force ``backend``'s."""

    backend: str
    tgt_cloud: torch.Tensor
    grid: Any = None

    def __call__(self, warped):
        if self.grid is not None:
            return grid_nearest_neighbors(warped, self.grid)
        return nearest_neighbors(warped, self.tgt_cloud, backend=self.backend)

    def on(self, tgt_cloud, grid):
        """The same search over copies of its target side on another card."""
        return dataclasses.replace(self, tgt_cloud=tgt_cloud, grid=grid)


def _searcher(backend, tgt_cloud, grid):
    return _Search(backend, tgt_cloud, grid)


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
    backend, grid = _search_plan(tgt_cloud, nn_backend, max_corr_dist)
    return _searcher(backend, tgt_cloud, grid)


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


class _Matcher:
    """The update hook of a registration block: warp the source by x,
    search the target, gather the matches (for point2plane their normals
    too, for gicp their covariances) and gate them.

    ``tgt``, ``extra`` (the target's normals or covariances) and ``grid``
    are the matcher's own: the buffers of a layout that ``_matcher`` keeps
    and ``load`` fills before each solve, or the caller's tensors and
    searcher (``icp_block``). The solver captures a step once per update
    hook (``core.solver``), so every solve of one layout goes through one
    matcher and replays one graph."""

    def __init__(self, method, tgt, extra, search, max_corr_dist, grid=None):
        self.method = method
        self.tgt, self.extra, self.grid = tgt, extra, grid
        self.search = search  # warped → (idx, d²)
        self.max_corr_dist = max_corr_dist
        # the target side on other cards: {card: (tgt, extra, search, grid)}
        self.copies = {}

    def load(self, tgt, extra, grid):
        """Copy a pair's target side into the buffers, and into their copies
        on other cards (on the stream, after the solves already queued
        there)."""
        sides = [(self.tgt, self.extra, self.grid)] + [(t, e, g) for t, e, _, g in self.copies.values()]
        for t, e, g in sides:
            t.copy_(tgt)
            if extra is not None:
                e.copy_(extra)
            if grid is not None:
                for f in _GRID_TENSORS:
                    getattr(g, f).copy_(getattr(grid, f))

    def _side(self, device):
        """(target, extra, search) on ``device``: the matcher's own, or for a
        shard on another card (a mesh over several cards) copies made at
        the first search there, which runs eagerly (a capture's warm-up is
        one), so every search reads its own card's memory."""
        if device == self.tgt.device:
            return self.tgt, self.extra, self.search
        if device not in self.copies:
            if not isinstance(self.search, _Search):
                raise ValueError(f"a searcher over {self.tgt.device} cannot search from {device}")
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the target side's copy on {device} is made under a capture")
            grid = None if self.grid is None else dataclasses.replace(
                self.grid, **{f: getattr(self.grid, f).to(device) for f in _GRID_TENSORS})
            tgt = self.tgt.to(device)
            extra = None if self.extra is None else self.extra.to(device)
            self.copies[device] = (tgt, extra, self.search.on(tgt, grid), grid)
        return self.copies[device][:3]

    def __call__(self, x, data):
        tgt, extra, search = self._side(data["src"].device)
        idx, d2 = search(_warp(x, data["src"]))
        new = dict(matched=_take(tgt, idx), valid=_gate(d2, self.max_corr_dist))
        if self.method == "point2plane":
            new["normal"] = _take(extra, idx)
        elif self.method == "gicp":
            new["matched_cov"] = extra[_wrap(idx, extra.shape[0])]
        return dict(data, **new)


class _FleetMatcher:
    """The ``batch_update_fn`` of the ICP fleet block: every lane's source
    warped by that lane's estimate and searched against its own target, all
    lanes with one expansion search ("xla": K6 for CUDA tensors, its plain
    version for CPU tensors). ``tgts``: (B, M, 3), or one (M, 3) shared by
    the lanes of a multistart; a buffer of the layout ``_matcher`` keeps."""

    def __init__(self, tgts, max_corr_dist):
        self.tgts = tgts
        self.max_corr_dist = max_corr_dist

    def load(self, tgts):
        self.tgts.copy_(tgts)

    def __call__(self, x, data):
        T = se3.transform_from_params6(x)  # (B, 4, 4)
        warped = data["src"] @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        tgts = self.tgts.expand(x.shape[0], *self.tgts.shape[-2:])
        idx, d2 = nearest_neighbors(warped, tgts, backend="xla")
        return dict(data, matched=_take(tgts, idx), valid=_gate(d2, self.max_corr_dist))


# The matchers of the last few layouts (``_matcher``), the least recently
# used dropped first.
_MATCHERS = collections.OrderedDict()


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def _matcher(kind, tgt, *, extra=None, grid=None, backend=None, max_corr_dist=None):
    """The matcher of a layout, loaded with this pair's target side: kind
    "fleet" (``_FleetMatcher``) or a method of METHODS (``_Matcher``). A
    layout is the kind, the search (backend, or the grid's table shapes),
    the gate and the shapes, dtypes and device of the target side; its
    matcher, and with it its update hook and buffers, is made at its first
    use and kept (``device_loop.lookup``), as the JAX package jits its
    registration solves once per configuration."""
    grid_spec = None if grid is None else (
        _spec(grid.table_idx), _spec(grid.table_pts), grid.max_cell_occupancy, grid.n_points)
    parts = (kind, backend, max_corr_dist, _spec(tgt), _spec(extra), grid_spec)

    def make():
        tgt_b = torch.empty_like(tgt)
        if kind == "fleet":
            return _FleetMatcher(tgt_b, max_corr_dist)
        grid_b = None if grid is None else dataclasses.replace(
            grid, **{f: torch.empty_like(getattr(grid, f)) for f in ("table_idx", "table_pts", "cell_size")})
        extra_b = None if extra is None else torch.empty_like(extra)
        return _Matcher(kind, tgt_b, extra_b, _searcher(backend, tgt_b, grid_b), max_corr_dist, grid_b)

    m = device_loop.lookup(_MATCHERS, parts, make, device_loop.MAX_LOOPS)
    if kind == "fleet":
        m.load(tgt)
    else:
        m.load(tgt, extra, grid)
    return m


def _icp_block(src, tgt_cloud, update_fn, *, loss=None, weight_matrix=None):
    """The point-to-point ICP block whose matches ``update_fn`` finds."""
    src = torch.as_tensor(src)
    return make_block(
        _residual,
        data=_placeholder(src, torch.as_tensor(tgt_cloud)),
        prepare_fn=_prepare,
        update_fn=update_fn,
        loss=loss,
        weight_matrix=weight_matrix,
        linearize_fn=fused_point2point_linearizer if weight_matrix is None else None,
        name="icp",
    )


def _icp_block_with_searcher(src, tgt_cloud, searcher, *, loss=None, max_corr_dist=None, weight_matrix=None):
    """Build the ICP block around a given searcher."""
    tgt_cloud = torch.as_tensor(tgt_cloud)
    matcher = _Matcher("icp", tgt_cloud, None, searcher, max_corr_dist)
    return _icp_block(src, tgt_cloud, matcher, loss=loss, weight_matrix=weight_matrix)


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


def _point2plane_block(src, tgt_cloud, tgt_normals, update_fn, *, loss=None):
    """Point-to-plane ICP block, r = n·(T·s − q): the matched target point q
    and its normal n gathered again at every outer iteration."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)
    n = src.shape[0]
    data = _placeholder(src, tgt_cloud)
    data["normal"] = tgt_normals[:n] if tgt_cloud.shape[0] >= n else tgt_normals[:1].expand(n, 3)
    return make_block(
        _point2plane_residual, data=data, prepare_fn=_prepare, update_fn=update_fn, loss=loss, name="point2plane"
    )


def _gicp_block(src, tgt_cloud, src_cov, tgt_cov, update_fn, *, loss=None):
    """GICP block (``models.gicp``) whose matches, and the matches'
    covariances, are gathered again at every outer iteration."""
    src = torch.as_tensor(src)
    tgt_cloud = torch.as_tensor(tgt_cloud)
    n = src.shape[0]
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


def _pair_block(method, src, tgt_cloud, covs, search, *, loss=None, max_corr_dist=None, grid=None):
    """The block of ``method`` for one pair, around the matcher of its
    layout. ``covs``: the target's normals (point2plane), the (source,
    target) GICP covariances (gicp) or None (icp); ``search``: the
    brute-force backend, or "grid" with the pair's ``grid``."""
    extra = covs[1] if method == "gicp" else covs
    matcher = _matcher(method, tgt_cloud, extra=extra, grid=grid, backend=search, max_corr_dist=max_corr_dist)
    if method == "icp":
        return _icp_block(src, tgt_cloud, matcher, loss=loss)
    if method == "point2plane":
        return _point2plane_block(src, tgt_cloud, covs, matcher, loss=loss)
    return _gicp_block(src, tgt_cloud, covs[0], covs[1], matcher, loss=loss)


def _icp_fleet_block(srcs, tgt_clouds, *, loss=None, max_corr_dist=None):
    """The ICP block of B lanes: srcs (B, N, 3) and tgt_clouds (B, M, 3), or
    one src (N, 3) and target (M, 3) shared by the lanes of a multistart
    (solved with ``batch_data=False``), searched by the fleet matcher of
    its layout."""
    return make_block(
        _residual,
        data=_placeholder(srcs, tgt_clouds),
        prepare_fn=_prepare,
        batch_update_fn=_matcher("fleet", tgt_clouds, max_corr_dist=max_corr_dist),
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

    The JAX package's registrar jits its solves once per instance. Here a
    pair's block is built around the matcher of its layout (``_matcher``),
    whose update hook reads the pair's target side from buffers, so on the
    card every pair of one layout replays one captured step: the captures
    of a stream do not grow with its pairs. The registrar's contract:

    * an unseeded pair with a gate is seeded by a coarse ungated pass on
      clouds stride-subsampled to COARSE_MAX_POINTS: ``coarse_multistart``
      yaw starts (8 with "auto" when a gate is set) solved batched, all B
      starts searched against the shared target in one expansion search per
      pass (K6 on the card), the lowest cost not in NUMERIC_ERROR kept; or,
      with ``coarse_multistart=0``, one start. On the card the batched
      solve replays its layout's graph, K6 inside it
      (``_coarse_multistart_seed``);
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

    def _solve(self, src, tgt_cloud, x0, covs, search, grid=None):
        """The method's block for the pair, searched by ``search`` (a
        brute-force backend, or "grid" with ``grid``), solved from x0.
        ``covs``: ``_covs_for``'s surface statistics of the pair. Every pair
        of one layout goes through one matcher, and its solve replays one
        graph on the card."""
        blk = _pair_block(self.method, src, tgt_cloud, covs, search, loss=self.loss,
                          max_corr_dist=self.max_corr_dist, grid=grid)
        return levenberg_marquardt(problem(blk), x0, self.config)

    def _solve_grid(self, src, tgt_cloud, grid, x0, covs):
        return self._solve(src, tgt_cloud, x0, covs, "grid", grid)

    def _solve_grid_fused(self, src, tgt_cloud, x0, covs, S, K, occ):
        """Build at fixed capacities and solve, with no host read for the
        build: (result, device overflow flag). The capacities keep one
        layout, and one graph, across a stream."""
        grid, overflow = build_hash_grid_fixed(tgt_cloud, self.max_corr_dist, S, K, occ)
        return self._solve_grid(src, tgt_cloud, grid, x0, covs), overflow

    def _solve_brute(self, src, tgt_cloud, x0, covs):
        return self._solve(src, tgt_cloud, x0, covs, "pallas" if tgt_cloud.is_cuda else "xla")

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
        return torch.index_select(res.x, 0, torch.argmin(cost).reshape(1))[0]  # no host read

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
    The call is the span ``icp`` (``utils.tracing``).
    """
    with tracing.span("icp"):
        src = as_input(src)
        tgt_cloud = as_input(tgt_cloud)
        if x0 is None:
            x0 = _centroid_seed(src, tgt_cloud) if init == "centroid" else src.new_zeros(6)
        else:
            x0 = as_input(x0, src.device)
        if config is None:
            config = _icp_config()
        return _solve_pair("icp", src, tgt_cloud, None, x0, config, loss, max_corr_dist, nn_backend)


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
    its own ``icp(..., nn_backend="xla")`` solve.

    mesh: an optional ``parallel.mesh.Mesh`` whose axis (``mesh_axis``, the
    mesh's first by default) splits the lanes: each shard runs the batched
    loop on its B / n_shards lanes, with one search of its lanes a pass, on
    its device. Lanes are independent, so nothing is reduced; the results
    are concatenated in lane order (and gathered from every process of a
    mesh that spans processes). B must divide the shard count. The call is
    the span ``icp_batched`` (``utils.tracing``).
    """
    with tracing.span("icp_batched"):
        srcs = as_input(srcs)
        tgt_clouds = as_input(tgt_clouds)
        if config is None:
            config = _icp_config()
        if x0s is None:
            t0 = _median(tgt_clouds.to(srcs.dtype), dim=1) - _median(srcs, dim=1)
            x0s = torch.cat([t0, torch.zeros_like(t0)], dim=1)
        else:
            x0s = as_input(x0s, srcs.device)
        if mesh is None:
            blk = _icp_fleet_block(srcs, tgt_clouds, loss=loss, max_corr_dist=max_corr_dist)
            return levenberg_marquardt_batched(problem(blk), x0s, config)
        axis = mesh_axis or mesh.axis_names[0]
        n_shards = mesh.check_axis(axis)
        B = srcs.shape[0]
        if B % n_shards:
            raise ValueError(
                f"fleet size B={B} must divide the mesh axis {axis!r} ({n_shards} shards): "
                "pad the fleet to a multiple"
            )
        lanes = B // n_shards
        parts = []
        for j, dev in enumerate(mesh.devices):
            sl = slice((mesh.first_shard + j) * lanes, (mesh.first_shard + j + 1) * lanes)
            blk = _icp_fleet_block(srcs[sl].to(dev), tgt_clouds[sl].to(dev), loss=loss, max_corr_dist=max_corr_dist)
            parts.append(levenberg_marquardt_batched(problem(blk), x0s[sl].to(dev), config))

        def lanes_of(*leaves):
            if isinstance(leaves[0], dict):
                return {k: lanes_of(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
            return mesh.gather_rows(torch.cat([leaf.to(srcs.device) for leaf in leaves]))

        return LMResult(**{
            f.name: lanes_of(*(getattr(r, f.name) for r in parts)) for f in dataclasses.fields(LMResult)
        })


def _solve_pair(method, src, tgt_cloud, covs, x0, config, loss, max_corr_dist, nn_backend):
    """``icp``/``point2plane``/``gicp``'s solve: the method's block around
    the matcher of the pair's layout, so that two requests of one shape,
    config, loss and search capture one graph (``core.solver``)."""
    search, grid = _search_plan(tgt_cloud, nn_backend, max_corr_dist)
    blk = _pair_block(method, src, tgt_cloud, covs, search, loss=loss, max_corr_dist=max_corr_dist, grid=grid)
    return levenberg_marquardt(problem(blk), x0, config)


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
    return _solve_pair("point2plane", src, tgt_cloud, normals, x0, config, loss, max_corr_dist, nn_backend)


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
    covs = tuple(gicp_covariances(c, k=k, epsilon=epsilon).to(src.dtype) for c in (src, tgt_cloud))
    return _solve_pair("gicp", src, tgt_cloud, covs, x0, config, loss, max_corr_dist, nn_backend)
