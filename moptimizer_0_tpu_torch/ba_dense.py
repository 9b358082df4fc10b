"""Dense-Schur bundle adjustment — the explicit-Schur engine.

PyTorch counterpart of ``moptimizer_0_tpu.ba_dense`` (single device):

* observations are grouped by landmark once, on the host, into a dense
  (L, K) grid (``group_by_landmark``), optionally valence-segmented: rows
  sorted by observation count and processed in a few contiguous segments at
  their own slot widths K_s, so the Poisson-valence padding is not streamed;
* the per-camera exp map and right Jacobian are computed once per camera
  (``_camera_cache``) and gathered onto the grid by camera id; camera-axis
  reductions (U, g, the rhs) gather each camera's slots through a plan made
  once per layout (``camera_plan``) and sum them in chunks of 32, level by
  level, in one fixed order, so a solve is bitwise repeatable on the card
  and its gathers follow the observation count — never an
  (L, K, C) one-hot (43 GB at C = 2000) and never ``index_add_``, whose
  atomics on CUDA sum in no fixed order;
* the Schur complement S = U′ − W V′⁻¹ Wᵀ (6C × 6C, in the JAX package's
  permuted i·C + c order) is built explicitly by ``ops.schur``, whose
  correction sum runs in the hand-written CUDA kernel on the card, and the
  camera system is solved by one Cholesky factorization;
* the LM schedule is ``ba._lm_trials_tree`` (the reference's λ/ν/ρ rules),
  decided on the device; on CUDA an outer iteration is one replay of a
  CUDA graph with K11 inside (``ops/device_loop.py``), and a solve enqueues
  max_iterations replays with no host read. On the CPU the same body runs
  eagerly, one host read a trial.

``solve_ba_dense_sharded`` shards the landmark axis over a
``parallel.mesh.Mesh``: each shard keeps its landmarks' linearization, V, W,
h and back-substitution, and the camera-space objects (U, g, the costs, the
S correction, the rhs reduction and the landmark terms of the step's
metrics) are summed over the mesh, max|diag V| and max|δpt| maxed; the
(6C)² Cholesky and the camera step run once per process on reduced inputs.
With every local shard on the cameras' device and the reductions device
work (``Mesh.captures_on``: one process, or processes reducing through
``kernels/mesh_reduce.py`` or ``kernels/nccl_transport.py``) its step is a CUDA graph as the
unsharded one's, K11 launched once a shard an S build inside it; over a
process's several peer cards it is a graph a card, each card's over its
own shards (K11 once each an S build), reducing through the card
transport; over a gloo mesh or cards without peer access it runs the eager
loop, one host read a trial and an outer iteration.
"""

import collections
import dataclasses
import functools
from itertools import combinations

import numpy as np
import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.ops import block_cholesky, device_loop
from moptimizer_0_tpu_torch.ops import schur, segment_sum
from moptimizer_0_tpu_torch.parallel.mesh import Mesh


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass(eq=False)
class GroupedBA:
    """Landmark-grouped observation grid (built on the host, once).

    pixels:  (L, K, 2) measured projections, 0 in padding slots.
    cam_ids: (L, K) int32 camera of each slot, 0 in padding slots.
    mask:    (L, K) 1.0 for real observations, 0.0 for padding.

    Valence-segmented grids also carry
    perm:       (L,) int32 — grid row i holds original landmark perm[i];
    inv_perm:   (L,) int32 — original landmark j is row inv_perm[j];
    seg_bounds: tuple of (end_row, K_s): rows [prev_end, end_row) are
                processed at width K_s (K_s non-increasing).
    Unsegmented grids keep perm = inv_perm = None and seg_bounds = ().
    """

    pixels: torch.Tensor
    cam_ids: torch.Tensor
    mask: torch.Tensor
    perm: torch.Tensor | None = None
    inv_perm: torch.Tensor | None = None
    seg_bounds: tuple = ()

    def sort_points(self, pts):
        """Original-landmark-order array → grid-row order (rows = perm)."""
        return pts if self.perm is None else pts[self.perm]

    def unsort_points(self, pts):
        """Grid-row-order array → original landmark order."""
        return pts if self.inv_perm is None else pts[self.inv_perm]

    @functools.cached_property
    def views(self):
        """[(row_slice, single-grid GroupedBA)], always ≥ 1 entry: each
        segment's rows truncated to its K_s slots, as contiguous copies made
        once (the CUDA kernel takes contiguous grids)."""
        if not self.seg_bounds:
            return [(slice(0, self.pixels.shape[0]), self)]
        out, s = [], 0
        for e, k in self.seg_bounds:
            view = GroupedBA(
                pixels=self.pixels[s:e, :k].contiguous(),
                cam_ids=self.cam_ids[s:e, :k].contiguous(),
                mask=self.mask[s:e, :k].contiguous(),
            )
            out.append((slice(s, e), view))
            s = e
        return out

    @functools.cached_property
    def _schur_plans(self):
        return {}

    @functools.cached_property
    def _camera_plans(self):
        return {}

    def camera_plan(self, C):
        """The camera reductions' plan (``ops.segment_sum.segment_plan``) of
        this grid's camera ids and mask for C cameras, built on first use and
        kept (call it on a segment's view)."""
        if C not in self._camera_plans:
            self._camera_plans[C] = segment_sum.segment_plan(self.cam_ids, self.mask, C)
        return self._camera_plans[C]

    def schur_plan(self, C):
        """The S build's camera-pair plan (``ops.schur.pair_plan``) of this
        layout for C cameras: built on first use and kept, as ``views`` is
        (the camera ids and masks do not change during a solve)."""
        if C not in self._schur_plans:
            self._schur_plans[C] = schur.pair_plan([(v.cam_ids, v.mask) for _, v in self.views], C)
        return self._schur_plans[C]


def _seg_views(grouped):
    return grouped.views


def _plan_segments(counts_sorted_desc, max_segments):
    """Choose (end_row, K_s) bounds minimizing Σ L_s·K_s (host-side).

    Candidate boundaries are the rows where the sorted valence drops,
    subsampled to 40 when there are more; brute force over ≤ max_segments − 1
    of them. Returns (bounds, Σ L_s·K_s)."""
    s = counts_sorted_desc
    L = len(s)
    cand = (np.flatnonzero(np.diff(s) != 0) + 1).tolist()
    if len(cand) > 40:
        step = len(cand) / 40.0
        cand = sorted({cand[int(i * step)] for i in range(40)})

    def cost(bounds):
        tot, prev = 0, 0
        for b in list(bounds) + [L]:
            if b <= prev:
                continue
            tot += (b - prev) * int(s[prev])
            prev = b
        return tot

    best_bounds, best_cost = (), cost(())
    for n in range(1, max_segments):
        if len(cand) < n:
            break
        for bs in combinations(cand, n):
            c = cost(bs)
            if c < best_cost:
                best_cost, best_bounds = c, bs
    bounds = []
    prev = 0
    for b in list(best_bounds) + [L]:
        if b <= prev:
            continue
        bounds.append((b, int(s[prev])))
        prev = b
    return tuple(bounds), best_cost


def padding_factor(problem):
    """(L·K)/O — the single-K grid's inflation (K = the max valence)."""
    pt_idx = _np(problem.pt_idx)
    L = problem.points.shape[0]
    O = max(len(pt_idx), 1)
    K = max(int(np.bincount(pt_idx, minlength=L).max()), 1)
    return L * K / O


# the segments="auto" policy: at least _AUTO_MIN_L landmarks, and segmenting
# must cut the slot work below _AUTO_KEEP_FRACTION of L·K
_AUTO_MIN_L = 1024
_AUTO_KEEP_FRACTION = 0.85


def _auto_plan(counts, segments, max_segments):
    """Shared segmentation policy (host-side): (perm, seg_bounds, slot_work),
    with perm = None and seg_bounds = () when the single-K layout is kept and
    slot_work the Σ L_s·K_s the chosen layout streams."""
    L = len(counts)
    K = max(int(counts.max()), 1) if L else 1
    full = L * K
    if segments == "auto":
        max_seg = max_segments if L >= _AUTO_MIN_L else 1
    else:
        max_seg = int(segments)
    if max_seg <= 1:
        return None, (), full
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    bounds, cost = _plan_segments(counts[perm], max_seg)
    if len(bounds) < 2 or (segments == "auto" and cost > _AUTO_KEEP_FRACTION * full):
        return None, (), full
    return perm, bounds, cost


def _auto_slot_work(problem, max_segments=4):
    """(slot_work, L, K) under the segments="auto" policy."""
    pt_idx = _np(problem.pt_idx)
    L = problem.points.shape[0]
    counts = np.bincount(pt_idx, minlength=L)
    K = max(int(counts.max()), 1)
    _, _, slot_work = _auto_plan(counts, "auto", max_segments)
    return slot_work, L, K


def dense_slot_factor(problem):
    """slot_work/O of the engine under its segments="auto" default."""
    slot_work, _, _ = _auto_slot_work(problem)
    return slot_work / max(len(_np(problem.pt_idx)), 1)


def dense_memory_bytes(problem):
    """The JAX package's shape-only estimate of the engine's peak device
    memory: 234 B per streamed slot, 16 B per stored grid slot and
    8·(6C)² for S and its factor."""
    slot_work, L, K = _auto_slot_work(problem)
    C = problem.camera_params.shape[0]
    return 234.0 * slot_work + 16.0 * L * K + 8.0 * (6 * C) ** 2


def group_by_landmark(problem, segments=1, max_segments=4):
    """Reorder a BAProblem's observations into the (L, K) grid, on the host.

    segments: 1 (rows in landmark order, one K), "auto" (sort rows by
    valence and split into up to ``max_segments`` segments when L ≥ 1024 and
    that trims ≥ 15% of the slot work), or an int ≥ 2 (force up to that
    many segments). The grid lands on the device of ``problem.points``.
    """
    pt_idx = _np(problem.pt_idx).astype(np.int64)
    cam_idx = _np(problem.cam_idx).astype(np.int64)
    pixels = _np(problem.pixels)
    L = problem.points.shape[0]
    C = problem.camera_params.shape[0]
    if len(pt_idx) and (pt_idx.min() < 0 or pt_idx.max() >= L):
        raise ValueError(f"pt_idx must lie in [0, {L})")
    if len(cam_idx) and (cam_idx.min() < 0 or cam_idx.max() >= C):
        raise ValueError(f"cam_idx must lie in [0, {C})")

    counts = np.bincount(pt_idx, minlength=L)
    K = max(int(counts.max()), 1)
    perm, seg_bounds, _ = _auto_plan(counts, segments, max_segments)

    row_of = np.arange(L, dtype=np.int64)
    if perm is not None:
        row_of[perm] = np.arange(L, dtype=np.int64)
    order = np.argsort(pt_idx, kind="stable")
    starts = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(pt_idx)) - starts[pt_idx[order]]

    grid_pix = np.zeros((L, K, 2), dtype=pixels.dtype)
    grid_cam = np.zeros((L, K), dtype=np.int32)
    grid_mask = np.zeros((L, K), dtype=pixels.dtype)
    rows = row_of[pt_idx[order]]
    grid_pix[rows, slot] = pixels[order]
    grid_cam[rows, slot] = cam_idx[order]
    grid_mask[rows, slot] = 1.0

    dev = problem.points.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    return GroupedBA(
        pixels=t(grid_pix),
        cam_ids=t(grid_cam),
        mask=t(grid_mask),
        perm=None if perm is None else t(perm),
        inv_perm=None if perm is None else t(np.argsort(perm).astype(np.int32)),
        seg_bounds=seg_bounds,
    )


def _gather_cache(cache, grouped):
    """cache rows gathered onto the grid by camera id: (L, K, q). Padding
    slots gather camera 0; every consumer masks them."""
    return cache[grouped.cam_ids]


def _linearize_grouped(cams, pts, intr, grouped):
    """Masked residuals and closed-form Jacobians on the (L, K) grid:
    r (L,K,2), A = ∂r/∂cam (L,K,2,6), B = ∂r/∂pt (L,K,2,3) (``ba._reproject``
    on (L, K) tensors). Padding slots are set to exactly 0 with
    ``torch.where``, never by multiplying: a padding slot may put the point
    behind camera 0 and give an inf.
    """
    q = _gather_cache(ba._camera_cache(cams), grouped).unbind(-1)
    p = (pts[:, 0:1], pts[:, 1:2], pts[:, 2:3])  # (L, 1) against the (L, K) grid
    r, A, B = ba._reproject(q, p, grouped.pixels, intr)
    m = grouped.mask > 0
    r = torch.where(m[..., None], r, 0.0)
    A = torch.where(m[..., None, None], A, 0.0)
    B = torch.where(m[..., None, None], B, 0.0)
    return r, A, B


def _cost_grouped(cams, pts, intr, grouped):
    """Σ‖r‖² on the grid; pts in grid-row order (``grouped.sort_points``)."""
    cache = ba._camera_cache(cams, with_jacobian=False)
    y = torch.zeros((), dtype=cams.dtype, device=cams.device)
    for sl, seg in _seg_views(grouped):
        q = _gather_cache(cache, seg).unbind(-1)
        p = pts[sl]
        r = ba._reproject(q, (p[:, 0:1], p[:, 1:2], p[:, 2:3]), seg.pixels, intr, jacobians=False)
        r = torch.where(seg.mask[..., None] > 0, r, 0.0)
        y = y + torch.sum(r * r)
    return y


def _gn_blocks_grouped(grouped, r, A, B, C, loss):
    """Gauss-Newton blocks: U (C,6,6) and g (C,6) summed per camera through
    the grid's ``camera_plan``, V (L,3,3) and h (L,3) by sums over K,
    W (L,K,6,3) on the grid.
    A robust loss weights H and b only, w = loss(‖r‖²) per slot."""
    if loss is not None:
        w = loss.weight(torch.sum(r * r, dim=-1))
        w = torch.where(grouped.mask > 0, w, 0.0)
        Aw = w[..., None, None] * A
        Bw = w[..., None, None] * B
        rw = w[..., None] * r
    else:
        Aw, Bw, rw = A, B, r
    plan = grouped.camera_plan(C)
    AtA = ba._outer_rows(Aw, A)  # (L,K,6,6)
    Ar = A[..., 0, :] * rw[..., 0, None] + A[..., 1, :] * rw[..., 1, None]  # (L,K,6)
    U = segment_sum.segment_sum(plan, AtA.reshape(-1, 36)).reshape(C, 6, 6)
    g = segment_sum.segment_sum(plan, Ar.reshape(-1, 6))
    V = torch.sum(ba._outer_rows(Bw, B), dim=1)
    W = ba._outer_rows(Aw, B)
    h = torch.sum(B[..., 0, :] * rw[..., 0, None] + B[..., 1, :] * rw[..., 1, None], dim=1)
    return U, V, W, g, h


def _linearize_and_blocks(cams, pts, intr, grouped, loss):
    """Per-segment linearization + GN blocks: (U, V, W_segs, g, h, y0).

    U and g sum over segments; V and h stack along the grid rows; W is the
    list of per-segment (L_s, K_s, 6, 3) grids. pts in grid-row order."""
    C = cams.shape[0]
    U = g = y0 = None
    V_l, W_l, h_l = [], [], []
    for sl, seg in _seg_views(grouped):
        r, A, B = _linearize_grouped(cams, pts[sl], intr, seg)
        U_s, V_s, W_s, g_s, h_s = _gn_blocks_grouped(seg, r, A, B, C, loss)
        y_s = torch.sum(r * r)
        U = U_s if U is None else U + U_s
        g = g_s if g is None else g + g_s
        y0 = y_s if y0 is None else y0 + y_s
        V_l.append(V_s)
        W_l.append(W_s)
        h_l.append(h_s)
    V = V_l[0] if len(V_l) == 1 else torch.cat(V_l, dim=0)
    h = h_l[0] if len(h_l) == 1 else torch.cat(h_l, dim=0)
    return U, V, W_l, g, h, y0


def _chol3x3(A):
    """Closed-form lower Cholesky factor of a batch of SPD 3×3 matrices."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(a11)
    i11 = 1.0 / l11
    l21 = a21 * i11
    l31 = a31 * i11
    l22 = torch.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(a33 - l31 * l31 - l32 * l32)
    zero = torch.zeros_like(l11)
    return torch.stack(
        [
            torch.stack([l11, zero, zero], dim=-1),
            torch.stack([l21, l22, zero], dim=-1),
            torch.stack([l31, l32, l33], dim=-1),
        ],
        dim=-2,
    )


def _tri_inv_lower(Lmat):
    """Closed-form inverse of a batch of 3×3 lower-triangular matrices."""
    a, b, c = Lmat[..., 0, 0], Lmat[..., 1, 0], Lmat[..., 1, 1]
    d, e, f = Lmat[..., 2, 0], Lmat[..., 2, 1], Lmat[..., 2, 2]
    ia, ic, if_ = 1.0 / a, 1.0 / c, 1.0 / f
    zero = torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([ia, zero, zero], dim=-1),
            torch.stack([-b * ia * ic, ic, zero], dim=-1),
            torch.stack([(b * e * ic - d) * ia * if_, -e * ic * if_, if_], dim=-1),
        ],
        dim=-2,
    )


def _w_segments(W, grouped):
    views = _seg_views(grouped)
    W_segs = W if isinstance(W, (list, tuple)) else [W]
    if len(W_segs) != len(views):
        raise ValueError(
            f"W has {len(W_segs)} segment grids but the grouped layout has {len(views)} "
            "segments — pass the W list from _linearize_and_blocks for a valence-segmented grid"
        )
    return views, W_segs


def _build_schur(U_d, Vinv_chol, W, grouped, fixed_mask, chunk=512, backend="auto"):
    """Explicit S = blockdiag(U′) − Σ_l Ã_lᵀÃ_l in the permuted i·C + c order,
    with gauge rows for fixed cameras (``ops.schur.build_schur``).
    Vinv_chol is L⁻¹ of V′ = L Lᵀ, per landmark in grid-row order."""
    _, W_segs = _w_segments(W, grouped)
    return schur.build_schur(U_d, Vinv_chol, W_segs, grouped, fixed_mask, backend=backend, chunk=chunk)


def _damped_landmarks(V, lam):
    """(Linv, V′⁻¹) of the damped V′ = V + λ·diag(V) + 1e-12·I: Linv is the
    inverse of V′'s Cholesky factor, V′⁻¹ = Linvᵀ Linv."""
    V_d = ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=V.dtype, device=V.device)
    Linv = _tri_inv_lower(_chol3x3(V_d))
    return Linv, torch.sum(Linv[..., :, None] * Linv[..., None, :], dim=-3)


def _rhs_reduction(views, W_segs, Vinv, h, C):
    """Σ_lk 1[cam=c] W_lk (V′⁻¹ h)_l per camera: (C, 6)."""
    t = torch.sum(Vinv * h[:, None, :], dim=-1)  # (L,3)
    red = torch.zeros((C, 6), dtype=h.dtype, device=h.device)
    for (sl, seg), W_s in zip(views, W_segs):
        Wt = torch.sum(W_s * t[sl][:, None, None, :], dim=-1)  # (L_s,K_s,6)
        red = red + segment_sum.segment_sum(seg.camera_plan(C), Wt.reshape(-1, 6))
    return red


def _camera_step(S, g, red, fixed_mask, schur_solver):
    """δcam (C, 6) from S and rhs = −(g − red), gauge rows zeroed."""
    C = g.shape[0]
    # into S's i·C + c order, and the solution back
    rhs = (-(g - red) * fixed_mask[:, None]).T.reshape(-1)
    d_cam = block_cholesky.spd_solve(S, rhs, method=schur_solver).reshape(6, C).T
    return d_cam * fixed_mask[:, None]


def _back_substitute(views, W_segs, Vinv, h, d_cam):
    """δl = V′⁻¹ (−h − Σ_k W_lkᵀ δc[cam(l,k)]): (L, 3)."""
    Wtd_l = []
    for (sl, seg), W_s in zip(views, W_segs):
        dc_g = d_cam[seg.cam_ids]  # (L_s,K_s,6); padding slots have W = 0
        Wtd_l.append(torch.sum(W_s * dc_g[..., :, None], dim=(1, 2)))
    Wtd = Wtd_l[0] if len(Wtd_l) == 1 else torch.cat(Wtd_l, dim=0)
    return torch.sum(Vinv * (-h - Wtd)[:, None, :], dim=-1)


def _solve_delta_dense(grouped, C, U, V, W, g, h, lam, fixed_mask, chunk, schur_solver="auto",
                       schur_backend="auto"):
    """One damped dense-Schur solve → (δcam (C,6), δpt (L,3))."""
    _, W_segs = _w_segments(W, grouped)
    d_cam, (d_pt,) = _solve_delta_shards(
        U, g, [(grouped, V, W_segs, h)], C, lam, fixed_mask, chunk, schur_solver, schur_backend,
        Mesh(devices=(U.device,)),
    )
    return d_cam, d_pt


def _solve_delta_shards(U, g, shards, C, lam, fixed_mask, chunk, schur_solver, schur_backend, mesh):
    """One damped dense-Schur solve with the landmarks in shards: ``shards``
    holds each local shard's (GroupedBA, V, W_segs, h) on its device. Each
    shard's S correction (one K11 launch) and rhs reduction are summed over
    the mesh, the camera step is solved once on U's device, and each shard
    back-substitutes its own landmarks → (δcam (C,6), (δpt_s (L_s,3), ...))."""
    terms = []
    for (shard, V, W_segs, h), dev in zip(shards, mesh.devices):
        Linv, Vinv = _damped_landmarks(V, lam.to(dev))
        corr = schur.grouped_correction(Linv, W_segs, shard, C, backend=schur_backend, chunk=chunk)
        terms.append((corr, _rhs_reduction(shard.views, W_segs, Vinv, h, C), Vinv))
    S_corr, red = mesh.psum([t[:2] for t in terms], device=U.device)
    S = schur.assemble_schur(S_corr, ba._damp_blocks(U, lam), fixed_mask)
    d_cam = _camera_step(S, g, red, fixed_mask, schur_solver)
    d_pts = tuple(
        _back_substitute(shard.views, W_segs, Vinv, h, d_cam.to(dev))
        for (shard, _, W_segs, h), (_, _, Vinv), dev in zip(shards, terms, mesh.devices)
    )
    return d_cam, d_pts


@dataclasses.dataclass(frozen=True)
class DenseBAConfig:
    """Settings, with the fields and defaults of the JAX package's DenseBAConfig.

    schur_chunk: landmarks per A2 panel of the plain S build.
    schur_solver: "auto" or "xla" (one Cholesky), or "blocked" (the
    blocked recursion of ``ops.block_cholesky``, which also forms L⁻¹).
    schur_precision, gn_precision: the JAX package's matmul pass counts on
    the TPU. The port computes both stages in the problem's dtype whatever
    they say (float32 on the card, no TF32 or bf16); their mapping is queued
    (ROADMAP.md).
    rel_cost_tol: accepted step improving the cost by ≤ tol·y0 → CONVERGED.
    """

    max_iterations: int = 15
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    schur_chunk: int = 512
    schur_solver: str = "auto"
    schur_precision: str = "default"
    gn_precision: str = "default"
    rel_cost_tol: float = 0.0


def _dense_outer_step(cams, pts, intr, shards, loss, n_fixed, lam, config, mesh=None, schur_backend="auto"):
    """One outer LM iteration over explicit state, the landmarks in shards:
    pts is a tuple of each local shard's (L_s, 3) points in its grid-row
    order, shards their GroupedBAs. With ``mesh`` None there is one shard,
    on the cameras' device, and δ·(λδ − b) is one dot over the flat δ;
    otherwise the camera-space sums are reduced over the mesh (``Mesh.psum``,
    ``Mesh.pmax``: JAX's ``axis_name`` sites) and so is the landmark part of
    the step metrics.

    Returns (cams, pts, λ′, terminal, status, record), all tensors:
    ``terminal`` a 0-dim bool, ``status`` a 0-dim int32, record cost,
    cost_new, rho, lam and ``trials`` (int32, the damped solves run)."""
    sharded = mesh is not None
    dtype, dev = cams.dtype, cams.device
    C = cams.shape[0]
    if not sharded:
        mesh = Mesh(devices=(dev,))
    devs = mesh.devices
    blocks = [
        _linearize_and_blocks(cams.to(d), p, intr.to(d), s, loss) for p, s, d in zip(pts, shards, devs)
    ]
    U, g, y0 = mesh.psum([(b[0], b[3], b[5]) for b in blocks], device=dev)
    v_diag_max = mesh.pmax([torch.max(torch.abs(torch.diagonal(b[1], dim1=-2, dim2=-1))) for b in blocks],
                           device=dev)
    lam = ba._seed_lambda(lam, U, None, config.init_lambda_factor, v_diag_max=v_diag_max)
    fixed_mask = (torch.arange(C, device=dev) >= n_fixed).to(dtype)
    state = ba._lm_init_state_tree((cams, *pts), lam, y0, dtype)
    converged0 = state["stop"].clone()
    landmarks = [(s, b[1], b[2], b[4]) for s, b in zip(shards, blocks)]

    def solve_fn(lam_k):
        d_cam, d_pts = _solve_delta_shards(
            U, g, landmarks, C, lam_k, fixed_mask, config.schur_chunk, config.schur_solver, schur_backend, mesh
        )
        return (d_cam, *d_pts)

    def cost_fn(params):
        cams_i = params[0]
        return mesh.psum(
            [_cost_grouped(cams_i.to(d), p, intr.to(d), s) for p, s, d in zip(params[1:], shards, devs)],
            device=dev,
        )

    g_flat = g.reshape(-1)

    def metrics_fn(delta, lam_k):
        # δ·(λδ − b): the camera part computed on every process, the
        # landmark part summed over the mesh
        dc = delta[0].reshape(-1)
        land = mesh.psum(
            [torch.dot(dp.reshape(-1), lam_k.to(d) * dp.reshape(-1) - b[4].reshape(-1))
             for dp, b, d in zip(delta[1:], blocks, devs)],
            device=dev,
        )
        max_pt = mesh.pmax([torch.max(torch.abs(dp)) for dp in delta[1:]], device=dev)
        return torch.dot(dc, lam_k * dc - g_flat) + land, torch.maximum(torch.max(torch.abs(dc)), max_pt)

    b_flat = None if sharded else torch.cat([g_flat, blocks[0][4].reshape(-1)])
    state = ba._lm_trials_tree(
        state, y0, b_flat, (cams, *pts), solve_fn, cost_fn, config.inner_iterations,
        rel_cost_tol=config.rel_cost_tol, metrics_fn=metrics_fn if sharded else None,
    )
    cams_out, *pts_out = state["params"]
    return (cams_out, tuple(pts_out), *ba._step_result(state, y0, converged0))


def _dense_loop(problem, grouped, config, schur_backend):
    """The StepLoop of the dense engine over one GroupedBA, its points in
    grid-row order. On CUDA it is captured once per layout (the grouping
    with its plans, intrinsics, loss, gauge, shapes, dtype, config and S
    backend: K11 runs inside the graph) and kept; on the CPU it is eager."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    graph = device_loop.graphs(problem.camera_params)

    def make():
        def body(cams, pts, lam):
            cams, (pts,), lam, terminal, status, record = _dense_outer_step(
                cams, (pts,), problem.intrinsics, [grouped], problem.loss, problem.n_fixed_cameras,
                lam, config, schur_backend=schur_backend,
            )
            return (cams, pts, lam), terminal, status, record

        carry = (problem.camera_params, grouped.sort_points(problem.points),
                 torch.full((), -1.0, dtype=dtype, device=dev))
        return device_loop.StepLoop(body, carry, config.max_iterations, ba._record_dtypes(dtype),
                                    Status.MAXIMUM_ITERATIONS_REACHED, graph=graph,
                                    name=f"ba_step_dense {ba._layout_name(problem)}")

    if not graph:
        return make()
    return device_loop.cached(
        ("dense", grouped, config, schur_backend, problem.loss, problem.n_fixed_cameras,
         tuple(problem.camera_params.shape), tuple(problem.points.shape), dtype, dev, problem.intrinsics), make,
    )


def ba_step_dense(problem, grouped, lam, config=DenseBAConfig(), *, schur_backend="auto"):
    """One outer LM iteration: (cams, pts, λ′, terminal, status, record), all
    tensors, with points in the problem's own landmark order. Pass λ = −1 on
    the first call to seed λ from the GN diagonal. ``schur_backend`` routes
    the S build (``ops.schur``). On CUDA the step is one replay of a graph
    captured at the first call of its layout, K11 inside, with no host
    read."""
    loop = _dense_loop(problem, grouped, config, schur_backend)
    loop.start((problem.camera_params, grouped.sort_points(problem.points), lam))
    loop.step(ba._read)
    (cams, pts, lam), terminal, status, record = loop.outputs()
    return cams, grouped.unsort_points(pts), lam, terminal, status, record


# host groupings kept for the solves that are not given one: a second solve of
# the same observations reuses the grid, its plans and its captured graph
MAX_GROUPINGS = 4
_GROUPINGS = collections.OrderedDict()


def _grouping(problem):
    """``group_by_landmark(problem, segments="auto")``, kept on CUDA for the
    problem's incidence and pixels (their identity and version), the last
    MAX_GROUPINGS of them."""
    if not device_loop.graphs(problem.camera_params):
        return group_by_landmark(problem, segments="auto")
    return device_loop.lookup(
        _GROUPINGS, (problem.cam_idx, problem.pt_idx, problem.pixels, problem.points.shape[0],
                     problem.camera_params.shape[0], problem.points.device),
        lambda: group_by_landmark(problem, segments="auto"), MAX_GROUPINGS,
    )


def solve_ba_dense(problem, config=DenseBAConfig(), grouped=None, host_loop=False, *,
                   schur_backend="auto"):
    """Full LM solve with the dense-Schur engine.

    Groups the observations by landmark on the host (segments="auto") unless
    ``grouped`` is given; on CUDA the groupings of the last MAX_GROUPINGS
    problems are kept, so a second solve reuses the grid and its captured
    graph. On CUDA an outer iteration is one replay of the
    ``ba_step_dense`` graph: the default ``host_loop=False`` enqueues
    max_iterations replays, each under IF(¬done), and reads nothing back
    after the first capture; ``host_loop=True`` reads done after each replay
    (one read an outer iteration). Both give the same bits. On the CPU the
    same body runs eagerly, one host read a trial and an outer iteration.
    The result's trace holds cost, cost_new, rho and lam per outer iteration
    (NaN-filled to max_iterations) and ``trials``, the damped solves of each
    iteration. ``schur_backend`` routes the S build: "auto" (the CUDA kernel
    for CUDA tensors), "cuda" or "torch" (its plain version).
    """
    if grouped is None:
        grouped = _grouping(problem)
    loop = _dense_loop(problem, grouped, config, schur_backend)
    loop.start((problem.camera_params, grouped.sort_points(problem.points), -1.0))
    loop.solve(config.max_iterations, ba._read, host_loop)
    cams, pts = loop.carry[0].clone(), loop.carry[1].clone()
    cost = _cost_grouped(cams, pts, problem.intrinsics, grouped)
    return ba._loop_result(loop, cams, grouped.unsort_points(pts), cost)


def _shard_grids(problem, mesh, grouped, n_shards):
    """Each local shard's GroupedBA: the grid flattened back to landmark
    order with a single K, L padded to a shard multiple (mask 0), rows split
    in mesh order, each on its shard's device."""
    L = problem.points.shape[0]
    pixels, cam_ids, mask = grouped.pixels, grouped.cam_ids, grouped.mask
    if grouped.seg_bounds:
        # valence segments do not align with shard boundaries
        inv = grouped.inv_perm.long()
        pixels, cam_ids, mask = pixels[inv], cam_ids[inv], mask[inv]
    pad = -(-L // n_shards) * n_shards - L
    if pad:
        # padding rows: mask 0 everywhere, so V′ = 1e-12·I, h = 0 and δpt = 0
        pixels = torch.cat([pixels, pixels.new_zeros((pad, *pixels.shape[1:]))])
        cam_ids = torch.cat([cam_ids, cam_ids.new_zeros((pad, *cam_ids.shape[1:]))])
        mask = torch.cat([mask, mask.new_zeros((pad, *mask.shape[1:]))])
    rows = (L + pad) // n_shards
    out = []
    for j, dev in enumerate(mesh.devices):
        sl = slice((mesh.first_shard + j) * rows, (mesh.first_shard + j + 1) * rows)
        out.append(GroupedBA(pixels=pixels[sl].to(dev).contiguous(), cam_ids=cam_ids[sl].to(dev).contiguous(),
                             mask=mask[sl].to(dev).contiguous()))
    return out


def _shard_points(points, mesh, n_shards):
    """Each local shard's (L_s, 3) points of ``_shard_grids``' rows (the
    padding rows 1.0)."""
    L = points.shape[0]
    pad = -(-L // n_shards) * n_shards - L
    if pad:
        points = torch.cat([points, points.new_ones((pad, 3))])
    rows = (L + pad) // n_shards
    return [points[(mesh.first_shard + j) * rows : (mesh.first_shard + j + 1) * rows].to(dev)
            for j, dev in enumerate(mesh.devices)]


def _sharded_dense_loop(problem, mesh, config, grouped, n_shards):
    """The StepLoop of ``solve_ba_dense_sharded``, its context the shards'
    GroupedBAs. The grouping (unless ``grouped`` is given), the shard grids
    and each shard's camera and K11 pair plans are made once, before the
    capture. On CUDA with a mesh that captures on the cameras' device the
    loop is captured once per layout (the mesh by value, the incidence
    and pixels by identity, ``grouped`` when given, intrinsics, loss, gauge,
    shapes, dtype and config: K11 runs inside the graph) and kept; over one
    process's several peer cards it is a graph a card (``CardLoops``), card
    c's over its shards' landmarks, with the cameras, λ and the intrinsics
    on the card; otherwise it is eager."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    C = problem.camera_params.shape[0]
    graph = device_loop.graphs(problem.camera_params) and mesh.captures_on(dev)
    name = f"ba_step_dense_sharded {ba._layout_name(problem)} shards={n_shards}"

    def make():
        shards = _shard_grids(problem, mesh, group_by_landmark(problem) if grouped is None else grouped, n_shards)
        for shard in shards:
            shard.camera_plan(C)
            if graph:
                shard.schur_plan(C)

        def make_loop(view, carry, capture):
            own = [shards[j] for j in view.shards]
            intr = problem.intrinsics.to(carry[0].device)

            def body(cams, *rest):
                *pts, lam = rest
                cams, pts, lam, terminal, status, record = _dense_outer_step(
                    cams, tuple(pts), intr, own, problem.loss, problem.n_fixed_cameras, lam, config, view
                )
                return (cams, *pts, lam), terminal, status, record

            return device_loop.StepLoop(body, carry, config.max_iterations, ba._record_dtypes(dtype),
                                        Status.MAXIMUM_ITERATIONS_REACHED, graph=capture, context=own, name=name)

        carry = (problem.camera_params, *_shard_points(problem.points, mesh, n_shards),
                 torch.full((), -1.0, dtype=dtype, device=dev))
        return device_loop.card_loops(mesh, graph, make_loop, carry, (None, *range(mesh.n_local), None), name,
                                      context=shards)

    if not graph:
        return make()
    return device_loop.cached(
        ("dense_sharded", mesh.layout(), grouped, config, problem.loss, problem.n_fixed_cameras,
         tuple(problem.camera_params.shape), tuple(problem.points.shape), dtype, dev, problem.cam_idx,
         problem.pt_idx, problem.pixels, problem.intrinsics), make,
    )


def solve_ba_dense_sharded(problem, mesh, config=DenseBAConfig(), axis="data", grouped=None):
    """Distributed dense-Schur BA: the landmark axis sharded over the mesh.

    The (L, K) grid and the landmark state are split along L (a segmented
    grid is flattened back to landmark order with one K, and L padded to a
    shard multiple); every shard gets its own GroupedBA, whose camera plan
    and K11 pair plan are made once. The cameras are replicated. Per outer
    iteration the camera-space objects are summed over the mesh
    (``Mesh.psum``: in shard order, then one all-reduce across processes),
    so every λ/ρ/status decision is the same on every process and their
    loops stay in lockstep. Returns a BAResult with the points in the
    problem's landmark order, on every process. Pass ``grouped`` (from
    ``group_by_landmark``) to reuse the host grouping.

    On CUDA, with a mesh that captures on the cameras' device
    (``Mesh.captures_on``), an outer iteration is one replay of a graph
    captured at the first solve of its layout (K11 once a shard an S build
    inside it) and the loop reads nothing back; a repeat solve of the same
    problem replays, with ``grouped`` None too (its grouping is made once,
    with the graph); over a process's several peer cards it replays a
    graph a card. Over a gloo mesh or cards without peer access the step
    runs eagerly, one host read a trial and an outer iteration. The solve ends
    with ``Mesh.check``, then gathers the points over the group.
    """
    n_shards = mesh.check_axis(axis)
    L = problem.points.shape[0]
    loop = _sharded_dense_loop(problem, mesh, config, grouped, n_shards)
    loop.start((problem.camera_params, *_shard_points(problem.points, mesh, n_shards), -1.0))
    loop.solve(config.max_iterations, ba._read)
    cams, *pts, _ = (t.clone() for t in loop.carry)
    intr, dev = problem.intrinsics, problem.camera_params.device
    cost = mesh.psum(
        [_cost_grouped(cams.to(d), p, intr.to(d), s) for p, s, d in zip(pts, loop.context, mesh.devices)], device=dev
    )
    mesh.check()
    points = mesh.gather_rows(torch.cat([p.to(dev) for p in pts]))[:L]
    return ba._loop_result(loop, cams, points, cost)
