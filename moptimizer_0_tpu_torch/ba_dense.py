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
* the LM schedule is ``ba._lm_trials`` (the reference's λ/ν/ρ rules), and
  the outer loop is a Python loop with one host read per trial.

The sharded solve (``solve_ba_dense_sharded``) is not ported yet
(ROADMAP.md, Queue 1).
"""

import dataclasses
import functools
from itertools import combinations

import numpy as np
import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.lie import so3
from moptimizer_0_tpu_torch.ops import block_cholesky
from moptimizer_0_tpu_torch.ops import schur, segment_sum


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


def _camera_cache(cams, with_jacobian=True):
    """Per-camera [R (9), t (3)] and, with the Jacobian, Jr(ω) (9): (C, 21)
    or (C, 12). The exp map runs once per camera, not once per observation."""
    t, w = cams[:, :3], cams[:, 3:]
    cols = [so3.exp(w).reshape(-1, 9), t]
    if with_jacobian:
        cols.append(so3.right_jacobian(w).reshape(-1, 9))
    return torch.cat(cols, dim=1)


def _gather_cache(cache, grouped):
    """cache rows gathered onto the grid by camera id: (L, K, q). Padding
    slots gather camera 0; every consumer masks them."""
    return cache[grouped.cam_ids]


def _linearize_grouped(cams, pts, intr, grouped):
    """Masked residuals and closed-form Jacobians on the (L, K) grid.

    r (L,K,2), A = ∂r/∂cam (L,K,2,6), B = ∂r/∂pt (L,K,2,3):

        pc = R p + t,  π = (fx·x/z + cx, fy·y/z + cy),  r = pix − π
        ∂π/∂pc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]
        ∂pc/∂t = I,  ∂pc/∂ω = −R [p]× Jr(ω),  ∂pc/∂p = R

    unrolled to elementwise work on (L, K) tensors. Padding slots are set to
    exactly 0 with ``torch.where``, never by multiplying: a padding slot may
    put the point behind camera 0 and give an inf.
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    q = _gather_cache(_camera_cache(cams), grouped).unbind(-1)
    R = [[q[0], q[1], q[2]], [q[3], q[4], q[5]], [q[6], q[7], q[8]]]
    t = (q[9], q[10], q[11])
    Jr = [[q[12], q[13], q[14]], [q[15], q[16], q[17]], [q[18], q[19], q[20]]]
    p0, p1, p2 = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]  # (L, 1)
    pix = grouped.pixels
    x = R[0][0] * p0 + R[0][1] * p1 + R[0][2] * p2 + t[0]
    y = R[1][0] * p0 + R[1][1] * p1 + R[1][2] * p2 + t[1]
    z = R[2][0] * p0 + R[2][1] * p1 + R[2][2] * p2 + t[2]
    iz = 1.0 / z
    r = torch.stack([pix[..., 0] - (fx * x * iz + cx), pix[..., 1] - (fy * y * iz + cy)], dim=-1)
    # the rows of ∂π/∂pc: [fx·iz, 0, −fx·x·iz²], [0, fy·iz, −fy·y·iz²]
    a0, b0 = fx * iz, -fx * x * iz * iz
    a1, b1 = fy * iz, -fy * y * iz * iz
    JpiR = [
        [a0 * R[0][m] + b0 * R[2][m] for m in range(3)],
        [a1 * R[1][m] + b1 * R[2][m] for m in range(3)],
    ]
    # Hp = hat(p) @ Jr
    Hp = [
        [-p2 * Jr[1][m] + p1 * Jr[2][m] for m in range(3)],
        [p2 * Jr[0][m] - p0 * Jr[2][m] for m in range(3)],
        [-p1 * Jr[0][m] + p0 * Jr[1][m] for m in range(3)],
    ]
    Arot = [[sum(JpiR[al][i] * Hp[i][m] for i in range(3)) for m in range(3)] for al in range(2)]
    zero = torch.zeros_like(iz)
    A = torch.stack(
        [
            torch.stack([-a0, zero, -b0] + Arot[0], dim=-1),
            torch.stack([zero, -a1, -b1] + Arot[1], dim=-1),
        ],
        dim=-2,
    )
    B = torch.stack(
        [torch.stack([-v for v in JpiR[0]], dim=-1), torch.stack([-v for v in JpiR[1]], dim=-1)],
        dim=-2,
    )
    m = grouped.mask > 0
    r = torch.where(m[..., None], r, 0.0)
    A = torch.where(m[..., None, None], A, 0.0)
    B = torch.where(m[..., None, None], B, 0.0)
    return r, A, B


def _cost_grouped(cams, pts, intr, grouped):
    """Σ‖r‖² on the grid; pts in grid-row order (``grouped.sort_points``)."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    cache = _camera_cache(cams, with_jacobian=False)
    y = torch.zeros((), dtype=cams.dtype, device=cams.device)
    for sl, seg in _seg_views(grouped):
        q = _gather_cache(cache, seg).unbind(-1)
        p = pts[sl]
        p0, p1, p2 = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        x = q[0] * p0 + q[1] * p1 + q[2] * p2 + q[9]
        yy = q[3] * p0 + q[4] * p1 + q[5] * p2 + q[10]
        z = q[6] * p0 + q[7] * p1 + q[8] * p2 + q[11]
        iz = 1.0 / z
        r = seg.pixels - torch.stack([fx * x * iz + cx, fy * yy * iz + cy], dim=-1)
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


def _solve_delta_dense(grouped, C, U, V, W, g, h, lam, fixed_mask, chunk, schur_solver="auto",
                       schur_backend="auto"):
    """One damped dense-Schur solve → (δcam (C,6), δpt (L,3))."""
    dtype = U.dtype
    views, W_segs = _w_segments(W, grouped)
    U_d = ba._damp_blocks(U, lam)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=dtype, device=U.device)
    Linv = _tri_inv_lower(_chol3x3(V_d))  # V′⁻¹ = Linvᵀ Linv
    Vinv = torch.sum(Linv[..., :, None] * Linv[..., None, :], dim=-3)

    S = _build_schur(U_d, Linv, W_segs, grouped, fixed_mask, chunk, schur_backend)

    # rhs = −(g − Σ_lk 1[cam=c] W_lk (V′⁻¹ h)_l), gauge rows zeroed
    t = torch.sum(Vinv * h[:, None, :], dim=-1)  # (L,3)
    red = torch.zeros_like(g)
    for (sl, seg), W_s in zip(views, W_segs):
        Wt = torch.sum(W_s * t[sl][:, None, None, :], dim=-1)  # (L_s,K_s,6)
        red = red + segment_sum.segment_sum(seg.camera_plan(C), Wt.reshape(-1, 6))
    rhs = -(g - red)
    # into S's i·C + c order, and the solution back
    rhs = (rhs * fixed_mask[:, None]).T.reshape(-1)
    d_cam = block_cholesky.spd_solve(S, rhs, method=schur_solver).reshape(6, C).T
    d_cam = d_cam * fixed_mask[:, None]

    # back-substitute: δl = V′⁻¹ (−h − Σ_k W_lkᵀ δc[cam(l,k)])
    Wtd_l = []
    for (sl, seg), W_s in zip(views, W_segs):
        dc_g = d_cam[seg.cam_ids]  # (L_s,K_s,6); padding slots have W = 0
        Wtd_l.append(torch.sum(W_s * dc_g[..., :, None], dim=(1, 2)))
    Wtd = Wtd_l[0] if len(Wtd_l) == 1 else torch.cat(Wtd_l, dim=0)
    d_pt = torch.sum(Vinv * (-h - Wtd)[:, None, :], dim=-1)
    return d_cam, d_pt


@dataclasses.dataclass(frozen=True)
class DenseBAConfig:
    """Settings, with the fields and defaults of the JAX package's DenseBAConfig.

    schur_chunk: landmarks per A2 panel of the plain S build.
    schur_solver: "auto" or "xla" (one Cholesky); "blocked" is not ported.
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


def _dense_outer_step(cams, pts, intr, grouped, loss, n_fixed, lam, config, schur_backend="auto"):
    """One outer LM iteration over explicit state; pts in grid-row order.

    Returns (cams, pts, λ′, terminal, status, record): ``terminal`` a Python
    bool, ``status`` a Status, record the tensors cost, cost_new, rho, lam and
    the Python int ``trials`` (damped solves run)."""
    dtype = cams.dtype
    C = cams.shape[0]

    U, V, W, g, h, y0 = _linearize_and_blocks(cams, pts, intr, grouped, loss)
    max_diag = torch.maximum(
        torch.max(torch.abs(torch.diagonal(U, dim1=-2, dim2=-1))),
        torch.max(torch.abs(torch.diagonal(V, dim1=-2, dim2=-1))),
    )
    lam = torch.where(lam < 0.0, config.init_lambda_factor * max_diag, lam)
    fixed_mask = (torch.arange(C, device=cams.device) >= n_fixed).to(dtype)
    state = ba._lm_init_state(cams, pts, lam, y0, dtype)
    converged0 = state["stop"]

    def solve_fn(lam_k):
        return _solve_delta_dense(
            grouped, C, U, V, W, g, h, lam_k, fixed_mask, config.schur_chunk,
            config.schur_solver, schur_backend,
        )

    def cost_fn(cams_i, pts_i):
        return _cost_grouped(cams_i, pts_i, intr, grouped)

    b_flat = torch.cat([g.reshape(-1), h.reshape(-1)])
    state = ba._lm_trials(
        state, y0, b_flat, cams, pts, solve_fn, cost_fn, config.inner_iterations,
        rel_cost_tol=config.rel_cost_tol,
    )
    status = Status.CONVERGED if converged0 else state["status"]
    record = dict(cost=y0, cost_new=state["y"], rho=state["rho"], lam=state["lam"],
                  trials=state["trials"])
    cams_out, pts_out = state["params"]
    return cams_out, pts_out, state["lam"], state["terminal"], status, record


def ba_step_dense(problem, grouped, lam, config=DenseBAConfig(), *, schur_backend="auto"):
    """One outer LM iteration: (cams, pts, λ′, terminal, status, record), with
    points in the problem's own landmark order. Pass λ = −1 on the first call
    to seed λ from the GN diagonal. ``schur_backend`` routes the S build
    (``ops.schur``)."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    cams, pts, lam, terminal, status, record = _dense_outer_step(
        problem.camera_params, grouped.sort_points(problem.points), problem.intrinsics, grouped,
        problem.loss, problem.n_fixed_cameras, lam, config, schur_backend,
    )
    return cams, grouped.unsort_points(pts), lam, terminal, status, record


TRACE_KEYS = ("cost", "cost_new", "rho", "lam")


def solve_ba_dense(problem, config=DenseBAConfig(), grouped=None, host_loop=False, *,
                   schur_backend="auto"):
    """Full LM solve with the dense-Schur engine.

    Groups the observations by landmark on the host (segments="auto") unless
    ``grouped`` is given, then runs the outer loop in Python; ``host_loop``
    is accepted for the JAX package's signature and changes nothing (both of
    its loops are this one loop here). The result's trace holds cost,
    cost_new, rho and lam per outer iteration (NaN-filled to
    max_iterations) and ``trials``, the damped solves of each iteration.
    ``schur_backend`` routes the S build: "auto" (the CUDA kernel for CUDA
    tensors), "cuda" or "torch" (its plain version).
    """
    del host_loop
    if grouped is None:
        grouped = group_by_landmark(problem, segments="auto")
    return _solve_dense_host(problem, grouped, config, schur_backend)


def _solve_dense_host(problem, grouped, config, schur_backend="auto"):
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    n_it = config.max_iterations
    lam = torch.full((), -1.0, dtype=dtype, device=dev)
    status = Status.MAXIMUM_ITERATIONS_REACHED
    records = []
    executed = 0
    # landmark state in grid-row order for the whole loop: sorted once here,
    # unsorted once at the end
    cams = problem.camera_params
    pts = grouped.sort_points(problem.points)
    for it in range(n_it):
        cams, pts, lam, terminal, status, record = _dense_outer_step(
            cams, pts, problem.intrinsics, grouped, problem.loss, problem.n_fixed_cameras,
            lam, config, schur_backend,
        )
        records.append(record)
        if terminal:
            executed = it  # the terminal iteration is not counted as executed
            break
        executed = it + 1

    pad = torch.full((n_it - len(records),), torch.nan, dtype=dtype, device=dev)
    trace = {
        k: torch.cat([torch.stack([rec[k] for rec in records]).to(dtype), pad]) if records
        else pad.clone()
        for k in TRACE_KEYS
    }
    trials = [rec["trials"] for rec in records] + [0] * (n_it - len(records))
    trace["trials"] = torch.tensor(trials, dtype=torch.int32, device=dev)
    return ba.BAResult(
        camera_params=cams,
        points=grouped.unsort_points(pts),
        status=torch.tensor(int(status), dtype=torch.int32, device=dev),
        iterations=torch.tensor(executed, dtype=torch.int32, device=dev),
        cost=_cost_grouped(cams, pts, problem.intrinsics, grouped),
        trace=trace,
    )
