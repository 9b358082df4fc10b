"""Schur-complement bundle adjustment: the matrix-free CG engine, and the
types and LM plumbing every BA engine shares.

PyTorch counterpart of ``moptimizer_0_tpu.ba``: joint refinement of C camera
poses and L landmarks from O pixel observations.

* residuals and per-observation Jacobians A_o = ∂r/∂cam (2×6) and
  B_o = ∂r/∂pt (2×3) in closed form on the flat (O, ·) layout
  (``_reproject``, shared with the dense engine's grid), the exp map and the
  right Jacobian computed once per camera;
* Gauss-Newton blocks U_c = Σ AᵀA (C,6,6), V_l = Σ BᵀB (L,3,3),
  W_o = AᵀB (O,6,3), g and h, every sum over cameras or landmarks through an
  ``ops.segment_sum`` plan made once a solve: no ``index_add_``, whose
  atomics sum in no fixed order on the card, so two solves are bit-equal;
* landmarks eliminated by the Schur complement, applied matrix-free,
      S u = U′ u − Σ_o W_o V′⁻¹ (Σ_o W_oᵀ u),
  and solved by block-Jacobi preconditioned CG (``ops.pcg``); S is never
  built, so memory is O(C + L + O) whatever the camera graph;
* back-substitution δl = V′⁻¹ (−h − Wᵀ δc) per landmark;
* the reference's LM λ/ν/ρ schedule (src/levenberg_marquadt_dyn.cpp:67-114)
  over the joint state, decided on the device: each trial under
  ``device_loop.cond(¬stop)``, each PCG iteration under cond(‖r‖² > tol²).
  On CUDA an outer iteration is one replay of a CUDA graph (``ba_step``),
  and ``solve_ba`` enqueues max_iterations replays with no host read
  (``ops/device_loop.py``). Eagerly (on the CPU, or for a problem sharded
  over a gloo mesh or cards without peer access) the same body reads the device once a trial,
  once every 32 PCG iterations and once an outer iteration (``HOST_READS``
  counts the reads).

``solve_ba(engine="dense")`` runs ``ba_dense.solve_ba_dense``, and
``engine="auto"`` routes between the two as the JAX package does.

Observation sharding: ``cam_idx``, ``pt_idx`` and ``pixels`` may be
``parallel.mesh.GlobalArray``s (``multihost.make_global_array(rows, mesh)``:
all the rows within one process, each process's own rows across processes),
the counterpart of the JAX package's arrays sharded along ``P("data")``.
Each local shard keeps its rows, its camera and landmark plans and its W on
its device; U, V, g, h and the costs are summed over the mesh
(``Mesh.psum``), and each PCG iteration's matvec reduces twice, Σ_o W_oᵀ u
(L, 3) and Σ_o W_o s (C, 6), where GSPMD inserts its two reductions for the
JAX engine. Cameras, points and the solver's vectors are replicated, so
every process reads the same flags and the processes' loops stay in
lockstep. The unsharded solve is the one-shard case of the same step. With
every local shard on the cameras' device and the reductions device work
(``Mesh.captures_on``: one process, or processes reducing through
``kernels/mesh_reduce.py`` or ``kernels/nccl_transport.py``) the sharded step is captured as the
unsharded one is: each PCG iteration's two reductions inside its IF node,
the shards and their plans made before the capture, a graph in every
process. Over a process's several peer cards the step is a graph a
card (``device_loop.CardLoops``), each card's over its own shards, its
reductions through the card transport (``parallel.mesh.CardMesh``). A gloo
mesh, or cards without peer access both ways, runs the eager loop. A
sharded solve or step ends with ``Mesh.check``.
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.ops.pcg import pcg
from moptimizer_0_tpu_torch.ops.segment_sum import segment_plan, segment_sum
from moptimizer_0_tpu_torch.parallel.mesh import GlobalArray, Mesh
from moptimizer_0_tpu_torch.utils import tracing
from moptimizer_0_tpu_torch.utils.device import require

# Reads of the device by the BA solve loops, their CG and their plans (a
# Python counter).
HOST_READS = 0


def _read(t):
    """t.tolist(), counted in HOST_READS; raises inside a CUDA-graph
    capture, where the device cannot be read."""
    global HOST_READS
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host read of the device inside a CUDA-graph capture")
    HOST_READS += 1
    return t.tolist()


@dataclasses.dataclass
class BAProblem:
    """State + data of a bundle-adjustment problem.

    camera_params: (C, 6) poses [t, ω], world→camera.
    points: (L, 3) landmarks.
    cam_idx, pt_idx: (O,) integer observation incidence.
    pixels: (O, 2) measured projections.
    intrinsics: (4,) [fx, fy, cx, cy] shared pinhole intrinsics.
    loss: robust loss (``core.loss``) weighting H and b only; None = trivial.
    n_fixed_cameras: gauge fixing — the first k cameras do not move.
    """

    camera_params: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    pixels: torch.Tensor
    intrinsics: torch.Tensor
    loss: Any = None
    n_fixed_cameras: int = 1


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Settings, with the fields and defaults of the JAX package's BAConfig.
    rel_cost_tol: an accepted step improving the cost by ≤ tol·y0 ends the
    solve CONVERGED (0 = off)."""

    max_iterations: int = 15
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    cg_iterations: int = 50
    cg_tol: float = 1e-8
    rel_cost_tol: float = 0.0


@dataclasses.dataclass
class BAResult:
    camera_params: torch.Tensor
    points: torch.Tensor
    status: torch.Tensor  # int32, a Status value
    iterations: torch.Tensor  # int32, executed outer iterations
    cost: torch.Tensor  # final Σ‖r‖²
    trace: dict  # per-outer-iteration records, NaN-filled to max_iterations


def _project(cam, point, intr):
    """Pinhole projection of world points through params6 poses; cam (..., 6)
    and point (..., 3) broadcast, the result is (..., 2)."""
    T = se3.transform_from_params6(cam)
    pc = (T[..., :3, :3] @ point[..., :, None])[..., 0] + T[..., :3, 3]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = pc[..., 2]
    return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)


def _residual(cam, point, pixel, intr):
    return pixel - _project(cam, point, intr)


def _camera_cache(cams, with_jacobian=True):
    """Per-camera [R (9), t (3)] and, with the Jacobian, Jr(ω) (9): (C, 21)
    or (C, 12). The exp map runs once per camera, not once per observation."""
    t, w = cams[:, :3], cams[:, 3:]
    cols = [so3.exp(w).reshape(-1, 9), t]
    if with_jacobian:
        cols.append(so3.right_jacobian(w).reshape(-1, 9))
    return torch.cat(cols, dim=1)


def _reproject(q, p, pix, intr, jacobians=True, intrinsics=False):
    """Residuals and closed-form Jacobians of pinhole reprojections.

    q: the columns of ``_camera_cache`` gathered per observation; p: the
    point's three coordinates; pix (..., 2). All broadcast together.
    Returns r (..., 2); with ``jacobians`` also A = ∂r/∂cam (..., 2, 6) and
    B = ∂r/∂pt (..., 2, 3); with ``intrinsics`` also K = ∂r/∂θ (..., 2, 4)
    for θ = [fx, fy, cx, cy]:

        pc = R p + t,  π = (fx·x/z + cx, fy·y/z + cy),  r = pix − π
        ∂π/∂pc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]
        ∂pc/∂t = I,  ∂pc/∂ω = −R [p]× Jr(ω),  ∂pc/∂p = R

    unrolled to elementwise work.
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    R = [[q[0], q[1], q[2]], [q[3], q[4], q[5]], [q[6], q[7], q[8]]]
    t = (q[9], q[10], q[11])
    p0, p1, p2 = p
    x = R[0][0] * p0 + R[0][1] * p1 + R[0][2] * p2 + t[0]
    y = R[1][0] * p0 + R[1][1] * p1 + R[1][2] * p2 + t[1]
    z = R[2][0] * p0 + R[2][1] * p1 + R[2][2] * p2 + t[2]
    iz = 1.0 / z
    r = torch.stack([pix[..., 0] - (fx * x * iz + cx), pix[..., 1] - (fy * y * iz + cy)], dim=-1)
    if not jacobians:
        return r
    Jr = [[q[12], q[13], q[14]], [q[15], q[16], q[17]], [q[18], q[19], q[20]]]
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
    if not intrinsics:
        return r, A, B
    one = torch.ones_like(iz)
    K = torch.stack(
        [
            torch.stack([-x * iz, zero, -one, zero], dim=-1),
            torch.stack([zero, -y * iz, zero, -one], dim=-1),
        ],
        dim=-2,
    )
    return r, A, B, K


def _flat(problem, cams, pts, jacobians, intrinsics=False):
    """``_reproject`` of every observation, on the flat (O, ·) layout."""
    q = _camera_cache(cams, with_jacobian=jacobians)[problem.cam_idx].unbind(-1)
    p = pts[problem.pt_idx].unbind(-1)
    return _reproject(q, p, problem.pixels, problem.intrinsics, jacobians, intrinsics)


def _mesh_of(problem):
    """The mesh of an observation-sharded problem; None for an unsharded one."""
    fields = (problem.cam_idx, problem.pt_idx, problem.pixels)
    sharded = [isinstance(f, GlobalArray) for f in fields]
    if not any(sharded):
        return None
    mesh = problem.cam_idx.mesh if sharded[0] else None
    n = problem.cam_idx.local.shape[0] if sharded[0] else -1
    if not all(sharded) or any(f.mesh is not mesh or f.local.shape[0] != n for f in fields):
        raise ValueError("cam_idx, pt_idx and pixels must all be GlobalArrays of one mesh, with as many rows")
    return mesh


def _shards(problem):
    """(mesh, shards) of a problem: an unsharded problem is one shard on its
    cameras' device, with no process group; an observation-sharded one (see
    the module docstring) splits this process's rows into equal parts in
    mesh order, each a BAProblem with its rows and the replicated cameras,
    points and intrinsics on its shard's device. The JAX package's
    ``device_put`` refuses a row count that the mesh does not divide, and
    so does this (``multihost.make_global_array`` first)."""
    mesh = _mesh_of(problem)
    if mesh is None:
        return Mesh(devices=(problem.camera_params.device,)), [problem]
    n = problem.cam_idx.local.shape[0]
    if n % mesh.n_local:
        raise ValueError(f"{n} observation rows do not divide {mesh.n_local} local shards")
    rows = n // mesh.n_local
    return mesh, [
        dataclasses.replace(
            problem,
            camera_params=problem.camera_params.to(dev),
            points=problem.points.to(dev),
            cam_idx=problem.cam_idx.local[j * rows : (j + 1) * rows].to(dev),
            pt_idx=problem.pt_idx.local[j * rows : (j + 1) * rows].to(dev),
            pixels=problem.pixels.local[j * rows : (j + 1) * rows].to(dev),
            intrinsics=problem.intrinsics.to(dev),
        )
        for j, dev in enumerate(mesh.devices)
    ]


def _at(shard, cams, pts, intr=None):
    """The shard evaluated at the replicated state (cams, pts) and, when
    given, intrinsics ``intr``."""
    dev = shard.cam_idx.device
    intr = shard.intrinsics if intr is None else intr
    return dataclasses.replace(shard, camera_params=cams.to(dev), points=pts.to(dev), intrinsics=intr.to(dev))


def _mesh_cost(mesh, shards, cams, pts, intr=None):
    """Σ‖r‖² over every shard's rows, summed over the mesh, on cams' device."""
    parts = []
    for shard in shards:
        s = _at(shard, cams, pts, intr)
        r = _flat(s, s.camera_params, s.points, jacobians=False)
        parts.append(torch.sum(r * r))
    return mesh.psum(parts, device=cams.device)


def residuals_all(problem):
    """(O, 2) residual array; of an observation-sharded problem, this
    process's rows."""
    _, shards = _shards(problem)
    dev = problem.camera_params.device
    rs = [_flat(s, s.camera_params, s.points, jacobians=False).to(dev) for s in shards]
    return rs[0] if len(rs) == 1 else torch.cat(rs)


def compute_cost(problem):
    mesh, shards = _shards(problem)
    return _mesh_cost(mesh, shards, problem.camera_params, problem.points)


def _outer_rows(X, Y):
    """Σ_i X[...,i,:,None]·Y[...,i,None,:] over the i = 2 residual rows."""
    return X[..., 0, :, None] * Y[..., 0, None, :] + X[..., 1, :, None] * Y[..., 1, None, :]


def _inv3x3(A):
    """Closed-form batched 3×3 inverse (adjugate over determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    idet = 1.0 / (a * co_a + b * co_b + c * co_c)
    return (
        torch.stack(
            [
                torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
                torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
                torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
            ],
            dim=-2,
        )
        * idet[..., None, None]
    )


def _damp_blocks(M, lam):
    """M + λ·diag(M) for a batch of square blocks."""
    return M + lam * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))


def _lm_init_state_tree(params, lam, y0, dtype):
    """The trial loop's state before the first trial, every entry a tensor
    that the trials write in place (the parameters and y copied from their
    starting values); ``stop`` and ``terminal`` start at |y0| < 8ε, on the
    device."""
    dev = y0.device
    converged0 = torch.abs(y0) < 8 * torch.finfo(dtype).eps
    # filled on the device: a tensor copied from a host scalar would add a
    # stream synchronisation per outer iteration on a CUDA device
    return dict(
        params=tuple(p.clone() for p in params),
        lam=lam.clone(),
        nu=torch.full((), 2.0, dtype=dtype, device=dev),
        y=y0.clone(),
        rho=torch.full((), torch.nan, dtype=dtype, device=dev),
        status=torch.full((), int(Status.MAXIMUM_ITERATIONS_REACHED), dtype=torch.int32, device=dev),
        stop=converged0,
        terminal=converged0.clone(),
        trials=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _lm_init_state(cams, pts, lam, y0, dtype):
    return _lm_init_state_tree((cams, pts), lam, y0, dtype)


def _lm_trials_tree(state, y0, b_flat, params0, solve_fn, cost_fn, inner_iterations,
                    rel_cost_tol=0.0, metrics_fn=None):
    """The inner LM trial loop over a tuple of parameter tensors.

    state: from ``_lm_init_state_tree``, updated in place and returned.
    solve_fn(λ) → δ tuple shaped like params0; cost_fn(params) → scalar;
    b_flat: the gradient in the order of the concatenated flattened δ.
    metrics_fn(δ, λ) → (δ·(λδ − b), max|δ|) replaces the b_flat computation
    of both (the sharded dense engine sums the landmark part over the mesh);
    b_flat is then unused. At most ``inner_iterations`` trials, each under
    ``device_loop.cond(¬stop)``: an IF node under capture, one host read of
    ¬stop eagerly, where the loop ends at the first trial not taken. A trial
    decides on the device, branch for branch as the JAX package's
    ``jnp.where``s; ``state["trials"]`` counts the damped solves.
    """
    dtype = y0.dtype
    eps = torch.finfo(dtype).eps
    s = state

    def trial():
        lam, nu = s["lam"], s["nu"]
        delta = solve_fn(lam)
        params_i = tuple(p + d for p, d in zip(params0, delta))
        yi = cost_fn(params_i)

        if metrics_fn is None:
            delta_flat = torch.cat([d.reshape(-1) for d in delta])
            denom = torch.dot(delta_flat, lam * delta_flat - b_flat)
            max_abs = torch.max(torch.abs(delta_flat))
        else:
            denom, max_abs = metrics_fn(delta, lam)
        rho = (y0 - yi) / denom
        is_nan = torch.isnan(yi)
        reject = rho < 0.0  # a NaN ρ falls through to accept
        small = max_abs < math.sqrt(eps)
        accept = ~is_nan & ~reject
        term_small = ~is_nan & reject & small
        retry = ~is_nan & reject & ~small
        converged = torch.abs(yi) < 8 * eps
        status = torch.where(
            is_nan, int(Status.NUMERIC_ERROR),
            torch.where(term_small, torch.where(converged, int(Status.CONVERGED), int(Status.SMALL_DELTA)),
                        s["status"]),
        )
        terminal = is_nan | term_small
        if rel_cost_tol > 0.0:
            # an accepted step at the noise floor; yi <= y0 keeps a NaN-ρ
            # acceptance of a cost increase from being labelled CONVERGED
            at_floor = accept & (yi <= y0) & ((y0 - yi) <= rel_cost_tol * torch.abs(y0))
            terminal = terminal | at_floor
            status = torch.where(at_floor, int(Status.CONVERGED), status)
        moved = accept | is_nan | term_small

        for p, p_i in zip(s["params"], params_i):
            p.copy_(torch.where(accept.to(p.device), p_i, p))
        # max(1/3, 1 − (2ρ − 1)³); a NaN ρ gives a NaN λ, as in JAX
        gain = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        s["lam"].copy_(torch.where(accept, lam * gain, torch.where(retry, nu * lam, lam)))
        s["nu"].copy_(torch.where(retry, 2.0 * nu, nu))
        s["y"].copy_(torch.where(moved, yi, s["y"]))
        s["rho"].copy_(rho)
        s["status"].copy_(status)
        s["terminal"].copy_(terminal)
        s["stop"].copy_(moved)
        s["trials"].add_(1)

    for _ in range(inner_iterations):
        if not device_loop.cond(~s["stop"], trial, _read):
            break
    return s


def _lm_trials(state, y0, b_flat, cams0, pts0, solve_fn, cost_fn, inner_iterations,
               rel_cost_tol=0.0):
    """``_lm_trials_tree`` for the (cameras, points) pair; solve_fn(λ) →
    (δcam, δpt), cost_fn(cams, pts) → scalar."""
    return _lm_trials_tree(
        state, y0, b_flat, (cams0, pts0), solve_fn, lambda p: cost_fn(p[0], p[1]),
        inner_iterations, rel_cost_tol=rel_cost_tol,
    )


def _step_result(state, y0, converged0):
    """(λ′, terminal, status, record) of an outer step from its trial state:
    a solve converged at its start keeps CONVERGED; record holds cost,
    cost_new, rho, lam and trials."""
    status = torch.where(converged0, int(Status.CONVERGED), state["status"])
    record = dict(cost=y0, cost_new=state["y"], rho=state["rho"], lam=state["lam"], trials=state["trials"])
    return state["lam"], state["terminal"], status, record


def make_ba_problem(O, C, L, seed=0, dtype=torch.float32, device="cuda"):
    """Synthetic BA instance with the numpy draws of the JAX package's bench
    (``bench._make_ba_problem``), in the same order: landmarks in a 20 m box
    30 m ahead, C cameras on a line, O observations with sorted uniform
    landmark ids and uniform camera ids, pixels projected by ``_project``
    plus N(0, 0.5²) noise, then cameras 2.. and every landmark perturbed.
    Two cameras are fixed. On the card unless ``device`` says otherwise;
    without a card the default raises."""
    device = require(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, size=(L, 3)) + np.array([0.0, 0.0, 30.0])
    cams = np.stack(
        [
            np.concatenate(
                [[0.08 * i - 0.04 * C, 0.5 * rng.normal(), 0.0], 0.02 * rng.normal(size=3)]
            )
            for i in range(C)
        ]
    )
    pt_idx = np.sort(rng.integers(0, L, size=O))
    cam_idx = rng.integers(0, C, size=O)

    def as_t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    cams_t, pts_t = as_t(cams), as_t(pts)
    cam_idx_t, pt_idx_t = as_t(cam_idx, torch.int64), as_t(pt_idx, torch.int64)
    intr = as_t([500.0, 500.0, 320.0, 240.0])
    pixels = _project(cams_t[cam_idx_t], pts_t[pt_idx_t], intr).cpu().numpy()
    pixels = pixels + 0.5 * rng.normal(size=pixels.shape)
    free = (torch.arange(C, device=device) >= 2)[:, None].to(dtype)
    return BAProblem(
        camera_params=cams_t + 0.01 * as_t(rng.normal(size=cams.shape)) * free,
        points=pts_t + 0.05 * as_t(rng.normal(size=pts.shape)),
        cam_idx=cam_idx_t,
        pt_idx=pt_idx_t,
        pixels=as_t(pixels),
        intrinsics=intr,
        n_fixed_cameras=2,
    )


def _plans(problem):
    """The camera and landmark sums' plans of this incidence (made once a
    solve; each level of a plan reads the device twice)."""
    global HOST_READS
    ones = torch.ones_like(problem.cam_idx)
    cam = segment_plan(problem.cam_idx, ones, problem.camera_params.shape[0])
    pt = segment_plan(problem.pt_idx, ones, problem.points.shape[0])
    HOST_READS += 2 * (len(cam[0]) + len(pt[0]))
    return cam, pt


def _linearize(problem):
    """Per-observation residuals and Jacobians: r (O,2), A (O,2,6), B (O,2,3)."""
    return _flat(problem, problem.camera_params, problem.points, jacobians=True)


def _rows_dot(X, v):
    """Σ_i X[:, i, :]·v[:, i] over the 2 residual rows → (O, n)."""
    return X[:, 0, :] * v[:, 0, None] + X[:, 1, :] * v[:, 1, None]


def _bmv(M, v):
    """Batched small matvec (n, i, j)·(n, j) → (n, i), as a broadcast sum."""
    return torch.sum(M * v[:, None, :], dim=-1)


def _irls(problem, r, *mats):
    """The robust loss's weight w = loss(‖r‖²) per observation applied to
    mats and r (H and b only); unchanged without a loss."""
    if problem.loss is None:
        return (*mats, r)
    w = problem.loss.weight(torch.sum(r * r, dim=1))
    return (*(w[:, None, None] * m for m in mats), w[:, None] * r)


def _gn_blocks(problem, r, A, B, plans):
    """Gauss-Newton blocks U (C,6,6), V (L,3,3), W (O,6,3), g (C,6), h (L,3);
    a robust loss weights H and b only."""
    cam, pt = plans
    Aw, Bw, rw = _irls(problem, r, A, B)
    C, L = problem.camera_params.shape[0], problem.points.shape[0]
    U = segment_sum(cam, _outer_rows(Aw, A).reshape(-1, 36)).reshape(C, 6, 6)
    V = segment_sum(pt, _outer_rows(Bw, B).reshape(-1, 9)).reshape(L, 3, 3)
    W = _outer_rows(Aw, B)
    g = segment_sum(cam, _rows_dot(A, rw))
    h = segment_sum(pt, _rows_dot(B, rw))
    return U, V, W, g, h


def _to_landmarks(mesh, rows, u, dev):
    """Σ_o W_oᵀ u[cam_idx_o] per landmark (L, 3), over every shard's rows and
    the mesh; u (C, 6). rows: each local shard's (problem, plans, W)."""
    return mesh.psum(
        [segment_sum(plans[1], torch.sum(W * u.to(p.cam_idx.device)[p.cam_idx][:, :, None], dim=1))
         for p, plans, W in rows],
        device=dev,
    )


def _to_cameras(mesh, rows, s, dev):
    """Σ_o W_o s[pt_idx_o] per camera (C, 6), over every shard's rows and the
    mesh; s (L, 3)."""
    return mesh.psum(
        [segment_sum(plans[0], _bmv(W, s.to(p.pt_idx.device)[p.pt_idx])) for p, plans, W in rows], device=dev
    )


def _schur_matvec(u, U_d, Vinv, mesh, rows, cam_mask):
    """S·u with S = U′ − W V′⁻¹ Wᵀ, matrix-free; u (C,6). Two reductions
    over the mesh: Σ Wᵀu (L, 3) and Σ W s (C, 6)."""
    dev = u.device
    u = u * cam_mask  # fixed cameras contribute nothing
    Uu = _bmv(U_d, u)
    s = _bmv(Vinv, _to_landmarks(mesh, rows, u, dev))
    return (Uu - _to_cameras(mesh, rows, s, dev)) * cam_mask


def _cam_mask(problem):
    C = problem.camera_params.shape[0]
    dev = problem.camera_params.device
    return (torch.arange(C, device=dev) >= problem.n_fixed_cameras).to(problem.camera_params.dtype)[:, None]


def _solve_delta(problem, U, V, g, h, lam, config, mesh, rows, count=None):
    """One damped Gauss-Newton solve: (δcam (C,6), δpt (L,3)). U, V, g, h
    are the mesh's sums; rows holds each local shard's (problem, plans, W).
    count: a 0-dim int32 tensor that the PCG iterations run are added to
    (``ops.pcg``), or None. The PCG solve lies between the markers
    ``ba_pcg_begin`` and ``ba_pcg_end``."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    U_d = _damp_blocks(U, lam)
    Vinv = _inv3x3(_damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=dtype, device=dev))
    cam_mask = _cam_mask(problem)

    # rhs = −(g − W V′⁻¹ h), for H δ = −b
    rhs = -(g - _to_cameras(mesh, rows, _bmv(Vinv, h), dev)) * cam_mask
    # the block-Jacobi preconditioner from U′
    U_inv = torch.linalg.inv_ex(U_d + 1e-12 * torch.eye(6, dtype=dtype, device=dev))[0]

    def mv(u):
        return _schur_matvec(u, U_d, Vinv, mesh, rows, cam_mask)

    def pre(u):
        return _bmv(U_inv, u) * cam_mask

    tracing.mark("ba_pcg_begin", rhs)
    d_cam = pcg(mv, rhs, pre, config.cg_iterations, config.cg_tol, _read, count=count) * cam_mask
    tracing.mark("ba_pcg_end", rhs)
    # back-substitute: δl = V′⁻¹ (−h − Wᵀ δcam)
    return d_cam, _bmv(Vinv, -h - _to_landmarks(mesh, rows, d_cam, dev))


def _seed_lambda(lam, U, V, factor, v_diag_max=None):
    """λ < 0 → factor · max |diag| of U and V. v_diag_max: V's max |diag|
    when V is spread over shards (then V is unused)."""
    if v_diag_max is None:
        v_diag_max = torch.max(torch.abs(torch.diagonal(V, dim1=-2, dim2=-1)))
    max_diag = torch.maximum(torch.max(torch.abs(torch.diagonal(U, dim1=-2, dim2=-1))), v_diag_max)
    return torch.where(lam < 0.0, factor * max_diag, lam)


def _linearize_shards(mesh, shards, plans, cams, pts):
    """Each shard's rows linearized at (cams, pts): (rows, (U, V, g, h, y0)),
    rows holding each local shard's (problem, plans, W) and the blocks and
    the cost summed over the mesh on cams' device."""
    rows, parts = [], []
    for shard, plan in zip(shards, plans):
        s = _at(shard, cams, pts)
        r, A, B = _linearize(s)
        U, V, W, g, h = _gn_blocks(s, r, A, B, plan)
        rows.append((s, plan, W))
        parts.append((U, V, g, h, torch.sum(r * r)))
    return rows, mesh.psum(parts, device=cams.device)


def _outer_step(problem, lam, config, mesh, shards, plans):
    """One outer LM iteration at the problem's (replicated) cameras and
    points, over the rows of ``shards`` (``_shards``) with their ``plans``:
    (cams, pts, λ′, terminal, status, record), all tensors: ``terminal`` a
    0-dim bool, ``status`` a 0-dim int32, ``record`` cost, cost_new, rho,
    lam, trials and pcg_iterations (int32, summed over the trials). The
    linearization and λ's seed lie between the markers
    ``ba_linearize_begin`` and ``ba_linearize_end``."""
    dtype = problem.camera_params.dtype
    cams0, pts0 = problem.camera_params, problem.points
    tracing.mark("ba_linearize_begin", cams0)
    rows, (U, V, g, h, y0) = _linearize_shards(mesh, shards, plans, cams0, pts0)
    lam = _seed_lambda(lam, U, V, config.init_lambda_factor)
    tracing.mark("ba_linearize_end", cams0)

    state = _lm_init_state(cams0, pts0, lam, y0, dtype)
    converged0 = state["stop"].clone()
    pcg_iterations = torch.zeros((), dtype=torch.int32, device=cams0.device)

    def solve_fn(lam_k):
        return _solve_delta(problem, U, V, g, h, lam_k, config, mesh, rows, count=pcg_iterations)

    def cost_fn(cams_i, pts_i):
        return _mesh_cost(mesh, shards, cams_i, pts_i)

    b_flat = torch.cat([g.reshape(-1), h.reshape(-1)])
    state = _lm_trials(
        state, y0, b_flat, cams0, pts0, solve_fn, cost_fn,
        config.inner_iterations, rel_cost_tol=config.rel_cost_tol,
    )
    cams, pts = state["params"]
    lam, terminal, status, record = _step_result(state, y0, converged0)
    return cams, pts, lam, terminal, status, dict(record, pcg_iterations=pcg_iterations)


def _layout_name(problem):
    """O, C and L of a problem, for naming its captured step."""
    return f"O={problem.cam_idx.shape[0]} C={problem.camera_params.shape[0]} L={problem.points.shape[0]}"


def _record_dtypes(dtype):
    """The names and dtypes of an outer iteration's record (its trace row),
    every BA engine's; the CG engine adds pcg_iterations (int32)."""
    return dict(cost=dtype, cost_new=dtype, rho=dtype, lam=dtype, trials=torch.int32)


def _graphs(problem):
    """Whether the BA step of this problem is a CUDA graph: on the card,
    outside ``device_loop.eager()``, unsharded or sharded over a mesh that
    captures on the cameras' device (``Mesh.captures_on``)."""
    mesh = _mesh_of(problem)
    dev = problem.camera_params.device
    return device_loop.graphs(problem.camera_params) and (mesh is None or mesh.captures_on(dev))


def _observations_key(problem):
    """The observations in a StepLoop's key: the incidence and pixel
    tensors, or for an observation-sharded problem the mesh and the
    GlobalArrays by identity with their rows (the graph reads the shards'
    rows where they lie)."""
    fields = (problem.cam_idx, problem.pt_idx, problem.pixels)
    mesh = _mesh_of(problem)
    if mesh is None:
        return fields
    return (mesh, *fields, *(f.local for f in fields))


def _sharded_loop(problem, config, graph, make_body, carry, name, record=None):
    """The StepLoop of an observation-sharded (or unsharded) step: the
    shards and their plans made once, ``make_body(mesh, shards, plans)``
    the step's body over them, its context (mesh, shards); a graph a card
    over a process's several peer cards (``device_loop.card_loops``, every
    carry entry on every card). record: the body's record names and dtypes
    (by default ``_record_dtypes``)."""
    mesh, shards = _shards(problem)
    plans = [_plans(s) for s in shards]
    record = record or _record_dtypes(problem.camera_params.dtype)

    def make_loop(view, carry, capture):
        body = make_body(view, [shards[j] for j in view.shards], [plans[j] for j in view.shards])
        return device_loop.StepLoop(body, carry, config.max_iterations, record,
                                    Status.MAXIMUM_ITERATIONS_REACHED, graph=capture, name=name,
                                    context=(mesh, shards))

    return device_loop.card_loops(mesh, graph, make_loop, carry, (None,) * len(carry), name, context=(mesh, shards))


def _cg_loop(problem, config):
    """The StepLoop of the CG engine on this problem, its context (mesh,
    shards). On CUDA the loop is captured once per layout (the incidence,
    pixels, intrinsics, loss, gauge, shapes, dtype and config; the mesh and
    the GlobalArrays of an observation-sharded problem) and kept, a graph a
    card over a process's several peer cards; on the CPU, or sharded over
    a gloo mesh or cards without peer access, it is eager."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    graph = _graphs(problem)

    def make_body(mesh, shards, plans):
        def body(cams, pts, lam):
            prob = dataclasses.replace(problem, camera_params=cams, points=pts)
            cams, pts, lam, terminal, status, record = _outer_step(prob, lam, config, mesh, shards, plans)
            return (cams, pts, lam), terminal, status, record

        return body

    def make():
        carry = (problem.camera_params, problem.points, torch.full((), -1.0, dtype=dtype, device=dev))
        return _sharded_loop(problem, config, graph, make_body, carry, f"ba_step {_layout_name(problem)}",
                             record=dict(_record_dtypes(dtype), pcg_iterations=torch.int32))

    if not graph:
        return make()
    return device_loop.cached(
        ("cg", config, problem.loss, problem.n_fixed_cameras, tuple(problem.camera_params.shape),
         tuple(problem.points.shape), dtype, dev, *_observations_key(problem), problem.intrinsics), make,
    )


def ba_step(problem, lam, config=BAConfig()):
    """One outer LM iteration of the CG engine, for callers that step,
    inspect or persist between iterations: (cams, pts, λ′, terminal, status,
    record), all tensors (``_outer_step``). Pass λ = −1 on the first call to
    seed λ from the GN diagonal. On CUDA the step is one replay of a graph
    captured at the first call of its layout, with no host read, an
    observation-sharded problem's too when its mesh captures on the
    cameras' device (a graph a card over several peer cards); sharded over a
    gloo mesh or cards without peer access it steps eagerly."""
    loop = _cg_loop(problem, config)
    loop.start((problem.camera_params, problem.points, lam))
    loop.step(_read)
    (cams, pts, lam), terminal, status, record = loop.outputs()
    loop.context[0].check()
    return cams, pts, lam, terminal, status, record


# engine="auto" routing: the JAX package's constants, kept so that the port
# routes every problem as it does. They were chosen for a 16 GB TPU v5e (the
# (6C)² camera system and its factor, the (L, K) grid's padding, the dense
# engine's estimated peak memory); they are not a budget measured on the
# H100, whose 80 GB would admit larger dense problems.
DENSE_MAX_CAMERAS = 3000
DENSE_MAX_PADDING = 16.0
DENSE_MAX_BYTES = 9e9


def _global_pt_idx(problem):
    """The landmark ids of every observation: of a problem sharded across
    processes gathered from all of them in process order (the same array
    on every process)."""
    g = problem.pt_idx
    if not isinstance(g, GlobalArray):
        return g
    local = g.local.detach().cpu().numpy()
    if g.mesh.group is None:
        return local
    parts = [None] * g.mesh.n_processes
    dist.all_gather_object(parts, local, group=g.mesh.group)
    return np.concatenate(parts)


def select_engine(problem):
    """engine="auto" routing (host-side, from shapes and the incidence):
    "dense" while C ≤ DENSE_MAX_CAMERAS, the valence-segmented slot factor
    ≤ DENSE_MAX_PADDING and the dense engine's estimated peak memory ≤
    DENSE_MAX_BYTES; else "cg". An observation-sharded problem is routed on
    its global incidence, and across processes every process gets the same
    answer."""
    from moptimizer_0_tpu_torch import ba_dense

    C = problem.camera_params.shape[0]
    whole = dataclasses.replace(problem, pt_idx=_global_pt_idx(problem))
    if (
        C <= DENSE_MAX_CAMERAS
        and ba_dense.dense_slot_factor(whole) <= DENSE_MAX_PADDING
        and ba_dense.dense_memory_bytes(whole) <= DENSE_MAX_BYTES
    ):
        return "dense"
    return "cg"


def _unsharded(problem):
    """The problem with plain observation tensors for the dense engine: an
    observation-sharded problem within one process holds all its rows, as
    the JAX package's dense engine gathers a sharded incidence to its host.
    Across processes that gather fails in the JAX package, and here it
    raises."""
    mesh = _mesh_of(problem)
    if mesh is None:
        return problem
    if mesh.group is not None:
        raise ValueError(
            "the dense engine does not take observations sharded across processes: shard the "
            "landmarks with ba_dense.solve_ba_dense_sharded, or solve with engine='cg'"
        )
    dev = problem.camera_params.device
    return dataclasses.replace(
        problem, cam_idx=problem.cam_idx.local.to(dev), pt_idx=problem.pt_idx.local.to(dev),
        pixels=problem.pixels.local.to(dev),
    )


TRACE_KEYS = ("cost", "cost_new", "rho", "lam")


def _loop_result(loop, cams, points, cost):
    """The BAResult of a finished StepLoop: its status, executed iterations
    and trace (cost, cost_new, rho and lam per outer iteration, NaN-filled to
    max_iterations, ``trials``, the damped solves of each, and the CG
    engine's ``pcg_iterations``), copied."""
    return BAResult(
        camera_params=cams,
        points=points,
        status=loop.status.clone(),
        iterations=loop.it.clone(),
        cost=cost,
        trace={k: v.clone() for k, v in loop.trace.items()},
    )


def solve_ba(problem, config=BAConfig(), host_loop=False, engine="cg"):
    """LM over (cameras, landmarks) with Schur-eliminated inner solves.

    engine:
      "cg"    — matrix-free Schur PCG (this module);
      "dense" — ``ba_dense.solve_ba_dense`` with this config's
                max_iterations, inner_iterations and init_lambda_factor
                (the JAX package passes no other field);
      "auto"  — ``select_engine``.

    On CUDA an outer iteration is one replay of the ``ba_step`` graph
    (captured at the first solve of its layout), an observation-sharded
    problem's too when its mesh captures on the cameras' device
    (``Mesh.captures_on``). The default ``host_loop=False`` enqueues max_iterations
    replays, each under IF(¬done), with the trace written on the device: no
    host read after the first capture. ``host_loop=True`` reads done after
    each replay and stops there (one read an outer iteration). Both give the
    same bits. On the CPU, and for a problem sharded over a gloo mesh or
    cards without peer access (module docstring), the same step body runs eagerly, reading the
    device once a trial, once every 32 PCG iterations and once an outer
    iteration, whatever ``host_loop`` says; the cameras and points of a
    sharded solve are replicated on every process, and "dense" takes it
    within one process only. The result's
    trace holds cost, cost_new, rho and lam per outer iteration (NaN-filled
    to max_iterations) and ``trials``; the CG engine's also
    ``pcg_iterations``, the PCG iterations run (summed over the trials), as
    Ceres reports ``linear_solver_iterations``. The solve is the span
    ``solve_ba``, its result's assembly the span ``result``
    (``utils.tracing``).
    """
    with tracing.span("solve_ba"):
        if engine == "auto":
            engine = select_engine(problem)
        if engine == "dense":
            from moptimizer_0_tpu_torch import ba_dense

            return ba_dense.solve_ba_dense(
                _unsharded(problem),
                ba_dense.DenseBAConfig(
                    max_iterations=config.max_iterations,
                    inner_iterations=config.inner_iterations,
                    init_lambda_factor=config.init_lambda_factor,
                ),
            )
        if engine != "cg":
            raise ValueError(f"unknown engine {engine!r}")

        loop = _cg_loop(problem, config)
        loop.start((problem.camera_params, problem.points, -1.0))
        loop.solve(config.max_iterations, _read, host_loop)
        with tracing.span("result"):
            cams, pts = loop.carry[0].clone(), loop.carry[1].clone()
            result = _loop_result(loop, cams, pts, _mesh_cost(*loop.context, cams, pts))
            loop.context[0].check()
        return result
