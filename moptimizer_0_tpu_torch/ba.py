"""Bundle-adjustment types and the LM plumbing the dense-Schur engine uses.

PyTorch counterpart of the subset of ``moptimizer_0_tpu.ba`` that
``ba_dense`` runs: the problem and result types, the pinhole projection and
its cost, the small block helpers, and the inner LM trial loop with the
reference's λ/ν/ρ schedule (src/levenberg_marquadt_dyn.cpp:77-114) as a
Python loop, branch for branch.

The matrix-free Schur-CG engine of the JAX module (``solve_ba``,
``ba_step``, ``select_engine``) is not ported yet; those names raise
``NotImplementedError`` (ROADMAP.md, Queue 1).
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.lie import se3


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


def residuals_all(problem):
    """(O, 2) residual array."""
    cams = problem.camera_params[problem.cam_idx]
    pts = problem.points[problem.pt_idx]
    return _residual(cams, pts, problem.pixels, problem.intrinsics)


def compute_cost(problem):
    r = residuals_all(problem)
    return torch.sum(r * r)


def _outer_rows(X, Y):
    """Σ_i X[...,i,:,None]·Y[...,i,None,:] over the i = 2 residual rows."""
    return X[..., 0, :, None] * Y[..., 0, None, :] + X[..., 1, :, None] * Y[..., 1, None, :]


def _damp_blocks(M, lam):
    """M + λ·diag(M) for a batch of square blocks."""
    return M + lam * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))


def _lm_init_state_tree(params, lam, y0, dtype):
    """The trial loop's state before the first trial; ``stop`` and
    ``terminal`` are Python bools (one host read of |y0| < 8ε)."""
    converged0 = bool(torch.abs(y0) < 8 * torch.finfo(dtype).eps)
    # filled on the device: a tensor copied from a host scalar would add a
    # stream synchronisation per outer iteration on a CUDA device
    return dict(
        params=params,
        lam=lam,
        nu=torch.full((), 2.0, dtype=dtype, device=y0.device),
        y=y0,
        rho=torch.full((), torch.nan, dtype=dtype, device=y0.device),
        status=Status.MAXIMUM_ITERATIONS_REACHED,
        stop=converged0,
        terminal=converged0,
        trials=0,
    )


def _lm_init_state(cams, pts, lam, y0, dtype):
    return _lm_init_state_tree((cams, pts), lam, y0, dtype)


def _lm_trials_tree(state, y0, b_flat, params0, solve_fn, cost_fn, inner_iterations,
                    rel_cost_tol=0.0):
    """The inner LM trial loop over a tuple of parameter tensors.

    state: from ``_lm_init_state_tree``. solve_fn(λ) → δ tuple shaped like
    params0; cost_fn(params) → scalar; b_flat: the gradient in the order of
    the concatenated flattened δ. Runs until a trial is accepted or ends the
    solve, at most ``inner_iterations`` trials, reading one small vector of
    flags back to the host per trial. ``state["trials"]`` counts the damped
    solves.
    """
    dtype = y0.dtype
    eps = torch.finfo(dtype).eps
    s = dict(state)
    for _ in range(inner_iterations):
        if s["stop"]:
            break
        lam, nu = s["lam"], s["nu"]
        delta = solve_fn(lam)
        params_i = tuple(p + d for p, d in zip(params0, delta))
        yi = cost_fn(params_i)

        delta_flat = torch.cat([d.reshape(-1) for d in delta])
        rho = (y0 - yi) / torch.dot(delta_flat, lam * delta_flat - b_flat)
        flags = [
            torch.isnan(yi),
            rho < 0.0,  # a NaN ρ falls through to accept
            torch.max(torch.abs(delta_flat)) < math.sqrt(eps),
            torch.abs(yi) < 8 * eps,
            # an accepted step at the noise floor; yi <= y0 keeps a NaN-ρ
            # acceptance of a cost increase from being labelled CONVERGED
            (yi <= y0) & ((y0 - yi) <= rel_cost_tol * torch.abs(y0)),
        ]
        is_nan, reject, small, cost_small, at_floor = torch.stack(flags).tolist()
        accept = not is_nan and not reject
        term_small = not is_nan and reject and small
        retry = not is_nan and reject and not small

        if is_nan:
            s["status"] = Status.NUMERIC_ERROR
        elif term_small:
            s["status"] = Status.CONVERGED if cost_small else Status.SMALL_DELTA
        s["terminal"] = is_nan or term_small
        if rel_cost_tol > 0.0 and accept and at_floor:
            s["terminal"] = True
            s["status"] = Status.CONVERGED

        if accept:
            s["params"] = params_i
            # max(1/3, 1 − (2ρ − 1)³); a NaN ρ gives a NaN λ, as in JAX
            s["lam"] = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        elif retry:
            s["lam"] = nu * lam
            s["nu"] = 2.0 * nu
        if accept or is_nan or term_small:
            s["y"] = yi
        s["rho"] = rho
        s["stop"] = accept or is_nan or term_small
        s["trials"] += 1
    return s


def _lm_trials(state, y0, b_flat, cams0, pts0, solve_fn, cost_fn, inner_iterations,
               rel_cost_tol=0.0):
    """``_lm_trials_tree`` for the (cameras, points) pair; solve_fn(λ) →
    (δcam, δpt), cost_fn(cams, pts) → scalar."""
    return _lm_trials_tree(
        state, y0, b_flat, (cams0, pts0), solve_fn, lambda p: cost_fn(p[0], p[1]),
        inner_iterations, rel_cost_tol=rel_cost_tol,
    )


def make_ba_problem(O, C, L, seed=0, dtype=torch.float32, device=None):
    """Synthetic BA instance with the numpy draws of the JAX package's bench
    (``bench._make_ba_problem``), in the same order: landmarks in a 20 m box
    30 m ahead, C cameras on a line, O observations with sorted uniform
    landmark ids and uniform camera ids, pixels projected by ``_project``
    plus N(0, 0.5²) noise, then cameras 2.. and every landmark perturbed.
    Two cameras are fixed."""
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


_CG_NOT_PORTED = (
    "the matrix-free Schur-CG engine is not ported yet (ROADMAP.md, Queue 1); "
    "use ba_dense.solve_ba_dense"
)


def select_engine(problem):
    raise NotImplementedError(_CG_NOT_PORTED)


def ba_step(problem, lam, config=None):
    raise NotImplementedError(_CG_NOT_PORTED)


def solve_ba(problem, config=None, host_loop=False, engine="cg"):
    raise NotImplementedError(_CG_NOT_PORTED)
