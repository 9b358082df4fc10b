"""Levenberg-Marquardt with the reference schedule, as an eager Python loop.

PyTorch counterpart of ``moptimizer_0_tpu.core.solver``:

outer loop (≤ max_iterations):
    data ← update hooks;  (y0, H, b) ← Σ_blocks linearize
    |y0| < 8ε  →  CONVERGED
    λ < 0      →  λ = 1e-9 · max|diag H|        (seeded once, kept across outer iterations)
    ν = 2                                        (reset every outer iteration)
    inner loop (≤ inner_iterations):
        δ  = solve(H + λ·diag(H), −b);  xi = x + δ;  yi = cost(xi)
        NaN yi → NUMERIC_ERROR
        ρ  = (y0 − yi) / δ·(λδ − b)
        ρ < 0:  max|δ| < √ε → CONVERGED if |yi| < 8ε else SMALL_DELTA
                else λ ← νλ, ν ← 2ν, retry
        else (a NaN ρ included): accept x ← xi, λ ← λ·max(1/3, 1−(2ρ−1)³)
    → MAXIMUM_ITERATIONS_REACHED

The arithmetic stays in tensors on the device of x; the loop reads one small
vector of flags back to the host per inner trial to decide where to go.
"""

import dataclasses
import enum
from typing import Any

import torch

from moptimizer_0_tpu_torch.core.linearize import (
    _as_dtype,
    compute_block_costs,
    compute_cost,
    linearize,
)
from moptimizer_0_tpu_torch.core.residual import Problem


class Status(enum.IntEnum):
    """Optimization status (the values of the JAX package's `Status`)."""

    CONVERGED = 0
    MAXIMUM_ITERATIONS_REACHED = 1
    SMALL_DELTA = 2
    NUMERIC_ERROR = 3
    FATAL_ERROR = 4


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Solver settings, with the fields and defaults of the JAX package's `LMConfig`."""

    max_iterations: int = 15
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    diff_mode: Any = "auto"  # "auto" | "analytic" | "fd" | per-block tuple
    linear_solver: str = "lu"  # "lu" | "cholesky"
    verbose: bool = False  # print one line per inner trial
    # accept a step with 0 ≤ y0 − yi ≤ tol·|y0| → CONVERGED (0 = off)
    rel_cost_tol: float = 0.0
    # ‖b‖∞ < tol at the start of an outer iteration → CONVERGED (0 = off)
    grad_tol: float = 0.0
    # wider dtype for H, b, costs, the damped solve and λ/ρ; None = x's dtype
    accum_dtype: Any = None
    # record every block's pre-step cost per outer iteration in trace["block_costs"]
    trace_block_costs: bool = False

    def __post_init__(self):
        if self.max_iterations < 0:
            raise ValueError("max_iterations cannot be less than 0.")
        if self.inner_iterations < 1:
            raise ValueError("inner_iterations must be >= 1.")
        if self.linear_solver not in ("lu", "cholesky", "unrolled"):
            raise ValueError(f"unknown linear_solver {self.linear_solver!r}")
        if self.rel_cost_tol < 0 or self.grad_tol < 0:
            raise ValueError("rel_cost_tol/grad_tol must be >= 0.")


@dataclasses.dataclass
class LMResult:
    x: torch.Tensor
    status: torch.Tensor  # int32, a Status value
    iterations: torch.Tensor  # int32, executed outer iterations
    cost: torch.Tensor  # final Σ‖r‖²
    lam: torch.Tensor  # final damping
    trace: dict  # per-outer-iteration records, NaN-filled to max_iterations


def _check_supported(config, manifold):
    if manifold is not None:
        raise NotImplementedError("manifolds are ported with core/manifold.py, a later slice")
    if config.linear_solver == "unrolled":
        raise NotImplementedError(
            'linear_solver="unrolled" is ported with the batched solver, a later slice'
        )


def _solve_damped(H, diag_H, lam, b, method):
    """δ = (H + λ·diag(H))⁻¹(−b). A failed factorization gives a NaN δ, which
    the caller turns into NUMERIC_ERROR through the NaN cost it causes."""
    A = H + lam * torch.diag(diag_H)
    if method == "cholesky":
        L, info = torch.linalg.cholesky_ex(A)
        delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
    else:
        delta, info = torch.linalg.solve_ex(A, -b)
    return torch.where(info != 0, torch.full_like(delta, torch.nan), delta)


def _trace_dtype(config, x):
    return _as_dtype(config.accum_dtype, x.dtype)


def _nan(shape, dtype, device):
    return torch.full(shape, torch.nan, dtype=dtype, device=device)


def _outer_iteration(problem, x, lam, config, manifold=None):
    """One outer LM iteration.

    Returns (problem', x', λ', terminal, status, record): ``terminal`` a
    Python bool, ``status`` a `Status`, the rest tensors on x's device.
    """
    _check_supported(config, manifold)
    dtype = _trace_dtype(config, x)
    dev = x.device
    eps = torch.finfo(dtype).eps
    sqrt_eps = torch.sqrt(torch.tensor(eps, dtype=dtype, device=dev))
    eight_eps = 8 * torch.tensor(eps, dtype=dtype, device=dev)

    problem = problem.update(x)
    y0, H, b = linearize(problem, x, mode=config.diff_mode, accum_dtype=config.accum_dtype)
    diag_H = torch.diagonal(H)

    converged0 = torch.abs(y0) < eight_eps
    if config.grad_tol > 0.0:
        converged0 = converged0 | (torch.max(torch.abs(b)) < config.grad_tol)
    lam = torch.where(lam < 0.0, config.init_lambda_factor * torch.max(torch.abs(diag_H)), lam)
    converged0 = bool(converged0)

    n_inner = config.inner_iterations
    inner_trace = dict(
        cost_new=_nan((n_inner,), dtype, dev),
        rho=_nan((n_inner,), dtype, dev),
        lam=_nan((n_inner,), dtype, dev),
        nu=_nan((n_inner,), dtype, dev),
        accepted=torch.zeros((n_inner,), dtype=torch.bool, device=dev),
    )
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    y = y0
    rho = torch.tensor(torch.nan, dtype=dtype, device=dev)
    status = Status.MAXIMUM_ITERATIONS_REACHED
    terminal = converged0
    accepted = False
    x_out = x

    for k in range(0 if converged0 else n_inner):
        delta = _solve_damped(H, diag_H, lam, b, config.linear_solver)
        xi = x + delta.to(x.dtype)
        yi = compute_cost(problem, xi, accum_dtype=config.accum_dtype)

        rho = (y0 - yi) / torch.dot(delta, lam * delta - b)
        flags = [
            torch.isnan(yi),
            rho < 0.0,  # a NaN ρ falls through to accept
            torch.max(torch.abs(delta)) < sqrt_eps,
            torch.abs(yi) < eight_eps,
        ]
        if config.rel_cost_tol > 0.0:
            flags.append((yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0)))
        flags = torch.stack(flags).tolist()
        is_nan, reject, small, cost_small = flags[:4]

        accept = not is_nan and not reject
        term_small = not is_nan and reject and small
        retry = not is_nan and reject and not small

        if config.verbose:
            print(
                f"[DEBUG] lm inner: {k + 1}/{n_inner} {float(y0)} {float(yi)} "
                f"{float(rho)} {float(lam)} {float(nu)}"
            )

        if is_nan:
            status = Status.NUMERIC_ERROR
        elif term_small:
            status = Status.CONVERGED if cost_small else Status.SMALL_DELTA
        terminal = is_nan or term_small
        # an accepted step that improved the cost by less than tol·|y0|: the
        # solve sits at its noise floor. yi <= y0 keeps a NaN-ρ acceptance of
        # a cost increase from being labelled CONVERGED.
        if config.rel_cost_tol > 0.0 and accept and flags[4]:
            terminal = True
            status = Status.CONVERGED

        inner_trace["cost_new"][k] = yi
        inner_trace["rho"][k] = rho
        inner_trace["lam"][k] = lam
        inner_trace["nu"][k] = nu
        inner_trace["accepted"][k] = accept

        if accept:
            x_out = xi
            gain = torch.maximum(
                torch.tensor(1.0 / 3.0, dtype=dtype, device=dev), 1.0 - (2.0 * rho - 1.0) ** 3
            )
            lam = lam * gain
        elif retry:
            lam = nu * lam
            nu = 2.0 * nu
        if accept or terminal:
            y = yi
        accepted = accept
        if accept or terminal:
            break

    if converged0:
        status = Status.CONVERGED
    record = dict(
        cost=y0,
        cost_new=y,
        rho=rho,
        lam=lam,
        nu=nu,
        accepted=torch.tensor(accepted, device=dev),
        inner=inner_trace,
    )
    if config.trace_block_costs:
        record["block_costs"] = compute_block_costs(problem, x, accum_dtype=config.accum_dtype)
    return problem, x_out, lam, terminal, status, record


def _write_record(trace, it, record):
    for key, value in record.items():
        if isinstance(value, dict):
            _write_record(trace[key], it, value)
        else:
            trace[key][it] = value


def _as_problem(problem):
    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    if len(problem.blocks) == 0:
        raise ValueError("No cost function added!")
    return problem


def levenberg_marquardt(problem, x0, config=LMConfig(), manifold=None):
    """Minimize a Problem (or a single block) from x0; x0 is not modified."""
    problem = _as_problem(problem)
    x = torch.as_tensor(x0)
    dtype = _trace_dtype(config, x)
    dev = x.device
    n_it, n_inner = config.max_iterations, config.inner_iterations
    trace = dict(
        cost=_nan((n_it,), dtype, dev),
        cost_new=_nan((n_it,), dtype, dev),
        rho=_nan((n_it,), dtype, dev),
        lam=_nan((n_it,), dtype, dev),
        nu=_nan((n_it,), dtype, dev),
        accepted=torch.zeros((n_it,), dtype=torch.bool, device=dev),
        inner=dict(
            cost_new=_nan((n_it, n_inner), dtype, dev),
            rho=_nan((n_it, n_inner), dtype, dev),
            lam=_nan((n_it, n_inner), dtype, dev),
            nu=_nan((n_it, n_inner), dtype, dev),
            accepted=torch.zeros((n_it, n_inner), dtype=torch.bool, device=dev),
        ),
    )
    if config.trace_block_costs:
        trace["block_costs"] = _nan((n_it, len(problem.blocks)), dtype, dev)

    lam = torch.tensor(-1.0, dtype=dtype, device=dev)
    status = Status.MAXIMUM_ITERATIONS_REACHED
    it = 0
    while it < n_it:
        problem, x, lam, terminal, status, record = _outer_iteration(
            problem, x, lam, config, manifold
        )
        _write_record(trace, it, record)
        # the terminal iteration is not counted as executed
        if terminal:
            break
        it += 1

    return LMResult(
        x=x,
        status=torch.tensor(int(status), dtype=torch.int32, device=dev),
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        cost=compute_cost(problem, x, accum_dtype=config.accum_dtype),
        lam=lam,
        trace=trace,
    )


def lm_step(problem, x, lam, config=LMConfig(), manifold=None):
    """One outer LM iteration: (problem', x', λ', terminal, status, record).
    Pass λ = −1 on the first call to seed λ from diag(H)."""
    problem = _as_problem(problem)
    x = torch.as_tensor(x)
    lam = torch.as_tensor(lam, dtype=_trace_dtype(config, x), device=x.device)
    return _outer_iteration(problem, x, lam, config, manifold)


def levenberg_marquardt_batched(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=True):
    """Batched solve of B instances; ported with the batched-solver slice."""
    raise NotImplementedError(
        "levenberg_marquardt_batched is ported with the batched solver, a later slice"
    )


def solve_multistart(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=False):
    """Best-of-B multistart; ported with the batched-solver slice."""
    raise NotImplementedError("solve_multistart is ported with the batched solver, a later slice")
