"""Levenberg-Marquardt with the reference schedule, as an eager Python loop.

PyTorch counterpart of ``moptimizer_0_tpu.core.solver``:

outer loop (≤ max_iterations):
    data ← update hooks;  (y0, H, b) ← Σ_blocks linearize
    |y0| < 8ε  →  CONVERGED
    λ < 0      →  λ = 1e-9 · max|diag H|        (seeded once, kept across outer iterations)
    ν = 2                                        (reset every outer iteration)
    inner loop (≤ inner_iterations):
        δ  = solve(H + λ·diag(H), −b);  xi = x ⊞ δ;  yi = cost(xi)
        NaN yi → NUMERIC_ERROR
        ρ  = (y0 − yi) / δ·(λδ − b)
        ρ < 0:  max|δ| < √ε → CONVERGED if |yi| < 8ε else SMALL_DELTA
                else λ ← νλ, ν ← 2ν, retry
        else (a NaN ρ included): accept x ← xi, λ ← λ·max(1/3, 1−(2ρ−1)³)
    → MAXIMUM_ITERATIONS_REACHED

With ``manifold=`` (``core.manifold``) the step lives in the tangent space:
H and b come from ``linearize_tangent`` and x ⊞ δ is ``manifold.retract``
(lane by lane in the batched solver); without one, x ⊞ δ = x + δ.

The arithmetic stays in tensors on the device of x; the loop reads one small
vector of flags back to the host per inner trial to decide where to go.
"""

import dataclasses
import enum
from typing import Any

import torch
from torch.func import vmap

from moptimizer_0_tpu_torch.core.linearize import (
    _as_dtype,
    compute_block_costs,
    compute_block_costs_batched,
    compute_cost,
    compute_cost_batched,
    linearize,
    linearize_batched,
    linearize_tangent,
    linearize_tangent_batched,
)
from moptimizer_0_tpu_torch.core.residual import Problem
from moptimizer_0_tpu_torch.ops.small_solve import cholesky_solve_unrolled


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


def _solve_damped(H, diag_H, lam, b, method):
    """δ = (H + λ·diag(H))⁻¹(−b) over any leading lane axes: H (..., P, P),
    λ (...). A failed factorization gives a NaN δ, which the caller turns
    into NUMERIC_ERROR through the NaN cost it causes."""
    A = H + lam[..., None, None] * torch.diag_embed(diag_H)
    if method == "unrolled":
        return cholesky_solve_unrolled(A, -b)
    if method == "cholesky":
        L, info = torch.linalg.cholesky_ex(A)
        delta = torch.cholesky_solve(-b[..., None], L)[..., 0]
    else:
        delta, info = torch.linalg.solve_ex(A, -b)
    return torch.where(info[..., None] != 0, torch.full_like(delta, torch.nan), delta)


def _retract_fn(manifold):
    """manifold.retract with the ``tangent_dim`` that linearize_tangent reads."""
    fn = lambda xx, dd: manifold.retract(xx, dd)  # noqa: E731
    fn.tangent_dim = manifold.tangent_dim
    return fn


def _retract(manifold, x, delta):
    """x ⊞ δ for one state: x + δ without a manifold."""
    return x + delta if manifold is None else manifold.retract(x, delta)


def _linearize_all(problem, x, config, manifold):
    if manifold is None:
        return linearize(problem, x, mode=config.diff_mode, accum_dtype=config.accum_dtype)
    return linearize_tangent(
        problem, x, _retract_fn(manifold), mode=config.diff_mode, accum_dtype=config.accum_dtype
    )


def _trace_dtype(config, x):
    return _as_dtype(config.accum_dtype, x.dtype)


def _nan(shape, dtype, device):
    return torch.full(shape, torch.nan, dtype=dtype, device=device)


def _full(value, dtype, device):
    """A 0-dim tensor of value filled on the device, with no host copy."""
    return torch.full((), value, dtype=dtype, device=device)


def _outer_iteration(problem, x, lam, config, manifold=None):
    """One outer LM iteration.

    Returns (problem', x', λ', terminal, status, record): ``terminal`` a
    Python bool, ``status`` a `Status`, the rest tensors on x's device.
    """
    dtype = _trace_dtype(config, x)
    dev = x.device
    eps = torch.finfo(dtype).eps
    # constants filled on the device: torch.tensor(scalar, device=cuda)
    # copies from pageable host memory and synchronises
    sqrt_eps = torch.sqrt(_full(eps, dtype, dev))
    eight_eps = 8 * _full(eps, dtype, dev)

    problem = problem.update(x)
    y0, H, b = _linearize_all(problem, x, config, manifold)
    diag_H = torch.diagonal(H)

    converged0 = torch.abs(y0) < eight_eps
    if config.grad_tol > 0.0:
        converged0 = converged0 | (torch.max(torch.abs(b)) < config.grad_tol)
    lam = torch.where(lam < 0.0, config.init_lambda_factor * torch.max(torch.abs(diag_H)), lam)
    converged0 = bool(converged0)

    n_inner = config.inner_iterations
    inner_trace = _trial_rows((n_inner,), dtype, dev)
    nu = _full(2.0, dtype, dev)
    y = y0
    rho = _full(torch.nan, dtype, dev)
    status = Status.MAXIMUM_ITERATIONS_REACHED
    terminal = converged0
    accepted = False
    x_out = x

    for k in range(0 if converged0 else n_inner):
        delta = _solve_damped(H, diag_H, lam, b, config.linear_solver)
        xi = _retract(manifold, x, delta.to(x.dtype))
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
            gain = torch.maximum(_full(1.0 / 3.0, dtype, dev), 1.0 - (2.0 * rho - 1.0) ** 3)
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
        accepted=_full(accepted, torch.bool, dev),
        inner=inner_trace,
    )
    if config.trace_block_costs:
        record["block_costs"] = compute_block_costs(problem, x, accum_dtype=config.accum_dtype)
    return problem, x_out, lam, terminal, status, record


def _trial_rows(shape, dtype, dev):
    """NaN-filled per-trial records of the given shape."""
    return dict(
        cost_new=_nan(shape, dtype, dev),
        rho=_nan(shape, dtype, dev),
        lam=_nan(shape, dtype, dev),
        nu=_nan(shape, dtype, dev),
        accepted=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def _new_trace(lanes, config, n_blocks, dtype, dev):
    """The NaN-filled trace: (*lanes, max_iterations) per-iteration records
    and (*lanes, max_iterations, inner_iterations) per-trial ones."""
    n_it, n_inner = config.max_iterations, config.inner_iterations
    trace = dict(
        cost=_nan((*lanes, n_it), dtype, dev),
        **_trial_rows((*lanes, n_it), dtype, dev),
        inner=_trial_rows((*lanes, n_it, n_inner), dtype, dev),
    )
    if config.trace_block_costs:
        trace["block_costs"] = _nan((*lanes, n_it, n_blocks), dtype, dev)
    return trace


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
    n_it = config.max_iterations
    trace = _new_trace((), config, len(problem.blocks), dtype, dev)

    lam = _full(-1.0, dtype, dev)
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
        status=_full(int(status), torch.int32, dev),
        iterations=_full(it, torch.int32, dev),
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


def _lanes(mask, like):
    """A (B,) mask shaped to broadcast against like (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _select(mask, new, old):
    """new where the lane's mask is set, old elsewhere, through dicts."""
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    return torch.where(_lanes(mask, new), new, old)


def _broadcast_lanes(data, B):
    """Shared data given a leading lane axis of size B (a view, no copy)."""
    if isinstance(data, dict):
        return {k: _broadcast_lanes(v, B) for k, v in data.items()}
    return data.expand(B, *data.shape)


def _write_lanes(trace, it, record, active):
    for key, value in record.items():
        if isinstance(value, dict):
            _write_lanes(trace[key], it, value, active)
        else:
            trace[key][:, it] = torch.where(_lanes(active, value), value, trace[key][:, it])


def levenberg_marquardt_batched(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=True):
    """Solve B instances of one problem structure together: x0_batch (B, P).

    Every lane does exactly what ``levenberg_marquardt`` does alone; the
    loop runs with a lane axis, every lane's step is taken, and finished
    lanes (and the data of their blocks) are frozen with ``torch.where``.
    batch_data=True: every data leaf has a leading B; False: the data is
    shared and only x0 varies (multistart). A data=None block is shared.
    Update hooks run once per pass of the outer loop for all lanes together
    (``ResidualBlock.update_batched``); the loop reads the host once per
    pass and once per inner trial for the whole batch, and ends when every
    lane is done.

    Returns an LMResult with a leading B on every field: the trace is
    (B, max_iterations) and (B, max_iterations, inner_iterations).
    """
    problem = _as_problem(problem)
    x = torch.as_tensor(x0_batch)
    B = x.shape[0]
    dtype = _trace_dtype(config, x)
    dev = x.device
    # constants filled on the device: torch.tensor(scalar, device=cuda)
    # copies from pageable host memory and synchronises
    eps = torch.full((), torch.finfo(dtype).eps, dtype=dtype, device=dev)
    sqrt_eps = torch.sqrt(eps)
    eight_eps = 8 * eps
    third = torch.full((), 1.0 / 3.0, dtype=dtype, device=dev)
    n_it, n_inner = config.max_iterations, config.inner_iterations
    adt = config.accum_dtype

    # a block with an update hook gets per-lane data from its first update on
    hooked = tuple(
        blk.update_fn is not None or blk.batch_update_fn is not None for blk in problem.blocks
    )
    if not batch_data:
        problem = Problem(
            blocks=tuple(
                dataclasses.replace(blk, data=_broadcast_lanes(blk.data, B)) if h else blk
                for blk, h in zip(problem.blocks, hooked)
            )
        )
    lane_data = tuple(batch_data or h for h in hooked)

    trace = _new_trace((B,), config, len(problem.blocks), dtype, dev)
    lam = torch.full((B,), -1.0, dtype=dtype, device=dev)
    status = torch.full((B,), int(Status.MAXIMUM_ITERATIONS_REACHED), dtype=torch.int32, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def full(value, dt=dtype):
        return torch.full((B,), value, dtype=dt, device=dev)

    for p in range(n_it):
        active = ~done
        updated = problem.update_batched(x)
        problem = Problem(
            blocks=tuple(
                dataclasses.replace(new, data=_select(active, new.data, old.data)) if h else old
                for new, old, h in zip(updated.blocks, problem.blocks, hooked)
            )
        )
        if manifold is None:
            y0, H, b = linearize_batched(problem, x, config.diff_mode, adt, lane_data)
        else:
            y0, H, b = linearize_tangent_batched(
                problem, x, _retract_fn(manifold), config.diff_mode, adt, lane_data
            )
        diag_H = torch.diagonal(H, dim1=-2, dim2=-1)

        converged0 = torch.abs(y0) < eight_eps
        if config.grad_tol > 0.0:
            converged0 = converged0 | (torch.amax(torch.abs(b), dim=-1) < config.grad_tol)
        seed = config.init_lambda_factor * torch.amax(torch.abs(diag_H), dim=-1)
        lam = torch.where(active & (lam < 0.0), seed, lam)

        inner = _trial_rows((B, n_inner), dtype, dev)
        nu = full(2.0)
        y = y0
        rho = full(torch.nan)
        accepted = full(False, torch.bool)
        lane_status = full(int(Status.MAXIMUM_ITERATIONS_REACHED), torch.int32)
        terminal = converged0
        x_out = x
        running = active & ~converged0
        # the one read of this pass before its trials: is any lane left to try?
        all_done = not bool(running.any())

        for k in range(0 if all_done else n_inner):
            delta = _solve_damped(H, diag_H, lam, b, config.linear_solver)
            if manifold is None:
                xi = x + delta.to(x.dtype)
            else:  # the retraction lane by lane
                xi = vmap(manifold.retract)(x, delta.to(x.dtype))
            yi = compute_cost_batched(problem, xi, adt, lane_data)
            rho_k = (y0 - yi) / torch.sum(delta * (lam[:, None] * delta - b), dim=-1)

            is_nan = running & torch.isnan(yi)
            ok = running & ~torch.isnan(yi)
            reject = rho_k < 0.0  # a NaN ρ falls through to accept
            small = torch.amax(torch.abs(delta), dim=-1) < sqrt_eps
            accept = ok & ~reject
            term_small = ok & reject & small
            retry = ok & reject & ~small

            small_status = torch.where(
                torch.abs(yi) < eight_eps, int(Status.CONVERGED), int(Status.SMALL_DELTA)
            ).to(torch.int32)
            lane_status = torch.where(term_small, small_status, lane_status)
            lane_status = torch.where(is_nan, int(Status.NUMERIC_ERROR), lane_status).to(torch.int32)
            term = is_nan | term_small
            if config.rel_cost_tol > 0.0:
                rel = accept & (yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0))
                term = term | rel
                lane_status = torch.where(rel, int(Status.CONVERGED), lane_status).to(torch.int32)

            if config.verbose:
                print(
                    f"[DEBUG] lm inner (lanes): {k + 1}/{n_inner} {y0.tolist()} {yi.tolist()} "
                    f"{rho_k.tolist()} {lam.tolist()} {nu.tolist()} running {running.tolist()}"
                )

            trial = dict(cost_new=yi, rho=rho_k, lam=lam, nu=nu, accepted=accept)
            for key, value in trial.items():
                inner[key][:, k] = torch.where(running, value, inner[key][:, k])

            x_out = torch.where(accept[:, None], xi, x_out)
            gain = torch.maximum(third, 1.0 - (2.0 * rho_k - 1.0) ** 3)
            lam = torch.where(accept, lam * gain, torch.where(retry, nu * lam, lam))
            nu = torch.where(retry, 2.0 * nu, nu)
            y = torch.where(accept | term, yi, y)
            rho = torch.where(running, rho_k, rho)
            accepted = torch.where(running, accept, accepted)
            terminal = terminal | term
            running = running & ~(accept | term)
            # the trial's one read, for the whole batch
            any_running, all_done = torch.stack([running.any(), (done | terminal).all()]).tolist()
            if not any_running:
                break

        lane_status = torch.where(converged0, int(Status.CONVERGED), lane_status).to(torch.int32)
        record = dict(
            cost=y0, cost_new=y, rho=rho, lam=lam, nu=nu, accepted=accepted, inner=inner
        )
        if config.trace_block_costs:
            record["block_costs"] = compute_block_costs_batched(problem, x, adt, lane_data)
        _write_lanes(trace, p, record, active)
        x = x_out
        status = torch.where(active, lane_status, status)
        # the terminal iteration is not counted as executed
        it = torch.where(active & ~terminal, it + 1, it)
        done = done | terminal
        if all_done:
            break

    return LMResult(
        x=x,
        status=status,
        iterations=it,
        cost=compute_cost_batched(problem, x, adt, lane_data),
        lam=lam,
        trace=trace,
    )


def solve_multistart(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=False):
    """Best-of-B multistart: the B starts solved batched, and the lane with
    the lowest final cost among those not in NUMERIC_ERROR returned as a
    single LMResult; if every lane failed, the lowest raw cost (the caller
    checks ``.status``). Returns (best, the batched LMResult)."""
    res = levenberg_marquardt_batched(problem, x0_batch, config, manifold, batch_data=batch_data)
    bad = res.status == int(Status.NUMERIC_ERROR)
    cost = torch.where(bad, torch.inf, res.cost)
    i = int(torch.argmin(torch.where(bad.all(), res.cost, cost)))

    def pick(value):
        return {k: pick(v) for k, v in value.items()} if isinstance(value, dict) else value[i]

    best = LMResult(**{f.name: pick(getattr(res, f.name)) for f in dataclasses.fields(res)})
    return best, res
