"""Levenberg-Marquardt with the reference schedule, decided on the device.

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

Every decision is a flag on the device, as in the JAX package's jitted
``while_loop``s: each trial runs under ``device_loop.cond(¬stop)`` (a pass
of the batched solver under cond(any lane running)) and writes its results
in place into tensors made before it. An outer iteration is the body of an
``ops.device_loop.StepLoop`` whose carry holds x, λ and every block's data
leaves (the ones the update hooks rewrite, such as ICP's matches, and the
weight matrices), and on CUDA it is one replay of a CUDA graph captured
once per layout: the config, the manifold, each block's functions by
identity, its loss by value, and the shapes, dtypes and device of x and of
the data leaves, which ``start`` copies into the loop's buffers. A solve
enqueues max_iterations replays, each under IF(¬done), and reads nothing
back after the layout's first capture. Eagerly, on the CPU or inside
``device_loop.eager()``, the same body reads the device through the
counted ``_read`` (``HOST_READS``) once before each trial and once an outer
iteration. ``verbose=True`` prints every trial, so it runs the eager body
on the card too. A problem sharded over a mesh (``parallel.sharded``)
whose local shards all lie on x's device and whose reductions are device
work (``Mesh.captures_on``: one process, or processes reducing through
``kernels/mesh_reduce.py`` or ``kernels/nccl_transport.py``) is captured like any other, its shards'
data leaves in the carry and the mesh and every shard's block structure in
the key; every process of a mesh captures and replays its own graph. A
mesh whose process holds several peer cards gets a graph a card
(``device_loop.CardLoops``): card c's step runs over its own shards with x,
λ and the flags replicated in its carry, and reduces through the card
transport (``parallel.mesh``), then, across processes, through its card's link. A
gloo mesh, or cards without peer access both ways, runs the eager body.
A capture records PyTorch's factorizations on cuSOLVER and cuBLAS
(``ops.small_solve.capturable_linalg``); the eager body runs on PyTorch's
default routes, which send a batched Cholesky solve to MAGMA, and equals
the graph bit for bit inside ``capturable_linalg``.
"""

import dataclasses
import enum
import functools
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
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.ops.small_solve import capturable_linalg, cholesky_solve_unrolled
from moptimizer_0_tpu_torch.utils import tracing

# Reads of the device by the LM loops (a Python counter).
HOST_READS = 0


def _read(t):
    """t.tolist(), counted in HOST_READS; raises inside a CUDA-graph
    capture, where the device cannot be read."""
    global HOST_READS
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host read of the device inside a CUDA-graph capture")
    HOST_READS += 1
    return t.tolist()


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


def _lam_dtype(problem, x, config):
    """λ's dtype: the accumulation dtype, or without one x's promoted with
    the problem's floating data, the dtype that H comes out in."""
    dtype = _trace_dtype(config, x)
    if config.accum_dtype is None:
        for b in getattr(problem, "shards", None) or (problem,):
            for leaf in (leaf for blk in b.blocks for leaf in _leaves(blk.data)):
                if leaf.is_floating_point():
                    dtype = torch.promote_types(dtype, leaf.dtype)
    return dtype


def _nan(shape, dtype, device):
    return torch.full(shape, torch.nan, dtype=dtype, device=device)


def _full(value, dtype, device):
    """A 0-dim tensor of value filled on the device, with no host copy."""
    return torch.full((), value, dtype=dtype, device=device)


def _rows(shape, dtype, dev):
    """NaN-filled per-trial records of the given shape."""
    return dict(
        cost_new=_nan(shape, dtype, dev),
        rho=_nan(shape, dtype, dev),
        lam=_nan(shape, dtype, dev),
        nu=_nan(shape, dtype, dev),
        accepted=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def _outer_iteration(problem, x, lam, config, manifold=None, read=None):
    """One outer LM iteration.

    Returns (problem', x', λ', terminal, status, record), all tensors on x's
    device: ``terminal`` a 0-dim bool, ``status`` a 0-dim int32, ``record``
    the iteration's trace row (``inner`` the per-trial (inner_iterations,)
    rows). Each trial runs under ``device_loop.cond(¬stop)``; ``read`` is
    the eager loop's read of that flag.
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

    n_inner = config.inner_iterations
    s = dict(
        x=x.clone(),
        lam=lam.clone(),
        nu=_full(2.0, dtype, dev),
        y=y0.clone(),
        rho=_full(torch.nan, dtype, dev),
        status=_full(int(Status.MAXIMUM_ITERATIONS_REACHED), torch.int32, dev),
        stop=converged0.clone(),  # converged before the trials: skip them
        terminal=converged0.clone(),
        accepted=torch.zeros((), dtype=torch.bool, device=dev),
        inner=_rows((n_inner,), dtype, dev),
    )

    def trial(k):
        lam_k, nu_k = s["lam"], s["nu"]
        delta = _solve_damped(H, diag_H, lam_k, b, config.linear_solver)
        xi = _retract(manifold, x, delta.to(x.dtype))
        yi = compute_cost(problem, xi, accum_dtype=config.accum_dtype)

        rho = (y0 - yi) / torch.dot(delta, lam_k * delta - b)
        is_nan = torch.isnan(yi)
        reject = rho < 0.0  # a NaN ρ falls through to accept
        small = torch.max(torch.abs(delta)) < sqrt_eps
        accept = ~is_nan & ~reject
        term_small = ~is_nan & reject & small
        retry = ~is_nan & reject & ~small

        if config.verbose:
            print(
                f"[DEBUG] lm inner: {k + 1}/{n_inner} {float(y0)} {float(yi)} "
                f"{float(rho)} {float(lam_k)} {float(nu_k)}"
            )

        converged = torch.abs(yi) < eight_eps
        status = torch.where(
            is_nan, int(Status.NUMERIC_ERROR),
            torch.where(term_small, torch.where(converged, int(Status.CONVERGED), int(Status.SMALL_DELTA)),
                        s["status"]),
        )
        terminal = is_nan | term_small
        if config.rel_cost_tol > 0.0:
            # an accepted step that improved the cost by less than tol·|y0|:
            # the solve sits at its noise floor. yi <= y0 keeps a NaN-ρ
            # acceptance of a cost increase from being labelled CONVERGED.
            at_floor = accept & (yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0))
            terminal = terminal | at_floor
            status = torch.where(at_floor, int(Status.CONVERGED), status)

        # the trial's slot: λ and ν as this trial used them
        for key, value in dict(cost_new=yi, rho=rho, lam=lam_k, nu=nu_k, accepted=accept).items():
            s["inner"][key][k].copy_(value)
        gain = torch.maximum(_full(1.0 / 3.0, dtype, dev), 1.0 - (2.0 * rho - 1.0) ** 3)
        moved = accept | terminal
        s["x"].copy_(torch.where(accept, xi, s["x"]))
        s["lam"].copy_(torch.where(accept, lam_k * gain, torch.where(retry, nu_k * lam_k, lam_k)))
        s["nu"].copy_(torch.where(retry, 2.0 * nu_k, nu_k))
        s["y"].copy_(torch.where(moved, yi, s["y"]))
        s["rho"].copy_(rho)
        s["status"].copy_(status)
        s["terminal"].copy_(terminal)
        s["accepted"].copy_(accept)
        s["stop"].copy_(moved)

    for k in range(n_inner):
        if not device_loop.cond(~s["stop"], functools.partial(trial, k), read):
            break

    status = torch.where(converged0, int(Status.CONVERGED), s["status"]).to(torch.int32)
    record = dict(
        cost=y0, cost_new=s["y"], rho=s["rho"], lam=s["lam"], nu=s["nu"], accepted=s["accepted"],
        inner=s["inner"],
    )
    if config.trace_block_costs:
        record["block_costs"] = compute_block_costs(problem, x, accum_dtype=config.accum_dtype)
    return problem, s["x"], s["lam"], s["terminal"], status, record


def _as_problem(problem):
    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    if len(problem.blocks) == 0:
        raise ValueError("No cost function added!")
    return problem


def _sharded(problem):
    """Whether the problem's rows are sharded over a mesh
    (``parallel.sharded.ShardedProblem``)."""
    return getattr(problem, "over_shards", None) is not None


def _on_device(problem, x):
    """The problem with each weight matrix a tensor on x's device (a sharded
    problem's on each shard's device), made once a solve: linearize converts
    it to its dtype there, with no host copy, and it rides in the carry."""
    if _sharded(problem):
        return dataclasses.replace(problem, shards=tuple(
            _weights_on(p, dev) for p, dev in zip(problem.shards, problem.mesh.devices)))
    return _weights_on(problem, x.device)


def _weights_on(problem, device):
    return Problem(blocks=tuple(
        b if b.weight_matrix is None
        else dataclasses.replace(b, weight_matrix=torch.as_tensor(b.weight_matrix, device=device))
        for b in problem.blocks
    ))


# A block's data: a tensor, None, or dicts, tuples and lists of them.

def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def _refill(tree, leaves):
    """tree with its tensors taken in order from the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_refill(v, leaves) for v in tree)
    return tree


def _structure(tree):
    """The layout of a tree: its containers, and each tensor's shape, dtype
    and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return (dict, tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_structure(v) for v in tree))
    return device_loop.key_part(tree)


def _block_tree(block):
    return (block.data, block.weight_matrix)


def _data_leaves(problem):
    """Every data leaf and weight matrix of the problem's blocks (of every
    shard's blocks, for a sharded problem)."""
    shards = getattr(problem, "shards", None)
    if shards:
        return [leaf for p in shards for leaf in _data_leaves(p)]
    return [leaf for b in problem.blocks for leaf in _leaves(_block_tree(b))]


def _with_data(problem, leaves):
    """The problem with its data leaves taken in order from ``leaves``."""
    it = iter(leaves)

    def refill(p):
        shards = getattr(p, "shards", None)
        if shards:
            return dataclasses.replace(p, shards=tuple(refill(q) for q in shards))
        blocks = []
        for b in p.blocks:
            data, weight_matrix = _refill(_block_tree(b), it)
            blocks.append(dataclasses.replace(b, data=data, weight_matrix=weight_matrix))
        return dataclasses.replace(p, blocks=tuple(blocks))

    return refill(problem)


def _loss_key(loss):
    """A loss by value: its type and parameters (a tensor parameter by
    identity). Its parameters are filled into the captured step."""
    if dataclasses.is_dataclass(loss):
        return (type(loss),) + tuple(device_loop.key_part(getattr(loss, f.name)) for f in dataclasses.fields(loss))
    return device_loop.key_part(loss)


_BLOCK_FUNCTIONS = ("residual_fn", "prepare_fn", "jacobian_fn", "update_fn", "linearize_fn", "weight_fn",
                    "batch_update_fn")


def _blocks_key(blocks):
    return tuple(
        (*(getattr(b, f) for f in _BLOCK_FUNCTIONS), b.weighted_cost, _loss_key(b.loss),
         _structure(_block_tree(b)))
        for b in blocks
    )


def _layout(kind, problem, x, config, manifold, *extra):
    """The key of a solve's StepLoop, as the JAX package's jit cache keys its
    program: the kind of loop, the config, the manifold, each block's
    functions by identity, its loss by value and the layout of its data,
    and x's shape, dtype and device; of a sharded problem also the mesh
    (its shards and devices) and every shard's blocks so, as jit keys the
    shardings of its inputs."""
    key = (kind, config, manifold, tuple(x.shape), x.dtype, x.device, *extra, _blocks_key(problem.blocks))
    if _sharded(problem):
        key += (problem.mesh.layout(), tuple(_blocks_key(p.blocks) for p in problem.shards))
    return key


def _flat(record, prefix=""):
    """A record with its ``inner`` dict flattened to "inner/<name>" keys."""
    out = {}
    for k, v in record.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nested(flat):
    out = {}
    for k, v in flat.items():
        if "/" in k:
            outer, inner = k.split("/", 1)
            out.setdefault(outer, {})[inner] = v
        else:
            out[k] = v
    return out


def _record_spec(config, n_blocks, dtype, lanes=()):
    """The names, dtypes and shapes of an outer iteration's record."""
    scalar = dict(cost=dtype, cost_new=dtype, rho=dtype, lam=dtype, nu=dtype, accepted=torch.bool)
    spec = {k: (dt, lanes) for k, dt in scalar.items()}
    for k, dt in scalar.items():
        if k != "cost":
            spec[f"inner/{k}"] = (dt, (*lanes, config.inner_iterations))
    if config.trace_block_costs:
        spec["block_costs"] = (dtype, (*lanes, n_blocks))
    return spec


def _graphs(problem, x, config):
    """Whether this solve's step is a CUDA graph: on the card, outside
    ``device_loop.eager()``, unless it prints every trial or its problem is
    sharded over a mesh that cannot capture on x's device
    (``Mesh.captures_on``)."""
    return (device_loop.graphs(x) and not config.verbose
            and (not _sharded(problem) or problem.mesh.captures_on(x.device)))


def _single_loop(problem, x, config, manifold):
    """The StepLoop of ``levenberg_marquardt`` and ``lm_step`` on this
    problem: cached per layout when its step is a graph, made anew (eager)
    otherwise. Its carry: x, λ and the problem's data leaves. A problem
    sharded over a process's several cards gets a ``device_loop.CardLoops``
    of a graph a card, each card's carry x, λ and its shards' leaves."""
    dtype, dev = _trace_dtype(config, x), x.device
    graph = _graphs(problem, x, config)
    mesh = problem.mesh if _sharded(problem) else None
    name = f"lm_step P={x.shape[0]}" + (f" shards={mesh.size}" if mesh is not None else "")

    def make_loop(view, carry, capture):
        prob = problem if view is mesh else problem.on(view)

        def body(x, lam, *data):
            prob_i, x, lam, terminal, status, record = _outer_iteration(
                _with_data(prob, data), x, lam, config, manifold, _read
            )
            return (x, lam, *_data_leaves(prob_i)), terminal, status, _flat(record)

        return device_loop.StepLoop(
            body, carry, config.max_iterations, _record_spec(config, len(problem.blocks), dtype),
            Status.MAXIMUM_ITERATIONS_REACHED, graph=capture, context=problem, name=name,
        )

    def make():
        carry = (x, _full(-1.0, _lam_dtype(problem, x, config), dev), *_data_leaves(problem))
        shard_of = (None, None, *(j for j, p in enumerate(problem.shards) for _ in _data_leaves(p))) if mesh else ()
        return device_loop.card_loops(mesh, graph, make_loop, carry, shard_of, name, context=problem)

    if not graph:
        return make()
    with capturable_linalg(dev):  # the routes the capture records
        return device_loop.cached(_layout("lm", problem, x, config, manifold), make)


def _trace_of(loop):
    return _nested({k: v.clone() for k, v in loop.trace.items()})


def levenberg_marquardt(problem, x0, config=LMConfig(), manifold=None):
    """Minimize a Problem (or a single block) from x0; x0 is not modified.

    On CUDA the solve is max_iterations replays of its step's graph, with no
    host read after the first solve of its layout (module docstring), a
    problem sharded over a mesh that captures on x's device included; on
    the CPU, inside ``device_loop.eager()``, with ``verbose=True`` (which
    prints every trial from the host) or for a problem sharded over a gloo
    mesh or over cards without peer access the same step runs eagerly. A
    problem sharded over a process's several cards replays a graph a card
    and returns on the first shard's card. A sharded solve ends with
    ``Mesh.check``. The solve is the span ``lm``, its result's assembly the
    span ``result`` (``utils.tracing``)."""
    with tracing.span("lm"):
        problem = _as_problem(problem)
        x = torch.as_tensor(x0)
        problem = _on_device(problem, x)
        loop = _single_loop(problem, x, config, manifold)
        loop.start((x, -1.0, *_data_leaves(problem)))
        loop.solve(config.max_iterations, _read)
        with tracing.span("result"):
            x, lam, *data = (t.clone() for t in loop.carry)
            result = LMResult(
                x=x,
                status=loop.status.clone(),
                iterations=loop.it.clone(),
                cost=compute_cost(_with_data(loop.context, data), x, accum_dtype=config.accum_dtype),
                lam=lam,
                trace=_trace_of(loop),
            )
            _check_mesh(problem)
        return result


def _check_mesh(problem):
    """``Mesh.check`` of a sharded problem's mesh: raises if a device
    all-reduce gave up on a peer."""
    if _sharded(problem):
        problem.mesh.check()


def lm_step(problem, x, lam, config=LMConfig(), manifold=None):
    """One outer LM iteration: (problem', x', λ', terminal, status, record),
    ``terminal`` a 0-dim bool and ``status`` a 0-dim int32 tensor, as the
    JAX package's jitted step returns them. Pass λ = −1 on the first call to
    seed λ from diag(H). On CUDA one replay of the step's graph (the one
    ``levenberg_marquardt`` captures for this layout)."""
    problem = _as_problem(problem)
    x = torch.as_tensor(x)
    problem = _on_device(problem, x)
    dtype = _lam_dtype(problem, x, config)
    lam = lam.to(dtype=dtype, device=x.device) if isinstance(lam, torch.Tensor) else _full(float(lam), dtype, x.device)
    loop = _single_loop(problem, x, config, manifold)
    loop.start((x, lam, *_data_leaves(problem)))
    loop.step(_read)
    (x, lam, *data), terminal, status, record = loop.outputs()
    _check_mesh(problem)
    return _with_data(problem, data), x, lam, terminal, status, _nested(record)


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


def _fill_like(v):
    return torch.full_like(v, torch.nan) if v.is_floating_point() else torch.zeros_like(v)


def _batched_pass(problem, x, lam, status, it, done, config, manifold, hooked, lane_data, read=None):
    """One pass of the batched outer loop over lanes x (B, P).

    Every lane not done does what ``_outer_iteration`` does alone; a done
    lane, and the data of its blocks, stay as they were. Returns (problem',
    x', λ', status', it', done', record): status, it (executed iterations)
    and done per lane, the record (B, ...) with the fill of an untouched
    trace row (NaN, False) in done lanes. The trials run under
    ``device_loop.cond(any lane running)``; ``read`` is the eager loop's
    read of that flag."""
    B = x.shape[0]
    dtype = _trace_dtype(config, x)
    dev = x.device
    eps = _full(torch.finfo(dtype).eps, dtype, dev)
    sqrt_eps = torch.sqrt(eps)
    eight_eps = 8 * eps
    third = _full(1.0 / 3.0, dtype, dev)
    n_inner = config.inner_iterations
    adt = config.accum_dtype

    def full(value, dt=dtype):
        return torch.full((B,), value, dtype=dt, device=dev)

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
        y0, H, b = linearize_tangent_batched(problem, x, _retract_fn(manifold), config.diff_mode, adt, lane_data)
    diag_H = torch.diagonal(H, dim1=-2, dim2=-1)

    converged0 = torch.abs(y0) < eight_eps
    if config.grad_tol > 0.0:
        converged0 = converged0 | (torch.amax(torch.abs(b), dim=-1) < config.grad_tol)
    seed = config.init_lambda_factor * torch.amax(torch.abs(diag_H), dim=-1)
    lam = torch.where(active & (lam < 0.0), seed, lam)

    running = active & ~converged0
    s = dict(
        x=x.clone(),
        lam=lam.clone(),
        nu=full(2.0),
        y=y0.clone(),
        rho=full(torch.nan),
        accepted=full(False, torch.bool),
        status=full(int(Status.MAXIMUM_ITERATIONS_REACHED), torch.int32),
        terminal=converged0.clone(),
        running=running,
        any=running.any(),  # is any lane left to try?
        inner=_rows((B, n_inner), dtype, dev),
    )

    def trial(k):
        running, lam_k, nu_k = s["running"], s["lam"], s["nu"]
        delta = _solve_damped(H, diag_H, lam_k, b, config.linear_solver)
        if manifold is None:
            xi = x + delta.to(x.dtype)
        else:  # the retraction lane by lane
            xi = vmap(manifold.retract)(x, delta.to(x.dtype))
        yi = compute_cost_batched(problem, xi, adt, lane_data)
        rho_k = (y0 - yi) / torch.sum(delta * (lam_k[:, None] * delta - b), dim=-1)

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
        lane_status = torch.where(term_small, small_status, s["status"])
        lane_status = torch.where(is_nan, int(Status.NUMERIC_ERROR), lane_status).to(torch.int32)
        term = is_nan | term_small
        if config.rel_cost_tol > 0.0:
            rel = accept & (yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0))
            term = term | rel
            lane_status = torch.where(rel, int(Status.CONVERGED), lane_status).to(torch.int32)

        if config.verbose:
            print(
                f"[DEBUG] lm inner (lanes): {k + 1}/{n_inner} {y0.tolist()} {yi.tolist()} "
                f"{rho_k.tolist()} {lam_k.tolist()} {nu_k.tolist()} running {running.tolist()}"
            )

        for key, value in dict(cost_new=yi, rho=rho_k, lam=lam_k, nu=nu_k, accepted=accept).items():
            slot = s["inner"][key][:, k]
            slot.copy_(torch.where(running, value, slot))

        gain = torch.maximum(third, 1.0 - (2.0 * rho_k - 1.0) ** 3)
        s["x"].copy_(torch.where(accept[:, None], xi, s["x"]))
        s["lam"].copy_(torch.where(accept, lam_k * gain, torch.where(retry, nu_k * lam_k, lam_k)))
        s["nu"].copy_(torch.where(retry, 2.0 * nu_k, nu_k))
        s["y"].copy_(torch.where(accept | term, yi, s["y"]))
        s["rho"].copy_(torch.where(running, rho_k, s["rho"]))
        s["accepted"].copy_(torch.where(running, accept, s["accepted"]))
        s["status"].copy_(lane_status)
        s["terminal"].copy_(s["terminal"] | term)
        left = running & ~(accept | term)
        s["running"].copy_(left)
        s["any"].copy_(left.any())

    for k in range(n_inner):
        if not device_loop.cond(s["any"], functools.partial(trial, k), read):
            break

    lane_status = torch.where(converged0, int(Status.CONVERGED), s["status"]).to(torch.int32)
    record = dict(
        cost=y0, cost_new=s["y"], rho=s["rho"], lam=s["lam"], nu=s["nu"], accepted=s["accepted"],
        inner=s["inner"],
    )
    if config.trace_block_costs:
        record["block_costs"] = compute_block_costs_batched(problem, x, adt, lane_data)
    record = {k: torch.where(_lanes(active, v), v, _fill_like(v)) for k, v in _flat(record).items()}
    terminal = s["terminal"]
    return (
        problem,
        s["x"],
        s["lam"],
        torch.where(active, lane_status, status),
        # the terminal iteration is not counted as executed
        torch.where(active & ~terminal, it + 1, it),
        done | terminal,
        record,
    )


def _batched_loop(problem, x, config, manifold, hooked, lane_data, batch_data):
    """The StepLoop of ``levenberg_marquardt_batched``: one pass an
    iteration, terminal when every lane is done. Its carry: x, λ, each
    lane's status, executed iterations and done, and the data leaves."""
    B = x.shape[0]
    dtype, dev = _trace_dtype(config, x), x.device
    graph = _graphs(problem, x, config)

    def make():
        def body(x, lam, status, it, done, *data):
            prob, *lanes, record = _batched_pass(
                _with_data(problem, data), x, lam, status, it, done, config, manifold, hooked, lane_data, _read
            )
            done = lanes[-1]
            return ((*lanes, *_data_leaves(prob)), done.all(),
                    _full(int(Status.MAXIMUM_ITERATIONS_REACHED), torch.int32, dev), record)

        carry = (
            x,
            torch.full((B,), -1.0, dtype=_lam_dtype(problem, x, config), device=dev),
            torch.full((B,), int(Status.MAXIMUM_ITERATIONS_REACHED), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            *_data_leaves(problem),
        )
        return device_loop.StepLoop(
            body, carry, config.max_iterations, _record_spec(config, len(problem.blocks), dtype, (B,)),
            Status.MAXIMUM_ITERATIONS_REACHED, graph=graph, name=f"lm_pass B={B} P={x.shape[1]}",
            context=problem, lanes=1,
        )

    if not graph:
        return make()
    with capturable_linalg(dev):  # the routes the capture records
        return device_loop.cached(_layout("lm_batched", problem, x, config, manifold, batch_data), make)


def levenberg_marquardt_batched(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=True):
    """Solve B instances of one problem structure together: x0_batch (B, P).

    Every lane does exactly what ``levenberg_marquardt`` does alone; the
    loop runs with a lane axis, every lane's step is taken, and finished
    lanes (and the data of their blocks) are frozen with ``torch.where``.
    batch_data=True: every data leaf has a leading B; False: the data is
    shared and only x0 varies (multistart). A data=None block is shared.
    Update hooks run once per pass of the outer loop for all lanes together
    (``ResidualBlock.update_batched``). "Any lane running" and "every lane
    done" are flags on the device: on CUDA a pass is one replay of a graph
    captured once per layout and a solve reads nothing back after it; the
    eager loop (the CPU, ``device_loop.eager()``, ``verbose=True``) reads
    the device once before each trial and once a pass.

    Returns an LMResult with a leading B on every field: the trace is
    (B, max_iterations) and (B, max_iterations, inner_iterations). The solve
    is the span ``lm_batched``, its result's assembly the span ``result``
    (``utils.tracing``).
    """
    with tracing.span("lm_batched"):
        problem = _as_problem(problem)
        x = torch.as_tensor(x0_batch)
        problem = _on_device(problem, x)
        B = x.shape[0]

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

        loop = _batched_loop(problem, x, config, manifold, hooked, lane_data, batch_data)
        loop.start((x, -1.0, int(Status.MAXIMUM_ITERATIONS_REACHED), 0, False, *_data_leaves(problem)))
        loop.solve(config.max_iterations, _read)
        with tracing.span("result"):
            x, lam, status, it, _, *data = (t.clone() for t in loop.carry)
            return LMResult(
                x=x,
                status=status,
                iterations=it,
                cost=compute_cost_batched(_with_data(loop.context, data), x, config.accum_dtype, lane_data),
                lam=lam,
                trace=_trace_of(loop),
            )


def solve_multistart(problem, x0_batch, config=LMConfig(), manifold=None, batch_data=False):
    """Best-of-B multistart: the B starts solved batched, and the lane with
    the lowest final cost among those not in NUMERIC_ERROR returned as a
    single LMResult; if every lane failed, the lowest raw cost (the caller
    checks ``.status``). The lane is picked on the device. Returns (best,
    the batched LMResult)."""
    res = levenberg_marquardt_batched(problem, x0_batch, config, manifold, batch_data=batch_data)
    bad = res.status == int(Status.NUMERIC_ERROR)
    cost = torch.where(bad, torch.inf, res.cost)
    i = torch.argmin(torch.where(bad.all(), res.cost, cost)).reshape(1)

    def pick(value):
        if isinstance(value, dict):
            return {k: pick(v) for k, v in value.items()}
        return torch.index_select(value, 0, i)[0]

    best = LMResult(**{f.name: pick(getattr(res, f.name)) for f in dataclasses.fields(res)})
    return best, res
