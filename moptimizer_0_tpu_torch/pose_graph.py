"""Pose-graph optimization (PGO): LM over a graph of relative-pose constraints.

PyTorch counterpart of ``moptimizer_0_tpu.pose_graph``: N absolute poses
(params6) from E relative-pose edges with 6×6 information matrices.

* per-edge residual r_e = [t, log R] of Z_e⁻¹ · T_i⁻¹ · T_j, and per-edge
  Jacobians (∂r/∂x_i, ∂r/∂x_j) by ``torch.func.jacfwd`` under ``vmap``;
* ``solver="dense"``: the 6N × 6N Gauss-Newton system from the four 6×6
  blocks of every edge and one Cholesky factorization a trial;
  ``solver="cg"``: matrix-free, block-Jacobi-preconditioned CG over the
  per-edge blocks;
* the LM λ/ν/ρ schedule of ``core.solver``, kept branch for branch, every
  decision a flag on the device, as in the JAX package's jitted
  ``while_loop``s: each trial runs under ``device_loop.cond(¬stop)`` and
  writes its results in place into tensors made before it, and an outer
  iteration is the body of an ``ops.device_loop.StepLoop``. On CUDA that
  body is captured once per layout (``_layout``: the config, the shapes and
  dtypes, n_fixed, the loss by value, the plan's structure) and a solve is
  max_iterations replays with no host read; its carry holds the poses, λ,
  the graph's data and the edge plan's tensors, which ``start`` copies in,
  so graphs of one layout replay one capture. The dense trial's Cholesky
  and CG's preconditioner inverse run on cuSOLVER there
  (``ops.small_solve.capturable_linalg``). On the CPU, and inside
  ``device_loop.eager()``, the same body runs eagerly.

Every sum over a pose's edges goes through an ``ops.segment_sum`` plan made
once per solve (the edge ends sorted once): no ``index_add_``, whose atomics
sum in no fixed order on the card, so two solves of one graph give the same
bits. ``HOST_READS`` counts the reads of the device by the plans and the
eager loop.

Gauge: the first ``n_fixed`` poses are held fixed by masking their deltas.
"""

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch.func import jacfwd, vmap

from moptimizer_0_tpu_torch.core.prior import marginalize as _marginalize
from moptimizer_0_tpu_torch.core.solver import Status, _loss_key
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.ops.pcg import pcg
from moptimizer_0_tpu_torch.ops.segment_sum import segment_plan, segment_sum
from moptimizer_0_tpu_torch.ops.small_solve import capturable_linalg

# Reads of the device by the solve loop and the plans (a Python counter).
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
class PGOPrior:
    """Gaussian prior factor over a subset of the flat 6N state:
    r = sqrt_info · (x_flat[idx] − x_ref) + offset, the carrier of
    marginalized information (``marginalize_oldest``) and, with n_fixed = 0,
    of the gauge."""

    x_ref: torch.Tensor  # (P',)
    sqrt_info: torch.Tensor  # (P', P')
    offset: torch.Tensor  # (P',)
    idx: torch.Tensor  # (P',) indices into the flat 6N state


@dataclasses.dataclass
class PoseGraph:
    """poses (N, 6) params6; edges i → j with measurement z_ij (params6 of
    the expected T_i⁻¹ T_j) and information (E, 6, 6). ``loss`` weights the
    edges' H and b only; ``prior`` (a PGOPrior) is supported by the dense
    solver, and the loss never applies to it."""

    poses: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    measurements: torch.Tensor
    information: torch.Tensor
    loss: Any = None
    prior: Any = None
    n_fixed: int = 1


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    max_iterations: int = 30
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    solver: str = "dense"  # "dense" (Cholesky on 6N×6N) | "cg" (matrix-free)
    cg_iterations: int = 100
    cg_tol: float = 1e-10
    # accept a step with 0 ≤ y0 − yi ≤ tol·|y0| → CONVERGED (0 = off)
    rel_cost_tol: float = 0.0


@dataclasses.dataclass
class PGOResult:
    poses: torch.Tensor
    status: torch.Tensor  # int32, a Status value
    iterations: torch.Tensor  # int32, executed outer iterations
    cost: torch.Tensor
    trace: dict  # cost, lam, rho per outer iteration, NaN where none ran


def _t_inv(T):
    """Inverse of rigid 4×4 transforms: [Rᵀ, −Rᵀt]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3._assemble_rt(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def _edge_residual(xi, xj, z):
    """r = [t-part, log R] of Z⁻¹ · T_i⁻¹ · T_j (zero iff T_i⁻¹T_j = Z); any
    leading axes."""
    Ti = se3.transform_from_params6(xi)
    Tj = se3.transform_from_params6(xj)
    Z = se3.transform_from_params6(z)
    E = _t_inv(Z) @ (_t_inv(Ti) @ Tj)
    return torch.cat([E[..., :3, 3], so3.log(E[..., :3, :3])], dim=-1)


def _ends(graph):
    return graph.edge_i.long(), graph.edge_j.long()


def residuals_all(graph):
    i, j = _ends(graph)
    return _edge_residual(graph.poses[i], graph.poses[j], graph.measurements)


def _prior_residual(prior, poses):
    x = poses.reshape(-1)[prior.idx.long()]
    return prior.sqrt_info @ (x - prior.x_ref) + prior.offset


def compute_cost(graph):
    """Σ r_eᵀ Ω_e r_e, plus ‖r_prior‖² when a PGOPrior is attached."""
    r = residuals_all(graph)
    cost = torch.sum(torch.einsum("ei,eij,ej->e", r, graph.information.to(r.dtype), r))
    if graph.prior is not None:
        rp = _prior_residual(graph.prior, graph.poses)
        cost = cost + torch.sum(rp * rp)
    return cost


def _linearize(graph):
    """(r, ∂r/∂x_i, ∂r/∂x_j): (E, 6), (E, 6, 6), (E, 6, 6)."""
    i, j = _ends(graph)
    xi, xj, z = graph.poses[i], graph.poses[j], graph.measurements
    if xi.shape[0] == 0:
        return xi.new_zeros(0, 6), xi.new_zeros(0, 6, 6), xi.new_zeros(0, 6, 6)

    def rj(a, b, zz):
        return (_edge_residual(a, b, zz), *jacfwd(_edge_residual, argnums=(0, 1))(a, b, zz))

    return vmap(rj)(xi, xj, z)


class _EdgePlan:
    """Where the edges' blocks sum, made once per graph: ``nodes`` sums an
    (E, q) pair of per-end values into the N poses, ``blocks`` the four 6×6
    blocks of every edge into the distinct (row, column) pose pairs
    ``keys`` (row·N + column, ascending) of the dense H."""

    def __init__(self, graph):
        i, j = _ends(graph)
        N = graph.poses.shape[0]
        ends = torch.cat([i, j])
        self.N = N
        self.nodes = segment_plan(ends, torch.ones_like(ends), N)
        self.keys, pair = torch.unique(torch.cat([i * N + i, i * N + j, j * N + i, j * N + j]), return_inverse=True)
        self.blocks = segment_plan(pair, torch.ones_like(pair), self.keys.shape[0])
        # the plans read 2 values a level, and the unique count once
        global HOST_READS
        HOST_READS += 2 * (len(self.nodes[0]) + len(self.blocks[0])) + 1

    def leaves(self):
        """The plan's device tensors: the node levels' (idx, real), the keys,
        the block levels' (idx, real)."""
        return [t for level in self.nodes[0] for t in level] + [self.keys] + [
            t for level in self.blocks[0] for t in level]

    def with_leaves(self, leaves):
        """This plan's structure with its tensors taken in order from
        ``leaves``."""
        it = iter(leaves)
        plan = copy.copy(self)
        plan.nodes = ([(next(it), next(it)) for _ in self.nodes[0]], self.nodes[1])
        plan.keys = next(it)
        plan.blocks = ([(next(it), next(it)) for _ in self.blocks[0]], self.blocks[1])
        return plan

    def node_sum(self, at_i, at_j):
        """Σ over each pose's edge ends: at_i (E, ...) at edge_i, at_j at
        edge_j → (N, ...)."""
        shape = at_i.shape[1:]
        flat = torch.cat([at_i.reshape(at_i.shape[0], -1), at_j.reshape(at_j.shape[0], -1)])
        return segment_sum(self.nodes, flat).reshape(self.N, *shape)


def _weighted_information(graph, r):
    Om = graph.information.to(graph.poses.dtype)
    if graph.loss is not None:
        # robust weight from the information-weighted squared norm
        sq = torch.einsum("ei,eij,ej->e", r, Om, r)
        Om = graph.loss.weight(sq)[:, None, None] * Om
    return Om


def _edge_blocks(graph, r, Ji, Jj):
    """Per-edge weighted H blocks and b contributions: H_ii, H_ij, H_jj
    (E, 6, 6), b_i, b_j (E, 6)."""
    Om = _weighted_information(graph, r)
    JiW = torch.einsum("eki,ekl->eil", Ji, Om)  # JᵢᵀΩ
    JjW = torch.einsum("eki,ekl->eil", Jj, Om)
    H_ii = torch.einsum("eil,elj->eij", JiW, Ji)
    H_ij = torch.einsum("eil,elj->eij", JiW, Jj)
    H_jj = torch.einsum("eil,elj->eij", JjW, Jj)
    b_i = torch.einsum("eil,el->ei", JiW, r)
    b_j = torch.einsum("eil,el->ei", JjW, r)
    return H_ii, H_ij, H_jj, b_i, b_j


def _assemble(graph, r, Ji, Jj, plan):
    """Dense H (6N, 6N) and b (6N): each pose pair's blocks summed through
    the plan, then written once into H."""
    N = graph.poses.shape[0]
    H_ii, H_ij, H_jj, b_i, b_j = _edge_blocks(graph, r, Ji, Jj)
    blocks = torch.cat([H_ii, H_ij, H_ij.transpose(-1, -2), H_jj]).reshape(-1, 36)
    H = H_ii.new_zeros(N * N, 36)
    H[plan.keys] = segment_sum(plan.blocks, blocks)
    H = H.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    b = plan.node_sum(b_i, b_j).reshape(-1)

    if graph.prior is not None:
        p = graph.prior
        idx = p.idx.long()
        # distinct indices: each entry is written once
        H[idx[:, None], idx[None, :]] += p.sqrt_info.T @ p.sqrt_info
        b[idx] += p.sqrt_info.T @ _prior_residual(p, graph.poses)
    return H, b


def _pgo_matvec(u, H_ii, H_ij, H_jj, edge_i, edge_j, plan, free):
    """H·u over the edge blocks; u (N, 6)."""
    u = u * free
    ui = u[edge_i]
    uj = u[edge_j]
    out_i = torch.einsum("eij,ej->ei", H_ii, ui) + torch.einsum("eij,ej->ei", H_ij, uj)
    out_j = torch.einsum("eji,ej->ei", H_ij, ui) + torch.einsum("eij,ej->ei", H_jj, uj)
    return plan.node_sum(out_i, out_j) * free


def _cg_system(graph, r, Ji, Jj, plan):
    """The CG path's per-outer-iteration system: the edge blocks, b (N, 6)
    and the per-pose diagonal blocks (N, 6, 6)."""
    H_ii, H_ij, H_jj, b_i, b_j = _edge_blocks(graph, r, Ji, Jj)
    return dict(
        H_ii=H_ii, H_ij=H_ij, H_jj=H_jj,
        b=plan.node_sum(b_i, b_j),
        diag_blocks=plan.node_sum(H_ii, H_jj),
    )


def _pgo_cg_solve(graph, system, lam, free_nodes, config, plan, read):
    """Damped Gauss-Newton step by block-Jacobi-preconditioned CG; returns
    (δ (N, 6), b (6N)). Stops when ‖res‖ ≤ cg_tol or after cg_iterations:
    eagerly ``read`` brings the test to the host every ``ops.pcg.CHECK``
    iterations, in a capture each iteration is an IF node on it."""
    dtype = graph.poses.dtype
    i, j = _ends(graph)
    diag_blocks, b = system["diag_blocks"], system["b"]
    d = torch.diagonal(diag_blocks, dim1=-2, dim2=-1)  # (N, 6)

    def mv(u):
        base = _pgo_matvec(u, system["H_ii"], system["H_ij"], system["H_jj"], i, j, plan, free_nodes)
        return base + lam * d * (u * free_nodes)

    eye = torch.eye(6, dtype=dtype, device=b.device)
    pre_inv = torch.linalg.inv_ex(diag_blocks + lam * torch.diag_embed(d) + 1e-12 * eye)[0]

    def pre(u):
        return torch.einsum("nij,nj->ni", pre_inv, u) * free_nodes

    x = pcg(mv, -b * free_nodes, pre, config.cg_iterations, config.cg_tol, read)
    return x, b.reshape(-1)


def marginalize_oldest(graph, n_drop=1, *, fix_weight=1e8, reg=1e-9):
    """Fixed-lag marginalization: drop the oldest n_drop poses.

    The factors adjacent to the dropped poses (their edges, any existing
    prior, and the gauge of dropped fixed poses, carried as a
    fix_weight·(max|diag H_A| + 1)·I absolute prior so the information stays
    finite) are linearized at the current poses and Schur-complemented onto
    the kept poses they touch (``core.prior.marginalize``). Edges between
    kept poses stay nonlinear in the returned graph.

    Host-side (the edge indices partition the factors, in numpy): call it
    between solves. Returns the reduced PoseGraph with poses[n_drop:], the
    kept edges re-indexed, the prior attached, and n_fixed =
    max(n_fixed − n_drop, 0)."""
    dev = graph.poses.device
    ei = graph.edge_i.cpu().numpy()
    ej = graph.edge_j.cpu().numpy()
    absorbed = (ei < n_drop) | (ej < n_drop)
    if not absorbed.any() and graph.prior is None and graph.n_fixed <= 0:
        raise ValueError("nothing connects the dropped poses; just slice them off")

    sel = torch.as_tensor(np.flatnonzero(absorbed), device=dev)
    sub = dataclasses.replace(
        graph,
        edge_i=graph.edge_i[sel],
        edge_j=graph.edge_j[sel],
        measurements=graph.measurements[sel],
        information=graph.information[sel],
        loss=None,  # the prior is a Gaussian; robust weights stay with live edges
    )
    r, Ji, Jj = _linearize(sub)
    H_A, b_A = _assemble(sub, r, Ji, Jj, _EdgePlan(sub))  # graph.prior included

    # the gauge of dropped fixed poses → a finite absolute prior on them
    n_fixed_dropped = min(graph.n_fixed, n_drop)
    if n_fixed_dropped > 0:
        scale = fix_weight * (float(torch.max(torch.abs(torch.diagonal(H_A)))) + 1.0)
        fixed_flat = torch.arange(6 * n_fixed_dropped, device=dev)
        H_A[fixed_flat, fixed_flat] += scale

    # support: kept poses touching absorbed factors (+ the existing prior's)
    touched = {int(p) for p in np.concatenate([ei[absorbed], ej[absorbed]]) if p >= n_drop}
    if graph.prior is not None:
        touched.update(int(f) // 6 for f in graph.prior.idx.cpu().numpy() if int(f) // 6 >= n_drop)
    if graph.n_fixed > n_drop:
        touched.update(range(n_drop, graph.n_fixed))
    support = sorted(touched)
    if not support:
        raise ValueError("dropped poses touch no kept pose — the graph is disconnected")

    # marginalize over the (dropped ∪ support) submatrix only: kept poses
    # outside the support have zero rows in H_A, which would make the
    # marginal square root singular
    drop_flat = np.arange(6 * n_drop)
    supp_flat = np.concatenate([np.arange(6 * p, 6 * p + 6) for p in support])
    sub_idx = torch.as_tensor(np.concatenate([drop_flat, supp_flat]), device=dev)
    H_sub = H_A[sub_idx[:, None], sub_idx[None, :]]
    H_sub = H_sub + reg * torch.eye(sub_idx.shape[0], dtype=H_sub.dtype, device=dev)
    x_sub = graph.poses.reshape(-1)[sub_idx]
    keep_local = torch.arange(len(drop_flat), sub_idx.shape[0], device=dev)
    x_ref, S, off = _marginalize(H_sub, b_A[sub_idx], x_sub, keep_local)

    live = torch.as_tensor(np.flatnonzero(~absorbed), device=dev)
    return dataclasses.replace(
        graph,
        poses=graph.poses[n_drop:],
        edge_i=graph.edge_i[live] - n_drop,
        edge_j=graph.edge_j[live] - n_drop,
        measurements=graph.measurements[live],
        information=graph.information[live],
        prior=PGOPrior(
            x_ref=x_ref, sqrt_info=S, offset=off,
            idx=torch.as_tensor(supp_flat - 6 * n_drop, device=dev),
        ),
        n_fixed=max(graph.n_fixed - n_drop, 0),
    )


def _dense_step(H, diag_H, b, lam, free):
    """δ = (H + λ·diag(H))⁻¹(−b), masked to the free entries; NaN where the
    Cholesky factorization fails (as XLA gives), never an exception."""
    A = H.clone()
    A.diagonal().add_(lam * diag_H)  # H + λ·diag(H) without a second 6N×6N temporary
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
    delta = torch.where(info != 0, torch.full_like(delta, torch.nan), delta)
    return delta * free


def _graph_leaves(graph):
    """The graph's data besides the poses: the edge ends, measurements and
    information, and the prior's x_ref, sqrt_info, offset and idx."""
    leaves = [graph.edge_i, graph.edge_j, graph.measurements, graph.information]
    if graph.prior is not None:
        p = graph.prior
        leaves += [p.x_ref, p.sqrt_info, p.offset, p.idx]
    return leaves


def _with_leaves(graph, poses, leaves):
    """graph at ``poses`` with its data taken in order from ``leaves``."""
    edge_i, edge_j, measurements, information, *prior = leaves
    return dataclasses.replace(
        graph, poses=poses, edge_i=edge_i, edge_j=edge_j, measurements=measurements, information=information,
        prior=PGOPrior(*prior) if prior else None,
    )


def _outer_iteration(graph, lam, config, plan, free, read):
    """One outer LM iteration of ``solve_pgo`` (the JAX package's
    ``outer_body``): (poses′, λ′, terminal, status, record), all tensors on
    the poses' device, ``record`` the iteration's trace row (cost, λ, ρ).
    Each trial runs under ``device_loop.cond(¬stop)`` and writes its
    results in place into tensors made before it; ``read`` is the eager
    loop's read of that flag."""
    dtype, dev = graph.poses.dtype, graph.poses.device
    eps = torch.full((), torch.finfo(dtype).eps, dtype=dtype, device=dev)
    sqrt_eps, eight_eps = torch.sqrt(eps), 8 * eps
    third = torch.full((), 1.0 / 3.0, dtype=dtype, device=dev)
    N = graph.poses.shape[0]
    free_nodes = free.reshape(N, 6)
    poses = graph.poses

    r, Ji, Jj = _linearize(graph)
    # y0 is the same cost functional as the trial cost yi (prior included)
    y0 = compute_cost(graph)
    if config.solver == "cg":
        system = _cg_system(graph, r, Ji, Jj, plan)
        diag_H = torch.diagonal(system["diag_blocks"], dim1=-2, dim2=-1).reshape(-1) * free
    else:
        H, b = _assemble(graph, r, Ji, Jj, plan)
        # gauge: the fixed poses' rows and columns zeroed, identity diagonal
        H = H * free[:, None] * free[None, :]
        H.diagonal().add_(1.0 - free)
        b = b * free
        diag_H = torch.diagonal(H)
    converged0 = torch.abs(y0) < eight_eps
    lam = torch.where(lam < 0.0, config.init_lambda_factor * torch.max(torch.abs(diag_H)), lam)

    s = dict(
        poses=poses.clone(),
        lam=lam.clone(),
        nu=torch.full((), 2.0, dtype=dtype, device=dev),
        rho=torch.full((), torch.nan, dtype=dtype, device=dev),
        status=torch.full((), int(Status.MAXIMUM_ITERATIONS_REACHED), dtype=torch.int32, device=dev),
        stop=converged0.clone(),  # converged before the trials: skip them
        terminal=converged0.clone(),
    )

    def trial():
        lam_k, nu_k = s["lam"], s["nu"]
        if config.solver == "cg":
            d_nodes, b_cg = _pgo_cg_solve(graph, system, lam_k, free_nodes, config, plan, read)
            delta = d_nodes.reshape(-1)
            b_rho = b_cg * free  # the gradient of the ρ denominator
        else:
            delta = _dense_step(H, diag_H, b, lam_k, free)
            b_rho = b
        poses_i = poses + delta.reshape(N, 6)
        yi = compute_cost(dataclasses.replace(graph, poses=poses_i))
        rho = (y0 - yi) / torch.dot(delta, lam_k * delta - b_rho)
        is_nan = torch.isnan(yi)
        reject = rho < 0.0  # a NaN ρ falls through to accept
        small = torch.max(torch.abs(delta)) < sqrt_eps
        accept = ~is_nan & ~reject
        term_small = ~is_nan & reject & small
        retry = ~is_nan & reject & ~small

        status = torch.where(
            is_nan, int(Status.NUMERIC_ERROR),
            torch.where(term_small, torch.where(torch.abs(yi) < eight_eps, int(Status.CONVERGED),
                                                int(Status.SMALL_DELTA)), s["status"]),
        )
        terminal = is_nan | term_small
        if config.rel_cost_tol > 0.0:
            # yi <= y0 keeps a NaN-ρ acceptance of a rise from CONVERGED
            at_floor = accept & (yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0))
            terminal = terminal | at_floor
            status = torch.where(at_floor, int(Status.CONVERGED), status)
        gain = torch.maximum(third, 1.0 - (2.0 * rho - 1.0) ** 3)
        s["poses"].copy_(torch.where(accept, poses_i, s["poses"]))
        s["lam"].copy_(torch.where(accept, lam_k * gain, torch.where(retry, nu_k * lam_k, lam_k)))
        s["nu"].copy_(torch.where(retry, 2.0 * nu_k, nu_k))
        s["rho"].copy_(rho)
        s["status"].copy_(status)
        s["terminal"].copy_(terminal)
        s["stop"].copy_(accept | is_nan | term_small)

    for _ in range(config.inner_iterations):
        if not device_loop.cond(~s["stop"], trial, read):
            break

    status = torch.where(converged0, int(Status.CONVERGED), s["status"]).to(torch.int32)
    return s["poses"], s["lam"], s["terminal"], status, dict(cost=y0, lam=s["lam"], rho=s["rho"])


def _layout(graph, config, plan):
    """The key of a solve's StepLoop, as the JAX package's jit cache keys
    ``solve_pgo`` (shapes, with the config static): the config, the dtype,
    device and shape of the poses, n_fixed, the loss by value, the shapes
    and dtypes of the graph's other data (the prior's P′ among them) and the
    plan's host structure (each level's (n_chunks, w), the distinct pose
    pairs). Two graphs that differ only in their tensors share a key."""
    leaves = _graph_leaves(graph) + plan.leaves()
    return ("pgo", config, graph.poses.dtype, graph.poses.device, tuple(graph.poses.shape), graph.n_fixed,
            _loss_key(graph.loss), graph.prior is not None, len(plan.nodes[0]), len(plan.blocks[0]),
            tuple((tuple(t.shape), t.dtype) for t in leaves))


def _pgo_loop(graph, config, plan):
    """The StepLoop of ``solve_pgo`` on this graph: on CUDA (outside
    ``device_loop.eager()``) captured once per layout (``_layout``) and kept,
    otherwise made anew and run eagerly. Its carry: the poses, λ, the
    graph's data and the plan's tensors, which ``start`` copies in."""
    dtype, dev = graph.poses.dtype, graph.poses.device
    N = graph.poses.shape[0]
    graph_mode = device_loop.graphs(graph.poses)
    n_data = len(_graph_leaves(graph))

    def make():
        free = (torch.arange(6 * N, device=dev) >= 6 * graph.n_fixed).to(dtype)
        # the body reads every tensor from the carry: its closure keeps the
        # graph's and the plan's structure, none of their data
        shell = _with_leaves(graph, None, [None] * n_data)
        plan_shell = plan.with_leaves([None] * len(plan.leaves()))

        def body(poses, lam, *data):
            g = _with_leaves(shell, poses, data[:n_data])
            poses, lam, terminal, status, record = _outer_iteration(
                g, lam, config, plan_shell.with_leaves(data[n_data:]), free, _read)
            return (poses, lam, *data), terminal, status, record

        return device_loop.StepLoop(
            body, _carry(graph, plan), config.max_iterations, dict(cost=dtype, lam=dtype, rho=dtype),
            Status.MAXIMUM_ITERATIONS_REACHED, graph=graph_mode,
            name=f"pgo_step {config.solver} N={N} E={graph.edge_i.shape[0]} {str(dtype).removeprefix('torch.')}",
        )

    if not graph_mode:
        return make()
    with capturable_linalg(dev):  # the routes the capture records
        return device_loop.cached(_layout(graph, config, plan), make)


def _carry(graph, plan):
    lam = torch.full((), -1.0, dtype=graph.poses.dtype, device=graph.poses.device)
    return (graph.poses, lam, *_graph_leaves(graph), *plan.leaves())


def solve_pgo(graph, config=PGOConfig()):
    """Solve the pose graph from graph.poses; returns a PGOResult.

    outer loop (≤ max_iterations): linearize at the poses; y0 = cost (the
    prior included); |y0| < 8ε → CONVERGED; λ seeded once from max|diag H|;
    ν = 2; up to inner_iterations trials as in ``core.solver`` (NaN cost →
    NUMERIC_ERROR; ρ < 0 with max|δ| < √ε → CONVERGED or SMALL_DELTA, else
    retry with λ ← νλ; otherwise, a NaN ρ included, accept). The terminal
    iteration is not counted.

    On CUDA an outer iteration is one replay of a CUDA graph captured once
    per layout (``_layout``): a solve builds its edge plan (2 host reads a
    level, and 1), then enqueues max_iterations replays and reads nothing
    back. On the CPU, and inside ``device_loop.eager()``, the same step runs
    eagerly, reading ¬done once an outer iteration, ¬stop before each trial
    and once more when the trials stopped, and CG's test every 32
    iterations."""
    if graph.prior is not None and config.solver == "cg":
        raise ValueError(
            "PGOPrior is supported by the dense solver; use "
            "PGOConfig(solver='dense') (the prior's SᵀS block is dense "
            "across its support, which breaks the edge-block matvec)"
        )
    if config.solver not in ("dense", "cg"):
        raise ValueError(f"unknown PGO solver {config.solver!r}")
    plan = _EdgePlan(graph)
    loop = _pgo_loop(graph, config, plan)
    loop.start(_carry(graph, plan))
    loop.solve(config.max_iterations, _read)
    poses = loop.carry[0].clone()
    return PGOResult(
        poses=poses,
        status=loop.status.clone(),
        iterations=loop.it.clone(),
        cost=compute_cost(dataclasses.replace(graph, poses=poses)),
        trace={k: v.clone() for k, v in loop.trace.items()},
    )
