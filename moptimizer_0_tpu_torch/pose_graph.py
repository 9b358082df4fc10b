"""Pose-graph optimization (PGO): LM over a graph of relative-pose constraints.

PyTorch counterpart of ``moptimizer_0_tpu.pose_graph``: N absolute poses
(params6) from E relative-pose edges with 6×6 information matrices.

* per-edge residual r_e = [t, log R] of Z_e⁻¹ · T_i⁻¹ · T_j, and per-edge
  Jacobians (∂r/∂x_i, ∂r/∂x_j) by ``torch.func.jacfwd`` under ``vmap``;
* ``solver="dense"``: the 6N × 6N Gauss-Newton system from the four 6×6
  blocks of every edge and one Cholesky factorization a trial;
  ``solver="cg"``: matrix-free, block-Jacobi-preconditioned CG over the
  per-edge blocks;
* the LM λ/ν/ρ schedule of ``core.solver``, kept branch for branch, as an
  eager Python loop with one host read per outer iteration and per trial.

Every sum over a pose's edges goes through an ``ops.segment_sum`` plan made
once per graph (the edge ends sorted once): no ``index_add_``, whose atomics
sum in no fixed order on the card, so two solves of one graph give the same
bits. ``HOST_READS`` counts the loop's reads of the device.

Gauge: the first ``n_fixed`` poses are held fixed by masking their deltas.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.func import jacfwd, vmap

from moptimizer_0_tpu_torch.core.prior import marginalize as _marginalize
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.ops.segment_sum import segment_plan, segment_sum

# CG iterations between two host reads of the stopping test; the iterations
# in between are masked once the test fails, so x is what a test at every
# iteration gives.
_CG_CHECK = 32

# Reads of the device by the solve loop and the plans (a Python counter).
HOST_READS = 0


def _read(t):
    """t.tolist(), counted in HOST_READS."""
    global HOST_READS
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


def _pgo_cg_solve(graph, system, lam, free_nodes, config, plan):
    """Damped Gauss-Newton step by block-Jacobi-preconditioned CG; returns
    (δ (N, 6), b (6N)). Stops when ‖res‖ ≤ cg_tol or after cg_iterations,
    reading the test every _CG_CHECK iterations."""
    dtype = graph.poses.dtype
    i, j = _ends(graph)
    diag_blocks, b = system["diag_blocks"], system["b"]
    d = torch.diagonal(diag_blocks, dim1=-2, dim2=-1)  # (N, 6)
    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=b.device)
    tol_sq = config.cg_tol**2

    def mv(u):
        base = _pgo_matvec(u, system["H_ii"], system["H_ij"], system["H_jj"], i, j, plan, free_nodes)
        return base + lam * d * (u * free_nodes)

    eye = torch.eye(6, dtype=dtype, device=b.device)
    pre_inv = torch.linalg.inv_ex(diag_blocks + lam * torch.diag_embed(d) + 1e-12 * eye)[0]

    def pre(u):
        return torch.einsum("nij,nj->ni", pre_inv, u) * free_nodes

    rhs = -b * free_nodes
    x = torch.zeros_like(rhs)
    res = rhs
    z = pre(res)
    p = z
    rz = torch.sum(res * z)
    active = torch.sum(res * res) > tol_sq
    for k in range(config.cg_iterations):
        if k % _CG_CHECK == 0 and not _read(active):
            break
        Ap = mv(p)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x_n = x + alpha * p
        res_n = res - alpha * Ap
        z = pre(res_n)
        rz_n = torch.sum(res_n * z)
        beta = rz_n / torch.maximum(rz, tiny)
        p_n = z + beta * p
        x, res, p, rz = (torch.where(active, new, old) for new, old in ((x_n, x), (res_n, res), (p_n, p), (rz_n, rz)))
        active = active & (torch.sum(res * res) > tol_sq)
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


def solve_pgo(graph, config=PGOConfig()):
    """Solve the pose graph from graph.poses; returns a PGOResult.

    outer loop (≤ max_iterations): linearize at the poses; y0 = cost (the
    prior included); |y0| < 8ε → CONVERGED; λ seeded once from max|diag H|;
    ν = 2; up to inner_iterations trials as in ``core.solver`` (NaN cost →
    NUMERIC_ERROR; ρ < 0 with max|δ| < √ε → CONVERGED or SMALL_DELTA, else
    retry with λ ← νλ; otherwise, a NaN ρ included, accept). The terminal
    iteration is not counted."""
    if graph.prior is not None and config.solver == "cg":
        raise ValueError(
            "PGOPrior is supported by the dense solver; use "
            "PGOConfig(solver='dense') (the prior's SᵀS block is dense "
            "across its support, which breaks the edge-block matvec)"
        )
    if config.solver not in ("dense", "cg"):
        raise ValueError(f"unknown PGO solver {config.solver!r}")
    dtype = graph.poses.dtype
    dev = graph.poses.device
    eps = torch.full((), torch.finfo(dtype).eps, dtype=dtype, device=dev)
    sqrt_eps, eight_eps = torch.sqrt(eps), 8 * eps
    third = torch.full((), 1.0 / 3.0, dtype=dtype, device=dev)
    N = graph.poses.shape[0]
    n_it = config.max_iterations
    plan = _EdgePlan(graph)

    free = (torch.arange(6 * N, device=dev) >= 6 * graph.n_fixed).to(dtype)
    free_nodes = free.reshape(N, 6)
    trace = {k: torch.full((n_it,), torch.nan, dtype=dtype, device=dev) for k in ("cost", "lam", "rho")}

    poses = graph.poses
    lam = torch.full((), -1.0, dtype=dtype, device=dev)
    status = Status.MAXIMUM_ITERATIONS_REACHED
    it = 0
    while it < n_it:
        graph_c = dataclasses.replace(graph, poses=poses)
        r, Ji, Jj = _linearize(graph_c)
        # y0 is the same cost functional as the trial cost yi (prior included)
        y0 = compute_cost(graph_c)
        if config.solver == "cg":
            system = _cg_system(graph_c, r, Ji, Jj, plan)
            diag_H = torch.diagonal(system["diag_blocks"], dim1=-2, dim2=-1).reshape(-1) * free
        else:
            H, b = _assemble(graph_c, r, Ji, Jj, plan)
            # gauge: the fixed poses' rows and columns zeroed, identity diagonal
            H = H * free[:, None] * free[None, :]
            H.diagonal().add_(1.0 - free)
            b = b * free
            diag_H = torch.diagonal(H)
        converged0 = torch.abs(y0) < eight_eps
        lam = torch.where(lam < 0.0, config.init_lambda_factor * torch.max(torch.abs(diag_H)), lam)
        converged0 = _read(converged0)

        nu = torch.full((), 2.0, dtype=dtype, device=dev)
        rho = torch.full((), torch.nan, dtype=dtype, device=dev)
        status = Status.MAXIMUM_ITERATIONS_REACHED
        terminal = converged0
        for _ in range(0 if converged0 else config.inner_iterations):
            if config.solver == "cg":
                d_nodes, b_cg = _pgo_cg_solve(graph_c, system, lam, free_nodes, config, plan)
                delta = d_nodes.reshape(-1)
                b_rho = b_cg * free  # the gradient of the ρ denominator
            else:
                delta = _dense_step(H, diag_H, b, lam, free)
                b_rho = b
            poses_i = poses + delta.reshape(N, 6)
            yi = compute_cost(dataclasses.replace(graph, poses=poses_i))
            rho = (y0 - yi) / torch.dot(delta, lam * delta - b_rho)
            flags = [
                torch.isnan(yi),
                rho < 0.0,  # a NaN ρ falls through to accept
                torch.max(torch.abs(delta)) < sqrt_eps,
                torch.abs(yi) < eight_eps,
            ]
            if config.rel_cost_tol > 0.0:
                # yi <= y0 keeps a NaN-ρ acceptance of a rise from CONVERGED
                flags.append((yi <= y0) & ((y0 - yi) <= config.rel_cost_tol * torch.abs(y0)))
            flags = _read(torch.stack(flags))
            is_nan, reject, small, cost_small = flags[:4]
            accept = not is_nan and not reject
            term_small = not is_nan and reject and small
            retry = not is_nan and reject and not small

            if is_nan:
                status = Status.NUMERIC_ERROR
            elif term_small:
                status = Status.CONVERGED if cost_small else Status.SMALL_DELTA
            terminal = is_nan or term_small
            if config.rel_cost_tol > 0.0 and accept and flags[4]:
                terminal = True
                status = Status.CONVERGED
            if accept:
                poses = poses_i
                lam = lam * torch.maximum(third, 1.0 - (2.0 * rho - 1.0) ** 3)
            elif retry:
                lam = nu * lam
                nu = 2.0 * nu
            if accept or is_nan or term_small:
                break
        if converged0:
            status = Status.CONVERGED
        trace["cost"][it] = y0
        trace["lam"][it] = lam
        trace["rho"][it] = rho
        # the terminal iteration is not counted as executed
        if terminal:
            break
        it += 1

    return PGOResult(
        poses=poses,
        status=torch.full((), int(status), dtype=torch.int32, device=dev),
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        cost=compute_cost(dataclasses.replace(graph, poses=poses)),
        trace=trace,
    )
