"""Self-calibrating bundle adjustment: cameras, landmarks and the shared
intrinsics θ = [fx, fy, cx, cy] refined together.

PyTorch counterpart of ``moptimizer_0_tpu.ba_intrinsics``. After the
landmarks are eliminated the reduced system covers 6C + 4 unknowns:

    [ S_cc  S_cθ ] [δc]   [ r_c ]        S_cc = U′ − W V′⁻¹ Wᵀ
    [ S_cθᵀ S_θθ ] [δθ] = [ r_θ ],       S_cθ = P − W V′⁻¹ Y
                                         S_θθ = Z′ − Yᵀ V′⁻¹ Y

with K_o = ∂r/∂θ (2,4) per observation, P = Σ_c AᵀK, Y_l = Σ_{o∈l} BᵀK and
Z = Σ KᵀK, all summed through the engine's ``ops.segment_sum`` plans and
solved matrix-free by the same preconditioned CG, then δl back-substituted
with the extra −Y δθ term. The LM trials are ``ba._lm_trials_tree`` over
(cameras, landmarks, intrinsics), each trial under ``device_loop.cond``:
on CUDA an outer iteration of an unsharded problem is one replay of a CUDA
graph in which a trial after the one that ends the iteration is skipped on
the device, where the JAX package computes every trial and masks the ones
after it; eagerly the loop stops there.

Observation sharding is the CG engine's (``ba`` module docstring): with
``cam_idx``, ``pt_idx`` and ``pixels`` given as ``GlobalArray``s, each local
shard keeps its rows, plans and W; U, V, P, Y, Z, g, h, g_t and the costs
are summed over the mesh in one ``Mesh.psum``, and each PCG iteration's
matvec makes the CG engine's two reductions, Σ Wᵀu_c (L, 3) and Σ W s
(C, 6). The θ terms of the matvec sum the replicated P, Y and Z over
cameras and landmarks, so they need no reduction of their own. The JAX
package runs the same solve under GSPMD and refuses only a row count the
mesh does not divide; so does this. The unsharded solve is the one-shard
case, and a sharded step is a CUDA graph where the CG engine's is (its
mesh captures on the cameras' device, ``Mesh.captures_on``; a graph a card
over a process's several peer cards).
"""

import dataclasses

import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.ops.pcg import pcg
from moptimizer_0_tpu_torch.ops.segment_sum import segment_sum


def _linearize_full(problem):
    """(r, A (O,2,6), B (O,2,3), K (O,2,4)) with the intrinsics Jacobian K."""
    return ba._flat(problem, problem.camera_params, problem.points, jacobians=True, intrinsics=True)


def _gn_blocks_full(problem, r, A, B, K, plans):
    """U, V, W, P (C,6,4), Y (L,3,4), Z (4,4), g, h and g_θ (4,)."""
    cam, pt = plans
    Aw, Bw, Kw, rw = ba._irls(problem, r, A, B, K)
    C, L = problem.camera_params.shape[0], problem.points.shape[0]
    U = segment_sum(cam, ba._outer_rows(Aw, A).reshape(-1, 36)).reshape(C, 6, 6)
    V = segment_sum(pt, ba._outer_rows(Bw, B).reshape(-1, 9)).reshape(L, 3, 3)
    W = ba._outer_rows(Aw, B)
    P = segment_sum(cam, ba._outer_rows(Aw, K).reshape(-1, 24)).reshape(C, 6, 4)
    Y = segment_sum(pt, ba._outer_rows(Bw, K).reshape(-1, 12)).reshape(L, 3, 4)
    Z = torch.sum(ba._outer_rows(Kw, K), dim=0)
    g = segment_sum(cam, ba._rows_dot(A, rw))
    h = segment_sum(pt, ba._rows_dot(B, rw))
    g_t = torch.sum(ba._rows_dot(K, rw), dim=0)
    return U, V, W, P, Y, Z, g, h, g_t


def _linearize_shards_full(mesh, shards, plans, params):
    """Each shard's rows linearized at params = (cams, pts, θ): (rows,
    (U, V, P, Y, Z, g, h, g_t, y0)), rows holding each local shard's
    (problem, plans, W) and the blocks and the cost summed over the mesh on
    cams' device."""
    rows, parts = [], []
    for shard, plan in zip(shards, plans):
        s = ba._at(shard, *params)
        r, A, B, K = _linearize_full(s)
        U, V, W, P, Y, Z, g, h, g_t = _gn_blocks_full(s, r, A, B, K, plan)
        rows.append((s, plan, W))
        parts.append((U, V, P, Y, Z, g, h, g_t, torch.sum(r * r)))
    return rows, mesh.psum(parts, device=params[0].device)


def _solve_delta_full(problem, blocks, lam, config, mesh, rows):
    """Damped Schur solve over (cams, θ): (δcam, δpt, δθ). blocks: the
    mesh's sums (U, V, P, Y, Z, g, h, g_t); rows: each local shard's
    (problem, plans, W)."""
    U, V, P, Y, Z, g, h, g_t = blocks
    C = problem.camera_params.shape[0]
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    bmv = ba._bmv

    U_d = ba._damp_blocks(U, lam)
    Z_d = ba._damp_blocks(Z, lam)
    Vinv = ba._inv3x3(ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=dtype, device=dev))
    cam_mask = ba._cam_mask(problem)

    def pack(u_c, u_t):
        return torch.cat([u_c.reshape(-1), u_t])

    def unpack(u):
        return u[: 6 * C].reshape(C, 6), u[6 * C :]

    def matvec(u):
        u_c, u_t = unpack(u)
        u_c = u_c * cam_mask
        out_c = bmv(U_d, u_c) + torch.sum(P * u_t, dim=-1)
        out_t = torch.sum(P * u_c[:, :, None], dim=(0, 1)) + Z_d @ u_t
        # landmark elimination: s_l = V′⁻¹ (Wᵀu_c + Y u_t) per landmark
        s = bmv(Vinv, ba._to_landmarks(mesh, rows, u_c, dev) + torch.sum(Y * u_t, dim=-1))
        out_c = out_c - ba._to_cameras(mesh, rows, s, dev)
        out_t = out_t - torch.sum(Y * s[:, :, None], dim=(0, 1))
        return pack(out_c * cam_mask, out_t)

    t0 = bmv(Vinv, h)
    r_c = -(g - ba._to_cameras(mesh, rows, t0, dev)) * cam_mask
    r_t = -(g_t - torch.sum(Y * t0[:, :, None], dim=(0, 1)))

    # the block-Jacobi preconditioner: U′ blocks and the Z′ block
    U_inv = torch.linalg.inv_ex(U_d + 1e-12 * torch.eye(6, dtype=dtype, device=dev))[0]
    Z_inv = torch.linalg.inv_ex(Z_d + 1e-12 * torch.eye(4, dtype=dtype, device=dev))[0]

    def pre(u):
        u_c, u_t = unpack(u)
        return pack(bmv(U_inv, u_c) * cam_mask, Z_inv @ u_t)

    d_cam, d_t = unpack(pcg(matvec, pack(r_c, r_t), pre, config.cg_iterations, config.cg_tol, ba._read))
    d_cam = d_cam * cam_mask
    # back-substitute: δl = V′⁻¹ (−h − Wᵀδc − Y δθ)
    d_pt = bmv(Vinv, -h - ba._to_landmarks(mesh, rows, d_cam, dev) - torch.sum(Y * d_t, dim=-1))
    return d_cam, d_pt, d_t


def _step_selfcal(problem, lam, config, mesh, shards, plans):
    """One outer LM iteration over (cams, pts, θ), over the rows of
    ``shards`` (``ba._shards``) with their ``plans``: (cams, pts, θ, λ′,
    terminal, status, record), all tensors as ``ba._outer_step`` gives
    them."""
    dtype = problem.camera_params.dtype
    params0 = (problem.camera_params, problem.points, problem.intrinsics)
    rows, sums = _linearize_shards_full(mesh, shards, plans, params0)
    blocks, y0 = sums[:-1], sums[-1]
    U, V, g, h, g_t = blocks[0], blocks[1], blocks[5], blocks[6], blocks[7]
    lam = ba._seed_lambda(lam, U, V, config.init_lambda_factor)

    state = ba._lm_init_state_tree(params0, lam, y0, dtype)
    converged0 = state["stop"].clone()

    def solve_fn(lam_k):
        return _solve_delta_full(problem, blocks, lam_k, config, mesh, rows)

    def cost_fn(params):
        return ba._mesh_cost(mesh, shards, *params)

    b_flat = torch.cat([g.reshape(-1), h.reshape(-1), g_t])
    state = ba._lm_trials_tree(
        state, y0, b_flat, params0, solve_fn, cost_fn, config.inner_iterations,
        rel_cost_tol=config.rel_cost_tol,
    )
    cams, pts, intr = state["params"]
    return (cams, pts, intr, *ba._step_result(state, y0, converged0))


def _selfcal_loop(problem, config):
    """The StepLoop of the self-calibrating step, the intrinsics part of the
    carry, its context (mesh, shards): captured once per layout on CUDA, as
    ``ba._cg_loop``'s (an observation-sharded problem's when its mesh
    captures on the cameras' device, a graph a card over several peer
    cards), eager otherwise."""
    dtype, dev = problem.camera_params.dtype, problem.camera_params.device
    graph = ba._graphs(problem)

    def make_body(mesh, shards, plans):
        def body(cams, pts, intr, lam):
            prob = dataclasses.replace(problem, camera_params=cams, points=pts, intrinsics=intr)
            cams, pts, intr, lam, terminal, status, record = _step_selfcal(prob, lam, config, mesh, shards, plans)
            return (cams, pts, intr, lam), terminal, status, record

        return body

    def make():
        carry = (problem.camera_params, problem.points, problem.intrinsics,
                 torch.full((), -1.0, dtype=dtype, device=dev))
        return ba._sharded_loop(problem, config, graph, make_body, carry,
                                f"ba_step_selfcal {ba._layout_name(problem)}")

    if not graph:
        return make()
    return device_loop.cached(
        ("selfcal", config, problem.loss, problem.n_fixed_cameras, tuple(problem.camera_params.shape),
         tuple(problem.points.shape), dtype, dev, *ba._observations_key(problem)), make,
    )


def ba_step_selfcal(problem, lam, config=ba.BAConfig()):
    """One LM iteration refining cameras, landmarks and intrinsics:
    (cams, pts, θ, λ′, terminal, status, record), all tensors; λ = −1 seeds
    λ. On CUDA the step is one replay of a graph captured at the first call
    of its layout, with no host read, an observation-sharded problem's too
    when its mesh captures on the cameras' device (a graph a card over
    several peer cards); sharded over a gloo mesh or cards without peer
    access it steps eagerly."""
    loop = _selfcal_loop(problem, config)
    loop.start((problem.camera_params, problem.points, problem.intrinsics, lam))
    loop.step(ba._read)
    (cams, pts, intr, lam), terminal, status, record = loop.outputs()
    loop.context[0].check()
    return cams, pts, intr, lam, terminal, status, record


def solve_ba_selfcal(problem, config=ba.BAConfig()):
    """Full self-calibrating BA, stepped from Python as the JAX package
    does: one ``ba_step_selfcal`` an outer iteration (on CUDA one graph
    replay) and one read of its terminal flag. Returns (BAResult with an
    empty trace, θ). An observation-sharded problem steps so too when its
    mesh captures on the cameras' device, and eagerly over a gloo mesh or
    cards without peer access; the cameras, points and θ of the result are replicated
    on every process."""
    loop = _selfcal_loop(problem, config)
    loop.start((problem.camera_params, problem.points, problem.intrinsics, -1.0))
    loop.solve(config.max_iterations, ba._read, host_loop=True)
    cams, pts, intr, _ = (t.clone() for t in loop.carry)
    result = ba._loop_result(loop, cams, pts, ba._mesh_cost(*loop.context, cams, pts, intr))
    loop.context[0].check()
    return dataclasses.replace(result, trace={}), intr
