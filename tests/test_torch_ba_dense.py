"""The port's dense-Schur bundle adjustment against the JAX package's.

Both packages get the same problems, built once in numpy/JAX and carried
across as numpy (``interop.ba_problem_from_numpy``), all in float64 on the
CPU. Tolerances and why:

* the host layout (``group_by_landmark``, the segment plan, the routing
  estimators) is numpy on both sides: equal element for element;
* the linearization, GN blocks, Cholesky pieces and damped step are the same
  closed forms evaluated in another order: 1e-12 relative to the largest
  entry (a few hundred ulps; the damped step goes through a Cholesky solve
  of S, whose conditioning magnifies roundoff, so it is held to 1e-10);
* full solves: status, iterations and NaN slots equal; costs, λ and the
  final state to 1e-9 relative, and ρ to 1e-9 + 1e-12·|y0|/|y0 − yi|,
  since ρ divides a difference of two costs summed in other orders. Parity
  solves stop before the noise floor (``rel_cost_tol``), where that
  difference is itself roundoff and the sign of ρ, and with it every later
  decision, depends on the summation order (ROADMAP.md, Queue 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu.core.loss import Huber as JHuber
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.loss import Huber
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.ops import block_cholesky

from test_ba import make_synthetic_ba

FIELDS = ("camera_params", "points", "cam_idx", "pt_idx", "pixels", "intrinsics")


def port(jprob, loss=None):
    """The port's copy of a JAX BAProblem."""
    arrays = {k: np.asarray(getattr(jprob, k)) for k in FIELDS}
    return interop.ba_problem_from_numpy(
        **arrays, n_fixed_cameras=jprob.n_fixed_cameras, loss=loss, device="cpu"
    )


def uneven_problem():
    """The uneven-valence construction of tests/test_ba_dense.py: landmark l
    seen by cameras 0..(l % C), noiseless pixels, perturbed start."""
    rng = np.random.default_rng(11)
    C, L = 6, 15
    pts = rng.uniform(-2, 2, size=(L, 3)) + np.array([0.0, 0.0, 8.0])
    cams = np.stack(
        [np.concatenate([[1.2 * i - 3.0, 0.1 * rng.normal(), 0.0], 0.03 * rng.normal(size=3)])
         for i in range(C)]
    )
    cam_idx = np.asarray([c for l in range(L) for c in range((l % C) + 1)])
    pt_idx = np.asarray([l for l in range(L) for _ in range((l % C) + 1)])
    prob = jba.BAProblem(
        camera_params=jnp.asarray(cams), points=jnp.asarray(pts), cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx), pixels=jnp.zeros((len(cam_idx), 2)),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0]), n_fixed_cameras=2,
    )
    pixels = jax.vmap(jba._project, (0, 0, None))(
        prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics
    )
    return dataclasses.replace(
        prob,
        pixels=pixels,
        camera_params=prob.camera_params
        + 0.01 * jnp.asarray(rng.normal(size=cams.shape)) * (jnp.arange(C) >= 2)[:, None],
        points=prob.points + 0.05 * jnp.asarray(rng.normal(size=pts.shape)),
    )


def with_unobserved(jprob, n_extra=10, seed=0):
    """``jprob`` plus ``n_extra`` landmarks that no camera observes."""
    rng = np.random.default_rng(seed)
    extra = rng.uniform(-2, 2, size=(n_extra, 3)) + np.array([0.0, 0.0, 8.0])
    return dataclasses.replace(jprob, points=jnp.concatenate([jprob.points, jnp.asarray(extra)]))


def with_duplicates(jprob, every=7):
    """``jprob`` with every ``every``-th observation repeated, 0.3 px off: a
    landmark that one camera observes twice."""
    rows = np.arange(0, len(np.asarray(jprob.pt_idx)), every)
    return dataclasses.replace(
        jprob,
        cam_idx=jnp.concatenate([jprob.cam_idx, jprob.cam_idx[rows]]),
        pt_idx=jnp.concatenate([jprob.pt_idx, jprob.pt_idx[rows]]),
        pixels=jnp.concatenate([jprob.pixels, jprob.pixels[rows] + 0.3]),
    )


PROBLEMS = {
    "synthetic": lambda: make_synthetic_ba(C=5, L=40, noise=0.3, seed=7)[0],
    "uneven": uneven_problem,
    # bench-style: L >= 1024, so segments="auto" segments
    "bench": lambda: bench._make_ba_problem(12_000, 10, 1_200, jnp, dtype=np.float64, seed=0),
    # Poisson(0.8) valence: a fifth of the landmarks unobserved
    "bench_sparse": lambda: bench._make_ba_problem(160, 6, 200, jnp, dtype=np.float64, seed=0),
    "unobserved": lambda: with_unobserved(make_synthetic_ba(C=5, L=40, noise=0.3, seed=7)[0]),
    "duplicates": lambda: with_duplicates(make_synthetic_ba(C=4, L=30, noise=0.3, seed=3)[0]),
}


@functools.lru_cache(maxsize=None)
def jax_problem(name):
    """PROBLEMS[name](), built once per test process (JAX arrays are
    immutable, so the tests share them)."""
    return PROBLEMS[name]()


@functools.lru_cache(maxsize=None)
def jax_grouped(name, segments):
    return jbd.group_by_landmark(jax_problem(name), segments=segments)


# The JAX side's stages under jit: one XLA compile each instead of one per
# primitive and segment shape, which is what keeps these tests short. The
# math is the same; "highest" keeps the JAX package's matmuls in float64.
_j_linearize = jax.jit(jbd._linearize_grouped)
_j_cost = jax.jit(jbd._cost_grouped)
_j_gn_blocks = jax.jit(jbd._gn_blocks_grouped, static_argnames=("C", "precision"))
_j_blocks = jax.jit(functools.partial(jbd._linearize_and_blocks, loss=None, precision="highest"))
_j_solve_delta = jax.jit(
    functools.partial(jbd._solve_delta_dense, schur_precision="highest"),
    static_argnames=("C", "chunk"),
)


@functools.lru_cache(maxsize=None)
def jax_blocks(name, segments):
    """The JAX package's (U, V, W_segs, g, h, y0) at the problem's start."""
    jprob, jg = jax_problem(name), jax_grouped(name, segments)
    return _j_blocks(jprob.camera_params, jg.sort_points(jprob.points), jprob.intrinsics, jg)


def rel_err(t, j):
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300))


def both_grouped(name, segments):
    jprob = jax_problem(name)
    tprob = port(jprob)
    return jprob, tprob, jax_grouped(name, segments), tbd.group_by_landmark(tprob, segments=segments)


@pytest.mark.parametrize(
    "name,segments",
    [
        ("synthetic", 1),
        ("uneven", "auto"),  # L < 1024: auto keeps one K
        ("bench", 1),
        ("bench", "auto"),
        ("bench", 2),
        ("bench_sparse", 3),  # zero-width last segment
        ("unobserved", 2),  # zero-width last segment
    ],
)
def test_group_by_landmark_matches_jax(name, segments):
    _, _, jg, tg = both_grouped(name, segments)
    assert tg.seg_bounds == jg.seg_bounds
    if name in ("bench_sparse", "unobserved"):
        assert tg.seg_bounds[-1][1] == 0
    if (name, segments) == ("bench", "auto"):
        assert len(tg.seg_bounds) >= 2
    for key in ("pixels", "cam_ids", "mask", "perm", "inv_perm"):
        j, t = getattr(jg, key), getattr(tg, key)
        assert (j is None) == (t is None), key
        if j is not None:
            assert t.dtype == {"pixels": torch.float64, "mask": torch.float64}.get(key, torch.int32)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=key)
    for (jsl, jv), (tsl, tv) in zip(jbd._seg_views(jg), tbd._seg_views(tg)):
        assert jsl == tsl
        np.testing.assert_array_equal(tv.cam_ids.numpy(), np.asarray(jv.cam_ids))
        assert tv.cam_ids.is_contiguous() and tv.pixels.is_contiguous()


@pytest.mark.parametrize("name", ["uneven", "bench", "bench_sparse"])
def test_layout_estimators_match_jax(name):
    jprob = jax_problem(name)
    tprob = port(jprob)
    assert tbd.padding_factor(tprob) == jbd.padding_factor(jprob)
    assert tbd.dense_slot_factor(tprob) == jbd.dense_slot_factor(jprob)
    assert tbd.dense_memory_bytes(tprob) == jbd.dense_memory_bytes(jprob)
    counts = np.sort(np.bincount(np.asarray(jprob.pt_idx), minlength=jprob.points.shape[0]))[::-1]
    for n in (1, 2, 4):
        assert tbd._plan_segments(counts, n) == jbd._plan_segments(counts, n)


def test_group_by_landmark_refuses_bad_indices():
    jprob = jax_problem("synthetic")
    bad = port(dataclasses.replace(jprob, cam_idx=jprob.cam_idx.at[3].set(5)))
    with pytest.raises(ValueError, match="cam_idx"):
        tbd.group_by_landmark(bad)
    bad = port(dataclasses.replace(jprob, pt_idx=jprob.pt_idx.at[0].set(-1)))
    with pytest.raises(ValueError, match="pt_idx"):
        tbd.group_by_landmark(bad)


@pytest.mark.parametrize("name,segments", [("uneven", 1), ("bench", 3), ("unobserved", 2)])
def test_linearize_grouped_matches_jax(name, segments):
    jprob, tprob, jg, tg = both_grouped(name, segments)
    jpts, tpts = jg.sort_points(jprob.points), tg.sort_points(tprob.points)
    for (sl, jv), (_, tv) in zip(jbd._seg_views(jg), tbd._seg_views(tg)):
        r_j, A_j, B_j = _j_linearize(jprob.camera_params, jpts[sl], jprob.intrinsics, jv)
        r_t, A_t, B_t = tbd._linearize_grouped(tprob.camera_params, tpts[sl], tprob.intrinsics, tv)
        assert r_t.shape == r_j.shape and A_t.shape == A_j.shape and B_t.shape == B_j.shape
        if r_t.numel():
            for t, j in ((r_t, r_j), (A_t, A_j), (B_t, B_j)):
                assert rel_err(t, j) < 1e-12
            # padding slots are exactly 0
            pad = tv.mask == 0
            assert (r_t[pad] == 0).all() and (A_t[pad] == 0).all() and (B_t[pad] == 0).all()
    y_j = _j_cost(jprob.camera_params, jpts, jprob.intrinsics, jg)
    y_t = tbd._cost_grouped(tprob.camera_params, tpts, tprob.intrinsics, tg)
    assert abs(float(y_t) - float(y_j)) <= 1e-12 * float(y_j)


@pytest.mark.parametrize("robust", [False, True], ids=["trivial", "huber"])
def test_gn_blocks_grouped_matches_jax(robust):
    jprob = jax_problem("synthetic")
    pix = np.asarray(jprob.pixels).copy()
    pix[::9] += 40.0  # outliers, so that the Huber weights vary
    jprob = dataclasses.replace(jprob, pixels=jnp.asarray(pix))
    jloss, tloss = (JHuber(delta=2.0), Huber(delta=2.0)) if robust else (None, None)
    tprob = port(jprob, tloss)
    jg, tg = jbd.group_by_landmark(jprob), tbd.group_by_landmark(tprob)
    C = tprob.camera_params.shape[0]
    r, A, B = _j_linearize(jprob.camera_params, jprob.points, jprob.intrinsics, jg)
    j_blocks = _j_gn_blocks(jg, r, A, B, C=C, loss=jloss, precision="highest")
    r, A, B = tbd._linearize_grouped(tprob.camera_params, tprob.points, tprob.intrinsics, tg)
    t_blocks = tbd._gn_blocks_grouped(tg, r, A, B, C, tloss)
    for name, t, j in zip("UVWgh", t_blocks, j_blocks):
        assert rel_err(t, j) < 1e-12, name


def test_linearize_and_blocks_segmented_matches_jax():
    jprob, tprob, jg, tg = both_grouped("bench", "auto")
    j = jax_blocks("bench", "auto")
    t = tbd._linearize_and_blocks(
        tprob.camera_params, tg.sort_points(tprob.points), tprob.intrinsics, tg, None
    )
    for name, tt, jj in zip(("U", "V", "W", "g", "h", "y0"), t, j):
        if name == "W":
            assert len(tt) == len(jj) == len(tg.seg_bounds)
            for ts, js in zip(tt, jj):
                assert rel_err(ts, js) < 1e-12
        else:
            assert rel_err(tt, jj) < 1e-12, name


def test_chol3x3_and_tri_inv_match_jax():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(50, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(3)
    L_t = tbd._chol3x3(torch.as_tensor(A))
    L_j = jbd._chol3x3(jnp.asarray(A))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(L_t.numpy() @ np.swapaxes(L_t.numpy(), -1, -2), A, rtol=1e-12)
    iL = tbd._tri_inv_lower(L_t)
    np.testing.assert_allclose(iL.numpy(), np.asarray(jbd._tri_inv_lower(L_j)), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(iL.numpy() @ L_t.numpy(), np.broadcast_to(np.eye(3), A.shape), atol=1e-12)


@pytest.mark.parametrize("name,segments", [("synthetic", 1), ("bench", "auto")])
def test_solve_delta_dense_matches_jax(name, segments):
    jprob, tprob, jg, tg = both_grouped(name, segments)
    C = tprob.camera_params.shape[0]
    fixed = (np.arange(C) >= jprob.n_fixed_cameras).astype(np.float64)
    j_blocks = jax_blocks(name, segments)
    t_blocks = tbd._linearize_and_blocks(
        tprob.camera_params, tg.sort_points(tprob.points), tprob.intrinsics, tg, None
    )
    for lam in (1e-6, 1e-2):
        d_j = _j_solve_delta(
            jg, C=C, U=j_blocks[0], V=j_blocks[1], W=j_blocks[2], g=j_blocks[3], h=j_blocks[4],
            lam=jnp.asarray(lam), fixed_mask=jnp.asarray(fixed), chunk=64,
        )
        d_t = tbd._solve_delta_dense(
            tg, C, *t_blocks[:5], torch.tensor(lam, dtype=torch.float64), torch.as_tensor(fixed), 64
        )
        for t, j in zip(d_t, d_j):
            assert rel_err(t, j) < 1e-10
        assert (d_t[0][: jprob.n_fixed_cameras] == 0).all()


def test_ba_step_dense_matches_jax_in_problem_order():
    jprob, tprob, jg, tg = both_grouped("bench", "auto")
    cfg = dict(max_iterations=4)
    j = jbd.ba_step_dense(jprob, jg, jnp.asarray(-1.0), jbd.DenseBAConfig(**cfg))
    t = tbd.ba_step_dense(tprob, tg, -1.0, interop.dense_config_from_fields(cfg))
    assert rel_err(t[0], j[0]) < 1e-9 and rel_err(t[1], j[1]) < 1e-9
    assert abs(float(t[2]) / float(j[2]) - 1) < 1e-9
    assert t[3] == bool(j[3]) and int(t[4]) == int(j[4])
    for key in tba.TRACE_KEYS:
        np.testing.assert_allclose(float(t[5][key]), float(j[5][key]), rtol=1e-9)
    assert t[5]["trials"] == 1


def jax_result_to_numpy(res):
    return {f.name: (
        {k: np.asarray(v) for k, v in res.trace.items()} if f.name == "trace"
        else np.asarray(getattr(res, f.name))
    ) for f in dataclasses.fields(res)}


def assert_same_solve(t_res, j_res, rtol=1e-9, cost_rel=1e-12):
    t, j = interop.result_to_numpy(t_res), jax_result_to_numpy(j_res)
    assert int(t["status"]) == int(j["status"])
    assert int(t["iterations"]) == int(j["iterations"])
    np.testing.assert_allclose(t["camera_params"], j["camera_params"], rtol=0,
                               atol=rtol * np.abs(j["camera_params"]).max())
    np.testing.assert_allclose(t["points"], j["points"], rtol=0, atol=rtol * np.abs(j["points"]).max())
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=rtol)
    tt, jt = t["trace"], j["trace"]
    assert set(tt) == set(jt) | {"trials"}
    y0 = jt["cost"]
    gain = np.abs(y0) / np.maximum(np.abs(y0 - jt["cost_new"]), 1e-300)
    for key in jt:
        np.testing.assert_array_equal(np.isnan(tt[key]), np.isnan(jt[key]), err_msg=key)
        tol = rtol + (cost_rel * np.nan_to_num(gain) if key == "rho" else 0.0)
        ok = np.isnan(jt[key]) | (np.abs(tt[key] - jt[key]) <= tol * np.abs(jt[key]))
        assert ok.all(), f"{key}: {tt[key][~ok]} != {jt[key][~ok]}"
    run = ~np.isnan(jt["cost"])
    assert (tt["trials"][run] >= 1).all() and (tt["trials"][~run] == 0).all()
    return t


@pytest.mark.parametrize(
    "name,cfg",
    [
        ("synthetic", dict(max_iterations=8, rel_cost_tol=1e-10)),
        ("bench", dict(max_iterations=6, rel_cost_tol=1e-10)),  # segments="auto" segments
        ("unobserved", dict(max_iterations=5, rel_cost_tol=1e-10, schur_chunk=16)),
    ],
)
def test_solve_ba_dense_matches_jax(name, cfg):
    jprob = jax_problem(name)
    tprob = port(jprob)
    j_res = jbd.solve_ba_dense(jprob, jbd.DenseBAConfig(**cfg))
    t_res = tbd.solve_ba_dense(tprob, interop.dense_config_from_fields(cfg))
    t = assert_same_solve(t_res, j_res)
    assert t["cost"] < 1e-2 * t["trace"]["cost"][0]
    if name == "unobserved":  # nothing moves a landmark no camera sees
        np.testing.assert_array_equal(t["points"][40:], np.asarray(jprob.points)[40:])


def test_robust_loss_and_fixed_cameras_solve_matches_jax():
    jprob = make_synthetic_ba(C=4, L=30, noise=0.1, seed=4, n_fixed=2)[0]
    pix = np.asarray(jprob.pixels).copy()
    pix[::11] += 80.0
    jprob = dataclasses.replace(jprob, pixels=jnp.asarray(pix), loss=JHuber(delta=2.0))
    tprob = port(jprob, Huber(delta=2.0))
    cfg = dict(max_iterations=10, rel_cost_tol=1e-10)
    j_res = jbd.solve_ba_dense(jprob, jbd.DenseBAConfig(**cfg))
    t_res = tbd.solve_ba_dense(tprob, tbd.DenseBAConfig(**cfg))
    assert_same_solve(t_res, j_res)
    assert torch.equal(t_res.camera_params[:2], tprob.camera_params[:2])


def test_nan_pixel_gives_numeric_error_like_jax():
    jprob = jax_problem("synthetic")
    jprob = dataclasses.replace(jprob, pixels=jprob.pixels.at[5, 0].set(jnp.nan))
    j_res = jbd.solve_ba_dense(jprob, jbd.DenseBAConfig(max_iterations=4))
    t_res = tbd.solve_ba_dense(port(jprob), tbd.DenseBAConfig(max_iterations=4))
    assert int(t_res.status) == int(j_res.status) == Status.NUMERIC_ERROR
    assert int(t_res.iterations) == int(j_res.iterations) == 0


def test_host_loop_flag_and_grouped_argument_change_nothing():
    tprob = port(jax_problem("uneven"))
    cfg = tbd.DenseBAConfig(max_iterations=5)
    a = interop.result_to_numpy(tbd.solve_ba_dense(tprob, cfg))
    b = interop.result_to_numpy(
        tbd.solve_ba_dense(tprob, cfg, grouped=tbd.group_by_landmark(tprob), host_loop=True)
    )
    for key in ("camera_params", "points", "cost", "status", "iterations"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["trace"]["trials"].shape == (5,) and a["trace"]["trials"].dtype == np.int32


@pytest.mark.parametrize("O,C,L,seed", [(3_000, 7, 400, 3)])
def test_make_ba_problem_matches_bench(O, C, L, seed):
    j = bench._make_ba_problem(O, C, L, jnp, dtype=np.float64, seed=seed)
    t = tba.make_ba_problem(O, C, L, seed=seed, dtype=torch.float64, device="cpu")
    for key in ("camera_params", "points", "cam_idx", "pt_idx", "intrinsics"):
        np.testing.assert_array_equal(getattr(t, key).numpy(), np.asarray(getattr(j, key)), err_msg=key)
    # pixels go through the two packages' own projections: rtol 1e-12
    np.testing.assert_allclose(t.pixels.numpy(), np.asarray(j.pixels), rtol=1e-12, atol=0)
    assert t.n_fixed_cameras == j.n_fixed_cameras == 2
    assert tba.make_ba_problem(O, C, L, seed=seed, device="cpu").camera_params.dtype == torch.float32
    np.testing.assert_allclose(
        float(tba.compute_cost(t)), float(jba.compute_cost(j)), rtol=1e-12
    )


def test_spd_solve():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(30, 30))
    A = torch.as_tensor(M @ M.T + 30 * np.eye(30))
    b = torch.as_tensor(rng.normal(size=30))
    for method in ("auto", "xla", "blocked"):
        x = block_cholesky.spd_solve(A, b, method)
        np.testing.assert_allclose((A @ x).numpy(), b.numpy(), rtol=0, atol=1e-12)
    B = torch.as_tensor(rng.normal(size=(30, 2)))
    assert block_cholesky.spd_solve(A, B).shape == (30, 2)
    assert block_cholesky.spd_solve(A, B, "blocked", base=8).shape == (30, 2)
    not_pd = A.clone()
    not_pd[4, 4] = -1.0
    assert torch.isnan(block_cholesky.spd_solve(not_pd, b)).all()  # like cho_factor: no raise
    assert torch.isnan(block_cholesky.spd_solve(not_pd, b, "blocked", base=8)).all()
    with pytest.raises(ValueError, match="unknown"):
        block_cholesky.spd_solve(A, b, "lu")


def test_cg_engine_names_raise_until_ported():
    """The CG engine's names are ported: none raises. select_engine routes
    as the JAX package does, and engine="dense" is solve_ba_dense with the
    config's three shared fields, bit for bit (test_torch_ba_cg.py holds the
    CG engine against the JAX package's)."""
    jprob = jax_problem("synthetic")
    tprob = port(jprob)
    assert tba.select_engine(tprob) == jba.select_engine(jprob) == "dense"
    cams, pts, lam, terminal, status, rec = tba.ba_step(tprob, -1.0, tba.BAConfig())
    assert cams.shape == tprob.camera_params.shape and rec["trials"] >= 1
    cfg = tba.BAConfig(max_iterations=4, inner_iterations=2, init_lambda_factor=1e-6)
    via = tba.solve_ba(tprob, cfg, engine="dense")
    direct = tbd.solve_ba_dense(tprob, tbd.DenseBAConfig(max_iterations=4, inner_iterations=2,
                                                         init_lambda_factor=1e-6))
    assert torch.equal(via.camera_params, direct.camera_params)
    torch.testing.assert_close(via.trace["cost"], direct.trace["cost"], rtol=0, atol=0, equal_nan=True)


def test_dense_config_and_problem_interop():
    jcfg = jbd.DenseBAConfig(max_iterations=7, inner_iterations=2, schur_chunk=64,
                             schur_precision="highest", gn_precision="high", rel_cost_tol=1e-6)
    tcfg = interop.dense_config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(tba.BAProblem)] == [
        f.name for f in dataclasses.fields(jba.BAProblem)
    ]
    tprob = port(jax_problem("synthetic"))
    assert tprob.cam_idx.dtype == torch.int64 and tprob.points.dtype == torch.float64
    np.testing.assert_allclose(
        tba.residuals_all(tprob).numpy(), np.asarray(jba.residuals_all(jax_problem("synthetic"))),
        rtol=1e-12, atol=1e-12,
    )
