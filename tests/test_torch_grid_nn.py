"""The port's voxel hash grid (``ops/grid_nn.py``) and ``PairwiseRegistrar``
against the JAX package's, on the same numpy inputs.

* Builds: the port's host build gives JAX's ``build_hash_grid`` tables slot
  for slot; its device and fixed-capacity builds give the same tables, and
  the fixed build flags overflow when K is cut.
* Queries run on shared tables (the JAX table carried across by
  ``interop.hash_grid_from_numpy``), in both modes: idx equal to JAX's, and
  d² to rtol 1e-6, because XLA on the CPU may contract the sum of squares
  into fused multiply-adds (the port rounds each operation on its own, so
  its two modes, and the port against its brute force ``_nn_torch`` inside
  the radius, agree bit for bit).
* ``PairwiseRegistrar`` (float64 clouds): the gated grid pair, the coarse
  multistart seed, the deferred overflow flag and its redo, and a capacity
  policy that stays put over a stream; results against the JAX registrar.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.ops import grid_nn as J
from moptimizer_0_tpu.registration import PairwiseRegistrar as JRegistrar
from moptimizer_0_tpu.registration import icp as j_icp
from moptimizer_0_tpu_torch import registration as treg
from moptimizer_0_tpu_torch.interop import hash_grid_from_numpy
from moptimizer_0_tpu_torch.ops import grid_nn as P
from moptimizer_0_tpu_torch.ops.nn_search import _nn_torch
from moptimizer_0_tpu_torch.registration import PairwiseRegistrar, icp, make_searcher
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

FACHADA = pathlib.Path(__file__).parent / "data" / "fachada.txt"
D2_RTOL = 1e-6


def _clouds():
    """name → (points, cell): uniform, negative coordinates (the hash's
    uint32 wrap), a dense clump in a sparse halo (large K, hash collisions),
    every point three times (exact ties)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (400, 3))
    return {
        "uniform": (rng.uniform(-5, 5, (6000, 3)), 0.4),
        "negative": (rng.uniform(-30, -10, (3000, 3)), 1.0),
        "clump": (np.concatenate([rng.normal(0, 0.05, (300, 3)), rng.uniform(-5, 5, (1500, 3))]), 1.0),
        "duplicates": (np.concatenate([base, base, base]), 0.2),
    }


CLOUDS = _clouds()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _shared(jgrid):
    return hash_grid_from_numpy(
        np.asarray(jgrid.table_idx), np.asarray(jgrid.table_pts), np.asarray(jgrid.cell_size),
        jgrid.max_cell_occupancy, jgrid.n_points, device="cpu",
    )


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_builds_give_jax_host_tables_slot_for_slot(name):
    pts, cell = CLOUDS[name]
    jg = J.build_hash_grid(pts.astype(np.float32), cell)
    want_idx, want_pts = np.asarray(jg.table_idx), np.asarray(jg.table_pts)
    host = P.build_hash_grid(_t(pts), cell)
    dev = P.build_hash_grid_device(_t(pts), cell)
    fixed, overflow = P.build_hash_grid_fixed(_t(pts), cell, host.n_slots, host.bucket_size,
                                              host.max_cell_occupancy)
    for g in (host, dev, fixed):
        np.testing.assert_array_equal(g.table_idx.numpy(), want_idx)
        np.testing.assert_array_equal(g.table_pts.numpy(), want_pts)
        assert g.n_points == jg.n_points
    assert host.max_cell_occupancy == dev.max_cell_occupancy == jg.max_cell_occupancy
    assert not bool(overflow)
    _, cut = P.build_hash_grid_fixed(_t(pts), cell, host.n_slots, host.bucket_size - 16)
    assert bool(cut)


def test_fixed_build_at_a_small_k_drops_points_and_flags_them():
    pts, cell = CLOUDS["clump"]
    g, overflow = P.build_hash_grid_fixed(_t(pts), cell, 64, 16)
    _, j_overflow = J.build_hash_grid_fixed(pts.astype(np.float32), cell, 64, 16)
    assert bool(overflow) and bool(j_overflow)
    kept = g.table_idx.numpy()
    assert (kept >= 0).sum() < len(pts) and len(np.unique(kept[kept >= 0])) == (kept >= 0).sum()


def test_builds_validate():
    with pytest.raises(ValueError):
        P.build_hash_grid(torch.zeros(5, 2), 1.0)
    with pytest.raises(ValueError):
        P.build_hash_grid(torch.zeros(5, 3), 0.0)
    with pytest.raises(ValueError):
        P.build_hash_grid_device(torch.zeros(5, 3), -1.0)
    with pytest.raises(RuntimeError, match="CUDA"):  # numpy input goes to the card, and there is none
        P.build_hash_grid(np.zeros((5, 3)), 1.0)


def _queries(name, rng):
    pts, cell = CLOUDS[name]
    lo, hi = pts.min(0) - cell, pts.max(0) + cell
    q = np.concatenate([pts[::3] + 0.3 * cell * rng.normal(size=pts[::3].shape), rng.uniform(lo, hi, (500, 3))])
    return q.astype(np.float32)


def _check_against_jax(q, jgrid, **kw):
    ji, jd = map(np.asarray, J.grid_nearest_neighbors(jnp.asarray(q), jgrid, **kw))
    pi, pd = P.grid_nearest_neighbors(_t(q), _shared(jgrid), **kw)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_array_equal(np.isinf(pd.numpy()), np.isinf(jd))
    np.testing.assert_allclose(pd.numpy(), jd, rtol=D2_RTOL, atol=0)
    return pi, pd


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_both_modes_on_shared_tables_match_jax(name):
    pts, cell = CLOUDS[name]
    q = _queries(name, np.random.default_rng(1))
    jg = J.build_hash_grid(pts.astype(np.float32), cell)
    reads = P.HOST_READS
    qi, qd = _check_against_jax(q, jg, mode="query")
    assert P.HOST_READS == reads  # the query-major path reads nothing back
    ci, cd = _check_against_jax(q, jg, mode="auto")
    assert P.HOST_READS == reads + 1  # one read: the capacities and the cell count
    assert torch.equal(qi, ci) and torch.equal(qd.view(torch.int32), cd.view(torch.int32))
    assert (ci >= 0).sum() > len(q) // 2
    xi, xd = P.grid_nearest_neighbors(_t(q), _shared(jg), mode="cell")  # "auto" on CPU tensors
    assert P.HOST_READS == reads + 2
    assert torch.equal(xi, ci) and torch.equal(xd.view(torch.int32), cd.view(torch.int32))


def test_auto_mode_is_cell_major_on_the_cpu_and_query_major_on_the_card():
    assert P._auto_mode(torch.device("cpu")) == "cell"
    assert P._auto_mode(torch.device("cuda", 0)) == "query"
    with pytest.raises(ValueError, match="unknown mode"):
        P.grid_nearest_neighbors(torch.zeros(4, 3), P.build_hash_grid(torch.ones(5, 3), 1.0), mode="bogus")


@pytest.mark.parametrize("name", ["uniform", "clump"])
def test_inside_the_radius_the_grid_equals_brute_force_bit_for_bit(name):
    """Where the brute force's d² < cell², the grid gives its idx and its d²
    bit for bit; elsewhere (−1, +inf). The correspondences of gated brute
    force, which the chip check holds against K5."""
    pts, cell = CLOUDS[name]
    q = _queries(name, np.random.default_rng(2))
    gi, gd = P.grid_nearest_neighbors(_t(q), P.build_hash_grid(_t(pts), cell))
    bi, bd = _nn_torch(_t(q), _t(pts))
    inside = bd < np.float32(cell) ** 2
    assert torch.equal(gi[inside], bi[inside])
    assert torch.equal(gd[inside].view(torch.int32), bd[inside].view(torch.int32))
    assert bool((gi[~inside] == -1).all()) and bool(torch.isinf(gd[~inside]).all())


def test_fallbacks_on_capacity_cells_and_extent_match_jax():
    pts, cell = CLOUDS["uniform"]
    jg = J.build_hash_grid(pts.astype(np.float32), cell)
    rng = np.random.default_rng(3)
    crowd = np.concatenate([_queries("uniform", rng), np.float32([1.05, 1.05, 1.05]) + 0.01 * rng.random((200, 3))])
    want = _check_against_jax(crowd, jg, mode="query")
    for kw in (dict(query_capacity=8), dict(max_cells=4)):
        got = _check_against_jax(crowd, jg, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    far = _queries("uniform", rng)
    far[0] = [3000.0, 0.0, 0.0]  # 7,500 cells away
    _check_against_jax(far, jg)


def test_negative_coordinates_outliers_nan_queries_and_a_single_query():
    pts, cell = CLOUDS["negative"]
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.uniform(-30, -10, (600, 3)), rng.uniform(100, 120, (50, 3))]).astype(np.float32)
    q[7] = np.nan
    q[9, 2] = np.nan
    jg = J.build_hash_grid(pts.astype(np.float32), cell)
    grid = _shared(jg)
    for mode in ("auto", "cell", "query"):
        gi, gd = P.grid_nearest_neighbors(_t(q), grid, mode=mode)
        for rows in ([7, 9], slice(-50, None)):
            assert bool((gi[rows] == -1).all()) and bool(torch.isinf(gd[rows]).all())
    finite = np.isfinite(q).all(1)
    _check_against_jax(q[finite], jg)
    gi, gd = P.grid_nearest_neighbors(_t(q[:1]), grid)
    assert gi.shape == (1,) and gi.dtype == torch.int32 and gd.dtype == torch.float32


def test_rings_2_matches_jax_and_reaches_farther():
    pts, _ = CLOUDS["uniform"]
    q = np.random.default_rng(5).uniform(-5, 5, (800, 3)).astype(np.float32)
    jg = J.build_hash_grid(pts.astype(np.float32), 0.15)
    i1, _ = _check_against_jax(q, jg, rings=1)
    i2, _ = _check_against_jax(q, jg, rings=2)
    _check_against_jax(q, jg, rings=2, mode="query")
    assert int((i2 >= 0).sum()) > int((i1 >= 0).sum())


def test_estimate_spacing_matches_jax_on_the_whole_cloud_and_survives_duplicates():
    rng = np.random.default_rng(6)
    base = rng.uniform(0, 10, (700, 3)).astype(np.float32)
    trip = np.concatenate([base, base, base])
    for cloud in (base, trip):  # sample ≥ M: the median does not depend on the draw
        want = J.estimate_spacing(cloud, sample=len(cloud))
        got = P.estimate_spacing(_t(cloud), sample=len(cloud))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    s_clean = P.estimate_spacing(_t(base))
    s_dup = P.estimate_spacing(_t(trip), generator=torch.Generator().manual_seed(3))
    assert s_dup > 0
    np.testing.assert_allclose(s_dup, s_clean, rtol=0.35)
    with pytest.raises(ValueError):
        P.estimate_spacing(torch.zeros(64, 3))


def test_make_searcher_routes_grid_and_gated_auto(monkeypatch):
    """"grid", and gated "auto" at GRID_AUTO_MIN_TARGETS targets or more,
    search the grid (radius semantics: a far query gets (−1, +inf));
    ungated "auto" and smaller targets stay brute force."""
    tgt = torch.as_tensor(np.random.default_rng(8).uniform(0, 10, (2000, 3)), dtype=torch.float32)
    far = torch.tensor([[500.0, 500.0, 500.0]])

    def searched(backend, gate):
        idx, d2 = make_searcher(tgt, backend, gate)(far)
        return int(idx[0]), float(d2[0])

    assert searched("grid", 1.0) == (-1, float("inf"))
    assert searched("auto", 1.0)[0] >= 0  # 2,000 targets: brute force
    monkeypatch.setattr(treg, "GRID_AUTO_MIN_TARGETS", 1000)
    assert searched("auto", 1.0) == (-1, float("inf"))
    assert searched("auto", None)[0] >= 0
    idx, d2 = make_searcher(tgt, "grid", None)(tgt[:5] + 0.01)  # cell from the spacing
    assert bool((idx >= 0).all())


def _pair(seed, n=1500, x=(0.2, -0.1, 0.15, 0.03, 0.02, -0.04)):
    src = np.random.default_rng(seed).uniform(0, 8, (n, 3))
    T = np.asarray(jse3.transform_from_params6(jnp.asarray(x)))
    return src, src @ T[:3, :3].T + T[:3, 3], np.asarray(x)


def test_icp_grid_matches_jax_and_brute_force():
    src, tgt, x_true = _pair(5)
    j = j_icp(jnp.asarray(src), jnp.asarray(tgt), nn_backend="grid", max_corr_dist=2.0)
    t = icp(torch.as_tensor(src), torch.as_tensor(tgt), nn_backend="grid", max_corr_dist=2.0)
    bf = icp(torch.as_tensor(src), torch.as_tensor(tgt), nn_backend="torch", max_corr_dist=2.0)
    assert int(t.status) == int(j.status) == int(bf.status)
    assert int(t.iterations) == int(j.iterations) == int(bf.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.x.numpy(), bf.x.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(t.x.numpy(), x_true, atol=1e-9)


def test_icp_grid_recovers_the_fachada_transform_in_float32():
    cloud = load_txt_cloud(FACHADA).astype(np.float32)[::8]
    x_true = np.array([0.4, -0.3, 0.2, 0.05, -0.04, 0.06])
    T = np.asarray(jse3.transform_from_params6(jnp.asarray(x_true)))
    tgt = (cloud @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    res = icp(torch.as_tensor(cloud), torch.as_tensor(tgt), nn_backend="grid", max_corr_dist=1.0)
    assert int(res.status) != 3
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=2e-3)


def test_registrar_gated_grid_stream_matches_jax():
    """Three same-density pairs through one registrar of each package: the
    first pair learns the capacities, every pair then builds at them; the
    policy stays put and x equals JAX's."""
    jreg = JRegistrar(max_corr_dist=2.0, nn_backend="grid")
    treg_ = PairwiseRegistrar(max_corr_dist=2.0, nn_backend="grid")
    policies = []
    for seed in range(3):
        src, tgt, x_true = _pair(20 + seed)
        j = jreg.register(jnp.asarray(src), jnp.asarray(tgt), x0=jnp.zeros(6))
        t, overflow = treg_.register(torch.as_tensor(src), torch.as_tensor(tgt), x0=torch.zeros(6, dtype=torch.float64),
                                     defer_overflow=True)
        assert isinstance(overflow, torch.Tensor) and not bool(overflow)
        assert int(t.status) == int(j.status) and int(t.iterations) == int(j.iterations)
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
        np.testing.assert_allclose(t.x.numpy(), x_true, atol=1e-8)
        policies.append(treg_._grid_policy)
    assert policies[0] == policies[1] == policies[2] == jreg._grid_policy


def test_registrar_overflow_redo_grows_the_policy_and_matches_jax():
    """A pair whose target is denser than the policy's: the deferred flag is
    True, redo_overflow rebuilds (K grows by at least 16) and solves as the
    JAX registrar does."""
    rng = np.random.default_rng(31)
    x_true = np.array([0.2, -0.1, 0.05, 0.01, 0.02, -0.015])
    T = np.asarray(jse3.transform_from_params6(jnp.asarray(x_true)))
    Tinv = np.linalg.inv(T)
    jreg = JRegistrar(max_corr_dist=0.5, nn_backend="grid")
    treg_ = PairwiseRegistrar(max_corr_dist=0.5, nn_backend="grid")
    for hi in (20.0, 2.0):  # sparse, then far denser
        tgt = rng.uniform(0, hi, (2000, 3))
        src = tgt @ Tinv[:3, :3].T + Tinv[:3, 3]
        j = jreg.register(jnp.asarray(src), jnp.asarray(tgt), x0=jnp.zeros(6))
        x0 = torch.zeros(6, dtype=torch.float64)
        before = treg_._grid_policy
        t, overflow = treg_.register(torch.as_tensor(src), torch.as_tensor(tgt), x0=x0, defer_overflow=True)
        if hi == 2.0:
            assert bool(overflow)
            t = treg_.redo_overflow(torch.as_tensor(src), torch.as_tensor(tgt), x0)
            assert treg_._grid_policy[1] >= before[1] + 16
        assert treg_._grid_policy == jreg._grid_policy
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
        np.testing.assert_allclose(t.x.numpy(), x_true, atol=2e-3)


@pytest.mark.parametrize("multistart", ["auto", 0])
def test_registrar_unseeded_pair_coarse_seed_matches_jax(multistart):
    """An unseeded gated pair: the coarse pass (8 yaw starts batched, or one
    start) on the stride-subsampled clouds, then the gated solve."""
    src, tgt, x_true = _pair(40, n=1200, x=(0.6, -0.4, 0.1, 0.0, 0.0, 0.5))
    jreg = JRegistrar(max_corr_dist=0.5, nn_backend="grid", coarse_multistart=multistart)
    treg_ = PairwiseRegistrar(max_corr_dist=0.5, nn_backend="grid", coarse_multistart=multistart)
    assert treg_.coarse_multistart == (8 if multistart == "auto" else 0)
    assert treg._coarse_subsample(torch.zeros(5000, 3)).shape[0] == 2500  # every 2nd point
    assert treg._coarse_subsample(torch.zeros(4096, 3)).shape[0] == 4096
    j = jreg.register(jnp.asarray(src), jnp.asarray(tgt))
    t = treg_.register(torch.as_tensor(src), torch.as_tensor(tgt))
    assert int(t.status) == int(j.status)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.x.numpy(), x_true, atol=1e-8)


def test_registrar_brute_route_and_methods_not_ported():
    src, tgt, x_true = _pair(50, n=800)
    reg = PairwiseRegistrar(max_corr_dist=2.0)  # 800 targets: brute force
    res, overflow = reg.register(torch.as_tensor(src), torch.as_tensor(tgt), x0=torch.zeros(6, dtype=torch.float64),
                                 defer_overflow=True)
    assert overflow is None and reg._grid_policy is None
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-8)
    for method in ("point2plane", "gicp"):  # ported: the same pair, brute force, as JAX's registrar
        jres = JRegistrar(max_corr_dist=2.0, method=method).register(jnp.asarray(src), jnp.asarray(tgt),
                                                                     x0=jnp.zeros(6))
        res = PairwiseRegistrar(max_corr_dist=2.0, method=method).register(
            torch.as_tensor(src), torch.as_tensor(tgt), x0=torch.zeros(6, dtype=torch.float64))
        assert int(res.status) == int(jres.status) and int(res.iterations) == int(jres.iterations)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        PairwiseRegistrar(method="bogus")
