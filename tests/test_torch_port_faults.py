"""Faults of the port against the JAX package, each pinned on the inputs
that showed it (float64, the same numpy inputs to both packages).

* F1: a masked row with a NaN residual. Under jit XLA turns the JAX code's
  product with the cast mask into a select, so the row adds 0; the port
  selects (``torch.where``) at the same places. Status, iterations and cost
  equal the JAX package's for ``icp``, ``icp_batched``, a generic block
  through the LM solver and ``compute_cost``.
* F2: ``_median`` gives NaN for a column that holds a NaN, as
  ``jnp.median`` does, so the centroid seed of a cloud with a NaN is NaN in
  both packages.
* F3: the dense-BA camera reductions (U, g, the rhs) sum each camera's
  slots through a plan, in one fixed order, never with ``index_add_``.
* F4: a searcher's idx −1 (the grid's "nothing within the cell") gathers
  the last target point, as JAX's wrapping index does, in a row the gate
  marks invalid.
* F6: each subpackage ``__init__`` exports the JAX package's names (the
  models and ``ops.nearest_neighbors`` were missing), with the renames
  listed in ``RENAMED``.
* F7: ``nearest_neighbors`` takes the JAX package's ``block_q``,
  ``block_p`` and ``chunk``, and they change no result.
* F8: ``lm_step`` returns ``terminal`` and ``status`` as 0-dim tensors (a
  bool and an int32), as the JAX package's jitted step returns arrays, and
  they equal JAX's.
"""

import ast
import importlib
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.core import linearize as jlin
from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.ops.nn_search import nearest_neighbors as j_nn
from moptimizer_0_tpu.registration import _icp_block_with_searcher as j_icp_block
from moptimizer_0_tpu.registration import icp as j_icp
from moptimizer_0_tpu.registration import icp_batched as j_icp_batched
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch.core import linearize as tlin
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.ops import segment_sum
from moptimizer_0_tpu_torch.ops.nn_search import nearest_neighbors
from moptimizer_0_tpu_torch.registration import (
    _icp_block_with_searcher,
    _median,
    _take,
    icp,
    icp_batched,
)

NUMERIC_ERROR = int(tsol.Status.NUMERIC_ERROR)
CONVERGED = int(tsol.Status.CONVERGED)


def _nan_cloud(seed=0, n=300):
    """The fault's repro: a 300-point uniform cloud as the target, and the
    same cloud with one NaN coordinate as the source."""
    tgt = np.random.default_rng(seed).uniform(0, 10, (n, 3))
    src = tgt.copy()
    src[5, 1] = np.nan
    return src, tgt


def _same_outcome(t, j):
    assert int(t.status) == int(j.status)
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-12, atol=1e-300)
    np.testing.assert_array_equal(np.isnan(t.x.numpy()), np.isnan(np.asarray(j.x)))


@pytest.mark.parametrize(
    "x0,status",
    [(np.zeros(6), CONVERGED), (np.array([0.02, 0.0, 0.0, 0.0, 0.0, 0.0]), NUMERIC_ERROR)],
    ids=["exact_seed", "offset_seed"],
)
def test_f1_icp_with_a_masked_nan_row_matches_jax(x0, status):
    src, tgt = _nan_cloud()
    j = j_icp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(x0), nn_backend="xla")
    t = icp(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(x0), nn_backend="xla")
    assert int(j.status) == status and int(j.iterations) == 0
    assert np.isfinite(float(j.cost))
    _same_outcome(t, j)


def test_f1_icp_batched_with_a_masked_nan_row_matches_jax():
    src, tgt = _nan_cloud()
    clean = np.random.default_rng(1).uniform(0, 10, (300, 3))
    srcs = np.stack([src, clean, src])
    tgts = np.stack([tgt, clean + 0.01, tgt])
    x0s = np.array([np.zeros(6), np.zeros(6), [0.02, 0, 0, 0, 0, 0]])
    j = j_icp_batched(jnp.asarray(srcs), jnp.asarray(tgts), jnp.asarray(x0s))
    t = icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), torch.as_tensor(x0s))
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    assert np.isfinite(np.asarray(j.cost)).all()
    np.testing.assert_allclose(t.cost.numpy(), np.asarray(j.cost), rtol=1e-9, atol=1e-20)
    assert int(t.status[0]) == CONVERGED and int(t.status[2]) == NUMERIC_ERROR


def _generic_blocks():
    """r = x − p per row, masked by v; row 3 is masked and NaN."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(40, 2))
    p[3] = np.nan
    v = np.ones(40, bool)
    v[3] = False
    j = jres.make_block(lambda x, d: (x - d["p"], d["v"]), data=dict(p=jnp.asarray(p), v=jnp.asarray(v)))
    t = tres.make_block(lambda x, d: (x - d["p"], d["v"]), data=dict(p=torch.as_tensor(p), v=torch.as_tensor(v)))
    return j, t


def test_f1_generic_block_and_compute_cost_match_jax():
    jb, tb = _generic_blocks()
    x = np.array([0.3, -0.2])
    # the block as an argument of the jit, as the LM solver passes it: a
    # mask folded in as a constant is not turned into a select
    j_cost = jax.jit(jlin.compute_cost)(jb, jnp.asarray(x))
    t_cost = tlin.compute_cost(tb, torch.as_tensor(x))
    assert np.isfinite(float(j_cost))
    np.testing.assert_allclose(float(t_cost), float(j_cost), rtol=1e-12)
    cfg = dict(diff_mode="auto", max_iterations=10)
    j = jsol.levenberg_marquardt(jres.problem(jb), jnp.asarray(x), jsol.LMConfig(**cfg))
    t = tsol.levenberg_marquardt(tres.problem(tb), torch.as_tensor(x), tsol.LMConfig(**cfg))
    assert int(j.status) == NUMERIC_ERROR and np.isfinite(float(j.cost))
    _same_outcome(t, j)


def test_f2_median_is_nan_for_a_column_with_nan():
    a = np.random.default_rng(3).normal(size=(6, 3))
    a[2, 1] = np.nan
    got = _median(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(jnp.asarray(a), axis=0)))
    assert np.isnan(got[1]) and np.isfinite(got[[0, 2]]).all()


def test_f2_centroid_seed_of_a_cloud_with_nan_matches_jax():
    src, tgt = _nan_cloud()
    j = j_icp(jnp.asarray(src), jnp.asarray(tgt), nn_backend="xla")
    t = icp(torch.as_tensor(src), torch.as_tensor(tgt), nn_backend="xla")
    _same_outcome(t, j)
    jb = j_icp_batched(jnp.asarray(src[None]), jnp.asarray(tgt[None]))
    tb = icp_batched(torch.as_tensor(src[None]), torch.as_tensor(tgt[None]))
    np.testing.assert_array_equal(tb.status.numpy(), np.asarray(jb.status))
    np.testing.assert_array_equal(tb.iterations.numpy(), np.asarray(jb.iterations))
    np.testing.assert_array_equal(np.isnan(tb.x.numpy()), np.isnan(np.asarray(jb.x)))


def _grid_layout(seed, L, K, C, keep, skew=0.0):
    """Random cameras, or with ``skew`` that share of the slots on camera 1."""
    rng = np.random.default_rng(seed)
    cam = rng.integers(0, C, (L, K))
    cam[rng.random((L, K)) < skew] = 1
    mask = torch.as_tensor(rng.random((L, K)) < keep, dtype=torch.float64)
    return torch.as_tensor(cam, dtype=torch.int32), mask


@pytest.mark.parametrize(
    "L,K,C,keep,skew",
    [(50, 7, 5, 0.6, 0.0), (30, 12, 40, 0.3, 0.0), (0, 4, 3, 1.0, 0.0), (10, 3, 4, 0.0, 0.0),
     (400, 6, 60, 0.9, 0.9)],
)
def test_f3_camera_sum_equals_the_per_camera_sum(L, K, C, keep, skew):
    """The plan sums every real slot of each camera once (duplicate cameras
    in a row, cameras with no slot, empty and all-padding grids, and one
    camera holding most slots); each level gathers at most
    n + C·CHUNK items, however busy the busiest camera."""
    cam, mask = _grid_layout(L + K + C, L, K, C, keep, skew)
    vals = torch.as_tensor(np.random.default_rng(5).normal(size=(L * K, 6)))
    want = np.zeros((C, 6))
    for s, (c, m) in enumerate(zip(cam.reshape(-1).tolist(), mask.reshape(-1).tolist())):
        if m > 0:
            want[c] += vals[s].numpy()
    plan = segment_sum.segment_plan(cam, mask, C)
    got = segment_sum.segment_sum(plan, vals)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    again = segment_sum.segment_sum(segment_sum.segment_plan(cam, mask, C), vals)
    assert torch.equal(got, again)
    n = int((mask > 0).sum())
    for idx, _ in plan[0]:
        assert idx.numel() <= n + C * segment_sum.CHUNK
        n = idx.shape[0]
    if skew:
        assert len(plan[0]) == 3  # the busy camera's ~1,900 slots: chunks of 32, of 32, then one


def test_f3_no_index_add_in_the_camera_reductions():
    # U and g, and the rhs reduction (_rhs_reduction, which every damped solve
    # calls through _solve_delta_shards, sharded or not)
    for fn in (tbd._gn_blocks_grouped, tbd._rhs_reduction):
        src = inspect.getsource(fn)
        assert "index_add_" not in src and "scatter_add" not in src and "camera_plan" in src
    src = inspect.getsource(tbd._solve_delta_shards)
    assert "index_add_" not in src and "scatter_add" not in src and "_rhs_reduction" in src
    for fn in (tbd._solve_delta_dense, tbd._dense_outer_step):
        assert "_solve_delta_shards" in inspect.getsource(fn)


def _masking_searcher(cloud, radius):
    """Brute force that answers (−1, +inf) beyond ``radius``, as the grid
    does."""

    def search(warped):
        idx, d2 = j_nn(warped, cloud, backend="xla")
        far = d2 >= radius**2
        return jnp.where(far, -1, idx), jnp.where(far, jnp.inf, d2)

    return search


def test_f4_take_wraps_minus_one_to_the_last_point():
    cloud = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([2, -1, 0], dtype=torch.int32)
    np.testing.assert_array_equal(_take(cloud, idx).numpy(), cloud.numpy()[[2, 3, 0]])
    fleet = torch.stack([cloud, cloud + 100])
    got = _take(fleet, torch.tensor([[-1, 1], [0, -1]]))
    np.testing.assert_array_equal(got.numpy(), np.stack([cloud.numpy()[[3, 1]], cloud.numpy()[[0, 3]] + 100]))


def test_f4_a_searcher_returning_minus_one_matches_jax():
    rng = np.random.default_rng(6)
    tgt = rng.uniform(0, 10, (400, 3))
    src = tgt[:300] + np.array([0.05, -0.03, 0.02])
    src[:20] += 30.0  # far from every target: the searcher answers −1
    radius = 1.0
    cfg = dict(diff_mode="auto", max_iterations=20, linear_solver="cholesky")
    jt = jnp.asarray(tgt)
    jb = j_icp_block(jnp.asarray(src), jt, _masking_searcher(jt, radius), max_corr_dist=radius)
    j = jsol.levenberg_marquardt(jres.problem(jb), jnp.zeros(6), jsol.LMConfig(**cfg))

    tt = torch.as_tensor(tgt)

    def t_search(warped):
        idx, d2 = nearest_neighbors(warped, tt, backend="xla")
        far = d2 >= radius**2
        return torch.where(far, -1, idx), torch.where(far, torch.inf, d2)

    tb = _icp_block_with_searcher(torch.as_tensor(src), tt, t_search, max_corr_dist=radius)
    t = tsol.levenberg_marquardt(tres.problem(tb), torch.zeros(6, dtype=torch.float64), tsol.LMConfig(**cfg))
    assert int(t.status) == int(j.status) != NUMERIC_ERROR
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.x.numpy()[:3], [-0.05, 0.03, -0.02], atol=1e-6)


# JAX package names that the port keeps under another name: the stopwatch
# times any callable to the card's completion, nothing jitted.
RENAMED = {"time_jitted": "time_fn"}
# Subpackages of the JAX package with an __init__, but ``native`` (the C++
# text-cloud parser, not ported: the port reads clouds with numpy).
SUBPACKAGES = ["", "core", "lie", "models", "ops", "parallel", "utils"]


def _exports(package):
    """The public names an ``__init__.py`` binds by its imports."""
    path = pathlib.Path(importlib.import_module(package).__file__)
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_f6_subpackages_export_the_jax_names(sub):
    suffix = f".{sub}" if sub else ""
    want = {RENAMED.get(n, n) for n in _exports("moptimizer_0_tpu" + suffix)}
    got = _exports("moptimizer_0_tpu_torch" + suffix)
    if sub:
        assert got == want
    else:  # the port also exports icp, icp_batched and parallel at the top
        assert want <= got
    module = importlib.import_module("moptimizer_0_tpu_torch" + suffix)
    assert all(hasattr(module, n) for n in got)


def test_f7_nearest_neighbors_takes_the_jax_keywords():
    def keywords(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items() if p.kind == p.KEYWORD_ONLY}

    assert keywords(nearest_neighbors) == keywords(j_nn)
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.uniform(0, 10, (300, 3)))
    p = torch.as_tensor(rng.uniform(0, 10, (200, 3)))
    lanes = (q.reshape(3, 100, 3), p.reshape(2, 100, 3)[[0, 1, 0]])
    cases = [("torch", q, p), ("auto", q, p), ("xla", q, p), ("xla", *lanes)]
    for backend, qq, pp in cases:
        idx, d2 = nearest_neighbors(qq, pp, backend=backend)
        for chunk in (1, 7, 1024):
            i2, e2 = nearest_neighbors(qq, pp, backend=backend, block_q=64, block_p=128, chunk=chunk)
            assert torch.equal(i2, idx) and torch.equal(e2, d2), (backend, chunk)


@pytest.mark.parametrize("x0,terminal", [([0.0, 0.0], False), ([1.2, 2.0], False), ([0.0, 0.0], True)],
                         ids=["start", "far", "nan"])
def test_f8_lm_step_terminal_and_status_are_0_dim_tensors(x0, terminal):
    """From λ = −1: the first step from 0, one from far off,
    and a step on data with a NaN (terminal, NUMERIC_ERROR)."""
    from moptimizer_0_tpu.models.curve_fitting import CERES_CURVE_DATA

    data = CERES_CURVE_DATA.copy()
    if terminal:
        data[5, 1] = np.nan
    tb = tres.make_block(lambda x, d: torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])]),
                         data=torch.as_tensor(data))
    jb = jres.make_block(lambda x, d: jnp.array([d[1] - jnp.exp(x[0] * d[0] + x[1])]), data=jnp.asarray(data))
    t = tsol.lm_step(tres.problem(tb), torch.as_tensor(x0), -1.0, tsol.LMConfig(linear_solver="cholesky"))
    j = jsol.lm_step(jres.problem(jb), jnp.asarray(x0), -1.0, jsol.LMConfig(linear_solver="cholesky"))
    for tv, jv in zip(t[3:5], j[3:5]):
        assert isinstance(tv, torch.Tensor) and tv.shape == () == np.shape(jv)
    assert t[3].dtype == torch.bool and t[4].dtype == torch.int32
    assert bool(t[3]) == bool(j[3]) == terminal
    assert int(t[4]) == int(j[4])
