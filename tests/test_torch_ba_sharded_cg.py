"""The port's observation-sharded Schur-CG bundle adjustment against the JAX
package's solve (``tests/test_ba.py::test_ba_sharded_observations_match``).

JAX shards ``cam_idx``, ``pt_idx`` and ``pixels`` along ``P("data")`` and
GSPMD reduces the segment sums over the mesh; the port takes the same
arrays as ``GlobalArray``s (``multihost.make_global_array``) over
``make_mesh(n, device="cpu")``. Float64 on the CPU, the problems built by
the JAX helpers and carried across as numpy. Tolerances and why:

* against the JAX single-device solve, cameras and points to 1e-8 absolute:
  the bound ``tests/test_ba.py`` holds JAX's own sharded solve to;
* against the port's unsharded solve (with and without a robust loss), the
  same bound, and the trace's costs to 1e-9 relative and 1e-12 of the start
  cost (this noise-free problem descends to ~1e-20, where roundoff is all
  that is left): the shards sum U, V, g, h, the costs and each matvec's two
  reductions in another order than one segment sum over all rows;
* two 4-shard solves, and a 1-shard mesh against the unsharded engine, bit
  for bit: the shard order is fixed and one shard is the unsharded step.

A row count that the mesh does not divide is refused, as JAX's
``device_put`` refuses it (checked on the JAX side too).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu.parallel import make_mesh as j_make_mesh
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_intrinsics
from moptimizer_0_tpu_torch.core.loss import Huber
from moptimizer_0_tpu_torch.parallel import make_mesh, multihost

from test_ba import make_synthetic_ba
from test_torch_ba_cg import port

CFG = dict(max_iterations=10)


@pytest.fixture(scope="module")
def case():
    """tests/test_ba.py's sharded problem (O = 128) and JAX's single-device solve."""
    start, _ = make_synthetic_ba(C=4, L=32, n_fixed=2, seed=6)
    return start, jba.solve_ba(start, jba.BAConfig(**CFG))


def sharded(prob, n):
    """The port's problem with its observations sharded over n CPU shards."""
    mesh = make_mesh(n, device="cpu")
    return dataclasses.replace(
        prob, **{k: multihost.make_global_array(getattr(prob, k), mesh) for k in ("cam_idx", "pt_idx", "pixels")}
    )


def _same(a, b):
    return all(
        torch.equal(x, y)
        for x, y in [(a.camera_params, b.camera_params), (a.points, b.points), (a.cost, b.cost)]
        + [(a.trace[k], b.trace[k]) for k in ("trials",)]
    ) and torch.equal(torch.nan_to_num(a.trace["cost"]), torch.nan_to_num(b.trace["cost"]))


def test_eight_shards_match_jax_single_solve(case):
    start, ref = case
    res = tba.solve_ba(sharded(port(start), 8), tba.BAConfig(**CFG))
    np.testing.assert_allclose(res.camera_params.numpy(), np.asarray(ref.camera_params), atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(ref.points), atol=1e-8)
    np.testing.assert_array_equal(res.camera_params[:2].numpy(), np.asarray(start.camera_params)[:2])
    assert int(res.status) == int(ref.status)


@pytest.mark.parametrize("n,loss", [(2, None), (8, None), (4, Huber(delta=1.0))])
def test_sharded_matches_port_unsharded(case, n, loss):
    prob = dataclasses.replace(port(case[0]), loss=loss)
    single = tba.solve_ba(prob, tba.BAConfig(**CFG))
    res = tba.solve_ba(sharded(prob, n), tba.BAConfig(**CFG))
    np.testing.assert_allclose(res.camera_params.numpy(), single.camera_params.numpy(), atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), single.points.numpy(), atol=1e-8)
    run = int(torch.isfinite(single.trace["cost"]).sum())
    costs = single.trace["cost"][:run].numpy()
    np.testing.assert_allclose(res.trace["cost"][:run].numpy(), costs, rtol=1e-9, atol=1e-12 * costs[0])
    assert float(tba.compute_cost(sharded(prob, n))) == pytest.approx(float(tba.compute_cost(prob)), rel=1e-12)


def test_four_shard_repeat_and_one_shard_bit_equal(case):
    prob = port(case[0])
    a = tba.solve_ba(sharded(prob, 4), tba.BAConfig(**CFG))
    b = tba.solve_ba(sharded(prob, 4), tba.BAConfig(**CFG))
    assert _same(a, b)
    assert _same(tba.solve_ba(sharded(prob, 1), tba.BAConfig(**CFG)), tba.solve_ba(prob, tba.BAConfig(**CFG)))


def test_ba_step_on_sharded_problem(case):
    prob = port(case[0])
    cams, pts, lam, terminal, status, record = tba.ba_step(sharded(prob, 4), -1.0)
    cams1, pts1, lam1, terminal1, status1, record1 = tba.ba_step(prob, -1.0)
    np.testing.assert_allclose(cams.numpy(), cams1.numpy(), atol=1e-10)
    np.testing.assert_allclose(pts.numpy(), pts1.numpy(), atol=1e-10)
    assert float(record["cost"]) == pytest.approx(float(record1["cost"]), rel=1e-12)
    assert float(lam) == pytest.approx(float(lam1), rel=1e-12)
    assert (terminal, status, record["trials"]) == (terminal1, status1, record1["trials"])
    assert tba.residuals_all(sharded(prob, 4)).shape == (128, 2)


def test_rows_that_do_not_divide_the_mesh_are_refused(case):
    start = case[0]
    with pytest.raises(ValueError, match="divisible by 8"):
        jax.device_put(start.cam_idx[:127], NamedSharding(j_make_mesh(8), PartitionSpec("data")))
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        multihost.make_global_array(port(start).cam_idx[:127], mesh)
    prob = sharded(port(start), 8)
    mixed = dataclasses.replace(prob, pixels=prob.pixels.local)
    for solve in (tba.solve_ba, ba_intrinsics.solve_ba_selfcal):
        with pytest.raises(ValueError, match="GlobalArrays of one mesh"):
            solve(mixed)


@pytest.mark.parametrize("engine", ["auto", "dense"])
def test_dense_routes_on_sharded_problem(case, engine):
    """Within one process JAX routes the sharded problem on its host-read
    incidence and the dense engine solves it on one device; so does the port."""
    start = case[0]
    j_shard = NamedSharding(j_make_mesh(8), PartitionSpec("data"))
    j_start = dataclasses.replace(
        start, **{k: jax.device_put(getattr(start, k), j_shard) for k in ("cam_idx", "pt_idx", "pixels")}
    )
    assert jba.select_engine(j_start) == "dense"
    ref = jba.solve_ba(j_start, jba.BAConfig(**CFG), engine=engine)
    prob = sharded(port(start), 8)
    assert tba.select_engine(prob) == "dense"
    res = tba.solve_ba(prob, tba.BAConfig(**CFG), engine=engine)
    np.testing.assert_allclose(res.camera_params.numpy(), np.asarray(ref.camera_params), atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(ref.points), atol=1e-8)


def test_auto_routes_past_the_camera_bound_to_sharded_cg(case, monkeypatch):
    """A problem that "auto" routes to CG runs the sharded CG engine."""
    prob = sharded(port(case[0]), 4)
    monkeypatch.setattr(tba, "DENSE_MAX_CAMERAS", 3)
    assert tba.select_engine(prob) == "cg"
    assert _same(tba.solve_ba(prob, tba.BAConfig(**CFG), engine="auto"), tba.solve_ba(prob, tba.BAConfig(**CFG)))
