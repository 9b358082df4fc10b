"""The port's self-calibrating BA on observation-sharded problems against the
JAX package's unsharded self-calibration.

The JAX package runs ``solve_ba_selfcal`` on observations sharded along
``P("data")`` under GSPMD, with no sharding code of its own; the port takes
``cam_idx``, ``pt_idx`` and ``pixels`` as ``GlobalArray``s
(``multihost.make_global_array``) over ``make_mesh(n, device="cpu")``.
Float64 on the CPU, the problem of ``tests/test_torch_ba_intrinsics.py``'s
JAX parity test (C = 5, L = 40, O = 200, 0.2 px noise, intrinsics off by
[+8, −6, +3, −2]). Tolerances and why:

* against JAX's unsharded solve and step, with and without a robust loss:
  status and iterations equal, θ, cameras, points and cost to 1e-9
  relative, the bound of the unsharded parity test. The shards sum U, V,
  P, Y, Z, g, h, g_t, the costs and each matvec's two reductions in
  another order than one sum over all rows, a roundoff far below it; the
  solve stops on ``rel_cost_tol`` before the noise floor, where the accept
  decisions would be roundoff's choice;
* a 1-shard mesh against the unsharded solve, and two 4-shard solves, bit
  for bit: one shard is the unsharded step, and the shard order is fixed.

A row count that the mesh does not divide is refused, as JAX's
``device_put`` refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_intrinsics as jbi
from moptimizer_0_tpu.core.loss import Huber as JHuber
from moptimizer_0_tpu.parallel import make_mesh as j_make_mesh
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_intrinsics as tbi
from moptimizer_0_tpu_torch.core.loss import Huber
from moptimizer_0_tpu_torch.parallel import make_mesh, multihost
from moptimizer_0_tpu_torch.parallel.mesh import GlobalArray

from test_ba import make_synthetic_ba
from test_torch_ba_cg import port, rel_err
from test_torch_ba_intrinsics import WRONG
from test_torch_ba_sharded_cg import sharded

CFG = dict(max_iterations=20, rel_cost_tol=1e-10)
DELTA = 0.3  # Huber's δ in px: below the noise's largest residuals, so weights bite


@pytest.fixture(scope="module")
def start():
    jprob, gt = make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)
    return dataclasses.replace(jprob, intrinsics=gt.intrinsics + jnp.asarray(WRONG))


def _same(a, b):
    (ra, ia), (rb, ib) = a, b
    return all(torch.equal(x, y) for x, y in [(ra.camera_params, rb.camera_params), (ra.points, rb.points),
                                               (ra.cost, rb.cost), (ia, ib), (ra.iterations, rb.iterations)])


@pytest.mark.parametrize("n,huber", [(2, False), (8, False), (4, True)])
def test_sharded_selfcal_matches_jax_unsharded(start, n, huber):
    jprob = dataclasses.replace(start, loss=JHuber(delta=DELTA) if huber else None)
    prob = sharded(port(start, loss=Huber(delta=DELTA) if huber else None), n)
    jres, jintr = jbi.solve_ba_selfcal(jprob, jba.BAConfig(**CFG))
    res, intr = tbi.solve_ba_selfcal(prob, tba.BAConfig(**CFG))
    assert int(jres.iterations) >= 4
    assert (int(res.status), int(res.iterations)) == (int(jres.status), int(jres.iterations))
    for t, j in [(intr, jintr), (res.camera_params, jres.camera_params), (res.points, jres.points)]:
        assert rel_err(t, j) < 1e-9
    assert abs(float(res.cost) / float(jres.cost) - 1) < 1e-9
    np.testing.assert_array_equal(res.camera_params[:2].numpy(), np.asarray(start.camera_params)[:2])
    j = jbi.ba_step_selfcal(jprob, -1.0, jba.BAConfig(**CFG))
    t = tbi.ba_step_selfcal(prob, -1.0, tba.BAConfig(**CFG))
    for tv, jv in zip(t[:4], j[:4]):
        assert rel_err(tv, jv) < 1e-9
    assert t[4] == bool(j[4]) and int(t[5]) == int(j[5])


def test_one_shard_and_a_repeat_bit_equal(start):
    prob = port(start)
    single = tbi.solve_ba_selfcal(prob, tba.BAConfig(**CFG))
    assert _same(tbi.solve_ba_selfcal(sharded(prob, 1), tba.BAConfig(**CFG)), single)
    assert _same(tbi.solve_ba_selfcal(sharded(prob, 4), tba.BAConfig(**CFG)),
                 tbi.solve_ba_selfcal(sharded(prob, 4), tba.BAConfig(**CFG)))
    a, b = tbi.ba_step_selfcal(sharded(prob, 1), -1.0), tbi.ba_step_selfcal(prob, -1.0)
    assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])) and a[4:6] == b[4:6]
    assert all(torch.equal(a[6][k], b[6][k]) for k in ("cost", "cost_new", "rho", "lam"))


def test_rows_that_do_not_divide_the_mesh_are_refused(start):
    with pytest.raises(ValueError, match="divisible by 8"):
        jax.device_put(start.cam_idx[:199], NamedSharding(j_make_mesh(8), PartitionSpec("data")))
    prob = port(start)
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        multihost.make_global_array(prob.cam_idx[:199], mesh)
    # GlobalArrays made by hand, past make_global_array's check
    ragged = dataclasses.replace(prob, **{
        k: GlobalArray(local=getattr(prob, k)[:199], mesh=mesh, axis="data", shape=(199, *getattr(prob, k).shape[1:]))
        for k in ("cam_idx", "pt_idx", "pixels")
    })
    for call in (lambda: tbi.solve_ba_selfcal(ragged), lambda: tbi.ba_step_selfcal(ragged, -1.0)):
        with pytest.raises(ValueError, match="do not divide"):
            call()
