"""The port's landmark-sharded dense-Schur BA against the JAX package's
``solve_ba_dense_sharded`` on its 8 CPU devices (``tests/conftest.py``).

The cases of ``tests/test_ba_dense.py`` (L = 41, not a shard multiple; 1-,
2- and 8-way invariance; Huber loss with two fixed cameras) and of
``tests/test_ba_dense_segmented.py`` (a segmented grid flattened), in
float64 on the CPU, each JAX solve made once. Tolerances and why:

* status and iterations equal; cameras, points, the final cost and the
  trace's cost, cost_new and λ to 1e-9 relative, and ρ to 1e-9 +
  1e-12·|y0|/|y0 − yi|: both packages sum the shards' camera-space
  objects, in other orders (JAX's psum, the port's shard order), so the
  solves part by roundoff, which ρ's difference of two costs magnifies
  (``tests/test_torch_ba_dense.py``'s bounds for the unsharded solve);
* L = 41 runs 10 iterations into the noise floor, where the sign of ρ is
  roundoff's: it is held to JAX's result with the bounds below;
* against the port's own single-device solve, the bounds
  ``tests/test_ba_dense.py`` holds JAX's sharded solve to (1e-7 on the state,
  1e-9 on the trace's costs over the common iterations, which may differ
  by one where a SMALL_DELTA stop falls on roundoff).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu.core.loss import Huber as JHuber
from moptimizer_0_tpu.parallel import make_mesh as j_make_mesh
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.loss import Huber
from moptimizer_0_tpu_torch.parallel import make_mesh

from test_ba import make_synthetic_ba
from test_ba_dense_segmented import make_skewed_ba
from test_torch_ba_dense import assert_same_solve, jax_result_to_numpy, port


def _robust_problem():
    start, _ = make_synthetic_ba(C=5, L=23, noise=0.4, seed=29, n_fixed=2)
    pix = np.array(start.pixels)
    pix[::7] += 40.0  # outliers, so that the robust weights vary
    return dataclasses.replace(start, pixels=jnp.asarray(pix), loss=JHuber(delta=5.0))


# name → (JAX problem, DenseBAConfig fields, JAX mesh size, port losses)
CASES = {
    "L41": (lambda: make_synthetic_ba(C=5, L=41, noise=0.3, seed=13)[0],
            dict(max_iterations=10, schur_chunk=8), 8),
    "invariance": (lambda: make_synthetic_ba(C=4, L=24, noise=0.5, seed=21)[0],
                   dict(max_iterations=6, schur_chunk=4), 8),
    "robust": (_robust_problem, dict(max_iterations=8, schur_chunk=4), 8),
}


def _port(jprob):
    return port(jprob, None if jprob.loss is None else Huber(delta=float(jprob.loss.delta)))


def _assert_close_solve(t, ref):
    """tests/test_ba_dense.py's bounds for a sharded solve against another."""
    assert abs(int(t["iterations"]) - int(ref["iterations"])) <= 1
    n = min(int(t["iterations"]), int(ref["iterations"]))
    np.testing.assert_allclose(t["trace"]["cost"][:n], ref["trace"]["cost"][:n], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(t["camera_params"], ref["camera_params"], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(t["points"], ref["points"], rtol=1e-7, atol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax(name):
    make, cfg, n = CASES[name]
    jprob = make()
    return jprob, jbd.solve_ba_dense_sharded(jprob, j_make_mesh(n), jbd.DenseBAConfig(**cfg))


@pytest.mark.parametrize(
    "name,n_shards",
    [("L41", 8), ("L41", 3), ("invariance", 1), ("invariance", 2), ("invariance", 8), ("robust", 8),
     ("robust", 2)],
)
def test_sharded_solve_matches_jax(name, n_shards):
    jprob, j_res = _jax(name)
    cfg = interop.dense_config_from_fields(CASES[name][1])
    tprob = _port(jprob)
    res = tbd.solve_ba_dense_sharded(tprob, make_mesh(n_shards, device="cpu"), cfg)
    t = interop.result_to_numpy(res)
    assert t["points"].shape == tuple(tprob.points.shape)
    if name == "L41":
        _assert_close_solve(t, jax_result_to_numpy(j_res))
    else:
        assert_same_solve(res, j_res)
    # against the port's own single-device solve
    _assert_close_solve(t, interop.result_to_numpy(tbd.solve_ba_dense(tprob, cfg)))
    if name == "robust":  # gauge fixing
        assert torch.equal(res.camera_params[:2], tprob.camera_params[:2])


def test_segmented_grid_is_flattened():
    """tests/test_ba_dense_segmented.py's case: a segments=3 grid, 2 shards."""
    jprob = make_skewed_ba(seed=7)
    cfg = dict(max_iterations=3, schur_chunk=16)
    j_mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    j_res = jbd.solve_ba_dense_sharded(
        jprob, j_mesh, jbd.DenseBAConfig(**cfg), grouped=jbd.group_by_landmark(jprob, segments=3)
    )
    tprob = _port(jprob)
    grouped = tbd.group_by_landmark(tprob, segments=3)
    assert grouped.seg_bounds
    res = tbd.solve_ba_dense_sharded(tprob, make_mesh(2, device="cpu"), tbd.DenseBAConfig(**cfg), grouped=grouped)
    assert_same_solve(res, j_res)
    ref = tbd.solve_ba_dense(tprob, tbd.DenseBAConfig(**cfg))
    eps = np.finfo(np.float64).eps
    assert abs(float(res.cost) - float(ref.cost)) < 1e5 * eps * max(1.0, float(ref.cost))


def test_sharded_solve_repeats_bit_for_bit():
    """Two 4-shard solves of one problem are bit-equal; a mesh without the
    axis is refused."""
    tprob = _port(_jax("invariance")[0])
    cfg = interop.dense_config_from_fields(CASES["invariance"][1])
    a = interop.result_to_numpy(tbd.solve_ba_dense_sharded(tprob, make_mesh(4, device="cpu"), cfg))
    b = interop.result_to_numpy(tbd.solve_ba_dense_sharded(tprob, make_mesh(4, device="cpu"), cfg))
    for key in ("camera_params", "points", "cost", "status", "iterations"):
        np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="axes"):
        tbd.solve_ba_dense_sharded(tprob, make_mesh(2, device="cpu"), cfg, axis="fleet")
