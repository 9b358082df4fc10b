"""The port's meshes, sharded linearization and distributed LM against the
JAX package's ``parallel`` on its 8 CPU devices (``tests/conftest.py``).

Both packages get the same numpy cloud in float64 on the CPU. Tolerances
and why:

* a padded block is the same sum with exact zeros added: (c, H, b) to
  1e-13 relative, as ``tests/test_sharding.py`` holds JAX's;
* sharded sums add the same terms in other partitions (shards, then the
  mesh reduction): cost to 1e-12 and H, b to 1e-10 relative to the largest
  entry, ``tests/test_sharding.py``'s bounds;
* except fd across packages: an fd column divides the residual's roundoff
  by h = √ε·|x_j| (1.5e-10 at x_j = 0.01), and the two packages' rotations
  round differently, so their fd H and b agree to 1e-6 of the largest
  entry (~1e-7 measured); within the port the rows round alike;
* the distributed LM's trace: costs to 1e-8 relative (1e-18 absolute at the
  noise floor) and x to 1e-10, as ``tests/test_sharding.py``;
* fleet lanes: x to 1e-9, status and iterations equal, as
  ``tests/test_torch_batched_solver.py`` holds ``icp_batched``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu.core.linearize import linearize as j_linearize
from moptimizer_0_tpu.core.residual import make_block as j_make_block
from moptimizer_0_tpu.core.residual import problem as j_problem
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.models.point2point import point2point_block as j_p2p
from moptimizer_0_tpu.parallel import distributed_levenberg_marquardt as j_dist_lm
from moptimizer_0_tpu.parallel import make_mesh as j_make_mesh
from moptimizer_0_tpu.parallel import pad_block_to as j_pad
from moptimizer_0_tpu.parallel import sharded_compute_cost as j_sharded_cost
from moptimizer_0_tpu.parallel import sharded_linearize as j_sharded_lin
from moptimizer_0_tpu.registration import icp_batched as j_icp_batched
from moptimizer_0_tpu.registration import icp_block as j_icp_block
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.linearize import compute_cost, linearize
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import levenberg_marquardt
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.models.point2point import point2point_block
from moptimizer_0_tpu_torch.parallel import (
    distributed_levenberg_marquardt,
    make_mesh,
    pad_block_to,
    shard_block_data,
    sharded_compute_cost,
    sharded_linearize,
)
from moptimizer_0_tpu_torch.registration import icp, icp_batched, icp_block

X_TRUE = np.array([1.0, 2.0, 3.0, 0.2, 0.2, 0.2])
X_EVAL = np.array([0.1, -0.2, 0.3, 0.01, 0.02, 0.03])
N_ROWS = 777  # not a multiple of 2 or 8: the sharded paths pad
FD_RTOL = 1e-6
# (name, port block kwargs, derivative mode)
MODES = [
    ("auto-fused", dict(analytic=True), "auto"),
    ("auto-jacfwd", dict(analytic=True, fused=False), "auto"),
    ("analytic", dict(analytic=True), "analytic"),
    ("fd", dict(analytic=True), "fd"),
]


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(42)
    src = rng.uniform(0, 10, size=(4096, 3))
    T = np.asarray(jse3.transform_from_params6(jnp.asarray(X_TRUE)))
    return src, src @ T[:3, :3].T + T[:3, 3]


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(b)), 1e-300)
    assert np.max(np.abs(a - b)) <= rtol * scale, (np.max(np.abs(a - b)), scale)


def _port_block(src, tgt, **kw):
    return point2point_block(torch.as_tensor(src), torch.as_tensor(tgt), **kw)


@pytest.mark.parametrize("name,kw,mode", MODES, ids=[m[0] for m in MODES])
def test_pad_block_to_keeps_the_system(cloud, name, kw, mode):
    """pad_block_to adds masked rows only; the fused linearizer sees through
    the {_inner, _valid} wrapping and agrees with JAX's on the padded block."""
    src, tgt = cloud[0][:N_ROWS], cloud[1][:N_ROWS]
    x = torch.as_tensor(X_EVAL)
    blk = _port_block(src, tgt, **kw)
    padded = pad_block_to(blk, 8)
    assert padded.data["_valid"].shape == (784,) and int(padded.data["_valid"].sum()) == N_ROWS
    assert pad_block_to(padded, 8) is padded
    for a, b in zip(linearize(padded, x, mode=mode), linearize(blk, x, mode=mode)):
        _close(a, b, 1e-13)
    _close(compute_cost(padded, x), compute_cost(blk, x), 1e-13)
    if name == "auto-fused":
        j_padded = j_pad(j_p2p(jnp.asarray(src), jnp.asarray(tgt), analytic=True), 8)
        for a, b in zip(linearize(padded, x, mode=mode), j_linearize(j_padded, jnp.asarray(X_EVAL), mode=mode)):
            _close(a, b, 1e-12)


@pytest.mark.parametrize("name,kw,mode", MODES, ids=[m[0] for m in MODES])
def test_sharded_linearize_matches_jax(cloud, name, kw, mode):
    """(c, H, b) and the cost over 1, 2 and 8 shards against JAX's
    shard_map on make_mesh(8), and against the unsharded linearization."""
    src, tgt = cloud[0][:N_ROWS], cloud[1][:N_ROWS]
    x = torch.as_tensor(X_EVAL)
    j_blk = j_p2p(jnp.asarray(src), jnp.asarray(tgt), **kw)
    # jitted: JAX's eager shard_map takes 20-50 s here
    jc, jH, jb = jax.jit(lambda b, x: j_sharded_lin(b, x, j_make_mesh(8), mode=mode))(j_blk, jnp.asarray(X_EVAL))
    j_cost = jax.jit(lambda b, x: j_sharded_cost(b, x, j_make_mesh(8)))(j_blk, jnp.asarray(X_EVAL))
    blk = _port_block(src, tgt, **kw)
    single = linearize(blk, x, mode=mode)
    for n in (1, 2, 8):
        mesh = make_mesh(n, device="cpu")
        c, H, b = sharded_linearize(blk, x, mesh, mode=mode)
        _close(c, jc, 1e-12)
        _close(H, jH, FD_RTOL if mode == "fd" else 1e-10)
        _close(b, jb, FD_RTOL if mode == "fd" else 1e-10)
        for a, s in zip((c, H, b), single):
            _close(a, s, 1e-10)
        _close(sharded_compute_cost(blk, x, mesh), j_cost, 1e-12)


def test_mesh_layout_and_shard_blocks(cloud):
    mesh = make_mesh(4, axis="fleet", device="cpu")
    assert mesh.shape == {"fleet": 4} and mesh.axis_names == ("fleet",) and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="axes"):
        mesh.check_axis("data")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)
    blk = _port_block(cloud[0][:8], cloud[1][:8])
    shards = shard_block_data(blk, mesh, "fleet")
    assert len(shards) == 4
    np.testing.assert_array_equal(torch.cat([s.data["src"] for s in shards]).numpy(), cloud[0][:8])
    with pytest.raises(ValueError, match="pad_block_to"):
        shard_block_data(_port_block(cloud[0][:7], cloud[1][:7]), mesh, "fleet")
    mesh3 = make_mesh(3, device="cpu")
    parts = [torch.tensor([1.0, -2.0]), torch.tensor([0.5, 4.0]), torch.tensor([3.0, 0.0])]
    np.testing.assert_array_equal(mesh3.psum(parts).numpy(), [4.5, 2.0])
    np.testing.assert_array_equal(mesh3.pmax(parts).numpy(), [3.0, 4.0])


@pytest.fixture(scope="module")
def dist_lm_jax(cloud):
    src, tgt = cloud
    cfg = JLMConfig(diff_mode="auto", max_iterations=30)
    return j_dist_lm(j_problem(j_p2p(jnp.asarray(src), jnp.asarray(tgt))), jnp.zeros(6), j_make_mesh(8), cfg)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_distributed_lm_matches_jax(cloud, dist_lm_jax, n_shards):
    """The pattern of tests/test_sharding.py::test_distributed_lm_matches_single_device:
    the trace of the distributed LM against JAX's on make_mesh(8) and the
    port's own single-device solve (4,096 rows: 3 shards pad)."""
    src, tgt = cloud
    cfg = interop.config_from_fields(dict(diff_mode="auto", max_iterations=30))
    blk = _port_block(src, tgt)
    res = distributed_levenberg_marquardt(problem(blk), torch.zeros(6, dtype=torch.float64),
                                          make_mesh(n_shards, device="cpu"), cfg)
    single = levenberg_marquardt(problem(blk), torch.zeros(6, dtype=torch.float64), cfg)
    for ref in (dist_lm_jax, single):
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10)
        assert int(res.status) == int(ref.status)
        assert int(res.iterations) == int(ref.iterations)
        np.testing.assert_allclose(res.trace["cost"].numpy(), np.asarray(ref.trace["cost"]),
                                   rtol=1e-8, atol=1e-18, equal_nan=True)
    T_est = se3.transform_from_params6(res.x).numpy()
    T_true = np.asarray(jse3.transform_from_params6(jnp.asarray(X_TRUE)))
    np.testing.assert_allclose(T_est, T_true, atol=1e-5)


def test_distributed_lm_with_updates_and_a_dataless_block(cloud):
    """An ICP block (one correspondence search a shard an outer iteration)
    beside a block without data (counted once, on the first shard): equal
    to JAX's distributed LM of the same problem on make_mesh(4), where GSPMD
    replicates the dataless block, and to the port's single-device solve.
    600 rows divide 4 shards: neither package pads a block with an update
    hook. JAX searches with "xla", whose matmul cross term can only part
    from the plain search at near ties, which 600 points 1 m apart lack."""
    src, tgt = torch.as_tensor(cloud[0][:600]), torch.as_tensor(cloud[1][:600])
    x_true = torch.as_tensor([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], dtype=torch.float64)
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    prior = make_block(lambda x, d: 1e-3 * (x - x_true), data=None, name="prior")
    fields = dict(diff_mode="auto", max_iterations=20, linear_solver="cholesky")
    cfg = interop.config_from_fields(fields)
    jx_true = jnp.asarray(x_true.numpy())
    j_prior = j_make_block(lambda x, d: 1e-3 * (x - jx_true), data=None, name="prior")
    j_blk = j_icp_block(jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy()), nn_backend="xla")
    j_res = j_dist_lm(j_problem(j_blk, j_prior), jnp.zeros(6), j_make_mesh(4), JLMConfig(**fields))
    x0 = torch.zeros(6, dtype=torch.float64)
    searches = []

    def counted(name):
        blk = icp_block(src, tgt, nn_backend="torch")
        inner = blk.update_fn

        def update_fn(x, data):
            searches.append(name)
            return inner(x, data)

        return dataclasses.replace(blk, update_fn=update_fn)

    single = levenberg_marquardt(problem(counted("single"), prior), x0, cfg)
    n_single = len(searches)
    res = distributed_levenberg_marquardt(problem(counted("dist"), prior), x0, make_mesh(4, device="cpu"), cfg)
    for ref in (j_res, single):
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10)
        np.testing.assert_allclose(res.trace["cost"].numpy(), np.asarray(ref.trace["cost"]),
                                   rtol=1e-8, atol=1e-18, equal_nan=True)
        assert int(res.status) == int(ref.status)
        assert int(res.iterations) == int(ref.iterations)
    outer = int(np.isfinite(res.trace["cost"].numpy()).sum())
    assert len(searches) - n_single == 4 * outer
    np.testing.assert_allclose(res.x.numpy(), x_true.numpy(), atol=1e-6)
    np.testing.assert_allclose(icp(src, tgt, nn_backend="torch").x.numpy(), x_true.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def fleet():
    """tests/test_sharding.py's fleet (8 lanes of 256 points), JAX's sharded
    solve of it and the port's unsharded one."""
    rng = np.random.default_rng(7)
    B, N = 8, 256
    srcs = np.stack([rng.uniform(0, 4, size=(N, 3)) for _ in range(B)])
    x_true = np.stack(
        [np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.1, 0.1, 3)]) for _ in range(B)]
    )
    Ts = [np.asarray(jse3.transform_from_params6(jnp.asarray(x))) for x in x_true]
    tgts = np.stack([s @ T[:3, :3].T + T[:3, 3] for s, T in zip(srcs, Ts)])
    fields = dict(diff_mode="auto", max_iterations=12, linear_solver="cholesky")
    j_res = j_icp_batched(srcs, tgts, config=JLMConfig(**fields), mesh=j_make_mesh(8, axis="fleet"))
    plain = icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), config=interop.config_from_fields(fields))
    return srcs, tgts, x_true, fields, j_res, plain


@pytest.mark.parametrize("n_shards", [2, 8])
def test_icp_batched_mesh_matches_jax(fleet, n_shards):
    srcs, tgts, x_true, fields, j_res, plain = fleet
    cfg = interop.config_from_fields(fields)
    mesh = make_mesh(n_shards, axis="fleet", device="cpu")
    res = icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), config=cfg, mesh=mesh)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j_res.x), atol=1e-9)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(j_res.status))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(j_res.iterations))
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), atol=1e-9)
    assert res.trace["inner"]["rho"].shape == plain.trace["inner"]["rho"].shape
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-3)
    with pytest.raises(ValueError, match="must divide"):
        icp_batched(torch.as_tensor(srcs[:6]), torch.as_tensor(tgts[:6]), config=cfg,
                    mesh=make_mesh(4, axis="fleet", device="cpu"))
