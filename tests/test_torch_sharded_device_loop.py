"""The port's sharded solves as the bodies of their CUDA-graph loops, on the
CPU, against the JAX package's jitted sharded solves on its 8 CPU devices
(``tests/conftest.py``); and what decides and keys their capture.

On CUDA a sharded solve whose mesh lies in one process on its device is
captured once per layout (``ops.device_loop``). Here the ``sharded``
fixture makes ``device_loop.graphs`` say yes and leaves out the capture
itself (``StepLoop._capture``), so each solve goes through the engines'
graph path (the layout's key, ``device_loop.cached``, the loop kept and
started again) and runs the same step body eagerly, which is what the card
replays. Float64, the problems of the sharded tests they follow.
Tolerances and why:

* the distributed LM over an ICP block with its update hook (2 shards):
  x to 1e-10 and the trace's costs to 1e-8 relative (1e-18 absolute at the
  noise floor), ``tests/test_torch_parallel.py``'s bounds;
* ``solve_ba`` on ``GlobalArray`` observations: cameras and points to 1e-8
  absolute, the bound ``tests/test_ba.py`` holds JAX's sharded solve to
  (``tests/test_torch_ba_sharded_cg.py``);
* the sharded self-calibration: status and iterations equal, θ, cameras,
  points and cost to 1e-9 relative (``tests/test_torch_ba_selfcal_sharded.py``);
* ``solve_ba_dense_sharded``: ``assert_same_solve``'s 1e-9 relative with ρ's
  roundoff allowance (``tests/test_torch_ba_sharded.py``);
* a second solve of one layout, through the kept loop, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu import ba_intrinsics as jbi
from moptimizer_0_tpu.core.residual import problem as j_problem
from moptimizer_0_tpu.parallel import distributed_levenberg_marquardt as j_dist_lm
from moptimizer_0_tpu.registration import icp_block as j_icp_block
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch import ba_intrinsics as tbi
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core import solver
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.parallel import distributed_levenberg_marquardt, make_mesh, mesh as mesh_module
from moptimizer_0_tpu_torch.parallel.mesh import Mesh
from moptimizer_0_tpu_torch.parallel.sharded import ShardedProblem
from moptimizer_0_tpu_torch.registration import icp_block

from test_ba import make_synthetic_ba
from test_torch_ba_cg import port, rel_err
from test_torch_ba_dense import assert_same_solve
from test_torch_ba_intrinsics import WRONG
from test_torch_ba_sharded_cg import sharded as observation_sharded

LM_FIELDS = dict(diff_mode="auto", max_iterations=20, linear_solver="cholesky")
CG_CFG = dict(max_iterations=10)
SELFCAL_CFG = dict(max_iterations=20, rel_cost_tol=1e-10)
DENSE_CFG = dict(max_iterations=6, schur_chunk=4)


@pytest.fixture
def sharded(monkeypatch):
    """The engines take their graph path on the CPU, capture left out: the
    keys their solves ask ``device_loop.cached`` for, and the names of the
    loops made (each would be one capture)."""
    keys, made = [], []
    real = device_loop.cached

    def cached(parts, make):
        keys.append(tuple(device_loop.key_part(p) for p in parts))
        return real(parts, make)

    monkeypatch.setattr(device_loop, "graphs", lambda t: True)
    monkeypatch.setattr(device_loop, "cached", cached)
    monkeypatch.setattr(device_loop.StepLoop, "_capture", lambda self, name: made.append(name))
    device_loop.clear()
    yield keys, made
    device_loop.clear()


def _icp_scene(n=600):
    rng = np.random.default_rng(42)
    src = torch.as_tensor(rng.uniform(0, 10, size=(n, 3)))
    x_true = torch.as_tensor([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], dtype=torch.float64)
    T = se3.transform_from_params6(x_true)
    return src, src @ T[:3, :3].T + T[:3, 3], x_true


def _same_lm(a, b):
    return all(torch.equal(torch.nan_to_num(getattr(a, f)), torch.nan_to_num(getattr(b, f)))
               for f in ("x", "status", "iterations", "cost", "lam")) and all(
        torch.equal(torch.nan_to_num(a.trace[k]), torch.nan_to_num(b.trace[k])) for k in ("cost", "cost_new", "lam"))


def test_distributed_lm_body_matches_jax(sharded):
    """An ICP block over 2 shards (a correspondence search a shard an outer
    iteration, its matches in the carry) against JAX's distributed LM on 2
    of its devices; a second solve of the layout replays the kept loop."""
    keys, made = sharded
    src, tgt, x_true = _icp_scene()
    j_blk = j_icp_block(jnp.asarray(src.numpy()), jnp.asarray(tgt.numpy()), nn_backend="xla")
    j_res = j_dist_lm(j_problem(j_blk), jnp.zeros(6), JMesh(np.array(jax.devices()[:2]), ("data",)),
                      JLMConfig(**LM_FIELDS))
    blk = icp_block(src, tgt, nn_backend="torch")
    cfg = interop.config_from_fields(LM_FIELDS)
    x0 = torch.zeros(6, dtype=torch.float64)
    res = distributed_levenberg_marquardt(problem(blk), x0, make_mesh(2, device="cpu"), cfg)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(j_res.x), atol=1e-10)
    np.testing.assert_allclose(res.trace["cost"].numpy(), np.asarray(j_res.trace["cost"]),
                               rtol=1e-8, atol=1e-18, equal_nan=True)
    assert (int(res.status), int(res.iterations)) == (int(j_res.status), int(j_res.iterations))
    np.testing.assert_allclose(res.x.numpy(), x_true.numpy(), atol=1e-6)
    again = distributed_levenberg_marquardt(problem(blk), x0, make_mesh(2, device="cpu"), cfg)
    assert _same_lm(again, res)
    assert len(keys) == 2 and keys[0] == keys[1] and made == ["lm_step P=6 shards=2"]


def test_distributed_lm_layout_keys(sharded):
    """2 and 6 shards of one block are two layouts (the mesh and each
    shard's rows in the key), two solves of one layout one; lm_step on a
    ShardedProblem asks for the solve's key."""
    keys, made = sharded
    src, tgt, _ = _icp_scene()
    blk = icp_block(src, tgt, nn_backend="torch")
    cfg = interop.config_from_fields(dict(LM_FIELDS, max_iterations=3))
    x0 = torch.zeros(6, dtype=torch.float64)
    for n in (2, 6, 2, 6):
        distributed_levenberg_marquardt(problem(blk), x0, make_mesh(n, device="cpu"), cfg)
    assert keys[0] != keys[1] and keys[2:] == keys[:2]
    assert made == ["lm_step P=6 shards=2", "lm_step P=6 shards=6"]
    # one step of the 2-shard layout through lm_step: the solve's loop
    mesh = make_mesh(2, device="cpu")
    shards = tuple(problem(b) for b in (dataclasses.replace(blk, data={k: v[i * 300:(i + 1) * 300]
                                                                       for k, v in blk.data.items()})
                                        for i in range(2)))
    sp = ShardedProblem(blocks=(blk,), shards=shards, mesh=mesh)
    _, x, lam, terminal, status, record = solver.lm_step(sp, x0, -1.0, cfg)
    assert keys[-1] == keys[0] and len(made) == 2
    first = distributed_levenberg_marquardt(problem(blk), x0, mesh, dataclasses.replace(cfg, max_iterations=1))
    assert torch.equal(x, first.x) and terminal.shape == () and status.dtype == torch.int32


def test_a_dataless_block_keeps_one_key(sharded):
    """A block without data counts on the first shard and is silenced on the
    others: the silenced function is equal for one block, so two solves of
    the layout share their key."""
    keys, _ = sharded
    src, tgt, x_true = _icp_scene(200)
    prior = make_block(lambda x, d: 1e-3 * (x - x_true), data=None, name="prior")
    blk = icp_block(src, tgt, nn_backend="torch")
    cfg = interop.config_from_fields(dict(LM_FIELDS, max_iterations=3))
    for _ in range(2):
        distributed_levenberg_marquardt(problem(blk, prior), torch.zeros(6, dtype=torch.float64),
                                        make_mesh(2, device="cpu"), cfg)
    assert len(keys) == 2 and keys[0] == keys[1]


def test_numpy_weight_matrix_is_placed_once():
    """A numpy weight matrix on a sharded block becomes a tensor on every
    shard's device before the loop, so it rides in the carry and no host
    copy runs inside a step; the solve equals the one with a tensor."""
    src, tgt, _ = _icp_scene(200)
    W = np.diag([4.0, 1.0, 0.25])
    blk = dataclasses.replace(icp_block(src, tgt, nn_backend="torch"), weight_matrix=W, linearize_fn=None)
    mesh = make_mesh(2, device="cpu")
    sp = ShardedProblem(blocks=(blk,), shards=tuple(
        problem(dataclasses.replace(blk, data={k: v[i * 100:(i + 1) * 100] for k, v in blk.data.items()}))
        for i in range(2)), mesh=mesh)
    placed = solver._on_device(sp, torch.zeros(6, dtype=torch.float64))
    for p, dev in zip(placed.shards, mesh.devices):
        wm = p.blocks[0].weight_matrix
        assert isinstance(wm, torch.Tensor) and wm.device == dev
        np.testing.assert_array_equal(wm.numpy(), W)
    leaves = solver._data_leaves(placed)
    assert sum(leaf is p.blocks[0].weight_matrix for p in placed.shards for leaf in leaves) == 2
    cfg = interop.config_from_fields(dict(LM_FIELDS, max_iterations=5))
    x0 = torch.zeros(6, dtype=torch.float64)
    a = distributed_levenberg_marquardt(problem(blk), x0, mesh, cfg)
    b = distributed_levenberg_marquardt(problem(dataclasses.replace(blk, weight_matrix=torch.as_tensor(W))), x0,
                                        mesh, cfg)
    assert _same_lm(a, b)


def test_on_one_device():
    """The predicate every engine decides by, ``Mesh.captures_on``: every
    local shard on the device and the reductions device work (a mesh in
    this process, or processes reducing on the device), and nothing else."""
    cpu = torch.device("cpu")
    assert make_mesh(4, device="cpu").captures_on(cpu)
    assert make_mesh(1, device="cpu").captures_on("cpu")
    assert not make_mesh(2, device="cpu").captures_on(torch.device("cuda", 0))
    assert not Mesh(devices=(cpu, cpu), group=object(), n_processes=2).captures_on(cpu)
    assert Mesh(devices=(cpu, cpu), group=object(), n_processes=2, transport="device").captures_on(cpu)
    two = Mesh(devices=(torch.device("cuda", 0), torch.device("cuda", 1)))
    assert not two.captures_on(torch.device("cuda", 0)) and not two.captures_on(torch.device("cuda", 1))
    assert Mesh(devices=(torch.device("cuda", 1),) * 3).captures_on(torch.device("cuda", 1))


def test_meshes_off_one_device_stay_eager(monkeypatch):
    """With graphs on, a sharded problem captures only when its mesh
    captures on x's device: a gloo group or a second device keeps the
    eager loop, a group reducing on the device captures, for every
    engine."""
    monkeypatch.setattr(device_loop, "graphs", lambda t: True)
    x = torch.zeros(6, dtype=torch.float64)
    cfg = solver.LMConfig()
    cpu = torch.device("cpu")
    prob = port(make_synthetic_ba(C=4, L=8, n_fixed=2, seed=6)[0])
    for mesh, graph in [(make_mesh(3, device="cpu"), True),
                        (Mesh(devices=(cpu,), group=object(), n_processes=2), False),
                        (Mesh(devices=(cpu,), group=object(), n_processes=2, transport="device"), True),
                        (Mesh(devices=(cpu, torch.device("cuda", 0))), False)]:
        sp = ShardedProblem(blocks=(), shards=(), mesh=mesh)
        assert solver._graphs(sp, x, cfg) == graph
        obs = dataclasses.replace(prob, **{k: mesh_module.GlobalArray(
            local=getattr(prob, k), mesh=mesh, axis="data", shape=tuple(getattr(prob, k).shape))
            for k in ("cam_idx", "pt_idx", "pixels")})
        assert tba._graphs(obs) == graph
    assert not solver._graphs(ShardedProblem(blocks=(), shards=(), mesh=make_mesh(3, device="cpu")), x,
                              solver.LMConfig(verbose=True))


def test_reductions_count_eager_calls_only():
    """Mesh.psum counts the reductions run eagerly; a warm-up or capture,
    which records a step's reductions, does not count them."""
    mesh = make_mesh(2, device="cpu")
    parts = [torch.ones(2), torch.ones(2)]
    n = mesh_module.REDUCTIONS
    mesh.psum(parts)
    assert mesh_module.REDUCTIONS == n + 1
    device_loop._local.warm = True
    try:
        mesh.psum(parts)
    finally:
        device_loop._local.warm = False
    assert mesh_module.REDUCTIONS == n + 1


@pytest.fixture(scope="module")
def cg_case():
    """tests/test_ba.py's sharded problem (O = 128) and JAX's solve of it with
    the observations sharded over 2 of its devices (GSPMD)."""
    start, _ = make_synthetic_ba(C=4, L=32, n_fixed=2, seed=6)
    shard = NamedSharding(JMesh(np.array(jax.devices()[:2]), ("data",)), PartitionSpec("data"))
    j_start = dataclasses.replace(start, **{k: jax.device_put(getattr(start, k), shard)
                                            for k in ("cam_idx", "pt_idx", "pixels")})
    return start, jba.solve_ba(j_start, jba.BAConfig(**CG_CFG))


def _same_ba(a, b):
    return all(torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)) for x, y in [
        (a.camera_params, b.camera_params), (a.points, b.points), (a.cost, b.cost), (a.status, b.status),
        (a.iterations, b.iterations)] + [(a.trace[k], b.trace[k]) for k in a.trace])


def test_sharded_cg_body_matches_jax(sharded, cg_case):
    """solve_ba on GlobalArray observations over 2 shards against JAX's
    solve of the same sharding; a repeat of one sharded problem replays its
    loop (one key), ba_step asks for the same, and another problem (new
    GlobalArrays) is a new key."""
    keys, made = sharded
    start, ref = cg_case
    prob = observation_sharded(port(start), 2)
    cfg = tba.BAConfig(**CG_CFG)
    res = tba.solve_ba(prob, cfg)
    np.testing.assert_allclose(res.camera_params.numpy(), np.asarray(ref.camera_params), atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(ref.points), atol=1e-8)
    assert int(res.status) == int(ref.status)
    assert _same_ba(tba.solve_ba(prob, cfg), res)
    tba.ba_step(prob, -1.0, cfg)
    assert len(set(keys)) == 1 and len(keys) == 3 and made == ["ba_step O=128 C=4 L=32"]
    tba.solve_ba(observation_sharded(port(start), 2), cfg)
    assert len(set(keys)) == 2


@pytest.fixture(scope="module")
def selfcal_case():
    """tests/test_torch_ba_selfcal_sharded.py's start and JAX's
    self-calibration with its observations sharded over 2 devices."""
    jprob, gt = make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)
    start = dataclasses.replace(jprob, intrinsics=gt.intrinsics + jnp.asarray(WRONG))
    shard = NamedSharding(JMesh(np.array(jax.devices()[:2]), ("data",)), PartitionSpec("data"))
    j_start = dataclasses.replace(start, **{k: jax.device_put(getattr(start, k), shard)
                                            for k in ("cam_idx", "pt_idx", "pixels")})
    return start, jbi.solve_ba_selfcal(j_start, jba.BAConfig(**SELFCAL_CFG))


def test_sharded_selfcal_body_matches_jax(sharded, selfcal_case):
    keys, made = sharded
    start, (jres, jintr) = selfcal_case
    prob = observation_sharded(port(start), 2)
    cfg = tba.BAConfig(**SELFCAL_CFG)
    res, intr = tbi.solve_ba_selfcal(prob, cfg)
    assert (int(res.status), int(res.iterations)) == (int(jres.status), int(jres.iterations))
    for t, j in [(intr, jintr), (res.camera_params, jres.camera_params), (res.points, jres.points)]:
        assert rel_err(t, j) < 1e-9
    assert abs(float(res.cost) / float(jres.cost) - 1) < 1e-9
    again, intr2 = tbi.solve_ba_selfcal(prob, cfg)
    assert _same_ba(again, res) and torch.equal(intr2, intr)
    assert len(keys) == 2 and keys[0] == keys[1] and made == ["ba_step_selfcal O=200 C=5 L=40"]


@pytest.fixture(scope="module")
def dense_case():
    """tests/test_torch_ba_sharded.py's "invariance" problem and JAX's
    solve_ba_dense_sharded of it over 2 devices."""
    jprob = make_synthetic_ba(C=4, L=24, noise=0.5, seed=21)[0]
    j_mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    return jprob, jbd.solve_ba_dense_sharded(jprob, j_mesh, jbd.DenseBAConfig(**DENSE_CFG))


def test_sharded_dense_body_matches_jax(sharded, dense_case, monkeypatch):
    """solve_ba_dense_sharded over 2 shards against JAX's; a repeat with
    grouped=None asks for one key and groups once (inside the loop's
    making), its result bit-equal; a given grouping is a key of its own."""
    keys, made = sharded
    jprob, j_res = dense_case
    prob = port(jprob)
    cfg = tbd.DenseBAConfig(**DENSE_CFG)
    groupings = []
    real = tbd.group_by_landmark
    monkeypatch.setattr(tbd, "group_by_landmark", lambda *a, **kw: groupings.append(1) or real(*a, **kw))
    res = tbd.solve_ba_dense_sharded(prob, make_mesh(2, device="cpu"), cfg)
    assert_same_solve(res, j_res)
    again = tbd.solve_ba_dense_sharded(prob, make_mesh(2, device="cpu"), cfg)
    assert _same_ba(again, res)
    assert len(keys) == 2 and keys[0] == keys[1] and len(groupings) == 1
    assert made == ["ba_step_dense_sharded O=96 C=4 L=24 shards=2"]
    grouped = real(prob)
    given = tbd.solve_ba_dense_sharded(prob, make_mesh(2, device="cpu"), cfg, grouped=grouped)
    assert _same_ba(given, res) and len(set(keys)) == 2
    tbd.solve_ba_dense_sharded(prob, make_mesh(4, device="cpu"), cfg)
    assert len(set(keys)) == 3
