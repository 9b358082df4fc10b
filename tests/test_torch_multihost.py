"""The port's multi-process path: two CPU processes over a local gloo group.

Both processes run on one host, so their mesh takes the "device"
transport, whose CPU tensors reduce through its plain version
(``parallel.mesh._all_reduce_plain``: an all-gather over the group, then
a rank-order sum).

The pattern of ``tests/test_multihost.py``: each process runs the port only
(torch, no JAX; this file is also the worker, run as a script:
``python tests/test_torch_multihost.py RANK PORT NPZ``), feeds its
own rows and solves over a global mesh of 2 processes × 2 shards; the
parent holds both to the JAX package's single-device solve of the whole
problem. Both processes run both cases and must print the same bits.
Every process has a 120 s limit and its group a 60 s timeout. Tolerances:

* in each process, the distributed curve fit against the port's own
  single-device fit: x to 1e-10 relative and 1e-12 absolute
  (``tests/_multihost_worker.py``'s bound);
* the curve fit against JAX's: x to 1e-7 relative. Both runs go on to the
  noise floor (25 iterations allowed, no rel_cost_tol, as the JAX worker),
  where the SMALL_DELTA stop falls on roundoff's iteration (12 in JAX, 15
  in the port) and x moves by ~1e-8 relative in the last steps;
* the BA's cameras to 1e-8 relative and 1e-10 absolute of JAX's
  (``tests/_multihost_ba_worker.py``'s bound);
* the observation-sharded CG solve, in each process, against a
  process-local solve of all rows, and its cameras against JAX's
  single-device CG solve: 1e-6 relative and 1e-8 absolute (the JAX
  worker's bound for its GSPMD-sharded CG solve);
* the observation-sharded self-calibration from intrinsics off by
  ``SELFCAL_WRONG``, in each process against a process-local solve, and its
  intrinsics and cameras against JAX's single-device self-calibration: the
  same bound, since it runs on the same reductions.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
SELFCAL_WRONG = [8.0, -6.0, 3.0, -2.0]  # tests/test_ba_intrinsics.py's perturbation


# ---------------------------------------------------------------- the worker


def _curve_worker(rank, port, _):
    from moptimizer_0_tpu_torch.parallel import multihost

    assert not multihost.is_initialized()
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=GROUP_TIMEOUT_S)
    assert multihost.is_initialized()
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "device"  # one host: the plain transport for CPU tensors
    assert mesh.shape["data"] == 4 and mesh.n_processes == 2 and mesh.process_index == rank
    return _curve_fit(mesh)


def _curve_nccl_worker(rank, port, _):
    """The curve fit on a mesh whose transport is "nccl", the transport of
    processes the device transport cannot join: its CPU tensors reduce
    through the same plain version, so its bits are the "device" mesh's."""
    import dataclasses

    from moptimizer_0_tpu_torch.parallel import multihost

    mesh = dataclasses.replace(multihost.global_mesh(shards_per_process=2, device="cpu"), transport="nccl")
    assert mesh.link is None and mesh.captures_on("cpu")
    return _curve_fit(mesh)


def _curve_fit(mesh):
    """The 64-row curve fit over ``mesh``, each process its 32 rows, held to
    the port's single-device fit: "x0 x1 status iterations"."""
    import torch

    from moptimizer_0_tpu_torch.core.residual import make_block, problem
    from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
    from moptimizer_0_tpu_torch.models.curve_fitting import CERES_CURVE_DATA
    from moptimizer_0_tpu_torch.parallel import distributed_levenberg_marquardt, multihost

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    data_full = torch.as_tensor(np.asarray(CERES_CURVE_DATA)[:64], dtype=torch.float64)
    data_local = multihost.host_local_shard(data_full)
    assert data_local.shape[0] == 32
    blk = multihost.make_global_block(make_block(residual, data=data_local), mesh)
    assert blk.data.shape[0] == 64  # the global row count
    cfg = LMConfig(max_iterations=25)
    res = distributed_levenberg_marquardt(problem(blk), torch.zeros(2, dtype=torch.float64), mesh, cfg)
    local = levenberg_marquardt(problem(make_block(residual, data=data_full)), torch.zeros(2, dtype=torch.float64), cfg)
    np.testing.assert_allclose(res.x.numpy(), local.x.numpy(), rtol=1e-10, atol=1e-12)
    x = res.x.numpy()
    return f"{float(x[0])!r} {float(x[1])!r} {int(res.status)} {int(res.iterations)}"


def _ba_worker(rank, port, path):
    import torch

    from moptimizer_0_tpu_torch import ba_dense, interop
    from moptimizer_0_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "device"  # one host: the plain transport for CPU tensors
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    start = interop.ba_problem_from_numpy(**arrays, n_fixed_cameras=2, device="cpu")
    grouped = ba_dense.group_by_landmark(start)
    # make_global_array round trip: the processes' L-shards make the global L
    local_pix = multihost.host_local_shard(grouped.pixels)
    assert local_pix.shape[0] == start.points.shape[0] // 2
    assert multihost.make_global_array(local_pix, mesh).shape == tuple(grouped.pixels.shape)
    cfg = ba_dense.DenseBAConfig(max_iterations=8, schur_chunk=8)
    res = ba_dense.solve_ba_dense_sharded(start, mesh, cfg, grouped=grouped)
    assert torch.isfinite(res.cost)
    cams, pts = res.camera_params.numpy(), res.points.numpy()
    return f"{float(res.cost)!r} {cams.tobytes().hex()} {pts.tobytes().hex()} {int(res.iterations)}"


def _cg_worker(rank, port, path):
    """The observation-sharded CG solve (``tests/_multihost_ba_worker.py``'s
    second case): each process feeds its own rows of cam_idx, pt_idx and
    pixels, held to a process-local solve of all rows at the JAX worker's
    bound; "dense" and "auto" (which routes this problem to "dense") raise,
    as the JAX package's solve does across processes."""
    import dataclasses

    import torch

    from moptimizer_0_tpu_torch import ba, interop
    from moptimizer_0_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "device"  # one host: the plain transport for CPU tensors
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    start = interop.ba_problem_from_numpy(**arrays, n_fixed_cameras=2, device="cpu")
    start_cg = dataclasses.replace(start, **{
        k: multihost.make_global_array(multihost.host_local_shard(getattr(start, k)), mesh)
        for k in ("cam_idx", "pt_idx", "pixels")
    })
    assert start_cg.pixels.shape == tuple(start.pixels.shape)
    cfg = ba.BAConfig(max_iterations=8)
    res = ba.solve_ba(start_cg, cfg)
    local = ba.solve_ba(start, cfg)
    np.testing.assert_allclose(res.camera_params.numpy(), local.camera_params.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.points.numpy(), local.points.numpy(), rtol=1e-6, atol=1e-8)
    assert torch.equal(res.camera_params[:2], start.camera_params[:2])
    route = ba.select_engine(start_cg)
    for engine in ("dense", "auto"):
        try:
            ba.solve_ba(start_cg, cfg, engine=engine)
        except ValueError as e:
            assert "solve_ba_dense_sharded" in str(e), e
        else:
            raise AssertionError(f"engine={engine!r} across processes did not raise")
    cams, pts = res.camera_params.numpy(), res.points.numpy()
    return f"{float(res.cost)!r} {cams.tobytes().hex()} {pts.tobytes().hex()} {int(res.iterations)} {route}"


def _selfcal_worker(rank, port, path):
    """Self-calibrating BA on the CG worker's sharding, from wrong intrinsics,
    held to a process-local self-calibration of all rows."""
    import dataclasses

    import torch

    from moptimizer_0_tpu_torch import ba, ba_intrinsics, interop
    from moptimizer_0_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "device"  # one host: the plain transport for CPU tensors
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["intrinsics"] = arrays["intrinsics"] + np.asarray(SELFCAL_WRONG)
    start = interop.ba_problem_from_numpy(**arrays, n_fixed_cameras=2, device="cpu")
    sharded = dataclasses.replace(start, **{
        k: multihost.make_global_array(multihost.host_local_shard(getattr(start, k)), mesh)
        for k in ("cam_idx", "pt_idx", "pixels")
    })
    cfg = ba.BAConfig(max_iterations=8)
    res, intr = ba_intrinsics.solve_ba_selfcal(sharded, cfg)
    local, local_intr = ba_intrinsics.solve_ba_selfcal(start, cfg)
    np.testing.assert_allclose(intr.numpy(), local_intr.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.camera_params.numpy(), local.camera_params.numpy(), rtol=1e-6, atol=1e-8)
    assert torch.equal(res.camera_params[:2], start.camera_params[:2])
    cams = res.camera_params.numpy()
    return f"{float(res.cost)!r} {intr.numpy().tobytes().hex()} {cams.tobytes().hex()} {int(res.iterations)}"


WORKERS = {"curve": _curve_worker, "curve_nccl": _curve_nccl_worker, "ba": _ba_worker, "cg": _cg_worker, "selfcal": _selfcal_worker}


def _worker_main(rank, port, path):
    """Every case in one process (the group is initialized once)."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    for case, worker in WORKERS.items():
        out = worker(int(rank), port, path)
        print(f"RESULT {case} {rank} {out}", flush=True)
    assert "jax" not in sys.modules, "a worker imported jax"
    dist.destroy_process_group()


# ---------------------------------------------------------------- the parent


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_pair(path):
    """{case: {rank: RESULT payload}} of both processes; fails on a non-zero
    exit or a timeout."""
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), port, path],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=ROOT)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {case: {} for case in WORKERS}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, case, r, payload = line.split(" ", 3)
                results[case][int(r)] = payload
    for case in WORKERS:
        assert set(results[case]) == {0, 1}, outs
    return results


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both processes, run once for every case: (the BA's JAX problem,
    {case: {rank: payload}})."""
    start = _ba_problem()
    path = str(tmp_path_factory.mktemp("multihost") / "ba.npz")
    fields = ("camera_params", "points", "cam_idx", "pt_idx", "pixels", "intrinsics")
    np.savez(path, **{k: np.asarray(getattr(start, k)) for k in fields})
    return start, _run_pair(path)


def test_two_process_distributed_lm(pair):
    _hold_curve(pair[1]["curve"])


def test_two_process_distributed_lm_nccl_mesh(pair):
    """The same processes' curve fit over an "nccl" mesh (its CPU tensors
    through the plain transport, as the "device" mesh's): JAX's fit, and the
    "device" mesh's bits."""
    _hold_curve(pair[1]["curve_nccl"])
    assert pair[1]["curve_nccl"][0] == pair[1]["curve"][0]


def _hold_curve(results):
    import jax.numpy as jnp

    from moptimizer_0_tpu import LMConfig, levenberg_marquardt
    from moptimizer_0_tpu.core.residual import make_block, problem
    from moptimizer_0_tpu.models.curve_fitting import CERES_CURVE_DATA

    assert results[0] == results[1]  # bit-equal
    m, c, status, iterations = results[0].split()
    data = jnp.asarray(np.asarray(CERES_CURVE_DATA)[:64], jnp.float64)
    ref = levenberg_marquardt(
        problem(make_block(lambda x, d: jnp.stack([d[1] - jnp.exp(x[0] * d[0] + x[1])]), data=data)),
        jnp.zeros(2, jnp.float64), LMConfig(max_iterations=25),
    )
    np.testing.assert_allclose([float(m), float(c)], np.asarray(ref.x), rtol=1e-7)
    assert int(status) == int(ref.status)
    # the SciPy MINPACK-LM minimum of the 64-row slice (tests/test_multihost.py)
    assert abs(float(m) - 0.29284892) < 5e-5 and abs(float(c) - 0.12883951) < 5e-5


def _ba_problem():
    """tests/_multihost_ba_worker.py's problem: C = 6, L = 32, every camera
    sees every landmark, two fixed cameras."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from moptimizer_0_tpu import ba

    rng = np.random.default_rng(11)
    C, L = 6, 32
    pts = rng.uniform(-3, 3, size=(L, 3)) + np.array([0.0, 0.0, 10.0])
    cams = np.stack([
        np.concatenate([[1.0 * i - 0.5 * (C - 1), 0.2 * rng.normal(), 0.0], 0.03 * rng.normal(size=3)])
        for i in range(C)
    ])
    cam_idx, pt_idx = np.repeat(np.arange(C), L), np.tile(np.arange(L), C)
    prob = ba.BAProblem(
        camera_params=jnp.asarray(cams), points=jnp.asarray(pts), cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx), pixels=jnp.zeros((len(cam_idx), 2)),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0]), n_fixed_cameras=2,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx],
                                                 prob.intrinsics)
    pixels = np.asarray(pixels) + 0.3 * rng.normal(size=pixels.shape)
    return dataclasses.replace(
        prob,
        pixels=jnp.asarray(pixels),
        camera_params=prob.camera_params
        + 0.005 * jnp.asarray(rng.normal(size=cams.shape)) * (jnp.arange(C) >= 2)[:, None].astype(jnp.float64),
        points=prob.points + 0.02 * jnp.asarray(rng.normal(size=pts.shape)),
    )


def test_two_process_dense_schur_ba(pair):
    from moptimizer_0_tpu import ba_dense

    start, results = pair[0], pair[1]["ba"]
    assert results[0] == results[1]  # cost, cameras and points bit-equal
    cfg = ba_dense.DenseBAConfig(max_iterations=8, schur_chunk=8)
    ref = ba_dense.solve_ba_dense(start, cfg)
    cams = np.frombuffer(bytes.fromhex(results[0].split()[1]), dtype=np.float64).reshape(6, 6)
    np.testing.assert_allclose(cams, np.asarray(ref.camera_params), rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(cams[:2], np.asarray(start.camera_params)[:2])


def test_two_process_sharded_cg_ba(pair):
    """Both processes bit-equal; the CG solve over their rows against the JAX
    package's single-device CG solve of all rows at the JAX worker's bound."""
    from moptimizer_0_tpu import ba

    start, results = pair[0], pair[1]["cg"]
    assert results[0] == results[1]
    cost, cams_hex, _, _, route = results[0].split()
    assert route == "dense" == ba.select_engine(start)
    ref = ba.solve_ba(start, ba.BAConfig(max_iterations=8))
    cams = np.frombuffer(bytes.fromhex(cams_hex), dtype=np.float64).reshape(6, 6)
    np.testing.assert_allclose(cams, np.asarray(ref.camera_params), rtol=1e-6, atol=1e-8)
    assert np.isfinite(float(cost))


def test_two_process_sharded_selfcal(pair):
    """Both processes bit-equal; the self-calibration over their rows against
    the JAX package's single-device self-calibration of all rows."""
    import dataclasses

    import jax.numpy as jnp

    from moptimizer_0_tpu import ba, ba_intrinsics

    start, results = pair[0], pair[1]["selfcal"]
    assert results[0] == results[1]
    cost, intr_hex, cams_hex, iterations = results[0].split()
    wrong = dataclasses.replace(start, intrinsics=start.intrinsics + jnp.asarray(SELFCAL_WRONG))
    ref, ref_intr = ba_intrinsics.solve_ba_selfcal(wrong, ba.BAConfig(max_iterations=8))
    intr = np.frombuffer(bytes.fromhex(intr_hex), dtype=np.float64)
    cams = np.frombuffer(bytes.fromhex(cams_hex), dtype=np.float64).reshape(6, 6)
    np.testing.assert_allclose(intr, np.asarray(ref_intr), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(cams, np.asarray(ref.camera_params), rtol=1e-6, atol=1e-8)
    assert int(iterations) == int(ref.iterations) and np.isfinite(float(cost))
    assert np.abs(intr - np.asarray(start.intrinsics)).max() < np.abs(SELFCAL_WRONG).max()


def test_initialize_failure_is_loud():
    """An unreachable coordinator with explicit arguments raises (non-zero
    exit, the error on stderr), never a silent single-process run."""
    code = (
        f"import sys; sys.path.insert(0, {ROOT!r})\n"
        "from moptimizer_0_tpu_torch.parallel import multihost\n"
        "multihost.initialize(coordinator_address='localhost:1', num_processes=2, process_id=1,\n"
        "                     initialization_timeout=2)\n"
        "print('UNREACHABLE-OK')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=TIMEOUT_S, env=_env())
    assert p.returncode != 0
    assert "UNREACHABLE-OK" not in p.stdout
    assert "Error" in p.stderr


def test_initialize_without_arguments_is_a_single_process_run(monkeypatch):
    import torch

    from moptimizer_0_tpu_torch.parallel import make_mesh, multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not multihost.is_initialized()
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "local"
    assert mesh.group is None and mesh.shape == make_mesh(2, device="cpu").shape
    a = torch.arange(10)
    assert torch.equal(multihost.host_local_shard(a), a)
    g = multihost.make_global_array(a.reshape(5, 2)[:4], mesh)
    assert g.shape == (4, 2) and torch.equal(g.local, a.reshape(5, 2)[:4])


if __name__ == "__main__":
    _worker_main(*sys.argv[1:4])
