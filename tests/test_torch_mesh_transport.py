"""The port's mesh transports: the rule that picks one, the capture
predicate, and the device transport's plain version in two CPU processes.

``multihost.choose_transport`` decides from every process's placement
(host, and each card with its peer cards) whether a mesh reduces on the
device ("device": ``kernels/mesh_reduce.py`` on CUDA; "nccl":
``kernels/nccl_transport.py`` on CUDA; both ``mesh._all_reduce_plain`` on
the CPU), over gloo, or locally; ``Mesh.captures_on`` admits a sharded step to the
engines' CUDA graphs. Both are driven here on fake placements and meshes
of ``torch.device("cuda", i)`` objects, which need no card.

The two processes (this file is also the worker: ``python
tests/test_torch_mesh_transport.py RANK PORT``, torch only, 120 s each,
the group's timeout 60 s) hold ``_all_reduce_plain`` bit for bit to
gloo's ``all_reduce`` (with two processes a rank-order sum is a + b, which
commutes) and to each other, for sums and maxima of float32 and float64
partials spread over 16 decades; a ``psum`` on the "device" mesh
equals the same ``psum`` on a "gloo" mesh bit for bit; and a distributed
curve fit through the engines' graph path (``device_loop.graphs`` forced
on, the capture left out, as ``tests/test_torch_sharded_device_loop.py``
does) keeps one loop for its layout and equals the eager solve bit for
bit. The kernel itself runs only on the card (``chip_smoke.py`` phase 15).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from moptimizer_0_tpu_torch.kernels import mesh_reduce
from moptimizer_0_tpu_torch.parallel import make_mesh, multihost
from moptimizer_0_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


def _on(host, *cards):
    """A process's placement: its host and (card, peers) for each card."""
    return host, tuple((card, frozenset(peers)) for card, *peers in cards)


# four peer cards of one host, each a peer of the others
PEERS = {c: [d for d in "abcd" if d != c] for c in "abcd"}


def _peer(c):
    return (f"GPU-{c}", *(f"GPU-{d}" for d in PEERS[c]))


# (case, every process's placement, the transport)
PLACEMENTS = [
    ("one process", [_on("h", ("GPU-a",))], "local"),
    ("one host, one card", [_on("h", ("GPU-a",))] * 2, "device"),
    ("one host, peer cards", [_on("h", ("GPU-a", "GPU-b")), _on("h", ("GPU-b", "GPU-a"))], "device"),
    ("one host, four processes on two peer cards",
     [_on("h", ("GPU-a", "GPU-b"))] * 2 + [_on("h", ("GPU-b", "GPU-a"))] * 2, "device"),
    ("one host, no peer access", [_on("h", ("GPU-a",)), _on("h", ("GPU-b",))], "nccl"),
    ("one host, peer access one way", [_on("h", ("GPU-a", "GPU-b")), _on("h", ("GPU-b",))], "nccl"),
    ("two hosts", [_on("h1", ("GPU-a",)), _on("h2", ("GPU-a",))], "nccl"),
    ("one host, the CPU", [_on("h", ("cpu",))] * 2, "device"),
    ("one host, the CPU and a card", [_on("h", ("cpu",)), _on("h", ("GPU-a",))], "gloo"),
    ("one host, one card, too many processes", [_on("h", ("GPU-a",))] * (mesh_reduce.MAX_MEMBERS + 1),
     "gloo"),
    ("each process sees only its card", [_on("h", ("GPU-a",)), _on("h", ("GPU-b",))], "nccl"),
    ("processes x cards, every card a peer", [_on("h", _peer("a"), _peer("b")), _on("h", _peer("c"), _peer("d"))],
     "device"),
    ("processes x cards, each sees only its own",
     [_on("h", ("GPU-a", "GPU-b"), ("GPU-b", "GPU-a")), _on("h", ("GPU-c", "GPU-d"), ("GPU-d", "GPU-c"))], "nccl"),
    ("processes x cards on two hosts", [_on("h1", _peer("a"), _peer("b")), _on("h2", _peer("a"), _peer("b"))],
     "nccl"),
    ("two processes share a card on two hosts", [_on("h1", ("GPU-a",))] * 2 + [_on("h2", ("GPU-b",))], "gloo"),
    ("processes x cards sharing a card", [_on("h", ("GPU-a",), ("GPU-b",)), _on("h", ("GPU-b",), ("GPU-c",))],
     "gloo"),
    ("two hosts, the CPU", [_on("h1", ("cpu",)), _on("h2", ("cpu",))], "gloo"),
    ("two hosts, nine processes", [_on(f"h{r % 2}", (f"GPU-{r}",)) for r in range(mesh_reduce.MAX_MEMBERS + 1)],
     "nccl"),
]


@pytest.mark.parametrize("places,transport", [p[1:] for p in PLACEMENTS], ids=[p[0] for p in PLACEMENTS])
def test_choose_transport(places, transport):
    assert multihost.choose_transport(places) == transport


def test_placement_of_the_cpu():
    assert multihost.placement("cpu") == (socket.gethostname(), (("cpu", frozenset()),))


class _NoIfBodies:
    """An NCCL link whose all-gather cannot be recorded in IF bodies (NCCL's
    graph mixing left on)."""

    in_if_bodies = False


def test_captures_on():
    """A sharded step is one graph only with every local shard on the device
    and a "local", "device" or "nccl" transport."""
    group = object()
    assert make_mesh(2, device="cpu").captures_on("cpu")
    for transport in ("device", "nccl"):
        mesh = Mesh(devices=(CUDA0, CUDA0), group=group, n_processes=2, transport=transport)
        assert mesh.captures_on(CUDA0) and not mesh.captures_on(CUDA1) and not mesh.per_card(CUDA0)
    assert not Mesh(devices=(CUDA0, CUDA0), group=group, n_processes=2, transport="gloo").captures_on(CUDA0)
    eager_nccl = Mesh(devices=(CUDA0,), group=group, n_processes=2, transport="nccl", link=_NoIfBodies())
    assert not eager_nccl.captures_on(CUDA0)  # its all-gather cannot sit in IF nodes: the eager body
    across = Mesh(devices=(CUDA0, CUDA1), group=group, n_processes=2, transport="device")
    assert not across.captures_on(CUDA0) and not across.captures_on(CUDA1)
    assert Mesh(devices=(CUDA1,) * 3).captures_on(CUDA1)


def test_mesh_transport_defaults_and_refusals():
    """A group's mesh is "gloo" unless told otherwise, one without a group
    "local"; a transport that contradicts the group is refused; the layout
    tells transports and buffers apart."""
    cpu, group = torch.device("cpu"), object()
    assert Mesh(devices=(cpu,)).transport == "local"
    assert Mesh(devices=(cpu,), group=group, n_processes=2).transport == "gloo"
    for kw in (dict(transport="device"), dict(transport="nccl"), dict(group=group, n_processes=2, transport="local"),
               dict(group=group, n_processes=2, transport="ring")):
        with pytest.raises(ValueError):
            Mesh(devices=(cpu,), **kw)
    a = Mesh(devices=(CUDA0,), group=group, n_processes=2, transport="device", link=object())
    b = Mesh(devices=(CUDA0,), group=group, n_processes=2, transport="device", link=object())
    gloo = Mesh(devices=(CUDA0,), group=group, n_processes=2)
    nccl = Mesh(devices=(CUDA0,), group=group, n_processes=2, transport="nccl", link=a.link)
    assert len({a.layout(), b.layout(), gloo.layout(), nccl.layout()}) == 4
    Mesh(devices=(cpu,), group=group, n_processes=2, transport="device").check()  # no buffers: nothing to read


def test_gathers_stay_out_of_step_bodies():
    """A gather of a mesh across processes runs after a loop, never in a
    step that a graph records: in a warm-up it raises."""
    from moptimizer_0_tpu_torch.ops import device_loop

    mesh = Mesh(devices=(torch.device("cpu"),), group=object(), n_processes=2, transport="device")
    device_loop._local.warm = True
    try:
        with pytest.raises(RuntimeError, match="gather_rows"):
            mesh.gather_rows(torch.ones(2))
    finally:
        device_loop._local.warm = False


def test_ipc_buffers_refuse_process_counts():
    for size in (1, mesh_reduce.MAX_MEMBERS + 1):
        with pytest.raises(ValueError):
            mesh_reduce.IpcBuffers(None, 0, size, CUDA0)


# ---------------------------------------------------------------- the worker

# (name, dtype, shape) of the partials each rank reduces
PARTIALS = [("f32", torch.float32, (1001,)), ("f64", torch.float64, (5, 7))]
CASES = [f"{name}-{op}" for name, _, _ in PARTIALS for op in ("sum", "max")] + ["psum-device-gloo", "graph-path"]


def _bits(t):
    t = t.contiguous()
    if t.is_floating_point():
        t = t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
    return t.numpy().tobytes().hex()


def _partial(rng, dtype, shape):
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-8, 8, size=shape)
    return torch.as_tensor(x, dtype=dtype)


def _worker_main(rank, port):
    import hashlib

    import torch.distributed as dist

    from moptimizer_0_tpu_torch.core.residual import make_block, problem
    from moptimizer_0_tpu_torch.core.solver import LMConfig
    from moptimizer_0_tpu_torch.models.curve_fitting import CERES_CURVE_DATA
    from moptimizer_0_tpu_torch.ops import device_loop
    from moptimizer_0_tpu_torch.parallel import distributed_levenberg_marquardt
    from moptimizer_0_tpu_torch.parallel import mesh as mesh_module

    rank = int(rank)
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    assert mesh.transport == "device" and mesh.link is None and mesh.captures_on("cpu")

    def report(case, ok, payload):
        digest = hashlib.sha256(payload.encode()).hexdigest()[:16]
        print(f"RESULT {case} {rank} {int(bool(ok))} {digest}", flush=True)

    rng = np.random.default_rng(100 + rank)
    for name, dtype, shape in PARTIALS:
        flat = _partial(rng, dtype, shape).reshape(-1)
        for op in ("sum", "max"):
            plain = mesh_module._all_reduce_plain(flat, op, mesh.group)
            ref = flat.clone()
            dist.all_reduce(ref, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
            report(f"{name}-{op}", plain.dtype == dtype and _bits(plain) == _bits(ref), _bits(plain))

    parts = [(_partial(rng, torch.float64, (6, 6)), _partial(rng, torch.float32, (4,))) for _ in range(2)]
    n = mesh_module.ALL_REDUCES
    on_device = mesh.psum(parts)
    counted = mesh_module.ALL_REDUCES - n == 2  # one a dtype
    original = multihost.choose_transport
    multihost.choose_transport = lambda places: "gloo"
    try:
        gloo_mesh = multihost.global_mesh(shards_per_process=2, device="cpu")
    finally:
        multihost.choose_transport = original
    on_gloo = gloo_mesh.psum(parts)
    same = gloo_mesh.transport == "gloo" and all(_bits(a) == _bits(b) for a, b in zip(on_device, on_gloo))
    report("psum-device-gloo", same and counted, "".join(_bits(t) for t in on_device))

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    data = multihost.host_local_shard(torch.as_tensor(np.asarray(CERES_CURVE_DATA)[:64], dtype=torch.float64))
    blk = multihost.make_global_block(make_block(residual, data=data), mesh)
    x0, cfg = torch.zeros(2, dtype=torch.float64), LMConfig(max_iterations=25)
    eager = distributed_levenberg_marquardt(problem(blk), x0, mesh, cfg)
    device_loop.graphs = lambda t: True
    device_loop.StepLoop._capture = lambda self, name: None
    graph = [distributed_levenberg_marquardt(problem(blk), x0, mesh, cfg) for _ in range(2)]
    kept = len(device_loop._LOOPS) == 1  # both graph-path solves on one layout's loop
    same = all(_bits(g.x) == _bits(eager.x) and int(g.iterations) == int(eager.iterations) for g in graph)
    report("graph-path", same and kept, _bits(eager.x))
    mesh.close()
    assert "jax" not in sys.modules, "a worker imported jax"
    dist.destroy_process_group()


# ---------------------------------------------------------------- the parent


@pytest.fixture(scope="module")
def pair():
    """{case: {rank: (ok, digest)}} of both processes."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), port], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {case: {} for case in CASES}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                _, case, r, ok, digest = line.split()
                results[case][int(r)] = (ok == "1", digest)
    return results


@pytest.mark.parametrize("case", CASES)
def test_two_processes(pair, case):
    """Each case holds in both processes, and both computed the same bits."""
    got = pair[case]
    assert set(got) == {0, 1}, got
    assert got[0][0] and got[1][0], got
    assert got[0][1] == got[1][1], got


if __name__ == "__main__":
    _worker_main(*sys.argv[1:3])
