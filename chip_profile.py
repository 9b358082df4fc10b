"""Profile one pass of the fleet ICP loop, one ICP request, or one SLAM pair, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_profile.py [--path fleet|icp|pair|gicp|pgo|ring_cg|sharded_cg|sharded_sequence|mesh_barrier|
                                    multicard_cg]
                            [--unprofiled] [--processes N] [--spread] [--out DIR]

``--path fleet`` (the default) builds the expansion kernel K6, makes the
64-lane fachada fleet of ``chip_smoke.py`` and runs one pass of
``icp_batched`` to reach the fleet's second iterate; the step is one pass
(max_iterations=1) from there. ``--path icp`` builds the brute-force kernel
K5; the step is one whole ICP request of ``chip_smoke.py`` (request A: the
full fachada scan in float32, ``icp`` with its defaults, K5 searching). The
step runs once to warm up and five times on the host clock (ending in a
host read), then once under ``torch.profiler``. ``--path pair`` builds no
kernel; the step is one steady-state pair of the SLAM sequence of
``chip_smoke.py`` (64 × 32,768 points, float32): ``PairwiseRegistrar``
with the bench's settings and grid search registers pairs 1 and 2 (the
first pair's coarse seed and the grid's capacities), and the step registers
pair 3 seeded with pair 2's pose. Its device time is split between the grid
query, the linearization, the trial costs and the damped solves (each
wrapped in a ``torch.profiler.record_function`` range) and the rest of the
LM loop. ``--path gicp`` builds K5; the step is one steady-state GICP pair
of the same sequence (``method="gicp"``, ``nn_backend="auto"``: K5 at
32,768 targets), pair 3 seeded with pair 2's pose, split between the two
covariance builds (knn + PCA, K9), the K5 searches, the linearization, the
trial costs and the damped solves, with the weight inverse (Ω = (C_q + R C_s
Rᵀ)⁻¹, inside the linearization and the trial costs) shown on its own.
``--path pgo`` builds no kernel; the step is the first five outer
iterations of the dense ``solve_pgo`` of ``chip_smoke.py``'s 2,000-pose ring
graph in float32, profiled twice: by its CUDA graph (five replays), then
by its step's body run eagerly on the capture's routes
(``device_loop.eager()``, ``capturable_linalg``), split between the edge
plans, the per-edge linearization, the 12,000² assembly, the costs and the
damped Cholesky solves. ``--path ring_cg`` builds no kernel; it repeats
one step of ``chip_smoke.py``'s phase 21 alone: the 300-pose ring's CG
``solve_pgo`` (float32, its graph ~1,200 PCG IF nodes a step) solved once
to capture, then profiled by its graph and by its eager body as
``chip_smoke._launch_profile`` reads the profiler (raw events), each
profile announced before it starts, so that a fault (whose Python stack
``faulthandler`` prints) shows which one it hit. ``--path sharded_cg``
builds no kernel; it repeats ``chip_smoke.py``'s phase 22 profiles alone:
the headline BA (O = 500k, C = 200, L = 50k, float32) by the CG engine
with its observations over 4 shards, then the self-calibration from
5(c)'s wrong intrinsics over 2, each solved twice by its graph (the
capture, then the reference bits), then profiled three times by its graph
and by its eager body, every profiled solve's result held to the
reference bit for bit, and solved once more unprofiled. ``--path
sharded_sequence`` builds K11 and repeats, SEQUENCE_ROUNDS times in one
process, ``chip_smoke.py`` phase 22's sharded BA paths on the headline
(dense over 2 and 4 shards, CG over 2 and 4, the self-calibration over 2
and 4), each solved by its graph (the reference bits, after its capture)
and by its eager body, then profiled by its graph and by its eager body,
every result held to the reference bit for bit and each step announced
before it starts (some 40 profiler sessions in one process, as in the
smoke run whose profiled self-calibration replay faulted); with
``--unprofiled`` the same sequence runs without the profiler. ``--path
mesh_barrier`` builds ``csrc/mesh_reduce.cu`` and starts this script twice
(``--rank 0|1 --port P``) as two processes on the card over a local gloo
group, whose mesh takes the device transport: each maps the other's IPC
buffer, then rank 0 and rank 1 bounce a flag MESH_PINGS times in one launch
(three times; µs a round trip by CUDA events), and both time an all-reduce
of one float32 eagerly and as 100 reductions captured in one CUDA graph
(µs each) and one of S's 5.76 MB, held bit for bit to the plain version.
It runs the pair once as it is and once under MPS, if
``nvidia-cuda-mps-control -d`` starts with its pipe and log directories
under ``build/mps`` (the daemon is told to quit after), and prints the
reason when it cannot. ``--processes N`` starts N processes (the flag is
bounced by two only); ``--spread`` puts rank r on card r (the cards must
be peers) and adds the headline CG BA with its observations over the
processes, by its graph and its eager body (bit-equal, the ranks too).
``--path multicard_cg`` (two cards or more) builds ``csrc/mesh_reduce.cu``
and solves the headline BA by the CG engine with its observations over a
one-process mesh of min(4, cards) cards, one shard a card
(``chip_smoke.py`` phase 23): twice by its graphs, one a card (the
capture, then the reference bits), then once under ``torch.profiler``,
held to the reference bit for bit; it prints each card's device time and
busy share, the card transport's share there, and the first card's kernels
by device time.
Prints the card, those host times and the traced one, the device time and busy share, the kernel
launches and host syncs, the search kernel's share of device time and the
kernels by device time, and writes the chrome trace to DIR (default
``build/profile``; the PGO path writes two).
"""

import argparse
import contextlib
import faulthandler
import functools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs
from moptimizer_0_tpu_torch import ba, ba_intrinsics, pose_graph, registration
from moptimizer_0_tpu_torch.core import linearize as core_linearize
from moptimizer_0_tpu_torch.core import solver
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.kernels import build, mesh_reduce
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.ops import device_loop, grid_nn
from moptimizer_0_tpu_torch.ops.small_solve import capturable_linalg
from moptimizer_0_tpu_torch.parallel import multihost
from moptimizer_0_tpu_torch.registration import PairwiseRegistrar, icp, icp_batched

faulthandler.enable()


def fleet_step(cloud):
    """One pass of the fleet loop from its second iterate."""
    srcs, tgts, _ = cs._fleet_inputs(cloud, np.random.default_rng(cs.SEED + 2))
    one_pass = LMConfig(diff_mode="auto", max_iterations=1, linear_solver="cholesky")
    x1 = icp_batched(srcs, tgts, config=one_pass).x

    def step():
        return icp_batched(srcs, tgts, x1, config=one_pass).x.cpu()

    return step


def icp_request(cloud):
    """One whole ICP request A of chip_smoke.py."""
    tgt = cs._transformed(cloud, cs.X_A, np.random.default_rng(cs.SEED + 1))

    def step():
        return icp(cloud, tgt).x.cpu()

    return step


def _steady_pair(cloud, **kw):
    """Pair 3 of the SLAM sequence, seeded with pair 2's pose, through a
    registrar with the bench's settings that registered pairs 1 and 2 (the
    first pair's coarse seed, the grid's capacities)."""
    scans, _ = cs.make_sequence(cs.SLAM_K, cs.SLAM_N)
    seq = [sc.to(cloud.device) for sc in scans[:4]]
    reg = PairwiseRegistrar(config=cs.SLAM_CONFIG, max_corr_dist=cs.SLAM_GATE, **kw)
    x = reg.register(seq[1], seq[0]).x
    x = reg.register(seq[2], seq[1], x0=x).x

    def step():
        res, _ = reg.register(seq[3], seq[2], x0=x, defer_overflow=True)
        return res.x.cpu()

    return step


def slam_pair(cloud):
    """One steady-state grid pair of the SLAM sequence (pair 3, seeded)."""
    return _steady_pair(cloud, nn_backend="grid")


def gicp_pair(cloud):
    """One steady-state GICP pair of the SLAM sequence, searched by K5."""
    return _steady_pair(cloud, method="gicp")


def ring_cg(dev):
    """chip_smoke.py phase 21's profile of the 300-pose ring's CG solve, by
    its graph and by its eager body (``chip_smoke._launch_profile``)."""
    n = min(cs.RING_BOUNDS)
    graph, _ = cs.make_ring_graph(n, cs.RING_SEED, cs.RING_DRIFT, dtype=torch.float32, device=dev)

    def solve():
        return pose_graph.solve_pgo(graph, cs.RING_CONFIGS["cg"])

    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    print(f"ring {n} CG: first solve (capture) {time.perf_counter() - t0:.3f} s", flush=True)
    for side, context in (("graph", contextlib.nullcontext), ("eager body", device_loop.eager)):
        print(f"ring {n} CG: profiling its {side} (raw events) ...", flush=True)
        with context(), capturable_linalg(dev):
            _, calls, ms, wall = cs._launch_profile(solve)
        print(f"ring {n} CG, {side}: launch calls {calls}, device ms {ms:.3f}, wall {wall:.3f} s, busy "
              f"{ms / 1e3 / wall:.3f}", flush=True)


def sharded_cg(dev):
    """chip_smoke.py phase 22's profiles of the observation-sharded CG and
    self-calibration graphs, each profiled solve held to the unprofiled
    graph solve's bits."""
    prob = ba.make_ba_problem(cs.BA_O, cs.BA_C, cs.BA_L, seed=cs.SEED, dtype=torch.float32, device=dev)
    cases = (
        ("CG over 4 shards", functools.partial(ba.solve_ba, cs._observation_sharded(prob, cs.make_mesh(4)))),
        ("self-cal over 2 shards", functools.partial(
            ba_intrinsics.solve_ba_selfcal, cs._observation_sharded(cs._selfcal_start(prob), cs.make_mesh(2)))),
    )
    for name, solve in cases:
        solve()
        ref = solve()
        torch.cuda.synchronize()
        for k in range(3):
            for side, context in (("graph", contextlib.nullcontext), ("eager body", device_loop.eager)):
                print(f"{name}: profiling its {side} ({k + 1} of 3) ...", flush=True)
                with context():
                    out, calls, ms, wall = cs._launch_profile(solve)
                print(f"{name}, {side} ({k + 1} of 3): launch calls {calls}, device ms {ms:.3f}, wall {wall:.3f} s, "
                      f"busy {ms / 1e3 / wall:.3f}, bit-equal to the unprofiled graph solve "
                      f"{cs._same_result(out, ref)}", flush=True)
        print(f"{name}: a graph solve after the profiles bit-equal {cs._same_result(solve(), ref)}", flush=True)


def multicard_cg(dev, trace):
    """``--path multicard_cg``: one profile of the headline CG BA's graphs
    over a one-process mesh of min(4, cards) cards (module docstring)."""
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"chip_profile --path multicard_cg: needs 2+ cards, found {n}")
    mesh = cs.make_mesh(min(4, n))
    prob = ba.make_ba_problem(cs.BA_O, cs.BA_C, cs.BA_L, seed=cs.SEED, dtype=torch.float32, device=dev)
    solve = functools.partial(ba.solve_ba, cs._observation_sharded(prob, mesh))
    solve()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ref = solve()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    print(f"CG BA over {len(mesh.cards)} cards by its graphs: {[f'{w:.4f}' for w in walls]} s", flush=True)
    for d in mesh.cards:
        torch.cuda.synchronize(d)
    print("profiling one solve by its graphs ...", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = solve()
        for d in mesh.cards:
            torch.cuda.synchronize(d)
        wall_s = time.perf_counter() - t0
    cards = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name = cards.setdefault(e.device_index(), {})
            t, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.duration_ns(), k + 1)
    print(f"profiled solve: wall {wall_s:.4f} s, bit-equal to the unprofiled graph solve "
          f"{cs._same_result(out, ref)}")
    for index, by_name in sorted(cards.items()):
        busy = sum(t for t, _ in by_name.values()) / 1e6
        transport = sum(t for name, (t, _) in by_name.items() if "cards_kernel" in name) / 1e6
        print(f"  card {index}: device {busy:.3f} ms in {sum(k for _, k in by_name.values())} events (busy "
              f"{busy / 1e3 / wall_s:.3f}), card transport {transport:.3f} ms ({transport / max(busy, 1e-9):.1%}) in "
              f"{sum(k for name, (_, k) in by_name.items() if 'cards_kernel' in name)} launches")
    first = cards.get(dev.index, {})
    busy = sum(t for t, _ in first.values()) / 1e6
    print(f"card {dev.index}'s kernels by device time (ms, launches, share):")
    for name, (t, k) in sorted(first.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {t / 1e6:9.3f} ms {k:6d}  {t / 1e6 / max(busy, 1e-9):6.1%}  {name[:110]}")
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"chrome trace: {trace}")


SEQUENCE_ROUNDS = 3


def sharded_sequence(dev, profiled):
    """Phase 22's sharded BA paths, SEQUENCE_ROUNDS times in one process
    (module docstring): a graph solve, an eager solve and, when
    ``profiled``, a profile of each, every result bit-equal to the graph's
    first."""
    prob = ba.make_ba_problem(cs.BA_O, cs.BA_C, cs.BA_L, seed=cs.SEED, dtype=torch.float32, device=dev)
    start = cs._selfcal_start(prob)
    cfg = ba.BAConfig()
    paths = [(f"dense_{n}", functools.partial(cs.ba_dense.solve_ba_dense_sharded, prob, cs.make_mesh(n)))
             for n in (2, 4)]
    paths += [(f"cg_{n}", functools.partial(ba.solve_ba, cs._observation_sharded(prob, cs.make_mesh(n)), cfg))
              for n in (2, 4)]
    paths += [(f"selfcal_{n}", functools.partial(ba_intrinsics.solve_ba_selfcal,
                                                 cs._observation_sharded(start, cs.make_mesh(n)), cfg))
              for n in (2, 4)]
    refs, sessions = {}, 0
    for r in range(SEQUENCE_ROUNDS):
        for name, solve in paths:
            print(f"round {r + 1}, {name}: solving by its graph ...", flush=True)
            out = solve()
            refs.setdefault(name, out)
            same = [cs._same_result(out, refs[name])]
            print(f"round {r + 1}, {name}: solving by its eager body ...", flush=True)
            with device_loop.eager():
                same.append(cs._same_result(solve(), refs[name]))
            if profiled:
                for side, context in (("graph", contextlib.nullcontext), ("eager body", device_loop.eager)):
                    print(f"round {r + 1}, {name}: profiling its {side} (session {sessions + 1}) ...", flush=True)
                    with context():
                        out, calls, ms, wall = cs._launch_profile(solve)
                    sessions += 1
                    same.append(cs._same_result(out, refs[name]))
                    print(f"round {r + 1}, {name}, {side}: launch calls {calls}, device ms {ms:.3f}, wall {wall:.3f} "
                          f"s", flush=True)
            print(f"round {r + 1}, {name}: bit-equal to the first graph solve {same}", flush=True)
            if not all(same):
                raise AssertionError(f"round {r + 1}, {name}: a solve differs from the first graph solve: {same}")
    print(f"sharded sequence: {SEQUENCE_ROUNDS} rounds, {sessions} profiler sessions, every solve bit-equal",
          flush=True)


MESH_PINGS = 1000
# each process of the barrier group is killed past this
MESH_PAIR_TIMEOUT_S = 180


def _mesh_group(env, n, spread):
    """This script's barrier_rank in n processes (environment ``env``; with
    ``spread`` rank r on card r): every rank's BARRIER record, or an error
    string."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    extra = ["--processes", str(n)] + ["--spread"] * spread
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--path", "mesh_barrier", "--rank",
                               str(r), "--port", str(port), *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_PAIR_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    records = [json.loads(line[len("BARRIER "):]) for out in outs for line in out.splitlines()
               if line.startswith("BARRIER ")]
    if len(records) != n or any(p.returncode != 0 for p in procs):
        return "the group failed: " + " | ".join(o[-1500:] for o in outs)
    for rec in records:
        ping = (f"flag round trip {', '.join(f'{u:.3f}' for u in rec['pingpong_us'])} µs ({MESH_PINGS} a launch); "
                if rec["pingpong_us"] else "")
        print(f"  rank {rec['rank']} on {rec['device']}: {ping}all-reduce of one float32 eagerly "
              f"{rec['eager_us']:.2f} µs, in a graph {rec['graph_us']:.2f} µs; of S (5.76 MB) {rec['s_ms']:.4f} ms, "
              f"bit-equal to the plain version {rec['s_bit_equal']}; transport {rec['transport']}", flush=True)
        if rec["cg"]:
            cg = rec["cg"]
            print(f"    CG BA on the headline, {n} processes × 1 shard: graph {cg['graph_s']:.4f} s, eager body "
                  f"{cg['eager_s']:.4f} s, first call {cg['first_s']:.4f} s; bit-equal to its eager body "
                  f"{cg['bit_equal']}; digest {cg['digest']}", flush=True)
    if len({r["cg"]["digest"] for r in records if r["cg"]}) > 1 or not all(r["s_bit_equal"] for r in records):
        return "the ranks differ"
    return records


def mesh_barrier(dev, n=2, spread=False):
    """The device transport's barrier between n processes, on one card (as
    they are, then under MPS) or spread over the cards (module docstring)."""
    where = "spread over the cards" if spread else "on one card"
    print(f"mesh barrier, {n} processes {where}:", flush=True)
    plain = _mesh_group(dict(os.environ), n, spread)
    print(f"mesh barrier, {n} processes {where}: {plain if isinstance(plain, str) else 'done'}", flush=True)
    if spread:
        return
    control = shutil.which("nvidia-cuda-mps-control")
    root = Path("build/mps").resolve()
    env = dict(os.environ, CUDA_MPS_PIPE_DIRECTORY=str(root / "pipe"), CUDA_MPS_LOG_DIRECTORY=str(root / "log"))
    if control is None:
        print("mesh barrier under MPS: not run (no nvidia-cuda-mps-control on PATH)", flush=True)
        return
    for d in ("pipe", "log"):
        (root / d).mkdir(parents=True, exist_ok=True)
    start = subprocess.run([control, "-d"], env=env, capture_output=True, text=True, timeout=60)
    if start.returncode != 0:
        print(f"mesh barrier under MPS: not run (nvidia-cuda-mps-control -d exited {start.returncode}: "
              f"{(start.stdout + start.stderr).strip()[-500:]})", flush=True)
        return
    try:
        print("mesh barrier, two processes under MPS:", flush=True)
        mps = _mesh_group(env, n, False)
        print(f"mesh barrier under MPS: {mps if isinstance(mps, str) else 'done'}", flush=True)
    finally:
        quit_ = subprocess.run([control], input="quit\n", env=env, capture_output=True, text=True, timeout=60)
        logs = " | ".join(f"{f.name}: {f.read_text()[-400:]}" for f in sorted((root / "log").glob("*.log")))
        print(f"MPS daemon told to quit (exit {quit_.returncode}); logs: {logs}", flush=True)


def barrier_rank(rank, port, n, spread):
    """One process of the barrier group: BARRIER {record} on stdout. Two
    processes bounce a flag; every group times an all-reduce of one float32
    (eagerly and in a graph of 100) and of S's 5.76 MB against the plain
    version's bits; a spread group also solves the headline CG BA with its
    observations over the processes, by its graph and its eager body."""
    import torch.distributed as dist

    from moptimizer_0_tpu_torch.parallel import mesh as mesh_module

    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=n, process_id=rank,
                         initialization_timeout=120)
    device = torch.device("cuda", rank % torch.cuda.device_count()) if spread else torch.device("cuda", 0)
    torch.cuda.set_device(device)  # the events, the synchronisations and the capture's stream on its card
    mesh = multihost.global_mesh(shards_per_process=1, device=str(device))
    ipc = mesh.link.buffers[0]  # the device transport of its one card
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    pings = []
    if n == 2:
        ipc.pingpong(10)
        for _ in range(3):
            pings.append(timed(lambda: ipc.pingpong(MESH_PINGS), 1) * 1e3 / MESH_PINGS)
    x = torch.ones(1, dtype=torch.float32, device=device)
    eager_us = timed(lambda: ipc.all_reduce(x, "sum"), 1000) * 1e3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            y = ipc.all_reduce(x, "sum")
    graph_us = timed(graph.replay, 10) * 1e3 / 100
    if float(y) != n:
        raise AssertionError(f"the all-reduce of {n} ones gave {float(y)}")
    s = torch.as_tensor(np.random.default_rng(rank).normal(size=(6 * cs.BA_C) ** 2), dtype=torch.float32,
                        device=device)
    s_ms = timed(lambda: ipc.all_reduce(s, "sum"), 50)
    s_equal = cs._same_result(ipc.all_reduce(s, "sum"), mesh_module._all_reduce_plain(s, "sum", mesh.group))
    cg = None
    if spread:
        prob = ba.make_ba_problem(cs.BA_O, cs.BA_C, cs.BA_L, seed=cs.SEED, dtype=torch.float32, device=device)
        sp = cs._observation_sharded(prob, mesh, multihost.host_local_shard)

        def solve():
            return ba.solve_ba(sp, ba.BAConfig())

        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        walls = {}
        for side, context in (("graph", contextlib.nullcontext), ("eager", device_loop.eager)):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            with context():
                out = solve()
            torch.cuda.synchronize()
            walls[side] = (time.perf_counter() - t0, out)
        cg = dict(first_s=first_s, graph_s=walls["graph"][0], eager_s=walls["eager"][0],
                  bit_equal=cs._same_result(walls["graph"][1], walls["eager"][1]),
                  digest=cs._digest(walls["graph"][1].camera_params))
    ipc.check()
    print("BARRIER " + json.dumps(dict(rank=rank, device=str(device), transport=mesh.transport, pingpong_us=pings,
                                       eager_us=eager_us, graph_us=graph_us, s_ms=s_ms, s_bit_equal=s_equal, cg=cg)),
          flush=True)
    del graph
    mesh.close()
    dist.destroy_process_group()


def pgo_solve(cloud):
    """The first PGO_ITERATIONS outer iterations of the dense solve of
    chip_smoke.py's 2,000-pose ring graph, float32."""
    graph, _ = cs.make_ring_graph(max(cs.RING_BOUNDS), cs.RING_SEED, cs.RING_DRIFT, dtype=torch.float32,
                                  device=cloud.device)
    config = pose_graph.PGOConfig(max_iterations=PGO_ITERATIONS)

    def step():
        return pose_graph.solve_pgo(graph, config).poses.cpu()

    return step


PGO_ITERATIONS = 5


# a pair's stages, each wrapped in a record_function range: (range name,
# module, attribute); the ranges of a path do not nest, but for the GICP
# path's weight inverse, which runs inside the linearization and the trial
# costs and is shown on its own
STAGES = (
    ("grid query", registration, "grid_nearest_neighbors"),
    ("linearization", registration, "fused_point2point_linearizer"),
    ("trial costs", solver, "compute_cost"),
    ("damped solves", solver, "_solve_damped"),
)
GICP_STAGES = (
    ("covariances", registration, "gicp_covariances"),
    ("K5 search", registration, "nearest_neighbors"),
    ("linearization", solver, "linearize"),
    ("trial costs", solver, "compute_cost"),
    ("damped solves", solver, "_solve_damped"),
    ("weight inverse", core_linearize, "_per_residual_weights"),
)
PGO_STAGES = (
    ("edge plans", pose_graph, "_EdgePlan"),
    ("linearization", pose_graph, "_linearize"),
    ("assembly", pose_graph, "_assemble"),
    ("costs", pose_graph, "compute_cost"),
    ("damped solves", pose_graph, "_dense_step"),
)
NESTED = {"weight inverse"}


def _ranged(name, fn):
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def _device_us(e):
    return e.device_time_total


# path: (what is traced, its maker, the module of its search kernel or None,
# its stages or None)
PATHS = {
    "fleet": ("one fleet pass", fleet_step, k_expand, None),
    "icp": ("one ICP request", icp_request, k_nn, None),
    "pair": ("one SLAM grid pair", slam_pair, None, STAGES),
    "gicp": ("one SLAM GICP pair", gicp_pair, k_nn, GICP_STAGES),
    "pgo": (f"{PGO_ITERATIONS} outer iterations of the 2,000-pose ring's dense PGO", pgo_solve, None, PGO_STAGES),
    "ring_cg": ("the 300-pose ring's CG PGO, by its graph and its eager body", None, None, None),
    "sharded_cg": ("the observation-sharded CG and self-cal graphs, profiled and held to their bits", None, None,
                   None),
    "sharded_sequence": ("phase 22's sharded BA paths, repeated, profiled or not", None, None, None),
    "mesh_barrier": ("the device transport's barrier between two processes, with and without MPS", None, None, None),
    "multicard_cg": ("the headline CG BA's graphs over one process's several cards", None, None, None),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=sorted(PATHS), default="fleet")
    parser.add_argument("--out", default="build/profile", help="directory for the chrome trace")
    parser.add_argument("--unprofiled", action="store_true", help="sharded_sequence without the profiler")
    parser.add_argument("--processes", type=int, default=2, help="mesh_barrier's processes (default 2)")
    parser.add_argument("--spread", action="store_true", help="mesh_barrier with rank r on card r")
    parser.add_argument("--rank", type=int, help="run as one of mesh_barrier's processes (internal)")
    parser.add_argument("--port", type=int, help="mesh_barrier's group port on localhost (internal)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this runs on a GPU only")
    if args.rank is not None:
        barrier_rank(args.rank, args.port, args.processes, args.spread)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda", 0)
    if args.path == "sharded_sequence":
        build.build(cs.k_schur.NAME, cs.k_schur.SOURCES)
        sharded_sequence(dev, not args.unprofiled)
        return
    if args.path == "multicard_cg":
        build.build(mesh_reduce.NAME, mesh_reduce.SOURCES)
        multicard_cg(dev, Path(args.out) / "multicard_cg_trace.json")
        return
    if args.path in ("ring_cg", "sharded_cg", "mesh_barrier"):
        if args.path == "mesh_barrier":
            build.build(mesh_reduce.NAME, mesh_reduce.SOURCES)
        if args.path == "mesh_barrier":
            mesh_barrier(dev, args.processes, args.spread)
        else:
            dict(ring_cg=ring_cg, sharded_cg=sharded_cg)[args.path](dev)
        return
    what, make, kernel, stages = PATHS[args.path]
    if kernel is not None:
        build.build(kernel.NAME, kernel.SOURCES)
    for name, module, attr in stages or ():
        setattr(module, attr, _ranged(name, getattr(module, attr)))
    cloud = torch.as_tensor(cs.load_txt_cloud(cs.FACHADA), dtype=torch.float32, device="cuda")
    step = make(cloud)
    if args.path != "pgo":
        profile_step(what, step, kernel, stages, Path(args.out) / f"{args.path}_trace.json")
        return
    # the solve by its graph (a replay an outer iteration: no stage ranges
    # inside), then its step's body eagerly on the capture's routes
    profile_step(f"{what} by its graph", step, None, None, Path(args.out) / "pgo_graph_trace.json")
    with device_loop.eager(), capturable_linalg(cloud.device):
        profile_step(f"{what} by its eager body", step, None, stages, Path(args.out) / "pgo_eager_trace.json")


def profile_step(what, step, kernel, stages, trace):
    """step() once to warm up, five times on the host clock, then once under
    torch.profiler: the host and device times, launches and syncs, the
    kernel's and each stage's share, the kernels by device time; the chrome
    trace to ``trace``."""
    step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"{what}, host clock ending in a host read: {[f'{w:.3f}' for w in walls]} ms")

    k_nn.reset_launches()
    k_expand.reset_launches()
    reads, pgo_reads = grid_nn.HOST_READS, pose_graph.HOST_READS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # (a record_function range may also show on the device timeline: not a kernel)
    ranges = {name for name, _, _ in stages or ()}
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in ranges]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    launches = sum(e.name == "cudaLaunchKernel" for e in events)
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in events)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in events)
    copies = sum(e.name == "cudaMemcpyAsync" for e in events)
    by_name = {}
    for e in device:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    print(
        f"profiled {what}: host {wall_ms:.3f} ms, device time {busy_ms:.3f} ms in {len(device)} device "
        f"events (busy {busy_ms / wall_ms:.1%} of the host time, idle {1 - busy_ms / wall_ms:.1%}), "
        f"{launches} cudaLaunchKernel, {graph_launches} cudaGraphLaunch, {syncs} stream/device syncs, {copies} "
        f"cudaMemcpyAsync; K5 launches {k_nn.launches()}, K6 launches {k_expand.launches()} (replayed and eager), "
        f"grid host reads {grid_nn.HOST_READS - reads}, PGO host reads {pose_graph.HOST_READS - pgo_reads}"
    )
    if kernel is not None:
        # the search kernel and its merge: every __global__ function of its source
        source = (build.CSRC_DIR / kernel.SOURCES[0]).read_text()
        names = re.findall(r"__global__ void\s+(?:__launch_bounds__\(\w+\)\s*)?(\w+)\(", source)
        mine = [k for k in by_name if any(f"{n}(" in k for n in names)]
        mine_ms = sum(by_name[k][0] for k in mine)
        print(f"{kernel.NAME}: {mine_ms:.3f} ms of device time in {sum(by_name[k][1] for k in mine)} kernels "
              f"({mine_ms / busy_ms:.1%})")
    if stages:
        # the ranges do not nest (a trial cost holds no query, a linearization
        # no solve), so each stage's device and host time is its own; a
        # NESTED stage's time is inside the others'
        times = {name: [0.0, 0.0, 0] for name, _, _ in stages}
        for e in events:
            if e.name in times and e.device_type == torch.autograd.DeviceType.CPU:
                times[e.name][0] += _device_us(e) / 1e3
                times[e.name][1] += e.cpu_time_total / 1e3
                times[e.name][2] += 1
        rest = busy_ms - sum(v[0] for k, v in times.items() if k not in NESTED)
        print("device time by stage (ms, share of device time; host ms inside the ranges; calls):")
        for name, (dev_ms, host_ms, calls) in times.items():
            inside = " (inside the linearization and trial costs)" if name in NESTED else ""
            print(f"  {name:14s} {dev_ms:9.3f} ms {dev_ms / busy_ms:6.1%}  host {host_ms:9.3f} ms  {calls} calls{inside}")
        print(f"  {'rest of LM':14s} {rest:9.3f} ms {rest / busy_ms:6.1%}")
    print("device time by kernel (ms, launches, share):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t:9.3f} ms {n:6d}  {t / busy_ms:6.1%}  {name[:110]}")
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    print(f"chrome trace: {trace}")


if __name__ == "__main__":
    main()
