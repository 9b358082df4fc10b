"""Profile one pass of the fleet ICP loop, one ICP request, or one SLAM pair, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_profile.py [--path fleet|icp|pair|gicp|pgo] [--out DIR]

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
graph in float32, split between the edge plans, the per-edge linearization,
the 12,000² assembly, the costs and the damped Cholesky solves.
Prints the card, those host times and the traced one, the device time and busy share, the kernel
launches and host syncs, the search kernel's share of device time and the
kernels by device time, and writes the chrome trace to DIR (default
``build/profile``).
"""

import argparse
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs
from moptimizer_0_tpu_torch import pose_graph, registration
from moptimizer_0_tpu_torch.core import linearize as core_linearize
from moptimizer_0_tpu_torch.core import solver
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.ops import grid_nn
from moptimizer_0_tpu_torch.registration import PairwiseRegistrar, icp, icp_batched


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
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=sorted(PATHS), default="fleet")
    parser.add_argument("--out", default="build/profile", help="directory for the chrome trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    what, make, kernel, stages = PATHS[args.path]
    if kernel is not None:
        build.build(kernel.NAME, kernel.SOURCES)
    for name, module, attr in stages or ():
        setattr(module, attr, _ranged(name, getattr(module, attr)))
    cloud = torch.as_tensor(cs.load_txt_cloud(cs.FACHADA), dtype=torch.float32, device="cuda")
    step = make(cloud)
    step()

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"{what}, host clock ending in a host read: {[f'{w:.3f}' for w in walls]} ms")

    k_nn.LAUNCHES = k_expand.LAUNCHES = 0
    reads = grid_nn.HOST_READS
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
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in events)
    copies = sum(e.name == "cudaMemcpyAsync" for e in events)
    by_name = {}
    for e in device:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    print(
        f"profiled {what}: host {wall_ms:.3f} ms, device time {busy_ms:.3f} ms in {len(device)} device "
        f"events (busy {busy_ms / wall_ms:.1%} of the host time, idle {1 - busy_ms / wall_ms:.1%}), "
        f"{launches} cudaLaunchKernel, {syncs} stream/device syncs, {copies} cudaMemcpyAsync; K5 launches "
        f"{k_nn.LAUNCHES}, K6 launches {k_expand.LAUNCHES}, grid host reads {grid_nn.HOST_READS - reads}"
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
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"{args.path}_trace.json"
    prof.export_chrome_trace(str(trace))
    print(f"chrome trace: {trace}")


if __name__ == "__main__":
    main()
