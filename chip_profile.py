"""Profile one pass of the fleet ICP loop, or one ICP request, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_profile.py [--path fleet|icp] [--out DIR]

``--path fleet`` (the default) builds the expansion kernel K6, makes the
64-lane fachada fleet of ``chip_smoke.py`` and runs one pass of
``icp_batched`` to reach the fleet's second iterate; the step is one pass
(max_iterations=1) from there. ``--path icp`` builds the brute-force kernel
K5; the step is one whole ICP request of ``chip_smoke.py`` (request A: the
full fachada scan in float32, ``icp`` with its defaults, K5 searching). The
step runs once to warm up and five times on the host clock (ending in a
host read), then once under ``torch.profiler``. Prints the card, those host
times and the traced one, the device time and busy share, the kernel
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
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.registration import icp, icp_batched


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


# path: (what is traced, its maker, the module of its search kernel)
PATHS = {
    "fleet": ("one fleet pass", fleet_step, k_expand),
    "icp": ("one ICP request", icp_request, k_nn),
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
    what, make, kernel = PATHS[args.path]
    build.build(kernel.NAME, kernel.SOURCES)
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

    kernel.LAUNCHES = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    launches = sum(e.name == "cudaLaunchKernel" for e in events)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in events)
    copies = sum(e.name == "cudaMemcpyAsync" for e in events)
    by_name = {}
    for e in device:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    # the search kernel and its merge: every __global__ function of its source
    source = (build.CSRC_DIR / kernel.SOURCES[0]).read_text()
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\(\w+\)\s*)?(\w+)\(", source)
    mine = [k for k in by_name if any(f"{n}(" in k for n in names)]
    mine_ms = sum(by_name[k][0] for k in mine)
    print(
        f"profiled {what}: host {wall_ms:.3f} ms, device time {busy_ms:.3f} ms in {len(device)} device "
        f"events (busy {busy_ms / wall_ms:.1%} of the host time), {launches} cudaLaunchKernel, "
        f"{syncs} stream/device syncs, {copies} cudaMemcpyAsync; {kernel.NAME} launches {kernel.LAUNCHES}, "
        f"{mine_ms:.3f} ms of device time in {sum(by_name[k][1] for k in mine)} kernels "
        f"({mine_ms / busy_ms:.1%})"
    )
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
