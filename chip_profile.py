"""Profile one pass of the fleet ICP loop on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_profile.py [--out DIR]

Builds the expansion kernel K6, makes the 64-lane fachada fleet of
``chip_smoke.py``, runs one pass of ``icp_batched`` to warm up and to reach
the fleet's second iterate, then traces one pass (max_iterations=1) from
there with ``torch.profiler``. Prints the card, the pass's host time
without and with the profiler, the device time and busy share, the kernel
launches and host syncs, and the kernels by device time; writes the chrome
trace to DIR (default ``build/profile``).
"""

import argparse
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
from moptimizer_0_tpu_torch.registration import icp_batched


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profile", help="directory for the chrome trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    build.build(k_expand.NAME, k_expand.SOURCES)

    cloud = torch.as_tensor(cs.load_txt_cloud(cs.FACHADA), dtype=torch.float32, device="cuda")
    srcs, tgts, _ = cs._fleet_inputs(cloud, np.random.default_rng(cs.SEED + 2))
    one_pass = LMConfig(diff_mode="auto", max_iterations=1, linear_solver="cholesky")
    x1 = icp_batched(srcs, tgts, config=one_pass).x

    def step():
        res = icp_batched(srcs, tgts, x1, config=one_pass)
        return res.x.cpu()

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"one fleet pass, host clock ending in a host read: {[f'{w:.3f}' for w in walls]} ms")

    k_expand.LAUNCHES = 0
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
    print(
        f"profiled pass: host {wall_ms:.3f} ms, device time {busy_ms:.3f} ms in {len(device)} device "
        f"events (busy {busy_ms / wall_ms:.1%} of the host time), {launches} cudaLaunchKernel, "
        f"{syncs} stream/device syncs, {copies} cudaMemcpyAsync, K6 launches {k_expand.LAUNCHES}"
    )
    by_name = {}
    for e in device:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    print("device time by kernel (ms, launches, share):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t:9.3f} ms {n:6d}  {t / busy_ms:6.1%}  {name[:110]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "fleet_pass_trace.json"))
    print(f"chrome trace: {out / 'fleet_pass_trace.json'}")


if __name__ == "__main__":
    main()
