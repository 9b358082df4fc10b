"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. the card: name and power limit from nvidia-smi;
2. build: every kernel of the path compiled from ``moptimizer_0_tpu_torch/csrc``;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main path and at ragged and tied shapes; timed with CUDA events;
4. the main path: three ICP requests on the full 29,310-point fachada LiDAR
   scan in float32, each with a shuffled target and a known transform that
   must be recovered to 2e-3; the kernels' launch counts must show that the
   path went through them; one request is repeated with the plain search and
   must give the same iterations and x.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import moptimizer_0_tpu_torch  # noqa: F401  (sets fp32 matmul precision)
from moptimizer_0_tpu_torch.core.loss import GemanMcClure
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops.nn_search import _nn_torch
from moptimizer_0_tpu_torch.registration import icp
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

ROOT = Path(__file__).resolve().parent
FACHADA = ROOT / "tests" / "data" / "fachada.txt"
SEED = 0
X_A = [0.4, -0.3, 0.2, 0.05, -0.04, 0.06]  # the fachada transform of tests/test_grid_nn.py
X_B = [-0.25, 0.15, -0.1, -0.03, 0.05, -0.02]
X_TOL = 2e-3


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _transformed(cloud, x, rng):
    T = se3.transform_from_params6(torch.tensor(x, dtype=cloud.dtype, device=cloud.device))
    tgt = se3.apply_transform(T, cloud)
    perm = torch.as_tensor(rng.permutation(cloud.shape[0]), device=cloud.device)
    return tgt[perm].contiguous()


def check_nn_kernel(cloud, rng):
    """nn_cuda against _nn_torch: equal indices and bit-equal d²."""
    dev = cloud.device
    cases = {"fachada": (_transformed(cloud, X_A, rng), cloud)}
    for n_query, n_points in ((33, 77), (1000, 4097)):
        q = torch.as_tensor(rng.uniform(-10, 10, (n_query, 3)), dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.uniform(-10, 10, (n_points, 3)), dtype=torch.float32, device=dev)
        cases[f"{n_query}x{n_points}"] = (q, p)
    base = torch.as_tensor(rng.uniform(-10, 10, (700, 3)), dtype=torch.float32, device=dev)
    cases["ties"] = (base[::3].contiguous(), torch.cat([base, base, base]))

    max_abs_err = 0.0
    for name, (q, p) in cases.items():
        idx_k, d2_k = k_nn.nn_cuda(q, p)
        idx_p, d2_p = _nn_torch(q, p)
        torch.cuda.synchronize()
        if not torch.equal(idx_k, idx_p):
            bad = int((idx_k != idx_p).sum())
            raise AssertionError(f"nn kernel {name}: {bad} indices differ from the plain version")
        if not torch.equal(d2_k.view(torch.int32), d2_p.view(torch.int32)):
            raise AssertionError(f"nn kernel {name}: d² not bit-equal to the plain version")
        if name == "ties" and not bool((idx_k < base.shape[0]).all()):
            raise AssertionError("nn kernel: a tie did not go to the smallest index")
        err = float((d2_k - d2_p).abs().max())
        max_abs_err = max(max_abs_err, err)
        print(f"nn kernel {name}: {q.shape[0]}x{p.shape[0]} idx equal, d2 bit-equal")

    q, p = cases["fachada"]
    for _ in range(3):
        k_nn.nn_cuda(q, p)
        _nn_torch(q, p)
    reps = 20
    plain_ms = [_time_ms(lambda: _nn_torch(q, p), reps)]
    kernel_ms = [_time_ms(lambda: k_nn.nn_cuda(q, p), reps)]
    kernel_ms.append(_time_ms(lambda: k_nn.nn_cuda(q, p), reps))
    plain_ms.append(_time_ms(lambda: _nn_torch(q, p), reps))
    print(
        f"nn time at {q.shape[0]}x{p.shape[0]} (CUDA events, mean of {reps}, "
        f"order plain, kernel, kernel, plain): kernel {kernel_ms} ms, plain {plain_ms} ms"
    )
    return max_abs_err, sum(kernel_ms) / 2, sum(plain_ms) / 2


def run_request(name, cloud, x_true, rng, nn_backend="auto", loss=None, max_corr_dist=None):
    tgt = _transformed(cloud, x_true, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp(cloud, tgt, loss=loss, max_corr_dist=max_corr_dist, nn_backend=nn_backend)
    x = res.x.cpu()
    wall_s = time.perf_counter() - t0
    outer = int(torch.isfinite(res.trace["cost"]).sum())
    trials = int(torch.isfinite(res.trace["inner"]["cost_new"]).sum())
    status = Status(int(res.status))
    err = float((x.double() - torch.tensor(x_true, dtype=torch.float64)).abs().max())
    print(
        f"request {name}: backend {nn_backend}, wall {wall_s:.4f} s, outer iterations "
        f"{outer} (iterations {int(res.iterations)}), trials {trials}, host syncs "
        f"{outer + trials}, status {status.name}, max|x - x_true| {err:.3e}, "
        f"cost {float(res.cost):.6e}"
    )
    if status == Status.NUMERIC_ERROR or not torch.isfinite(res.x).all() or x.shape != (6,):
        raise AssertionError(f"request {name}: status {status.name}, x {x.tolist()}")
    if err > X_TOL:
        raise AssertionError(f"request {name}: max|x - x_true| = {err} > {X_TOL}")
    return res, outer


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    path, log = build.build(k_nn.NAME, k_nn.SOURCES)
    print(f"build: {time.perf_counter() - t0:.3f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    rng = np.random.default_rng(SEED)
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    max_abs_err, kernel_ms, plain_ms = check_nn_kernel(cloud, rng)

    requests = [
        ("A", X_A, {}),
        ("B", X_B, {}),
        ("A-gated", X_A, dict(loss=GemanMcClure(tau=1.0), max_corr_dist=1.0)),
    ]
    k_nn.LAUNCHES = 0
    results, outer_total = {}, 0
    for name, x_true, kw in requests:
        results[name], outer = run_request(name, cloud, x_true, np.random.default_rng(SEED + 1), **kw)
        outer_total += outer
    launches = k_nn.LAUNCHES
    print(f"nn kernel launches on the main path: {launches} for {outer_total} outer iterations")
    if launches < outer_total or launches == 0:
        raise AssertionError(f"the main path launched the nn kernel {launches} times")

    plain, _ = run_request("A", cloud, X_A, np.random.default_rng(SEED + 1), nn_backend="torch")
    if int(plain.iterations) != int(results["A"].iterations):
        raise AssertionError("plain search: iterations differ from the kernel's run")
    dx = float((plain.x - results["A"].x).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"plain search: x differs from the kernel's run by {dx}")
    print(f"request A with the plain search: same iterations, max|dx| {dx:.3e}")

    kernels = [
        dict(
            name="nn_bruteforce",
            route="cuda",
            source="moptimizer_0_tpu_torch/csrc/nn_search.cu",
            replaces="moptimizer_0_tpu/ops/nn_search.py:136",
            launches=launches,
            max_abs_err=max_abs_err,
            ms=kernel_ms,
            plain_ms=plain_ms,
        )
    ]
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
