"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. the card: name and power limit from nvidia-smi;
2. build: every kernel compiled from ``moptimizer_0_tpu_torch/csrc``, one
   nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main paths and at ragged, tied and segmented shapes; timed with
   CUDA events in the order plain, kernel, kernel, plain;
4. the ICP path: three ICP requests on the full 29,310-point fachada LiDAR
   scan in float32, each with a shuffled target and a known transform that
   must be recovered to 2e-3; one request is repeated with the plain search
   and must give the same iterations and x;
5. the dense-BA path: ``solve_ba_dense`` on the O=500k, C=200, L=50k
   instance of the JAX package's bench in float32, which must end in the χ²
   band around its noise floor with the fixed cameras unmoved; its first
   three outer iterations are repeated with the plain S build and must give
   the same costs.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; the kernels of the path must have been launched. The line
before the last is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import moptimizer_0_tpu_torch  # noqa: F401  (sets fp32 matmul precision)
from moptimizer_0_tpu_torch import ba, ba_dense
from moptimizer_0_tpu_torch.core.loss import GemanMcClure
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.kernels import schur as k_schur
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops.nn_search import _nn_torch
from moptimizer_0_tpu_torch.ops.schur import _schur_corr_torch, fold_linv
from moptimizer_0_tpu_torch.registration import icp
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

ROOT = Path(__file__).resolve().parent
FACHADA = ROOT / "tests" / "data" / "fachada.txt"
SEED = 0
X_A = [0.4, -0.3, 0.2, 0.05, -0.04, 0.06]  # the fachada transform of tests/test_grid_nn.py
X_B = [-0.25, 0.15, -0.1, -0.03, 0.05, -0.02]
X_TOL = 2e-3

# The dense-BA instance of the JAX package's bench (bench.py:155-196).
BA_O, BA_C, BA_L = 500_000, 200, 50_000
BA_SIGMA = 0.5  # pixel noise of the instance
# The final cost must lie within ±1% of the χ² floor σ²·(2O − 6(C−2) − 3L).
# At the optimum the cost is σ² times a χ² variable with that many degrees
# of freedom, whose standard deviation is √(2·dof) ≈ 0.15% of it: ±1% is
# ±6.5 standard deviations.
BA_BAND = 0.01
# K11 against its plain version: max|ΔS_corr| ≤ 1e-5·max|S_corr|. Both sum
# float32 products in other orders (atomics in no fixed order, blocked
# matmul); an entry sums up to a few thousand products, so their roundoff
# differs by up to ~√n·ε ≈ 1e-6 of the entry.
S_BOUND = 1e-5
# The plain-S repeat: the steps differ only by that roundoff, so the costs
# of the first three outer iterations agree to 1e-5 relative.
BA_COST_RTOL = 1e-5


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


def _s_build_segments(prob, grouped):
    """The S build's inputs at one linearization of ``prob``: per segment
    (G, cam_ids, mask), with λ seeded as the solver seeds it."""
    pts = grouped.sort_points(prob.points)
    U, V, W, _, _, _ = ba_dense._linearize_and_blocks(
        prob.camera_params, pts, prob.intrinsics, grouped, prob.loss
    )
    lam = ba_dense.DenseBAConfig().init_lambda_factor * torch.maximum(
        U.diagonal(dim1=-2, dim2=-1).abs().max(), V.diagonal(dim1=-2, dim2=-1).abs().max()
    )
    V_d = ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=V.dtype, device=V.device)
    Linv = ba_dense._tri_inv_lower(ba_dense._chol3x3(V_d))
    return [
        (fold_linv(W_s, Linv[sl]), view.cam_ids, view.mask)
        for (sl, view), W_s in zip(ba_dense._seg_views(grouped), W)
    ]


def _random_segments(rng, dev, C, L, K, keep):
    """Random G with ragged masks; with K > C every landmark names some
    camera twice."""
    G = torch.as_tensor(rng.normal(size=(L, K, 6, 3)), dtype=torch.float32, device=dev)
    cam = torch.as_tensor(rng.integers(0, C, (L, K)), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.random((L, K)) < keep, dtype=torch.float32, device=dev)
    mask[3] = 0  # a landmark with no real slot
    return [(G, cam, mask)]


def _segments_text(grouped):
    return f"(end_row, K_s) {grouped.seg_bounds}" if grouped.seg_bounds else "unsegmented"


def check_schur_kernel(prob, grouped, dev, rng):
    """schur_corr_cuda against _schur_corr_torch: max|ΔS_corr|/max|S_corr| ≤
    S_BOUND per case; timed at the headline shape."""
    # many unobserved landmarks: forced into a zero-width last segment
    small = ba.make_ba_problem(4_000, 20, 5_000, seed=SEED + 1, device=dev)
    grouped3 = ba_dense.group_by_landmark(small, segments=3)
    if grouped3.seg_bounds[-1][1] != 0:
        raise AssertionError(f"expected a zero-width segment, got {grouped3.seg_bounds}")
    cases = {
        f"headline O={BA_O} C={BA_C} L={BA_L} segments {_segments_text(grouped)}":
            (_s_build_segments(prob, grouped), BA_C),
        "ragged C=5 L=37 K=9 with duplicate cameras": (_random_segments(rng, dev, 5, 37, 9, 0.6), 5),
        "wide C=7 L=23 K=70 (slot windows past 32)": (_random_segments(rng, dev, 7, 23, 70, 0.6), 7),
        f"segments=3 with unobserved landmarks, segments {_segments_text(grouped3)}":
            (_s_build_segments(small, grouped3), 20),
    }
    max_abs_err = 0.0
    for name, (segs, C) in cases.items():
        S_k = k_schur.schur_corr_cuda(segs, C)
        S_p = _schur_corr_torch(segs, C)
        torch.cuda.synchronize()
        err = float((S_k - S_p).abs().max())
        scale = float(S_p.abs().max())
        rel = err / scale
        print(f"schur kernel {name}: max|dS| {err:.4e}, max|S| {scale:.4e}, ratio {rel:.3e} (bound {S_BOUND:g})")
        if not torch.isfinite(S_k).all() or not rel <= S_BOUND:
            raise AssertionError(f"schur kernel {name}: max|dS|/max|S| = {rel} > {S_BOUND}")
        max_abs_err = max(max_abs_err, err)

    segs, C = next(iter(cases.values()))
    k_schur.schur_corr_cuda(segs, C)
    torch.cuda.synchronize()
    kernel_reps, plain_reps = 10, 2  # the plain build is 432 GFLOP of float32 matmul
    plain_ms = [_time_ms(lambda: _schur_corr_torch(segs, C), plain_reps)]
    kernel_ms = [_time_ms(lambda: k_schur.schur_corr_cuda(segs, C), kernel_reps)]
    kernel_ms.append(_time_ms(lambda: k_schur.schur_corr_cuda(segs, C), kernel_reps))
    plain_ms.append(_time_ms(lambda: _schur_corr_torch(segs, C), plain_reps))
    print(
        f"schur time at the headline shape (CUDA events, order plain, kernel, kernel, plain; "
        f"means of {plain_reps}/{kernel_reps}): kernel {kernel_ms} ms, plain {plain_ms} ms"
    )
    return max_abs_err, sum(kernel_ms) / 2, sum(plain_ms) / 2


def run_ba(prob, n_segs):
    """The dense-BA main path: one solve_ba_dense call, as a user makes it
    (host grouping included); K11 must launch once per trial and non-empty
    segment (``n_segs``)."""
    k_nn.LAUNCHES = k_schur.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(), schur_backend="auto")
    cost = float(res.cost)
    wall_s = time.perf_counter() - t0
    launches = k_schur.LAUNCHES
    if k_nn.LAUNCHES:
        raise AssertionError("the BA path launched the nn kernel")

    status = Status(int(res.status))
    trials = res.trace["trials"].tolist()
    run = int(torch.isfinite(res.trace["cost"]).sum())
    costs = res.trace["cost"][:run].tolist() + [cost]
    floor = BA_SIGMA**2 * (2 * BA_O - 6 * (BA_C - 2) - 3 * BA_L)
    print(
        f"dense BA O={BA_O} C={BA_C} L={BA_L} float32: wall {wall_s:.4f} s (host grouping "
        f"included), outer iterations run {run} (iterations {int(res.iterations)}), trials "
        f"{sum(trials)} {trials}, {wall_s / max(run, 1) * 1e3:.2f} ms per outer iteration, "
        f"status {status.name}, final cost {cost:.6e} vs chi2 floor {floor:.6e} "
        f"({(cost / floor - 1) * 100:+.4f}%)"
    )
    print(f"  cost trace {costs}")
    print(f"schur kernel launches on the BA path: {launches} for {sum(trials)} trials x {n_segs} segments")
    if status == Status.NUMERIC_ERROR or not np.isfinite(cost):
        raise AssertionError(f"dense BA: status {status.name}, cost {cost}")
    if not torch.equal(res.camera_params[:2], prob.camera_params[:2]):
        raise AssertionError("dense BA: a fixed camera moved")
    if any(b > a for a, b in zip(costs, costs[1:])):
        raise AssertionError(f"dense BA: the accepted cost rose: {costs}")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"dense BA: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if launches != sum(trials) * n_segs or launches == 0:
        raise AssertionError(f"the BA path launched the schur kernel {launches} times")
    return res, launches


def ba_steps(prob, grouped, backend, n=3):
    """The first n outer iterations through ba_step_dense: (cost, cost_new)
    pairs and the wall time of each step (host clock, ending in a host read)."""
    lam, costs, walls = -1.0, [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cams, pts, lam, _, _, rec = ba_dense.ba_step_dense(prob, grouped, lam, schur_backend=backend)
        costs.append((float(rec["cost"]), float(rec["cost_new"])))
        walls.append(time.perf_counter() - t0)
        prob = dataclasses.replace(prob, camera_params=cams, points=pts)
    print(f"dense BA steps, schur backend {backend}: wall {[f'{w * 1e3:.2f} ms' for w in walls]}, costs {costs}")
    return costs


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
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(build.build, k.NAME, k.SOURCES) for k in (k_nn, k_schur)]
        built = [f.result() for f in futures]
    print(f"build (one nvcc per source, in parallel): {time.perf_counter() - t0:.3f} s")
    for path, log in built:
        print(f"  -> {path.relative_to(ROOT)}")
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line):
                print(f"  {line.strip()}")

    rng = np.random.default_rng(SEED)
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    max_abs_err, kernel_ms, plain_ms = check_nn_kernel(cloud, rng)
    ba_prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    ba_grouped = ba_dense.group_by_landmark(ba_prob, segments="auto")
    s_err, s_kernel_ms, s_plain_ms = check_schur_kernel(ba_prob, ba_grouped, dev, rng)

    requests = [
        ("A", X_A, {}),
        ("B", X_B, {}),
        ("A-gated", X_A, dict(loss=GemanMcClure(tau=1.0), max_corr_dist=1.0)),
    ]
    k_nn.LAUNCHES = k_schur.LAUNCHES = 0
    results, outer_total = {}, 0
    for name, x_true, kw in requests:
        results[name], outer = run_request(name, cloud, x_true, np.random.default_rng(SEED + 1), **kw)
        outer_total += outer
    launches = k_nn.LAUNCHES
    print(f"nn kernel launches on the ICP path: {launches} for {outer_total} outer iterations")
    if launches < outer_total or launches == 0:
        raise AssertionError(f"the ICP path launched the nn kernel {launches} times")
    if k_schur.LAUNCHES:
        raise AssertionError("the ICP path launched the schur kernel")

    plain, _ = run_request("A", cloud, X_A, np.random.default_rng(SEED + 1), nn_backend="torch")
    if int(plain.iterations) != int(results["A"].iterations):
        raise AssertionError("plain search: iterations differ from the kernel's run")
    dx = float((plain.x - results["A"].x).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"plain search: x differs from the kernel's run by {dx}")
    print(f"request A with the plain search: same iterations, max|dx| {dx:.3e}")

    n_segs = sum(view.cam_ids.numel() > 0 for _, view in ba_dense._seg_views(ba_grouped))
    ba_res, s_launches = run_ba(ba_prob, n_segs)
    ba_steps(ba_prob, ba_grouped, "auto")
    plain_costs = ba_steps(ba_prob, ba_grouped, "torch")
    kernel_costs = list(zip(ba_res.trace["cost"][:3].tolist(), ba_res.trace["cost_new"][:3].tolist()))
    worst = max(abs(p - k) / abs(k) for pk, kk in zip(plain_costs, kernel_costs) for p, k in zip(pk, kk))
    print(f"plain-S repeat of the first 3 outer iterations: max relative cost difference {worst:.3e} "
          f"(bound {BA_COST_RTOL:g})")
    if not worst <= BA_COST_RTOL:
        raise AssertionError(f"plain-S repeat: costs differ by {worst} > {BA_COST_RTOL}")

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
        ),
        dict(
            name="schur_pairs",
            route="cuda",
            source="moptimizer_0_tpu_torch/csrc/schur.cu",
            replaces="benchmarks/schur_pallas_ab.py:38",
            launches=s_launches,
            max_abs_err=s_err,
            ms=s_kernel_ms,
            plain_ms=s_plain_ms,
        ),
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
