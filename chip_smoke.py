"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. the card: name and power limit from nvidia-smi;
2. build: every kernel compiled from ``moptimizer_0_tpu_torch/csrc``, one
   nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main paths and at ragged, tied, subnormal, split and segmented
   shapes (K11 also against itself: two builds bit for bit); timed with
   CUDA events in the order plain, library, kernel, kernel, library, plain;
4. the ICP path: three ICP requests on the full 29,310-point fachada LiDAR
   scan in float32, each with a shuffled target and a known transform that
   must be recovered to 2e-3; one request is repeated with the plain search
   and must give the same iterations and x;
5. the dense-BA path: ``solve_ba_dense`` on the O=500k, C=200, L=50k
   instance of the JAX package's bench in float32, which must end in the χ²
   band around its noise floor with the fixed cameras unmoved, with one K11
   launch per S build; its first three outer iterations are repeated with
   the plain S build and must give the same costs;
6. the fleet path: ``icp_batched`` on 64 lanes of the full fachada scan in
   float32, each lane with its own shuffled target and known transform to
   be recovered to 2e-3, with one launch of the expansion kernel K6 per
   pass of the batched loop; lanes 0, 1 and 63 are repeated as single
   ``icp(..., nn_backend="pallas_mxu")`` solves and must agree to 1e-5.

Each kernel's line also carries its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over 67 TFLOP/s (float32 outside the
tensor cores), the published peaks of an H100 SXM at 700 W; and, where one
PyTorch call computes the same function, that call's time (``library_ms``),
which the port never uses.

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
from moptimizer_0_tpu_torch.core.loss import GemanMcClure, TrivialLoss
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.kernels import schur as k_schur
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.ops.nn_search import _nn_expand_torch, _nn_torch
from moptimizer_0_tpu_torch.ops.schur import _schur_corr_pairs_torch, _schur_corr_torch, fold_linv, pair_plan
from moptimizer_0_tpu_torch.registration import icp, icp_batched
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
# K11 against its plain versions: max|ΔS_corr| ≤ 1e-5·max|S_corr|. They sum
# float32 products in other orders (lanes and a shuffle tree, a blocked
# matmul, index_add_); an entry sums up to a few thousand products, so their
# roundoff differs by up to ~√n·ε ≈ 1e-6 of the entry. Two runs of the
# kernel sum in one fixed order and must agree bit for bit.
S_BOUND = 1e-5
# The plain-S repeat: the steps differ only by that roundoff, so the costs
# of the first three outer iterations agree to 1e-5 relative.
BA_COST_RTOL = 1e-5

# The fleet of the JAX package's batch-64 ICP bench (bench.py:104-152): 64
# lanes of the full fachada scan. Lanes 0 and 1 use X_A and X_B, the others
# seeded transforms with |t| ≤ 0.4 m and |ω| ≤ 0.06 rad.
FLEET_B = 64
FLEET_T, FLEET_W = 0.4, 0.06
# Single solves against their fleet lanes: the batched moment sums round in
# another order than the single ones, so the two x differ by float32
# roundoff of the noise-floor solve.
FLEET_X_TOL = 1e-5
FLEET_SINGLES = (0, 1, 63)

# Published peaks of an H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, n_bytes):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nn_bound(lanes, n_query, n_points):
    """8 flops a pair; each query and target read once, (idx, d²) written once."""
    pairs = lanes * n_query * n_points
    return _bound(8 * pairs, 4 * lanes * (3 * n_query + 3 * n_points + 2 * n_query))


def _library_nn(q, p):
    """torch.cdist's matrix-product form and a min, one call a lane (the
    whole fleet's distance block would be 220 GB)."""
    if q.ndim == 2:
        return torch.cdist(q, p, compute_mode="use_mm_for_euclid_dist").min(-1)
    return [torch.cdist(qb, pb, compute_mode="use_mm_for_euclid_dist").min(-1) for qb, pb in zip(q, p)]


def _alternate(plain, kernel, library, reps, plain_reps=None):
    """Mean ms of each, in the order plain, library, kernel, kernel, library,
    plain (CUDA events)."""
    plain_reps = plain_reps or reps
    t = dict(plain=[], kernel=[], library=[])
    for name, fn, r in (("plain", plain, plain_reps), ("library", library, plain_reps),
                        ("kernel", kernel, reps), ("kernel", kernel, reps),
                        ("library", library, plain_reps), ("plain", plain, plain_reps)):
        t[name].append(_time_ms(fn, r))
    return t


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
        _library_nn(q, p)
    reps = 20
    t = _alternate(lambda: _nn_torch(q, p), lambda: k_nn.nn_cuda(q, p), lambda: _library_nn(q, p), reps)
    print(
        f"nn time at {q.shape[0]}x{p.shape[0]} (CUDA events, mean of {reps}, order plain, library, "
        f"kernel, kernel, library, plain): kernel {t['kernel']} ms, plain {t['plain']} ms, "
        f"library (cdist + min) {t['library']} ms"
    )
    timing = {k: sum(v) / len(v) for k, v in t.items()}
    return max_abs_err, timing, _nn_bound(1, q.shape[0], p.shape[0])


def _fleet_inputs(cloud, rng):
    """The fleet: 64 copies of the scan as sources; each lane's target is
    the scan under its transform, shuffled with its own permutation."""
    x_true = [X_A, X_B]
    for _ in range(FLEET_B - 2):
        t, w = rng.normal(size=3), rng.normal(size=3)
        t *= FLEET_T * rng.uniform() / np.linalg.norm(t)
        w *= FLEET_W * rng.uniform() / np.linalg.norm(w)
        x_true.append(np.concatenate([t, w]).tolist())
    srcs = cloud.expand(FLEET_B, *cloud.shape).contiguous()
    tgts = torch.stack([_transformed(cloud, x, rng) for x in x_true])
    return srcs, tgts, torch.tensor(x_true, dtype=torch.float64)


def _check_same(name, kernel_out, plain_out):
    idx_k, d2_k = kernel_out
    idx_p, d2_p = plain_out
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p):
        bad = int((idx_k != idx_p).sum())
        raise AssertionError(f"expansion kernel {name}: {bad} indices differ from the plain version")
    if not torch.equal(d2_k.view(torch.int32), d2_p.view(torch.int32)):
        raise AssertionError(f"expansion kernel {name}: d² not bit-equal to the plain version")
    finite = torch.isfinite(d2_k)
    return float((d2_k[finite] - d2_p[finite]).abs().max()) if finite.any() else 0.0


def _subnormal_cloud(rng, n, dev):
    """Coordinates near 1e-20, whose products lie below float32's normal
    range; every third point has one ordinary coordinate."""
    a = rng.uniform(-1, 1, (n, 3)) * 1e-20
    a[::3, 0] = rng.uniform(-1, 1, len(a[::3]))
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def check_expand_kernel(cloud, srcs, tgts, rng):
    """nn_expand_cuda against _nn_expand_torch: equal indices and bit-equal
    d² at the fleet shape and at one-lane, ragged, tied, NaN, 3-lane and
    subnormal cases; every case but the fleet has its targets split, and the
    tie cases have tied targets on both sides of a range's end. Timed at the
    fleet shape and at one lane."""
    dev = cloud.device
    cases = {
        f"fleet {FLEET_B}x{cloud.shape[0]}x{cloud.shape[0]}": (srcs, tgts),
        "one fachada lane": (_transformed(cloud, X_A, rng), cloud),
    }
    for n_query, n_points in ((33, 77), (1000, 4097)):
        q = torch.as_tensor(rng.uniform(-10, 10, (n_query, 3)), dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.uniform(-10, 10, (n_points, 3)), dtype=torch.float32, device=dev)
        cases[f"{n_query}x{n_points}"] = (q, p)
    # every target three times; the first copy must win across every cut:
    # 2,100 targets fall into ranges of 263 that cut the copies anywhere,
    # 768 into 3 ranges of 256 cut exactly at the copies
    base = torch.as_tensor(rng.uniform(-10, 10, (700, 3)), dtype=torch.float32, device=dev)
    cases["ties"] = (base[::3].contiguous(), torch.cat([base, base, base]))
    base_256 = base[:256]
    cases["ties, ranges cut at the copies"] = (base_256[::3].contiguous(), torch.cat([base_256] * 3))
    q_nan = torch.as_tensor(rng.uniform(-10, 10, (300, 3)), dtype=torch.float32, device=dev)
    q_nan[17] = torch.nan
    q_nan[200, 1] = torch.nan
    cases["NaN query rows"] = (q_nan, base)
    lanes_p = torch.as_tensor(rng.uniform(-10, 10, (3, 900, 3)), dtype=torch.float32, device=dev)
    lanes_p[1] += 40.0
    lanes_q = torch.as_tensor(rng.uniform(-10, 10, (3, 500, 3)), dtype=torch.float32, device=dev)
    cases["3 lanes of different clouds"] = (lanes_q, lanes_p)
    cases["subnormal products"] = (_subnormal_cloud(rng, 600, dev), _subnormal_cloud(rng, 1500, dev))

    max_abs_err = 0.0
    for name, (q, p) in cases.items():
        splits = k_expand.target_splits(q, p)
        if name.startswith("ties") and splits < 3:
            raise AssertionError(f"expansion kernel {name}: targets in {splits} ranges; the case needs 3 or more")
        out = k_expand.nn_expand_cuda(q, p)
        max_abs_err = max(max_abs_err, _check_same(name, out, _nn_expand_torch(q, p)))
        n_base = p.shape[-2] // 3
        if name.startswith("ties") and not bool((out[0] < n_base).all()):
            raise AssertionError(f"expansion kernel {name}: a tie did not go to the smallest index")
        if name.startswith("NaN query rows"):
            for row in (17, 200):
                if int(out[0][row]) != 0 or float(out[1][row]) != float("inf"):
                    raise AssertionError(f"expansion kernel: NaN query row {row} gave {out[0][row]}, {out[1][row]}")
        if name.startswith("3 lanes"):
            for b in range(3):
                _check_same(f"{name}, lane {b} alone", k_expand.nn_expand_cuda(q[b], p[b]),
                            tuple(o[b] for o in out))
        print(f"expansion kernel {name}: {tuple(q.shape)} x {tuple(p.shape)}, targets in {splits} "
              f"range(s): idx equal, d2 bit-equal")

    timing = {}
    for name, reps, plain_reps in ((next(iter(cases)), 3, 1), ("one fachada lane", 20, 5)):
        q, p = cases[name]
        k_expand.nn_expand_cuda(q, p)
        _library_nn(q, p)
        torch.cuda.synchronize()
        t = _alternate(lambda: _nn_expand_torch(q, p), lambda: k_expand.nn_expand_cuda(q, p),
                       lambda: _library_nn(q, p), reps, plain_reps)
        print(
            f"expansion time, {name} (CUDA events, means of {plain_reps}/{reps}, order plain, library, "
            f"kernel, kernel, library, plain): kernel {t['kernel']} ms, plain {t['plain']} ms, "
            f"library (cdist + min, one call a lane) {t['library']} ms"
        )
        timing[name] = {k: sum(v) / len(v) for k, v in t.items()}
    lanes = srcs.shape[0]
    fleet_bound = _nn_bound(lanes, srcs.shape[1], tgts.shape[1])
    lane_bound = _nn_bound(1, cloud.shape[0], cloud.shape[0])
    print(f"expansion bound: fleet {fleet_bound[0]:.4f} ms, one lane {lane_bound[0]:.4f} ms (by {fleet_bound[1]})")
    return max_abs_err, timing[next(iter(cases))], fleet_bound


def run_fleet(srcs, tgts, x_true):
    """The fleet path, as a user calls it: icp_batched with config=None,
    x0s=None, no gate and TrivialLoss. Every lane must recover its transform
    with K6 launched once per pass of the batched loop."""
    k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp_batched(srcs, tgts, loss=TrivialLoss())
    x = res.x.cpu()
    wall_s = time.perf_counter() - t0
    launches = k_expand.LAUNCHES
    tr = res.trace
    passes = int(torch.isfinite(tr["cost"]).any(0).sum())
    # trials run in each pass: the most any lane ran (a trial writes its λ)
    per_pass = torch.isfinite(tr["inner"]["lam"]).sum(-1).amax(0)
    trials = int(per_pass.sum())
    # a lane writes its record in every pass it is still running
    lane_passes = int(torch.isfinite(tr["cost"]).sum())
    status = res.status.cpu()
    err = (x.double() - x_true).abs().amax(1)
    names = {Status(int(v)).name: int((status == v).sum()) for v in status.unique()}
    print(
        f"fleet B={srcs.shape[0]} x {srcs.shape[1]} points float32: wall {wall_s:.4f} s, "
        f"{srcs.shape[0] / wall_s:.2f} alignments/s, {wall_s / srcs.shape[0] * 1e3:.3f} ms a lane; "
        f"passes {passes}, trials {trials} {per_pass[:passes].tolist()}, host reads {passes + trials}; "
        f"lane iterations min {int(res.iterations.min())} mean {float(res.iterations.double().mean()):.2f} "
        f"max {int(res.iterations.max())}; running lane-passes {lane_passes} of {passes * srcs.shape[0]} "
        f"searched; statuses {names}; max|x - x_true| over lanes {float(err.max()):.3e} (lane {int(err.argmax())})"
    )
    print(f"expansion kernel launches on the fleet path: {launches} for {passes} passes")
    if (status == Status.NUMERIC_ERROR).any() or not torch.isfinite(x).all():
        raise AssertionError(f"fleet: statuses {names}")
    if float(err.max()) > X_TOL:
        raise AssertionError(f"fleet: lane {int(err.argmax())} off by {float(err.max())} > {X_TOL}")
    if launches != passes or launches == 0:
        raise AssertionError(f"the fleet path launched the expansion kernel {launches} times for {passes} passes")
    if k_nn.LAUNCHES or k_schur.LAUNCHES:
        raise AssertionError("the fleet path launched the nn or schur kernel")
    return res, wall_s, launches


def fleet_vs_single(cloud, tgts, fleet, fleet_wall_s):
    """Lanes of the fleet repeated as single icp(..., "pallas_mxu") solves:
    healthy, x within FLEET_X_TOL of the lane; K6 at B = 1."""
    for b in FLEET_SINGLES:
        k_expand.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp(cloud, tgts[b], loss=TrivialLoss(), nn_backend="pallas_mxu")
        x = res.x.cpu()
        wall_s = time.perf_counter() - t0
        dx = float((x - fleet.x[b].cpu()).abs().max())
        st, st_lane = Status(int(res.status)), Status(int(fleet.status[b]))
        print(
            f"lane {b} as a single solve: wall {wall_s:.4f} s (fleet {fleet_wall_s / tgts.shape[0]:.4f} s "
            f"a lane), max|x - x_lane| {dx:.3e}, status {st.name} (lane {st_lane.name}), iterations "
            f"{int(res.iterations)} (lane {int(fleet.iterations[b])}), K6 launches {k_expand.LAUNCHES}"
        )
        if Status.NUMERIC_ERROR in (st, st_lane) or not dx <= FLEET_X_TOL:
            raise AssertionError(f"lane {b}: single solve differs from the fleet by {dx}, {st.name}")
        if k_expand.LAUNCHES == 0:
            raise AssertionError(f"lane {b}: the single pallas_mxu solve did not launch K6")


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
    S_BOUND per case, and two builds of each equal bit for bit; the plan's
    build time and bytes at the headline shape (the layout the solve
    caches); timed at the headline shape."""
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
    # the plan of the headline layout, as the solve builds it: once, cold
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head_plan = grouped.schur_plan(BA_C)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair_plan([(v.cam_ids, v.mask) for _, v in grouped.views], BA_C)
    torch.cuda.synchronize()
    plan_again_s = time.perf_counter() - t0
    print(f"schur plan at the headline shape: built in {plan_s * 1e3:.2f} ms (again {plan_again_s * 1e3:.2f} ms), "
          f"{head_plan.nbytes / 1e6:.3f} MB: {head_plan.pairs.shape[0]} entries in "
          f"{head_plan.block_cam.shape[0]} camera-pair blocks")

    max_abs_err = 0.0
    for name, (segs, C) in cases.items():
        plan, G = pair_plan([(cam, mask) for _, cam, mask in segs], C), _flat_g(segs)
        S_k = k_schur.schur_corr_cuda(plan, G)
        S_again = k_schur.schur_corr_cuda(plan, G)
        S_p = _schur_corr_torch(segs, C)
        S_pairs = _schur_corr_pairs_torch(plan, G)
        torch.cuda.synchronize()
        err = float((S_k - S_p).abs().max())
        scale = float(S_p.abs().max())
        rel = err / scale
        rel_pairs = float((S_k - S_pairs).abs().max()) / scale
        same = torch.equal(S_k.view(torch.int32), S_again.view(torch.int32))
        print(f"schur kernel {name}: max|dS| {err:.4e}, max|S| {scale:.4e}, ratio {rel:.3e} (bound {S_BOUND:g}); "
              f"against the plain gather over the plan {rel_pairs:.3e}; two builds bit-equal: {same}")
        if not torch.isfinite(S_k).all() or not rel <= S_BOUND or not rel_pairs <= S_BOUND:
            raise AssertionError(f"schur kernel {name}: max|dS|/max|S| = {rel}, {rel_pairs} > {S_BOUND}")
        if not same:
            raise AssertionError(f"schur kernel {name}: two builds of S_corr differ")
        max_abs_err = max(max_abs_err, err)

    segs, C = next(iter(cases.values()))
    plan, G = head_plan, _flat_g(segs)
    k_schur.schur_corr_cuda(plan, G)
    A2 = _dense_panel(segs, C)
    S_lib = A2.T @ A2
    S_p = _schur_corr_torch(segs, C)
    torch.cuda.synchronize()
    lib_rel = float((S_lib - S_p).abs().max()) / float(S_p.abs().max())
    kernel_reps, plain_reps = 20, 2  # the plain build is 432 GFLOP of float32 matmul
    t = _alternate(lambda: _schur_corr_torch(segs, C), lambda: k_schur.schur_corr_cuda(plan, G),
                   lambda: A2.T @ A2, kernel_reps, plain_reps)
    print(
        f"schur time per S build at the headline shape (one launch; CUDA events, order plain, library, "
        f"kernel, kernel, library, plain; means of {plain_reps}/{kernel_reps}): kernel {t['kernel']} ms, "
        f"plain {t['plain']} ms, library (A2ᵀA2 over the dense {tuple(A2.shape)} panel, {lib_rel:.2e} of "
        f"max|S| from the plain S) {t['library']} ms"
    )
    # the bound of the function, whatever its plan: the ordered pairs of
    # real slots with cam_k ≤ cam_k′ (the other half is their transpose),
    # 2·3 flops for each of 36 products; G, the camera ids and the masks
    # read once, S_corr written once
    entries = plan.pairs.shape[0]
    n_bytes = 4 * (6 * C) ** 2 + sum(t.numel() * t.element_size() for seg in segs for t in seg)
    bound = _bound(216 * entries, n_bytes)
    print(f"schur bound: {entries} plan entries, {216 * entries / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB: "
          f"{bound[0]:.4f} ms by {bound[1]}")
    del A2, S_lib
    return max_abs_err, {k: sum(v) / len(v) for k, v in t.items()}, bound


def _flat_g(segs):
    """The G of (G, cam_ids, mask) segments in one flat (n_slots, 6, 3)
    buffer, the kernel's layout."""
    return torch.cat([G.reshape(-1, 6, 3) for G, _, _ in segs])


def _dense_panel(segments, C):
    """The dense (3L, 6C) camera-incidence panel A2 that the TPU kernel
    streams: A2[3l + m, i·C + c] = Σ_k G[l,k,i,m]·mask[l,k]·[cam[l,k] = c]."""
    rows = []
    for G, cam_ids, mask in segments:
        n, K = cam_ids.shape
        if n * K == 0:
            continue
        real = (mask != 0) & (cam_ids >= 0) & (cam_ids < C)
        q = torch.arange(n, device=G.device)[:, None, None, None]
        i = torch.arange(6, device=G.device)[None, None, :, None]
        m = torch.arange(3, device=G.device)[None, None, None, :]
        cam = torch.where(real, cam_ids, 0).to(torch.int64)[:, :, None, None]
        idx = ((q * 3 + m) * 6 + i) * C + cam
        vals = torch.where(real[..., None, None], G * mask[..., None, None], 0.0)
        A2 = torch.zeros(n * 18 * C, dtype=G.dtype, device=G.device)
        A2.index_add_(0, idx.reshape(-1), vals.reshape(-1))
        rows.append(A2.reshape(n * 3, 6 * C))
    return torch.cat(rows)


def run_ba(prob):
    """The dense-BA main path: one solve_ba_dense call, as a user makes it
    (host grouping and the S build's plan included); K11 must launch once
    per trial, one S build for all segments."""
    k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(), schur_backend="auto")
    cost = float(res.cost)
    wall_s = time.perf_counter() - t0
    launches = k_schur.LAUNCHES
    if k_nn.LAUNCHES or k_expand.LAUNCHES:
        raise AssertionError("the BA path launched an nn kernel")

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
    print(f"schur kernel launches on the BA path: {launches} for {sum(trials)} trials (S builds)")
    if status == Status.NUMERIC_ERROR or not np.isfinite(cost):
        raise AssertionError(f"dense BA: status {status.name}, cost {cost}")
    if not torch.equal(res.camera_params[:2], prob.camera_params[:2]):
        raise AssertionError("dense BA: a fixed camera moved")
    if any(b > a for a, b in zip(costs, costs[1:])):
        raise AssertionError(f"dense BA: the accepted cost rose: {costs}")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"dense BA: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if launches != sum(trials) or launches == 0:
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
    kernels = (k_nn, k_expand, k_schur)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        futures = [pool.submit(build.build, k.NAME, k.SOURCES) for k in kernels]
        built = [f.result() for f in futures]
    print(f"build (one nvcc per source, in parallel): {time.perf_counter() - t0:.3f} s")
    for path, log in built:
        print(f"  -> {path.relative_to(ROOT)}")
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line):
                print(f"  {line.strip()}")

    rng = np.random.default_rng(SEED)
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    max_abs_err, nn_t, nn_bound = check_nn_kernel(cloud, rng)
    srcs, tgts, fleet_x = _fleet_inputs(cloud, np.random.default_rng(SEED + 2))
    e_err, e_t, e_bound = check_expand_kernel(cloud, srcs, tgts, rng)
    ba_prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    ba_grouped = ba_dense.group_by_landmark(ba_prob, segments="auto")
    s_err, s_t, s_bound = check_schur_kernel(ba_prob, ba_grouped, dev, rng)

    requests = [
        ("A", X_A, {}),
        ("B", X_B, {}),
        ("A-gated", X_A, dict(loss=GemanMcClure(tau=1.0), max_corr_dist=1.0)),
    ]
    k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
    results, outer_total = {}, 0
    for name, x_true, kw in requests:
        results[name], outer = run_request(name, cloud, x_true, np.random.default_rng(SEED + 1), **kw)
        outer_total += outer
    launches = k_nn.LAUNCHES
    print(f"nn kernel launches on the ICP path: {launches} for {outer_total} outer iterations")
    if launches < outer_total or launches == 0:
        raise AssertionError(f"the ICP path launched the nn kernel {launches} times")
    if k_schur.LAUNCHES or k_expand.LAUNCHES:
        raise AssertionError("the ICP path launched the schur or expansion kernel")

    plain, _ = run_request("A", cloud, X_A, np.random.default_rng(SEED + 1), nn_backend="torch")
    if int(plain.iterations) != int(results["A"].iterations):
        raise AssertionError("plain search: iterations differ from the kernel's run")
    dx = float((plain.x - results["A"].x).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"plain search: x differs from the kernel's run by {dx}")
    print(f"request A with the plain search: same iterations, max|dx| {dx:.3e}")

    ba_res, s_launches = run_ba(ba_prob)
    ba_steps(ba_prob, ba_grouped, "auto")
    plain_costs = ba_steps(ba_prob, ba_grouped, "torch")
    kernel_costs = list(zip(ba_res.trace["cost"][:3].tolist(), ba_res.trace["cost_new"][:3].tolist()))
    worst = max(abs(p - k) / abs(k) for pk, kk in zip(plain_costs, kernel_costs) for p, k in zip(pk, kk))
    print(f"plain-S repeat of the first 3 outer iterations: max relative cost difference {worst:.3e} "
          f"(bound {BA_COST_RTOL:g})")
    if not worst <= BA_COST_RTOL:
        raise AssertionError(f"plain-S repeat: costs differ by {worst} > {BA_COST_RTOL}")

    fleet, fleet_wall_s, e_launches = run_fleet(srcs, tgts, fleet_x)
    fleet_vs_single(cloud, tgts, fleet, fleet_wall_s)

    def entry(name, source, replaces, n_launches, err, t, bound):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=n_launches,
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound[0],
            bound_by=bound[1], library_ms=t["library"],
        )

    kernels = [
        entry("nn_bruteforce", "moptimizer_0_tpu_torch/csrc/nn_search.cu",
              "moptimizer_0_tpu/ops/nn_search.py:136", launches, max_abs_err, nn_t, nn_bound),
        entry("nn_expand", "moptimizer_0_tpu_torch/csrc/nn_expand.cu",
              "moptimizer_0_tpu/ops/nn_search.py:43", e_launches, e_err, e_t, e_bound),
        entry("schur_pairs", "moptimizer_0_tpu_torch/csrc/schur.cu",
              "benchmarks/schur_pallas_ab.py:38", s_launches, s_err, s_t, s_bound),
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
