"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. the card: name and power limit from nvidia-smi;
2. build: every kernel compiled from ``moptimizer_0_tpu_torch/csrc``, one
   nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, at the shapes
   of the main paths and at ragged, tied, NaN, overflowing, subnormal,
   split and segmented shapes (K11 also against itself: two builds bit for
   bit); timed with CUDA events in the order plain, library, kernel,
   kernel, library, plain;
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
   ``icp(..., nn_backend="pallas_mxu")`` solves and must agree to 1e-5;
7. the hash grid (``ops/grid_nn.py``, plain PyTorch) on one 32,768-point
   scan of the SLAM sequence and on the fachada scan at a 0.5 m cell: the
   host, device and fixed-capacity builds give equal tables (the fixed one
   flags overflow with K cut by 16), the cell-major and query-major queries
   and the default mode (query-major on the card) agree bit for bit, and
   the gated grid equals K5 wherever K5's d² is
   under the cell² and gives (−1, +inf) elsewhere; both queries, K5 and
   each build timed;
8. the SLAM front end: the JAX package's bench sequence
   (``benchmarks/slam_sequence_bench.py``: 64 scans × 32,768 points, seed
   42, float32) through ``scan_odometry`` with the bench's
   ``PairwiseRegistrar`` settings and a 0.5 m gate, (a) searching the grid
   (``nn_backend="grid"``, the bench's own) and (b) with
   ``nn_backend="auto"``, which routes every pair to K5; both must end with
   ATE < 0.05 m, K6 launched on the first pair (its 8-start coarse seed), K5
   never in (a) and once per LM outer iteration in (b), no NUMERIC_ERROR,
   and relative poses that agree to 1e-6;
9. the SLAM pipeline on the same sequence through ``scan_slam`` with
   ``nn_backend="auto"`` (K5), loop closures (0, 63) and (0, 62) and
   information 1/σ², for ``method="icp"``, ``"point2plane"`` and ``"gicp"``:
   the front end's, the closures' and the PGO's walls, frames/s as the
   bench computes it, ATE < 0.05 m for the odometry and < 0.01 m after PGO
   (and below the odometry's for icp and point2plane), no NUMERIC_ERROR, K5
   once per outer iteration and K6 on the first pair; the ICP graph's PGO is
   solved again (bit-equal) and by CG (within 1e-4 of the dense poses);
10. K9 (``gicp_covariances``, ``estimate_normals``) at 32,768 points and the
    host reads of one GICP pair;
11. ``scan_slam_fixed_lag`` (window 8, icp) on the first 24 scans: ATE <
    0.05 m, poses (24, 6), one marginalization a scan past the window;
12. the pose graph of ``tests/test_pose_graph.py`` rebuilt at 300 and 2,000
    poses in float32, solved by CG and by the dense Cholesky, each below its
    cost bound (``RING_BOUNDS``).

The dense-BA solve runs twice and must repeat itself bit for bit.

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

import contextlib
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
from moptimizer_0_tpu_torch import ba, ba_dense, odometry, pose_graph
from moptimizer_0_tpu_torch.core.loss import GemanMcClure, TrivialLoss
from moptimizer_0_tpu_torch.core.solver import LMConfig, Status
from moptimizer_0_tpu_torch.evaluation import ate_rmse, rpe
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.kernels import schur as k_schur
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.odometry import scan_odometry
from moptimizer_0_tpu_torch.ops import grid_nn, surface
from moptimizer_0_tpu_torch.ops.nn_search import _nn_expand_torch, _nn_torch
from moptimizer_0_tpu_torch.ops.schur import _schur_corr_pairs_torch, _schur_corr_torch, fold_linv, pair_plan
from moptimizer_0_tpu_torch.registration import PairwiseRegistrar, _coarse_subsample, _yaw_starts, icp, icp_batched
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

# The SLAM sequence of the JAX package's bench (slam_sequence_bench.py:34-109):
# 64 scans of a 32,768-point courtyard world, seed 42, 1 cm sensor noise,
# the bench's LM settings and a 0.5 m gate.
SLAM_K, SLAM_N, SLAM_SEED = 64, 32_768, 42
SENSOR_NOISE = 0.01
SLAM_GATE = 0.5
SLAM_CONFIG = LMConfig(diff_mode="auto", max_iterations=40, linear_solver="cholesky", rel_cost_tol=1e-6)
SLAM_ATE_BOUND = 0.05  # the odometry bound of tests/test_slam_sequence.py
# (a) and (b) make the same correspondence decisions (a gate equal to the
# cell) and the masked rows add exact zeros, so their poses should be equal;
# they are held to 1e-6.
SLAM_REL_TOL = 1e-6
GRID_CELL = 0.5
# The back end on the same sequence: the bench's two loop closures, the SLAM
# bound of tests/test_slam_sequence.py, and the fixed-lag run of
# tests/test_pgo_marginalization.py (its first 24 scans, window 8; the JAX
# test's window is 6, the function's default 8).
SLAM_LOOPS = ((0, SLAM_K - 1), (0, SLAM_K - 2))
SLAM_ATE_SLAM_BOUND = 0.01
# Every edge's information is 1/σ² of the 1 cm sensor noise. With the
# default unit information the loop closures' residuals (~3e-4 m) make a
# start cost below 8ε of float32 (9.5e-7), where the solver's absolute test
# stops at 0 iterations (CONVERGED): the SLAM poses would be the odometry's.
# The unit-information solve of the ICP graph is shown once, beside.
SLAM_INFORMATION = 1.0 / SENSOR_NOISE**2
# The methods whose SLAM ATE must also lie below their odometry's (the
# contract of tests/test_slam_sequence.py for ICP). GICP's loop closures on
# this sequence measure the rotation 2–3× worse than its odometry
# accumulates over their span (5e-5 against 2e-5 rad on an H100, printed per
# closure), though the translation twice better; one information for all
# six components carries that rotation into the trajectory over the 8 m
# lever arm, and its SLAM ATE ends above the odometry's. GICP is held to
# SLAM_ATE_SLAM_BOUND only.
SLAM_BEATS_ODOMETRY = ("icp", "point2plane")
FIXED_LAG_SCANS, FIXED_LAG_WINDOW = 24, 8
# PGO on tests/test_pose_graph.py's ring graph (drift 0.005, seed 10, as its
# slow CG test), float32, solved by CG (400 CG iterations a step, 40 outer
# iterations, as that test) and by the dense Cholesky of the 6N × 6N H:
# * at that test's 300 poses each must end below its bound, 1e-3 × the start
#   cost;
# * at 2,000 poses, a graph size users solve, the drift accumulates to
#   ~0.22 rad, and from that start LM descends slowly whatever the linear
#   solver: on an H100 dense and CG both end their 40 iterations at 2.2e-2
#   of the start, at the same cost. Each must end below 5e-2 × the start.
RING_DRIFT, RING_SEED = 0.005, 10
RING_BOUNDS = {300: 1e-3, 2000: 5e-2}
RING_CONFIGS = dict(
    cg=pose_graph.PGOConfig(max_iterations=40, solver="cg", cg_iterations=400),
    dense=pose_graph.PGOConfig(max_iterations=40),
)
# CG against dense on the 64-pose SLAM graph: the same optimum, to 1e-4.
PGO_CG_GAP = 1e-4
X_SMALL =[0.05, -0.03, 0.02, 0.01, -0.005, 0.01]  # the fachada grid query's transform

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


def _nn_cases(rng, dev):
    """The small cases both NN kernels are held to: ragged shapes; every
    target three times, where the first copy must win across every cut
    (2,100 targets fall into ranges of 263 that cut the copies anywhere, 768
    into 3 ranges of 256 cut exactly at the copies); NaN query rows 17 and
    200, a whole row and one coordinate."""
    cases = {}
    for n_query, n_points in ((33, 77), (1000, 4097)):
        q = torch.as_tensor(rng.uniform(-10, 10, (n_query, 3)), dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.uniform(-10, 10, (n_points, 3)), dtype=torch.float32, device=dev)
        cases[f"{n_query}x{n_points}"] = (q, p)
    base = torch.as_tensor(rng.uniform(-10, 10, (700, 3)), dtype=torch.float32, device=dev)
    cases["ties"] = (base[::3].contiguous(), torch.cat([base, base, base]))
    base_256 = base[:256]
    cases["ties, ranges cut at the copies"] = (base_256[::3].contiguous(), torch.cat([base_256] * 3))
    q_nan = torch.as_tensor(rng.uniform(-10, 10, (300, 3)), dtype=torch.float32, device=dev)
    q_nan[17] = torch.nan
    q_nan[200, 1] = torch.nan
    cases["NaN query rows"] = (q_nan, base)
    return cases


def check_nn_kernel(cloud, rng):
    """nn_cuda against _nn_torch: equal indices and bit-equal d² at the
    fachada shape, at the cases of ``_nn_cases`` and at NaN target rows,
    overflowing rows and subnormal differences, each with its targets in the
    ranges ``target_splits`` gives it. Timed at the fachada shape."""
    dev = cloud.device
    cases = {"fachada": (_transformed(cloud, X_A, rng), cloud), **_nn_cases(rng, dev)}
    q_nan, base = cases["NaN query rows"]
    p_nan = base.clone()
    p_nan[5] = torch.nan
    p_nan[400, 2] = torch.nan
    cases["NaN target rows"] = (torch.cat([p_nan[[4, 6, 399, 401]], q_nan[:200]]), p_nan)
    q_big, p_big = q_nan[:200].clone(), base.clone()
    q_big[17] = 1e20  # every d² of these rows overflows to +inf
    q_big[150, 0] = 3e19
    p_big[5] = -1e20
    p_big[400, 2] = -2e20
    cases["overflow rows"] = (q_big, p_big)
    tiny = _subnormal_cloud(rng, 2000, dev)
    tiny[1::5] *= 1e-19  # subnormal coordinates and differences
    cases["subnormal differences"] = (tiny[:600].contiguous(), tiny[500:].contiguous())

    max_abs_err = 0.0
    for name, (q, p) in cases.items():
        splits = k_nn.target_splits(q, p)
        if name.startswith("ties") and splits < 3:
            raise AssertionError(f"nn kernel {name}: targets in {splits} ranges; the case needs 3 or more")
        out = k_nn.nn_cuda(q, p)
        max_abs_err = max(max_abs_err, _check_same(f"nn kernel {name}", out, _nn_torch(q, p)))
        idx_k, d2_k = out
        if name.startswith("ties") and not bool((idx_k < p.shape[0] // 3).all()):
            raise AssertionError(f"nn kernel {name}: a tie did not go to the smallest index")
        rows = {"NaN query rows": (17, 200), "overflow rows": (17, 150)}.get(name, ())
        for row in rows:
            if int(idx_k[row]) != 0 or float(d2_k[row]) != float("inf"):
                raise AssertionError(f"nn kernel {name}: row {row} gave {idx_k[row]}, {d2_k[row]}")
        if name in ("NaN target rows", "overflow rows") and bool(((idx_k == 5) | (idx_k == 400)).any()):
            raise AssertionError(f"nn kernel {name}: a NaN or overflowing target was chosen")
        print(f"nn kernel {name}: {q.shape[0]}x{p.shape[0]}, targets in {splits} range(s): "
              f"idx equal, d2 bit-equal")

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
    return max_abs_err, timing, _nn_bound(1, q.shape[0], p.shape[0]), k_nn.target_splits(q, p)


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


def _check_same(what, kernel_out, plain_out):
    """Equal indices and bit-equal d²; the largest |Δd²| over finite d²."""
    idx_k, d2_k = kernel_out
    idx_p, d2_p = plain_out
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p):
        bad = int((idx_k != idx_p).sum())
        raise AssertionError(f"{what}: {bad} indices differ from the plain version")
    if not torch.equal(d2_k.view(torch.int32), d2_p.view(torch.int32)):
        raise AssertionError(f"{what}: d² not bit-equal to the plain version")
    finite = torch.isfinite(d2_k)
    return float((d2_k[finite] - d2_p[finite]).abs().max()) if finite.any() else 0.0


def _subnormal_cloud(rng, n, dev):
    """Coordinates near 1e-20, whose products lie below float32's normal
    range; every third point has one ordinary coordinate."""
    a = rng.uniform(-1, 1, (n, 3)) * 1e-20
    a[::3, 0] = rng.uniform(-1, 1, len(a[::3]))
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _coarse_seed_search(scans, dev):
    """The SLAM path's first K6 call: the coarse subsamples of scans 1 and
    0, the source warped by each yaw start of the registrar's multistart,
    against the target copied into every lane, as ``_icp_fleet_block``
    searches them."""
    src_c = _coarse_subsample(scans[1].to(dev))
    tgt_c = _coarse_subsample(scans[0].to(dev))
    B = PairwiseRegistrar(max_corr_dist=SLAM_GATE).coarse_multistart
    T = se3.transform_from_params6(_yaw_starts(src_c, tgt_c, B))
    warped = src_c @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    return warped.contiguous(), tgt_c.expand(B, *tgt_c.shape).contiguous()


def check_expand_kernel(cloud, srcs, tgts, coarse, rng):
    """nn_expand_cuda against _nn_expand_torch: equal indices and bit-equal
    d² at the fleet shape, at the SLAM coarse seed's shape (``coarse``: 8
    yaw starts against one shared target) and at one-lane, ragged, tied,
    NaN, 3-lane and subnormal cases; every case but the fleet has its
    targets split, and the tie cases have tied targets on both sides of a
    range's end. Timed at the fleet shape and at one lane."""
    dev = cloud.device
    cases = {
        f"fleet {FLEET_B}x{cloud.shape[0]}x{cloud.shape[0]}": (srcs, tgts),
        "SLAM coarse seed, {} yaw starts x {} x {}".format(*coarse[0].shape[:2], coarse[1].shape[1]): coarse,
        "one fachada lane": (_transformed(cloud, X_A, rng), cloud),
        **_nn_cases(rng, dev),
    }
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
        max_abs_err = max(max_abs_err, _check_same(f"expansion kernel {name}", out, _nn_expand_torch(q, p)))
        n_base = p.shape[-2] // 3
        if name.startswith("ties") and not bool((out[0] < n_base).all()):
            raise AssertionError(f"expansion kernel {name}: a tie did not go to the smallest index")
        if name.startswith("NaN query rows"):
            for row in (17, 200):
                if int(out[0][row]) != 0 or float(out[1][row]) != float("inf"):
                    raise AssertionError(f"expansion kernel: NaN query row {row} gave {out[0][row]}, {out[1][row]}")
        if name.startswith("3 lanes"):
            for b in range(3):
                _check_same(f"expansion kernel {name}, lane {b} alone", k_expand.nn_expand_cuda(q[b], p[b]),
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


def _solve_ba(prob):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(), schur_backend="auto")
    cost = float(res.cost)
    return res, cost, time.perf_counter() - t0


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def ba_repeat(prob, first, first_wall_s):
    """The solve again: the same trials, and costs, cameras and points equal
    bit for bit (the camera reductions and K11 sum in one fixed order)."""
    res, cost, wall_s = _solve_ba(prob)
    same = (
        res.trace["trials"].tolist() == first.trace["trials"].tolist()
        and torch.equal(_bits(res.trace["cost"]), _bits(first.trace["cost"]))
        and torch.equal(_bits(res.camera_params), _bits(first.camera_params))
        and torch.equal(_bits(res.points), _bits(first.points))
        and cost == float(first.cost)
    )
    print(f"dense BA solved twice: walls {first_wall_s:.4f}, {wall_s:.4f} s; trials {sum(res.trace['trials'].tolist())} "
          f"and {sum(first.trace['trials'].tolist())}; trials, cost trace, cameras and points bit-equal: {same}")
    if not same:
        raise AssertionError("dense BA: a second solve of the same instance differs from the first")


def run_ba(prob):
    """The dense-BA main path: one solve_ba_dense call, as a user makes it
    (host grouping and the S build's plan included); K11 must launch once
    per trial, one S build for all segments."""
    k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
    res, cost, wall_s = _solve_ba(prob)
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
    return res, launches, wall_s


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


def make_world(rng, n):
    """The courtyard world of benchmarks/slam_sequence_bench.py (4 walls and
    the ground, 32 m across) at n points, in the same rng call order."""
    per = n // 5
    s = 16.0
    u = rng.uniform(-s, s, size=(4, per))
    v = rng.uniform(0.0, 6.0, size=(4, per))
    walls = [
        np.column_stack([u[0], np.full(per, -s), v[0]]),
        np.column_stack([u[1], np.full(per, s), v[1]]),
        np.column_stack([np.full(per, -s), u[2], v[2]]),
        np.column_stack([np.full(per, s), u[3], v[3]]),
    ]
    g = rng.uniform(-s, s, size=(n - 4 * per, 2))
    ground = np.column_stack([g, np.zeros(len(g))])
    world = np.vstack(walls + [ground])
    world += 0.005 * rng.normal(size=world.shape)
    return world


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def make_sequence(k_scans, n_points, seed=SLAM_SEED, dtype=torch.float32):
    """benchmarks/slam_sequence_bench.make_sequence in numpy and the port's
    lie, in the same rng call order: k scans of the world seen from poses on
    a circle of 8 m, each with sensor noise, as (n, 3) CPU tensors of dtype,
    and the ground-truth poses (k, 6) in the frame of scan 0."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, n_points)
    poses = []
    for k in range(k_scans):
        th = 2 * np.pi * k / k_scans
        t = np.array([8.0 * np.cos(th), 8.0 * np.sin(th), 1.5])
        w = so3.log(torch.as_tensor(_yaw(th + np.pi / 2)))
        poses.append(np.concatenate([t, w.numpy()]))
    Ts = [se3.transform_from_params6(torch.as_tensor(p, dtype=dtype)).numpy() for p in poses]
    scans = []
    for T in Ts:
        Tinv = np.linalg.inv(T)
        local = world @ Tinv[:3, :3].T + Tinv[:3, 3]
        local = local + SENSOR_NOISE * rng.normal(size=local.shape)
        scans.append(torch.as_tensor(local, dtype=dtype))
    T0inv = np.linalg.inv(Ts[0])
    gt = []
    for T in Ts:
        Tr = T0inv @ T
        w = so3.log(torch.as_tensor(Tr[:3, :3], dtype=dtype))
        gt.append(np.concatenate([Tr[:3, 3], w.numpy()]))
    return scans, torch.as_tensor(np.stack(gt), dtype=dtype)


def _launches_of(fn):
    """cudaLaunchKernel calls of one fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name == "cudaLaunchKernel" for e in prof.events())


def _same_tables(a, b):
    """'slot for slot', 'as sets per slot' or '' (different)."""
    if torch.equal(a.table_idx, b.table_idx) and torch.equal(a.table_pts, b.table_pts):
        return "slot for slot"
    if a.table_idx.shape == b.table_idx.shape and torch.equal(
        torch.sort(a.table_idx, dim=1).values, torch.sort(b.table_idx, dim=1).values
    ):
        return "as sets per slot"
    return ""


def check_grid(cloud, scans, gt, rng):
    """The hash grid on the card at a 0.5 m cell, on scan 1 of the sequence
    moved into scan 0's frame by its true pose (against scan 0) and on the
    fachada scan under a small transform (against itself): the builds, both
    query modes, the gated grid against K5, and their times."""
    dev = cloud.device
    cases = {
        f"sequence scan 1 onto scan 0, {SLAM_N} points": (
            se3.apply_transform(se3.transform_from_params6(gt[1].to(dev)), scans[1].to(dev)).contiguous(),
            scans[0].to(dev),
        ),
        f"fachada, {cloud.shape[0]} points": (_transformed(cloud, X_SMALL, rng), cloud),
    }
    timing = {}
    for name, (q, p) in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = grid_nn.build_hash_grid(p, GRID_CELL)
        torch.cuda.synchronize()
        host_build_ms = (time.perf_counter() - t0) * 1e3
        dev_g = grid_nn.build_hash_grid_device(p, GRID_CELL)
        fixed, overflow = grid_nn.build_hash_grid_fixed(p, GRID_CELL, host.n_slots, host.bucket_size,
                                                        host.max_cell_occupancy)
        _, overflow_cut = grid_nn.build_hash_grid_fixed(p, GRID_CELL, host.n_slots, host.bucket_size - 16)
        same_dev, same_fixed = _same_tables(host, dev_g), _same_tables(host, fixed)
        print(f"grid {name}: S={host.n_slots} K={host.bucket_size} cell occupancy {host.max_cell_occupancy}; "
              f"device build equal to the host build {same_dev or 'NO'}; fixed build {same_fixed or 'NO'}, "
              f"overflow {bool(overflow)}; with K-16 overflow {bool(overflow_cut)}")
        if not same_dev or not same_fixed or bool(overflow) or not bool(overflow_cut):
            raise AssertionError(f"grid {name}: the builds disagree or the overflow flag is wrong")

        reads, falls = grid_nn.HOST_READS, grid_nn.FALLBACKS
        ci, cd = grid_nn.grid_nearest_neighbors(q, host, mode="cell")
        reads_per_query = grid_nn.HOST_READS - reads
        if grid_nn.FALLBACKS != falls:
            raise AssertionError(f"grid {name}: the cell-major query fell back to the query-major path")
        qi, qd = grid_nn.grid_nearest_neighbors(q, host, mode="query")
        _check_same(f"grid {name}: cell-major against query-major", (ci, cd), (qi, qd))
        reads = grid_nn.HOST_READS
        _check_same(f"grid {name}: the default mode against query-major", grid_nn.grid_nearest_neighbors(q, host),
                    (qi, qd))
        if grid_nn.HOST_READS != reads:
            raise AssertionError(f"grid {name}: the default mode on the card took the cell-major path")
        ki, kd = k_nn.nn_cuda(q, p)
        r = torch.full((), GRID_CELL, dtype=torch.float32, device=dev)
        inside = kd < r * r
        _check_same(f"grid {name}: gated grid against K5 inside the cell", (ci[inside], cd[inside]),
                    (ki[inside], kd[inside]))
        if not bool((ci[~inside] == -1).all()) or not bool(torch.isinf(cd[~inside]).all()):
            raise AssertionError(f"grid {name}: a query beyond the cell did not give (-1, +inf)")

        reps = 10
        t = dict(cell=[], query=[], k5=[])
        fns = dict(cell=lambda: grid_nn.grid_nearest_neighbors(q, host, mode="cell"),
                   query=lambda: grid_nn.grid_nearest_neighbors(q, host, mode="query"),
                   k5=lambda: k_nn.nn_cuda(q, p))
        for key in ("cell", "query", "k5", "k5", "query", "cell"):
            t[key].append(_time_ms(fns[key], reps))
        dev_build = _time_ms(lambda: grid_nn.build_hash_grid_device(p, GRID_CELL), 5)
        fixed_build = _time_ms(lambda: grid_nn.build_hash_grid_fixed(
            p, GRID_CELL, host.n_slots, host.bucket_size, host.max_cell_occupancy), reps)
        launches = {key: _launches_of(fns[key]) for key in fns}
        print(f"grid {name}: {int(inside.sum())} of {q.shape[0]} queries inside the cell; cell-major, "
              f"query-major and the default mode (query-major on the card) idx equal, d2 bit-equal; against K5 inside the cell idx equal, d2 bit-equal, "
              f"(-1, +inf) beyond it")
        print(f"grid {name} time (CUDA events, means of {reps}, order cell-major, query-major, K5, K5, "
              f"query-major, cell-major; a query's host read included): cell-major {t['cell']} ms, query-major "
              f"{t['query']} ms, K5 {t['k5']} ms; builds: host (numpy, upload included, host clock) "
              f"{host_build_ms:.3f} ms, device (two host reads) {dev_build:.3f} ms, fixed {fixed_build:.3f} ms; "
              f"host reads a query: cell-major {reads_per_query}, query-major 0; kernel launches a query "
              f"(torch.profiler): cell-major {launches['cell']}, query-major {launches['query']}, K5 {launches['k5']}")
        timing[name] = {k: sum(v) / len(v) for k, v in t.items()}
    return timing


class _Recorded(PairwiseRegistrar):
    """A PairwiseRegistrar that keeps, for each registration, its host wall
    time, its result and the K5 and K6 launches and grid host reads it made
    (Python counters: nothing is read from the card while it runs)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.pairs = []
        self.redos = 0

    def register(self, src, tgt_cloud, x0=None, *, defer_overflow=False):
        k5, k6, reads = k_nn.LAUNCHES, k_expand.LAUNCHES, grid_nn.HOST_READS
        t0 = time.perf_counter()
        out = super().register(src, tgt_cloud, x0, defer_overflow=defer_overflow)
        self.pairs.append(dict(
            wall=time.perf_counter() - t0, res=out[0] if defer_overflow else out, deferred=defer_overflow,
            k5=k_nn.LAUNCHES - k5, k6=k_expand.LAUNCHES - k6, grid_reads=grid_nn.HOST_READS - reads,
        ))
        return out

    def _redo_overflow(self, src, tgt_cloud, x0, covs):
        self.redos += 1
        return super()._redo_overflow(src, tgt_cloud, x0, covs)


def run_slam(scans, gt, nn_backend, dev):
    """scan_odometry over the sequence through a PairwiseRegistrar
    with the bench's settings: the front end's wall, the first pair's, the
    steady ms a pair, the LM work a pair, the launches and the trajectory's
    error. Returns (relative poses, K5 launches, K6 launches)."""
    reg = _Recorded(config=SLAM_CONFIG, nn_backend=nn_backend, max_corr_dist=SLAM_GATE)
    seq = [sc.to(dev) for sc in scans]
    k_scans = len(seq)
    k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
    grid_nn.HOST_READS = grid_nn.FALLBACKS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, rels = scan_odometry(seq, registrar=reg)
    poses = poses.cpu()
    front_s = time.perf_counter() - t0
    k5, k6, reads, falls = k_nn.LAUNCHES, k_expand.LAUNCHES, grid_nn.HOST_READS, grid_nn.FALLBACKS
    if k_schur.LAUNCHES:
        raise AssertionError("the SLAM path launched the schur kernel")

    pairs = reg.pairs
    outer = [int(torch.isfinite(pr["res"].trace["cost"]).sum()) for pr in pairs]
    trials = [int(torch.isfinite(pr["res"].trace["inner"]["cost_new"]).sum()) for pr in pairs]
    status = [Status(int(pr["res"].status)) for pr in pairs]
    first_s = pairs[0]["wall"]
    steady_s = (front_s - first_s) / (k_scans - 2)
    # one registration's own wall, without the redone ones a flag costs
    median_ms = float(np.median([p["wall"] for p in pairs[1:] if p["deferred"]])) * 1e3
    ate = float(ate_rmse(poses.double(), gt.double(), align=False))
    rpe_t, rpe_r = (float(v) for v in rpe(poses.double(), gt.double()))
    names = {st.name: status.count(st) for st in set(status)}
    print(
        f"SLAM front end, nn_backend={nn_backend!r}, {k_scans} scans x {seq[0].shape[0]} points float32: "
        f"wall {front_s:.4f} s for {k_scans - 1} pairs; first pair {first_s:.4f} s; steady "
        f"{steady_s * 1e3:.2f} ms a pair, {1 / steady_s:.2f} pairs/s (redone pairs included; a later pair's "
        f"own registration median {median_ms:.2f} ms); LM outer iterations a pair mean "
        f"{np.mean(outer):.2f} max {max(outer)}, trials {sum(trials)}; host reads: LM {sum(outer) + sum(trials)}, "
        f"grid {reads} ({falls} cell-major fallbacks); registrations {len(pairs)} ({sum(not p['deferred'] for p in pairs)} "
        f"redone), overflow rebuilds {reg.redos}; K5 launches {k5}, K6 launches {k6} (first pair {pairs[0]['k6']}); "
        f"statuses {names}; ATE {ate:.6f} m (align=False), RPE {rpe_t:.6f} m / {rpe_r:.6f} rad"
    )
    if Status.NUMERIC_ERROR in status or not torch.isfinite(poses).all():
        raise AssertionError(f"SLAM {nn_backend}: statuses {names}")
    if not ate < SLAM_ATE_BOUND:
        raise AssertionError(f"SLAM {nn_backend}: ATE {ate} >= {SLAM_ATE_BOUND}")
    if pairs[0]["k6"] == 0:
        raise AssertionError(f"SLAM {nn_backend}: the first pair's coarse multistart did not launch K6")
    if nn_backend == "grid" and k5:
        raise AssertionError(f"SLAM grid: K5 launched {k5} times")
    if nn_backend == "auto" and k5 < sum(outer):
        raise AssertionError(f"SLAM auto: K5 launched {k5} times for {sum(outer)} outer iterations")
    return rels.cpu(), k5, k6


@contextlib.contextmanager
def _slam_stages():
    """Records what the SLAM entry points do, from outside: every
    registrar odometry makes is a ``_Recorded``, and the front end
    (``scan_odometry``), the loop closures (``register_pair``), the PGO
    solves (``solve_pgo``, with their graphs) and ``marginalize_oldest`` are
    each timed between two synchronisations. Yields (walls, registrars,
    solves)."""
    walls = dict(front=[], loops=[], pgo=[], marg=[])
    regs, solves = [], []

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "pgo":
                solves.append((args[0], args[1] if len(args) > 1 else kwargs.get("config"), out))
            return out

        return wrapped

    def registrar(**kwargs):
        regs.append(_Recorded(**kwargs))
        return regs[-1]

    saved = dict(scan_odometry=odometry.scan_odometry, register_pair=odometry.register_pair,
                 PairwiseRegistrar=odometry.PairwiseRegistrar, solve_pgo=pose_graph.solve_pgo,
                 marginalize_oldest=pose_graph.marginalize_oldest)
    odometry.scan_odometry = timed("front", saved["scan_odometry"])
    odometry.register_pair = timed("loops", saved["register_pair"])
    odometry.PairwiseRegistrar = registrar
    pose_graph.solve_pgo = timed("pgo", saved["solve_pgo"])
    pose_graph.marginalize_oldest = timed("marg", saved["marginalize_oldest"])
    try:
        yield walls, regs, solves
    finally:
        for name in ("scan_odometry", "register_pair", "PairwiseRegistrar"):
            setattr(odometry, name, saved[name])
        pose_graph.solve_pgo = saved["solve_pgo"]
        pose_graph.marginalize_oldest = saved["marginalize_oldest"]


def _registrations(regs):
    """(outer iterations, trials, statuses) over every registration."""
    pairs = [p for r in regs for p in r.pairs]
    outer = [int(torch.isfinite(p["res"].trace["cost"]).sum()) for p in pairs]
    trials = [int(torch.isfinite(p["res"].trace["inner"]["cost_new"]).sum()) for p in pairs]
    return pairs, outer, trials, [Status(int(p["res"].status)) for p in pairs]


def _syncs_of(fn):
    """cudaStreamSynchronize and cudaDeviceSynchronize calls of one fn()
    under torch.profiler: the host reads it makes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in prof.events())


def run_scan_slam(scans, gt, method, dev):
    """The SLAM pipeline through its entry point, as the bench runs it:
    ``scan_slam`` over the sequence with the bench's settings, nn_backend
    "auto" (K5 at 32,768 targets), loop closures (0, K−1) and (0, K−2), the
    default PGO, and information 1/σ² (SLAM_INFORMATION). Returns (the
    PGOResult, the PGO's graph and config, a record of the run)."""
    seq = [sc.to(dev) for sc in scans]
    k_scans = len(seq)
    with _slam_stages() as (walls, regs, solves):
        k_nn.LAUNCHES = k_expand.LAUNCHES = k_schur.LAUNCHES = 0
        reads = pose_graph.HOST_READS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, poses_odo = odometry.scan_slam(seq, method=method, loop_closures=SLAM_LOOPS, config=SLAM_CONFIG,
                                               information_scale=SLAM_INFORMATION,
                                               loop_information_scale=SLAM_INFORMATION,
                                               nn_backend="auto", max_corr_dist=SLAM_GATE)
        poses = result.poses.cpu()
        wall_s = time.perf_counter() - t0
        k5, k6 = k_nn.LAUNCHES, k_expand.LAUNCHES
        pgo_reads = pose_graph.HOST_READS - reads
    if k_schur.LAUNCHES:
        raise AssertionError(f"SLAM {method}: the schur kernel launched")
    (reg,) = regs
    pairs, outer, trials, status = _registrations(regs)
    front_s, (pgo_s,) = walls["front"][0], walls["pgo"]
    loops_s = sum(walls["loops"])
    first_s = pairs[0]["wall"]
    steady_s = (front_s - first_s) / (k_scans - 2)
    fps = k_scans / ((k_scans - 1) * steady_s + loops_s + pgo_s)
    ate_odo = float(ate_rmse(poses_odo.cpu().double(), gt.double(), align=False))
    ate = float(ate_rmse(poses.double(), gt.double(), align=False))
    pgo_status = Status(int(result.status))
    names = {st.name: status.count(st) for st in set(status)}
    graph, config, _ = solves[0]
    closure_err = _closure_errors(graph, poses_odo, gt)
    print(
        f"scan_slam method={method!r}, nn_backend='auto', {k_scans} scans x {seq[0].shape[0]} points float32, "
        f"loop closures {list(SLAM_LOOPS)}: wall {wall_s:.4f} s; front end {front_s:.4f} s (first pair "
        f"{first_s:.4f} s, steady {steady_s * 1e3:.2f} ms a pair), loop closures {loops_s:.4f} s "
        f"({[f'{w:.4f}' for w in walls['loops']]}), PGO {pgo_s:.4f} s; frames/s (the bench's: K / ((K-1)·steady + "
        f"loops + PGO)) {fps:.2f}; registrations {len(pairs)} ({reg.redos} overflow rebuilds), LM outer "
        f"iterations mean {np.mean(outer):.2f} max {max(outer)}, trials {sum(trials)}, statuses {names}; PGO "
        f"{pgo_status.name}, iterations {int(result.iterations)}, host reads {pgo_reads}; K5 launches {k5}, K6 "
        f"launches {k6} (first pair {pairs[0]['k6']}); ATE odometry {ate_odo:.6f} m, SLAM {ate:.6f} m (align=False); "
        f"loop closures' error against the ground truth (m, rad), the odometry's over the same span: {closure_err}"
    )
    if Status.NUMERIC_ERROR in status or pgo_status == Status.NUMERIC_ERROR or not torch.isfinite(poses).all():
        raise AssertionError(f"scan_slam {method}: registrations {names}, PGO {pgo_status.name}")
    if poses.shape != (k_scans, 6):
        raise AssertionError(f"scan_slam {method}: poses of shape {tuple(poses.shape)}")
    if not ate_odo < SLAM_ATE_BOUND or not ate < SLAM_ATE_SLAM_BOUND or (method in SLAM_BEATS_ODOMETRY
                                                                       and not ate < ate_odo):
        raise AssertionError(f"scan_slam {method}: ATE odometry {ate_odo}, SLAM {ate}")
    if k5 < sum(outer) or pairs[0]["k6"] == 0:
        raise AssertionError(f"scan_slam {method}: K5 {k5} for {sum(outer)} outer iterations, first pair K6 "
                             f"{pairs[0]['k6']}")
    run = dict(wall_s=wall_s, front_s=front_s, steady_ms=steady_s * 1e3, loops_s=loops_s, pgo_s=pgo_s, fps=fps,
               ate_odo=ate_odo, ate=ate, k5=k5, k6=k6, pgo_reads=pgo_reads, reg=reg)
    return result, graph, config, run


def _closure_errors(graph, poses_odo, gt):
    """For each loop-closure edge (i, j): the (translation, rotation) norms
    of its measurement's error against the ground truth, and of the
    odometry's relative pose P_i⁻¹P_j over the same span."""
    out = []
    gt = gt.double()
    odo = poses_odo.cpu().double()
    for e in range(graph.poses.shape[0] - 1, graph.edge_i.shape[0]):
        i, j = int(graph.edge_i[e]), int(graph.edge_j[e])
        z = graph.measurements[e].cpu().double()
        z_odo = odometry._params6_of(torch.linalg.inv(se3.transform_from_params6(odo[i]))
                                     @ se3.transform_from_params6(odo[j]))
        errs = [pose_graph._edge_residual(gt[i], gt[j], m) for m in (z, z_odo)]
        out.append(((i, j), [(round(float(r[:3].norm()), 7), round(float(r[3:].norm()), 8)) for r in errs]))
    return out


def pgo_repeat_and_cg(graph, config, first):
    """The SLAM graph's PGO again (bit-equal poses, equal iterations and
    status), with solver="cg" (poses within PGO_CG_GAP of the dense), and
    with unit information (shown, not checked)."""
    unit = pose_graph.solve_pgo(dataclasses.replace(graph, information=graph.information / SLAM_INFORMATION), config)
    print(f"PGO of the SLAM graph with unit information: {Status(int(unit.status)).name}, iterations "
          f"{int(unit.iterations)}, start cost {float(unit.trace['cost'][0]):.3e} (8ε of {graph.poses.dtype} is "
          f"{8 * torch.finfo(graph.poses.dtype).eps:.3e}), max|poses - odometry| "
          f"{float((unit.poses - graph.poses).abs().max()):.3e}")
    again = pose_graph.solve_pgo(graph, config)
    same = (torch.equal(_bits(again.poses), _bits(first.poses)) and int(again.iterations) == int(first.iterations)
            and int(again.status) == int(first.status))
    reads = pose_graph.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg = pose_graph.solve_pgo(graph, dataclasses.replace(config, solver="cg"))
    gap = float((cg.poses - first.poses).abs().max())
    cg_s = time.perf_counter() - t0
    print(f"PGO of the SLAM graph ({graph.poses.shape[0]} poses, {graph.edge_i.shape[0]} edges) again: poses bit-equal, "
          f"iterations and status equal: {same}; solver='cg': {cg_s:.4f} s, {Status(int(cg.status)).name}, iterations "
          f"{int(cg.iterations)}, host reads {pose_graph.HOST_READS - reads}, max|poses - dense| {gap:.3e} "
          f"(bound {PGO_CG_GAP:g})")
    if not same:
        raise AssertionError("PGO: a second solve of the SLAM graph differs from the first")
    if not gap <= PGO_CG_GAP:
        raise AssertionError(f"PGO: the CG solve is {gap} from the dense one")


def surface_times(scans, dev):
    """K9 on the card: gicp_covariances and estimate_normals of one
    32,768-point scan (CUDA events, means of 5 after one warm-up), and the
    host reads of one steady GICP registration (scan 3 onto scan 2, seeded
    with the true relative pose)."""
    cloud = scans[2].to(dev)
    out = {}
    for name, fn in (("gicp_covariances", lambda: surface.gicp_covariances(cloud)),
                     ("estimate_normals", lambda: surface.estimate_normals(cloud))):
        fn()
        out[name] = _time_ms(fn, 5)
    reg = PairwiseRegistrar(config=SLAM_CONFIG, max_corr_dist=SLAM_GATE, method="gicp")
    x0 = reg.register(scans[2].to(dev), scans[1].to(dev)).x
    syncs = _syncs_of(lambda: reg.register(scans[3].to(dev), scans[2].to(dev), x0=x0).x.cpu())
    print(f"K9 at {cloud.shape[0]} points (knn k=10 + PCA, plain PyTorch; CUDA events, mean of 5): gicp_covariances "
          f"{out['gicp_covariances']:.3f} ms, estimate_normals {out['estimate_normals']:.3f} ms; one steady GICP pair "
          f"(two covariance builds, the solve): {syncs} host reads (stream syncs, torch.profiler)")
    out["gicp_pair_syncs"] = syncs
    return out


def run_fixed_lag(scans, gt, dev):
    """scan_slam_fixed_lag over the first FIXED_LAG_SCANS scans (window
    FIXED_LAG_WINDOW, icp, the bench's registrar settings)."""
    seq = [sc.to(dev) for sc in scans[:FIXED_LAG_SCANS]]
    with _slam_stages() as (walls, regs, solves):
        k_nn.LAUNCHES = k_expand.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = odometry.scan_slam_fixed_lag(seq, window=FIXED_LAG_WINDOW, method="icp", config=SLAM_CONFIG,
                                             nn_backend="auto", max_corr_dist=SLAM_GATE).cpu()
        wall_s = time.perf_counter() - t0
        k5, k6 = k_nn.LAUNCHES, k_expand.LAUNCHES
    pairs, outer, _, status = _registrations(regs)
    pgo_status = [Status(int(out.status)) for _, _, out in solves]
    ate = float(ate_rmse(poses.double(), gt[:FIXED_LAG_SCANS].double(), align=False))
    print(f"scan_slam_fixed_lag, window {FIXED_LAG_WINDOW}, {len(seq)} scans: wall {wall_s:.4f} s, "
          f"{wall_s / len(seq) * 1e3:.2f} ms a scan; {len(pairs)} registrations; PGO solves {len(solves)} "
          f"({sum(walls['pgo']):.4f} s, statuses {sorted({s.name for s in pgo_status})}), marginalizations "
          f"{len(walls['marg'])} ({sum(walls['marg']):.4f} s); K5 {k5}, K6 {k6}; ATE {ate:.6f} m (align=False)")
    if poses.shape != (FIXED_LAG_SCANS, 6) or not torch.isfinite(poses).all():
        raise AssertionError(f"fixed-lag SLAM: poses {tuple(poses.shape)}")
    if Status.NUMERIC_ERROR in status + pgo_status or not ate < SLAM_ATE_BOUND:
        raise AssertionError(f"fixed-lag SLAM: ATE {ate}, statuses {set(status)}, {set(pgo_status)}")
    if len(walls["marg"]) != FIXED_LAG_SCANS - FIXED_LAG_WINDOW or k5 < sum(outer):
        raise AssertionError(f"fixed-lag SLAM: {len(walls['marg'])} marginalizations, K5 {k5}")
    return dict(wall_s=wall_s, ate=ate, k5=k5, k6=k6)


def _relative(a, b):
    """params6 of T_a⁻¹ T_b (float64 CPU tensors)."""
    E = torch.linalg.inv(se3.transform_from_params6(a)) @ se3.transform_from_params6(b)
    return torch.cat([E[:3, 3], so3.log(E[:3, :3])])


def _compose(a, b):
    T = se3.transform_from_params6(a) @ se3.transform_from_params6(b)
    return torch.cat([T[:3, 3], so3.log(T[:3, :3])])


def make_ring_graph(n, seed=0, drift=0.03, dtype=torch.float64, device="cpu"):
    """tests/test_pose_graph.make_ring_graph in numpy and the port's lie, in
    the same rng call order: poses on a ring, the odometry chain and two
    loop closures (n−1 → 0, 0 → n/2) with exact measurements, and an
    initial guess integrating the odometry with noise. Returns (PoseGraph,
    ground-truth poses)."""
    rng = np.random.default_rng(seed)
    step = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n], dtype=torch.float64)
    gt = [torch.zeros(6, dtype=torch.float64)]
    for _ in range(n - 1):
        gt.append(_compose(gt[-1], step))
    edge_i = list(range(n - 1)) + [n - 1, 0]
    edge_j = list(range(1, n)) + [0, n // 2]
    meas = [_relative(gt[i], gt[j]) for i, j in zip(edge_i, edge_j)]
    init = [gt[0]]
    for k in range(n - 1):
        init.append(_compose(init[-1], meas[k] + drift * torch.as_tensor(rng.normal(size=6))))
    e = len(edge_i)
    graph = pose_graph.PoseGraph(
        poses=torch.stack(init).to(dtype=dtype, device=device),
        edge_i=torch.tensor(edge_i, device=device),
        edge_j=torch.tensor(edge_j, device=device),
        measurements=torch.stack(meas).to(dtype=dtype, device=device),
        information=torch.eye(6, dtype=dtype, device=device).expand(e, 6, 6).contiguous(),
        n_fixed=1,
    )
    return graph, torch.stack(gt)


def run_ring(dev, n, bound):
    """The n-pose ring graph in float32, by CG and by the dense Cholesky;
    each must end below bound × its start cost."""
    graph, _ = make_ring_graph(n, RING_SEED, RING_DRIFT, dtype=torch.float32, device=dev)
    start = float(pose_graph.compute_cost(graph))
    out = {}
    for name, config in RING_CONFIGS.items():
        reads = pose_graph.HOST_READS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pose_graph.solve_pgo(graph, config)
        cost = float(res.cost)
        wall_s = time.perf_counter() - t0
        out[name] = dict(wall_s=wall_s, iterations=int(res.iterations), reads=pose_graph.HOST_READS - reads,
                         ratio=cost / start)
        print(f"PGO ring, {n} poses, {graph.edge_i.shape[0]} edges, float32, solver={name!r}"
              f"{f' ({6 * n}² H)' if name == 'dense' else f', {config.cg_iterations} CG iterations a step'}: wall "
              f"{wall_s:.4f} s, {Status(int(res.status)).name}, iterations {int(res.iterations)}, host reads "
              f"{out[name]['reads']}, cost {start:.6e} -> {cost:.6e} ({cost / start:.3e} of the start; bound {bound:g})")
        if not np.isfinite(cost) or not cost < bound * start or int(res.status) == Status.NUMERIC_ERROR:
            raise AssertionError(f"PGO ring {n} {name}: cost {start} -> {cost}, {Status(int(res.status)).name}")
        out[name]["poses"] = res.poses
    out["max_gap"] = float((out["cg"].pop("poses") - out["dense"].pop("poses")).abs().max())
    print(f"PGO ring, {n} poses: max|poses cg - poses dense| {out['max_gap']:.3e}")
    return out


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
    max_abs_err, nn_t, nn_bound, nn_splits = check_nn_kernel(cloud, rng)
    t0 = time.perf_counter()
    scans, gt = make_sequence(SLAM_K, SLAM_N)
    print(f"SLAM sequence {SLAM_K} x {SLAM_N} points made in {time.perf_counter() - t0:.3f} s (host, numpy)")
    check_grid(cloud, scans, gt, rng)
    srcs, tgts, fleet_x = _fleet_inputs(cloud, np.random.default_rng(SEED + 2))
    e_err, e_t, e_bound = check_expand_kernel(cloud, srcs, tgts, _coarse_seed_search(scans, dev), rng)
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

    ba_res, s_launches, ba_wall_s = run_ba(ba_prob)
    ba_repeat(ba_prob, ba_res, ba_wall_s)
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

    rels_grid, k5_grid, k6_grid = run_slam(scans, gt, "grid", dev)
    rels_auto, k5_auto, k6_auto = run_slam(scans, gt, "auto", dev)
    d_rel = float((rels_grid - rels_auto).abs().max())
    bit_equal = torch.equal(rels_grid.view(torch.int32), rels_auto.view(torch.int32))
    print(f"SLAM relative poses, grid against auto over {SLAM_K - 1} pairs: max|diff| {d_rel:.3e}, bit-equal {bit_equal} "
          f"(bound {SLAM_REL_TOL:g})")
    if not d_rel <= SLAM_REL_TOL:
        raise AssertionError(f"SLAM: the grid and auto runs' relative poses differ by {d_rel}")

    slam = {}
    for method in ("icp", "point2plane", "gicp"):
        result, graph, config, slam[method] = run_scan_slam(scans, gt, method, dev)
        if method == "icp":
            pgo_repeat_and_cg(graph, config, result)
    k9 = surface_times(scans, dev)
    lag = run_fixed_lag(scans, gt, dev)
    ring = {n: run_ring(dev, n, bound) for n, bound in RING_BOUNDS.items()}

    def entry(name, source, replaces, n_launches, err, t, bound, **extra):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=n_launches,
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound[0],
            bound_by=bound[1], library_ms=t["library"], **extra,
        )

    kernels = [
        entry("nn_bruteforce", "moptimizer_0_tpu_torch/csrc/nn_search.cu",
              "moptimizer_0_tpu/ops/nn_search.py:136", launches, max_abs_err, nn_t, nn_bound,
              splits=nn_splits, slam_launches=dict(grid=k5_grid, auto=k5_auto),
              scan_slam_launches={m: r["k5"] for m, r in slam.items()}, fixed_lag_launches=lag["k5"]),
        entry("nn_expand", "moptimizer_0_tpu_torch/csrc/nn_expand.cu",
              "moptimizer_0_tpu/ops/nn_search.py:43", e_launches, e_err, e_t, e_bound,
              slam_launches=dict(grid=k6_grid, auto=k6_auto),
              scan_slam_launches={m: r["k6"] for m, r in slam.items()}, fixed_lag_launches=lag["k6"]),
        entry("schur_pairs", "moptimizer_0_tpu_torch/csrc/schur.cu",
              "benchmarks/schur_pallas_ab.py:38", s_launches, s_err, s_t, s_bound),
    ]
    print(json.dumps({"slam": {
        m: {k: v for k, v in r.items() if k != "reg"} for m, r in slam.items()
    } | {"k9_ms": k9, "fixed_lag": lag, "ring": ring}}))
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
