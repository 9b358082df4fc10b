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
   the plain S build and must give the same costs; then (a) the same
   instance through ``solve_ba(engine="cg")``, the matrix-free Schur-CG
   engine, which must end in the same band with the fixed cameras unmoved, a
   non-increasing cost trace, no K11 launch and a second solve bit-equal,
   its matvec and damped solve timed and their launches counted; (b)
   ``engine="auto"``, which must route the instance to the dense engine and
   equal its solve bit for bit, and route the O=1M, C=4,000, L=100k instance
   (past ``DENSE_MAX_CAMERAS``) to CG, which must end below its start with a
   non-increasing trace, no K11 launch and a repeat bit-equal; (c)
   ``solve_ba_selfcal`` from intrinsics off by [+8, −6, +3, −2], which must
   end within ±1% of its χ² floor (4 unknowns more) with the intrinsics
   within 1 px of the true ones, while plain ``solve_ba`` from the same
   intrinsics ends above that band;
6. the fleet path: ``icp_batched`` on 64 lanes of the full fachada scan in
   float32, each lane with its own shuffled target and known transform to
   be recovered to 2e-3, with one launch of the expansion kernel K6 per
   pass of the batched loop, replayed by its graph (and one more, eager, in
   the capture's warm-up); lanes 0, 1 and 63 are repeated as single
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
   once per outer iteration and K6 on the first pair, replayed by the
   coarse multistart's graph; the ICP graph's PGO is solved again
   (bit-equal), by CG and in float64 on the card: the float32 dense and CG
   poses each within √ε_f32 (their stopping rule's reach,
   ``PGO_F64_BOUND``) of the float64 optimum; from a drifted start the full
   float32 solve inside it and the one stopped after one outer iteration
   outside; the CG-against-dense gap shown;
10. K9 (``gicp_covariances``, ``estimate_normals``) at 32,768 points and the
    host reads of one GICP pair;
11. ``scan_slam_fixed_lag`` (window 8, icp) on the first 24 scans: ATE <
    0.05 m, poses (24, 6), one marginalization a scan past the window, one
    PGO capture a window layout and fewer layouts than solves;
12. the pose graph of ``tests/test_pose_graph.py`` rebuilt at 300 and 2,000
    poses in float32, solved by CG and by the dense Cholesky, each below its
    cost bound (``RING_BOUNDS``);
13. the reference's problem set in float32 on the card: the 9 problems of
    ``tests/trace_problems.py`` (curve near and far, Powell, rational,
    camera good and bad, accelerometer, the 15-DoF state through the
    Product(SO3, Euclidean(12)) manifold, point-to-point on fachada) and the
    Sphere(4) quaternion fit, each held to its ``tests/test_f32_envelope.py``
    bound;
14. the sharded paths in one process, float32 at full width, n shards on
    the one card (``parallel.make_mesh(n)``): (a) ``sharded_linearize`` and
    ``sharded_compute_cost`` of the fachada point2point block over 1, 2 and
    4 shards (4 pads) against the unsharded ones, then
    ``distributed_levenberg_marquardt`` over request A's ICP block over 2
    and 6 shards (one block: its graph captured once a shard count): x to
    2e-3 of the truth and to 1e-5 of request A, K5 replayed once per shard
    per outer iteration; (b) ``solve_ba_dense_sharded`` on the
    phase-5 instance over 2 shards (phase 5's segmented grid, flattened) and
    4: the χ² band, fixed cameras unmoved, the final cost within 1e-4 of
    phase 5's, K11 replayed once per shard per S build, a second 4-shard
    solve (a new mesh, ``grouped=None``) replaying the first's graph bit for
    bit, and one shard's K11 timed; (c) ``icp_batched`` over 4 shards of
    phase 6's fleet: every lane within 1e-5 of phase 6's (bit-equality
    reported), K6 once per shard per pass, B = 62 refused;
15. two processes on the one card (this script run with ``--rank``; each
    killed past 300 s) over a mesh of 2 processes × 2 shards whose
    transport is the device all-reduce through CUDA IPC buffers
    (``kernels/mesh_reduce.py``; the gloo group makes the group and carries
    the gathers): the 64-row curve fit through ``make_global_block`` and
    ``distributed_levenberg_marquardt`` (float64), ``solve_ba_dense_sharded``
    on the phase-5 instance, ``solve_ba`` (CG) on it with the observations
    sharded along rows, each process feeding its own half
    (``host_local_shard``, ``make_global_array``), and phase 18's
    self-calibration, each by its CUDA graph twice (the first captures, in
    each process) and by its step's body run eagerly on the card: every
    graph solve bit-equal to its eager body and to its repeat, the two
    processes bit-equal, 0 host reads in the loop (the self-calibration one
    an outer iteration), K11 replayed shards × S builds, the transport's
    launches counted; the BA within 1e-5 of phase 14(b)'s 4-shard cost, the
    CG's first three outer iterations within 1e-5 and its final cost within
    1e-5 of phase 16's 4-shard solve, ``engine="dense"`` refused; the CG
    solved once more over a gloo mesh (the placement rule patched), its
    digests equal to the device route's, its all-reduces counted and timed;
    and the transport kernel held bit for bit to its plain version
    (``parallel.mesh._all_reduce_plain``) for sum and max in float32 and
    float64 at S's 5.76 MB and at 1,001 elements, timed beside the plain
    version and gloo's all-reduce, and a reduction that one process skips
    raising in the other within ``TRANSPORT_TIMEOUT_S`` plus a second;
16. (run before 15) the observation-sharded CG engine in one process:
    ``solve_ba`` on the phase-5 instance with ``cam_idx``, ``pt_idx`` and
    ``pixels`` as ``GlobalArray``s over 2 and 4 shards (4 twice, bit-equal,
    the repeat replaying the first solve's graph with no host read),
    held to phase 5(a)'s unsharded CG solve (the first three outer
    iterations' cost and cost_new within 1e-5, the final cost within 1e-5
    and within ±1% of the χ² floor, fixed cameras unmoved, no K11), and the
    O=1M, C=4,000 instance over 4 shards held so to phase 5(b)'s routed
    solve; walls, host reads, and a PCG iteration's ms and reductions;
17. the six examples of ``moptimizer_0_tpu_torch.examples`` through their
    ``main()`` at the JAX scripts' sizes, with their asserts (the curve to
    its minimum, SciPy's three minima, the ICP transform to 2e-3, the fleet,
    multistart and fixed-lag checks, the SfM's aligned RMS < 0.05 and
    reprojection RMS < 1 px) and their launches (K5 in the ICP and the
    fixed-lag SLAM, K6 in the fleet, K11 once a trial in the BA example's
    ``engine="auto"`` route); ``solve_ba_dense(schur_solver="blocked")`` on
    the phase-5 instance within 1e-5 of phase 5's solve; and
    ``spd_solve_blocked`` against one ``cholesky_ex`` at 6C = 1,200 and
    24,000, relative residuals and times;
18. (run before 15, and in 15's processes) self-calibrating BA with the
    observations sharded: ``solve_ba_selfcal`` on 5(c)'s start with
    ``cam_idx``, ``pt_idx`` and ``pixels`` as ``GlobalArray``s over 2 and 4
    shards in one process, and over 2 processes × 2 shards (each process
    its own rows, in phase 15's processes), held to 5(c)'s unsharded solve:
    the first three outer iterations' cost and cost_new within 1e-5, the
    final cost within 1e-5 and within ±1% of the χ² floor, the intrinsics
    within 1 px of the true ones, fixed cameras unmoved, no kernel launched,
    both processes bit-equal; the status reported (a NaN trial at the
    float32 floor ends a solve NUMERIC_ERROR, as in the JAX package); walls
    beside 5(c)'s and host reads;
19. (run after 5) the BA steps as CUDA graphs: on the headline, the CG,
    dense and self-calibrating solves through their graphs (``host_loop``
    False and True) must equal their step bodies run eagerly on the card
    (``ops.device_loop.eager()``) bit for bit, with at most one host read a
    solve for ``host_loop=False`` and one an outer iteration for
    ``host_loop=True`` and the self-calibration, one graph launch a step,
    and the dense solve's replayed K11 launches equal to its trials;
    walls, host reads, launch calls, device ms and busy share beside the
    eager body's, and each capture's warm-up, capture and instantiation ms
    and pool bytes (every capture of the run, the O=1M, C=4,000 one too);
20. (run after 13) the LM solves as CUDA graphs: request A's ICP (K5), the
    64-lane fleet (K6), a multistart, ``lm_step`` from λ = −1, the reference
    problems of (d) in float32 (the state and Sphere fits are the manifold
    solves), one registrar pair with the grid and one by brute force (K5),
    point2plane and GICP, each through its graph and through its step's
    body run eagerly on the card (``device_loop.eager()``): bit-equal, 0
    host reads by the graph, K5's (K6's) replayed launches equal to the
    eager body's and to the outer iterations run (passes); walls, and for
    the ICP request, the fleet and the two pairs launch calls, device ms
    and busy share beside the eager body's; then ``scan_slam`` icp over the
    64 scans from an empty layout cache, by its graphs and eagerly
    (frames/s each), whose registrations' captures must all come from its
    first two registrations (the first pair's coarse multistart and pair
    solve); and every capture's warm-up, capture and instantiation ms and
    pool bytes;
21. (run after 12) the PGO solves as CUDA graphs: the SLAM graph of 9
    (icp) dense and CG, the rings of 12 at 300 and 2,000 poses dense and
    CG, and the 23 window solves of 11's fixed-lag stream, each through its
    graph and through its step's body run eagerly on the card: bit-equal
    (poses, iterations, status, trace), no host read but the edge plan's,
    max_iterations graph launches a solve; walls, launch calls, captures,
    each layout's warm-up, capture and instantiation ms and pool bytes; the
    fixed-lag stream's captures, one a layout (the windows of 2…9 poses,
    then the window with its marginal prior); and for ``scan_slam`` (icp,
    point2plane, GICP) frames/s, the PGO term and the first pair's wall
    with its replayed K6 launches;
22. (run after 14, 16 and 18, before 15) the one-process sharded solves as
    CUDA graphs: the distributed ICP over 2 and 6 shards, the sharded dense
    BA over 2 and 4, the observation-sharded CG over 2 and 4 and the O=1M
    instance over 4, and the sharded self-calibration over 2 and 4, each
    through its graph and through its step's body run eagerly on the card:
    bit-equal (x or cameras, points and intrinsics, iterations, status,
    trace), no host read in the loop (the self-calibration one an outer
    iteration), max_iterations graph launches a solve (the
    self-calibration one an outer iteration run), K5's replayed launches
    shards × outer iterations and K11's shards × S builds, each equal to the
    eager body's; walls, the eager body's mesh reductions, launch calls,
    device ms and busy share, each capture's warm-up, capture and
    instantiation ms and pool bytes, and ``torch.cuda.max_memory_reserved()``;
23. (run last, with two cards or more; with one it prints that it needs
    2+ cards and runs nothing) the one-process mesh over several cards
    (``make_mesh(2)`` and ``make_mesh(min(4, cards))``, one shard a card,
    and 4 shards over 2 cards): the curve fit and the distributed ICP
    (``distributed_levenberg_marquardt``, K5 inside; the fachada scan's
    first 29,304 points, which 4 shards divide), the observation-sharded
    CG BA and self-calibration, and ``solve_ba_dense_sharded`` (K11 inside)
    at the headline, each by its graphs (one a card, ``CardLoops``) twice and
    by the mesh's eager body: bit-equal to the eager body and to the repeat,
    every card's replicated state bit-equal to the first card's, within
    1e-5 of the unsharded solve (x for the LM paths, the final cost for BA;
    phases 5's, 12's and 18's BA solves, made here under ``--phase 23``),
    the BA cameras within √ε_f32·max(1, max|cameras|) of its, no host read after the capture (the self-calibration one an outer
    iteration), max_iterations replays on every card, and K5's (K11's)
    replayed launches on every card equal to the eager body's launches
    there; the card transport (``mesh_reduce.CardBuffers``) against its
    plain version bit for bit, its µs, and a card that never arrives
    raising through ``Mesh.check``. ``python3 chip_smoke.py --phase 23``
    runs the build and this phase alone.
25. (run last, in a process of its own: one profiler session a process)
    the port's tracing (``utils/tracing.py``): one small CG BA solve and
    request A's ICP, each captured first, profiled together in one
    ``torch.profiler`` session: the ``pcg_iteration`` markers on the device
    equal Σ ``trace["pcg_iterations"]``, ``step_begin`` and ``step_end``
    the outer iterations the two solves ran, ``ba_pcg_begin``/``_end`` the
    trials and ``ba_linearize_begin``/``_end`` the BA's iterations; each
    result bit-equal to its eager body's, no host read in the graph solves;
    the spans nested as placed, the median offset of a span's start and
    end from its range's event in the profiler's record within 20 µs, and
    no range of the program copied onto the device's timeline.
    ``python3 chip_smoke.py --phase 25`` runs the build and this phase
    alone.
26. (run after 3) the CG engine's matvec kernels (``csrc/schur_matvec.cu``)
    on the benchmark's Venice instance (``portbench/configs``, instance seed
    1; O = 5,001,946, C = 1,778, L = 993,923) at its start, with random u
    and s: each half within float32's error bound ((n + 6)·2⁻²⁴·Σ|terms|) of
    a float64 sum, as its plain version is, two calls bit-equal; the plan's
    build, W's copy in camera order, each half's ms beside its bytes bound
    and its plain ms, and each half over tile sizes and lanes a landmark.
    Phases 19 and 22 hold the kernels' replayed launches in every CG solve
    to 2 a PCG iteration and a trial on every shard (none eager, none in the
    dense solves). ``python3 chip_smoke.py --phase 26`` runs the build and
    this phase alone.

Every LM, BA and PGO solve runs its step graph (outside phases 15's and
19–22's eager runs and 15's gloo solve), the registrar's coarse multistart
and every sharded solve too, across phase 15's processes included: the
launches of K5, K6, K11, the matvec kernels and the transport there are counted on the card
(``replayed``), and a capture's warm-up launches each kernel of the step
once more, eagerly. The dense-BA solve runs twice and
must repeat itself bit for bit.

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

import argparse
import contextlib
import dataclasses
import faulthandler
import functools
import hashlib
import inspect
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import moptimizer_0_tpu_torch  # noqa: F401  (sets fp32 matmul precision)
from moptimizer_0_tpu_torch import ba, ba_dense, ba_intrinsics, odometry, pose_graph, registration
from moptimizer_0_tpu_torch.core import manifold, solver
from moptimizer_0_tpu_torch.core.linearize import compute_cost, linearize
from moptimizer_0_tpu_torch.core.loss import GemanMcClure, TrivialLoss
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, Status, levenberg_marquardt, lm_step, solve_multistart
from moptimizer_0_tpu_torch.evaluation import ate_rmse, rpe
from moptimizer_0_tpu_torch.kernels import build, graph_cond
from moptimizer_0_tpu_torch.kernels import mesh_reduce as k_mesh
from moptimizer_0_tpu_torch.kernels import nccl_transport
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.kernels import schur as k_schur
from moptimizer_0_tpu_torch.kernels import schur_matvec as k_matvec
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.models import accelerometer, camera, curve_fitting, powell, rational
from moptimizer_0_tpu_torch.models.point2point import point2point_block
from moptimizer_0_tpu_torch.models.state import product_state_block
from moptimizer_0_tpu_torch.odometry import scan_odometry
from moptimizer_0_tpu_torch.examples import (
    bundle_adjustment,
    cross_check_scipy,
    curve_fitting as curve_example,
    fleet_and_fixed_lag,
    icp_registration,
    sfm_reconstruct,
)
from moptimizer_0_tpu_torch.ops.block_cholesky import spd_solve, spd_solve_blocked
from moptimizer_0_tpu_torch.ops.small_solve import capturable_linalg
from moptimizer_0_tpu_torch.parallel import (
    distributed_levenberg_marquardt,
    make_mesh,
    multihost,
    sharded_compute_cost,
    sharded_linearize,
)
from moptimizer_0_tpu_torch.parallel import mesh as mesh_module
from moptimizer_0_tpu_torch.ops import device_loop, grid_nn, surface
from moptimizer_0_tpu_torch.ops.nn_search import _nn_expand_torch, _nn_torch
from moptimizer_0_tpu_torch.ops.segment_sum import segment_sum
from moptimizer_0_tpu_torch.ops.schur import (
    _schur_corr_pairs_torch,
    _schur_corr_torch,
    fold_linv,
    fold_segments,
    pair_plan,
    schur_corr_cuda,
)
from moptimizer_0_tpu_torch.registration import (
    PairwiseRegistrar,
    _centroid_seed,
    _coarse_subsample,
    _icp_config,
    _yaw_starts,
    icp,
    icp_batched,
    icp_block,
    point2plane,
)
from moptimizer_0_tpu_torch.registration import gicp as gicp_solve
from moptimizer_0_tpu_torch.utils import tracing
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

# a fault in native code (a kernel's binding, the profiler) prints the
# Python stack of every thread before the process dies
faulthandler.enable()

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
# The CG engine past DENSE_MAX_CAMERAS, at the headline's ten observations a
# landmark: engine="auto" must route it to "cg".
BA_CG_O, BA_CG_C, BA_CG_L = 1_000_000, 4_000, 100_000
# Self-calibrating BA starts from intrinsics off by tests/test_ba_intrinsics.py's
# perturbation; its χ² floor has 4 unknowns more.
SELFCAL_WRONG = (8.0, -6.0, 3.0, -2.0)
# The recovered intrinsics against the true ones, in px: the estimate's own
# error at 0.5 px noise, which shrinks as 1/√O (0.27 px at this O on an H100,
# PERF.md; 0.53 px at O = 100k, C = 100, L = 10k on the CPU).
SELFCAL_INTR_TOL = 1.0

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
# CG against dense on the 64-pose SLAM graph, printed beside what is held
# (PGO_F64_BOUND): the gap the check once held, whose 1e-4 lies below the
# float32 stopping rule's reach (both solves stop on SMALL_DELTA).
PGO_CG_GAP = 1e-4
# The SLAM graph's float32 PGO, dense and CG, is held to the graph's optimum:
# the dense solve of the same graph on the card in float64 (it stops at
# max|δ| < √ε_f64 = 1.5e-8). A float32 solve stops on SMALL_DELTA once a
# rejected trial's step has max|δ| < √ε_f32 = 3.45e-4 (params6: metres and
# radians). That step is the damped Gauss-Newton step from the final poses,
# (H + λ·diag H)⁻¹(−b), with λ seeded at 1e-9·max|diag H| and cut by ≥ 3 at
# each accepted step (the final λ is printed): the step of the local model to
# its optimum. So the stopping rule leaves each float32 solve within √ε_f32
# of the optimum in every component: max|poses − poses_f64| ≤ √ε_f32.
PGO_F64_BOUND = float(np.sqrt(np.finfo(np.float32).eps))
# The SLAM graph's whole correction lies near that bound (its odometry start
# is ~3.4e-4 from the optimum on an H100), so a solve that descends from the
# odometry cannot leave it. The check is also shown on the same graph from a
# drifted start, its odometry re-chained from the odometry edges with noise
# of RING_DRIFT (tests/test_pose_graph.py's drift of its rings): the full
# float32 solve from there must end inside the bound, the one stopped after
# one outer iteration outside.
PGO_DRIFT_SEED = 14
X_SMALL =[0.05, -0.03, 0.02, 0.01, -0.005, 0.01]  # the fachada grid query's transform

# The reference's problem set in float32 (tests/trace_problems.py and
# tests/test_f32_envelope.py): the curve minimum, the Ceres solution of the
# float32 camera fixture, and the camera fixture itself.
CURVE_MINIMUM = [0.291861, 0.131439]
F32_CAMERA_CERES = [-0.010075, 0.020714, -0.058274, 0.018369, -0.001367, 0.027415]
CAMERA_POINTS = [
    [2.055643, 0.065643, 0.684357, 1.0],
    [1.963083, -0.765833, 0.653833, 1.0],
    [2.927500, 0.707000, 0.125250, 1.0],
    [2.957833, 0.384667, 0.123667, 1.0],
    [2.756000, 0.712000, -0.298000, 1.0],
]
CAMERA_PIXELS = [[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]]
# tests/test_f32_envelope.py pins no float32 bound for these two: the state
# (rotation matrix and linear part) and the unit quaternion (norm and
# entries, up to sign) are held to 1e-5, a few hundred float32 ε at unit
# scale.
STATE_F32_BOUND = 1e-5
SPHERE_F32_BOUND = 1e-5

# The sharded paths (phase 14), float32 at full width.
# (a) The fachada point2point block, linearized over 1, 2 and 4 shards (29,310
# rows: 4 shards pad), at the off-optimum x of tests/test_sharding.py. The
# shards sum their rows in other partitions than the unsharded sum: float32
# roundoff of ~√n·ε ≈ 2e-5 of the largest entry at n = 29,310, held to 1e-4.
SHARDED_LIN_SHARDS = (1, 2, 4)
SHARDED_LIN_X = [0.5, 0.0, 0.1, 0.05, 0.0, -0.02]
SHARDED_LIN_RTOL = 1e-4
# The distributed ICP over 2 and 6 shards (both divide 29,310: a padded block's
# update_fn is not wrapped, in either package). Its x against the
# single-device request A: the moment sums round in another order, as the
# fleet's lanes against their single solves.
DIST_ICP_SHARDS = (2, 6)
DIST_ICP_X_TOL = FLEET_X_TOL
# (b) The dense-BA headline over 2 shards (phase 5's segmented grid, flattened)
# and 4 (grouped by the solve). The camera-space sums add the shards in
# another order than the single-device engine, a roundoff of the kind the
# plain-S repeat shows (1.7e-7 there on an H100): the cost and cost_new of
# the first SHARDED_BA_TRACE_ITERS outer iterations are held to phase 5's at
# BA_COST_RTOL. A wrong S correction or rhs of one shard changes the first
# steps by far more; the final cost alone would not show it, because the
# cost is summed exactly and LM reaches the same floor from a poorer step.
# The final costs end within a float32 ulp (1.2e-7 relative at 2.1e5) of
# phase 5's on an H100; at the noise floor the last accepted steps are
# roundoff's choice, which moves a final cost by up to ~10 ulps on small
# instances: held to 1e-5.
SHARDED_BA_SHARDS = (2, 4)
SHARDED_BA_TRACE_ITERS = 3
SHARDED_BA_COST_RTOL = 1e-5
# (c) The 64-lane fleet over 4 shards of 16 lanes: lanes are independent, so
# each lane's solve is the unsharded one's up to the order K6 and the moment
# sums run in: held to 1e-5.
FLEET_MESH = 4
SHARDED_FLEET_TOL = 1e-5
# Phase 15: two processes on the one card, 2 shards each, reducing through
# the device transport (the gloo group makes the group and carries the
# gathers), both running the 64-row curve fit and the dense-BA headline. The
# two processes must print the same bits; the BA's 2 × 2 mesh splits the
# landmarks as the 4-shard mesh of (b) and sums its 4 shards in another
# order ((s0 + s1) + (s2 + s3)): the first iterations' costs to BA_COST_RTOL
# and the final cost to SHARDED_BA_COST_RTOL of (b)'s, as (b) against phase 5.
TWO_PROCESS_TIMEOUT_S = 300
TWO_PROCESS_BA_RTOL = SHARDED_BA_COST_RTOL
# The transport's checks in phase 15: the kernel against its plain version
# at S's element count and at a small odd one, bit for bit (a rank-order
# sum and a max are the same operations in the same order); a peer that
# skips a reduction must make the other process's check raise within
# TRANSPORT_TIMEOUT_S (the kernel's bounded spin) plus a second of slack.
TRANSPORT_SIZES = ((6 * BA_C) ** 2, 1001)
TRANSPORT_TIMEOUT_S = 2.0
# Phase 16: the observation-sharded CG engine in one process, the headline
# over 2 and 4 shards (4 twice) and the O=1M, C=4,000 instance over 4. The
# shards sum U, V, g, h, the costs and each PCG iteration's two reductions in
# another order than the unsharded engine, a roundoff of the same kind as
# the sharded dense engine's: the first outer iterations' cost and cost_new
# to BA_COST_RTOL, the final cost to SHARDED_BA_COST_RTOL of the unsharded
# CG solve's (phase 5(a), and phase 5(b)'s routed solve for the big one).
# Phase 15 runs the headline's sharded CG over 2 processes × 2 shards: its
# rows split as the 4 shards here, summed as ((s0 + s1) + (s2 + s3)).
SHARDED_CG_SHARDS = (2, 4)
SHARDED_CG_BIG_SHARDS = 4
# Phase 18: self-calibrating BA on the same sharding, the headline from
# intrinsics off by SELFCAL_WRONG over 2 and 4 shards in one process and over
# 2 processes × 2 shards: it makes the CG engine's reductions plus P, Y, Z and
# g_t, summed in another order than the unsharded solve, held as phase 16:
# the first outer iterations to BA_COST_RTOL and the final cost to
# SHARDED_BA_COST_RTOL of phase 5(c)'s. On the CPU at O = 100k, 2 shards are
# 2.9e-7 (first iterations) and 0 (final) from the unsharded solve; one
# shard's P, Y, Z or g_t off by 1% moves the first iterations by 1.0e-3 to
# 2.7e-3, and g_t's leaves the final cost within 1e-7. The status is reported,
# not held: at the float32 floor λ falls towards ε, where the damped V of a
# landmark seen once is singular in float32 and its closed-form inverse
# (``ba._inv3x3``, the JAX package's) gives NaN, so a trial's cost is NaN and
# LM ends NUMERIC_ERROR after the last accepted step, as the JAX package
# would. Whether λ gets there is roundoff's choice: on an H100 the 2-shard
# solve reached λ = 1.6e-7 at its 15th iteration and the unsharded one did not.
SELFCAL_SHARDS = (2, 4)
# Phase 17: the blocked Cholesky (ops/block_cholesky.py) against one
# cholesky_ex on SPD matrices M·Mᵀ/n + I (eigenvalues in [1, 5]) at the
# headline's 6C and at 6C = 24,000: the relative residual ‖Ax − b‖/‖b‖ of
# each, in float32, is about √n·ε·κ ≈ 1e-4 at n = 24,000; held to 1e-3.
BLOCKED_SIZES = (6 * BA_C, 24_000)
BLOCKED_RESIDUAL = 1e-3
# The SciPy MINPACK-LM minimum of the curve data's first 64 rows
# (tests/test_multihost.py), to 5e-5.
CURVE_MINIMUM_64 = [0.29284892, 0.12883951]

# Published peaks of an H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _reset_launches():
    """Every kernel's launch count set to 0, its replayed launches too."""
    for k in (k_nn, k_expand, k_schur, k_matvec, k_mesh, nccl_transport):
        k.reset_launches()


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


def _example_kernel_inputs(dev):
    """Each kernel's inputs on the examples' paths, made by the example
    modules' own helpers at their main()'s defaults: {"nn": K5 cases,
    "expand": K6 cases, "schur": K11 cases as (segments, C)}. K5: the
    fixed-lag registrar's search, scan 1 at its true pose against scan 0;
    K6: the fleet's first pass (the sources against the targets) and the
    fixed-lag stream's coarse seed; K11: the BA example's S build, grouped
    as ``solve_ba_dense`` groups it on the engine="auto" route."""
    fl = {k: v.default for k, v in inspect.signature(fleet_and_fixed_lag.main).parameters.items()}
    rng = np.random.default_rng(0)  # main()'s stream: the fleet, then the scans
    srcs, tgts, _ = fleet_and_fixed_lag.make_fleet(rng, fl["B"], fl["N"])
    scans, gt = fleet_and_fixed_lag.make_scans(rng, fl["k_scans"], fl["n_scan"])
    scans = [torch.as_tensor(s, device=dev) for s in scans]
    T1 = se3.transform_from_params6(torch.as_tensor(gt[1], dtype=torch.float32, device=dev))
    coarse = _coarse_seed_search(scans, dev, gate=fleet_and_fixed_lag.GATE)
    B, N = srcs.shape[:2]
    ex = {k: v.default for k, v in inspect.signature(bundle_adjustment.main).parameters.items()}
    ba_start, _ = bundle_adjustment.make_problem(ex["C"], ex["L"], device=dev, dtype=ex["dtype"])
    grouped = ba_dense.group_by_landmark(ba_start, segments="auto")
    return dict(
        nn={f"fixed-lag example, scan 1 ({scans[1].shape[0]} points) against scan 0":
            (se3.apply_transform(T1, scans[1]).contiguous(), scans[0])},
        expand={
            f"fleet example {B}x{N}x{N}": (torch.as_tensor(srcs, device=dev), torch.as_tensor(tgts, device=dev)),
            "fixed-lag example coarse seed, {} yaw starts x {} x {}".format(*coarse[0].shape[:2],
                                                                            coarse[1].shape[1]): coarse,
        },
        schur={f"bundle_adjustment example C={ex['C']} L={ex['L']} segments {_segments_text(grouped)}":
               (_s_build_segments(ba_start, grouped), ex["C"])},
    )


def check_nn_kernel(cloud, rng, extra):
    """nn_cuda against _nn_torch: equal indices and bit-equal d² at the
    fachada shape, at the distributed ICP's shard shapes, at the examples'
    shapes (``extra``), at the cases of ``_nn_cases`` and at NaN target rows,
    overflowing rows and subnormal differences, each with its targets in the
    ranges ``target_splits`` gives it. Timed at the fachada shape."""
    dev = cloud.device
    q_full = _transformed(cloud, X_A, rng)
    cases = {"fachada": (q_full, cloud)}
    for n in DIST_ICP_SHARDS:
        # the distributed ICP's per-shard search: 1/n of the queries against
        # the whole target, which can give it other target ranges
        rows = cloud.shape[0] // n
        cases[f"fachada, one of {n} shards"] = (q_full[-rows:].contiguous(), cloud)
    cases.update(extra)
    cases.update(_nn_cases(rng, dev))
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


def _coarse_seed_search(scans, dev, gate=SLAM_GATE):
    """A scan stream's first K6 call: the coarse subsamples of scans 1 and
    0, the source warped by each yaw start of the multistart of a registrar
    gated at ``gate``, against the target copied into every lane, as
    ``_icp_fleet_block`` searches them."""
    src_c = _coarse_subsample(scans[1].to(dev))
    tgt_c = _coarse_subsample(scans[0].to(dev))
    B = PairwiseRegistrar(max_corr_dist=gate).coarse_multistart
    T = se3.transform_from_params6(_yaw_starts(src_c, tgt_c, B))
    warped = src_c @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    return warped.contiguous(), tgt_c.expand(B, *tgt_c.shape).contiguous()


def check_expand_kernel(cloud, srcs, tgts, coarse, rng, extra):
    """nn_expand_cuda against _nn_expand_torch: equal indices and bit-equal
    d² at the fleet shape, at one shard of the sharded fleet, at the SLAM
    coarse seed's shape (``coarse``: 8 yaw starts against one shared
    target), at the examples' shapes (``extra``) and at one-lane, ragged,
    tied, NaN, 3-lane and subnormal cases;
    the cases below the fleet's size have their targets split, and the tie
    cases have tied targets on both sides of a range's end. Timed at the
    fleet shape and at one lane."""
    dev = cloud.device
    lanes = FLEET_B // FLEET_MESH
    cases = {
        f"fleet {FLEET_B}x{cloud.shape[0]}x{cloud.shape[0]}": (srcs, tgts),
        f"fleet shard, {lanes} lanes (one of {FLEET_MESH})": (srcs[-lanes:], tgts[-lanes:]),
        "SLAM coarse seed, {} yaw starts x {} x {}".format(*coarse[0].shape[:2], coarse[1].shape[1]): coarse,
        **extra,
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
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp_batched(srcs, tgts, loss=TrivialLoss())
    x = res.x.cpu()
    wall_s = time.perf_counter() - t0
    launches, replayed = k_expand.launches(), k_expand.replayed()
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
    print(f"expansion kernel launches on the fleet path: {launches} for {passes} passes ({replayed} replayed; "
          f"the rest a capture's warm-up)")
    if (status == Status.NUMERIC_ERROR).any() or not torch.isfinite(x).all():
        raise AssertionError(f"fleet: statuses {names}")
    if float(err.max()) > X_TOL:
        raise AssertionError(f"fleet: lane {int(err.argmax())} off by {float(err.max())} > {X_TOL}")
    if replayed != passes or launches == 0 or launches - replayed > 1:
        raise AssertionError(f"the fleet path launched the expansion kernel {launches} times ({replayed} replayed) "
                             f"for {passes} passes")
    if k_nn.launches() or k_schur.launches():
        raise AssertionError("the fleet path launched the nn or schur kernel")
    return res, wall_s, launches, replayed


def fleet_vs_single(cloud, tgts, fleet, fleet_wall_s):
    """Lanes of the fleet repeated as single icp(..., "pallas_mxu") solves:
    healthy, x within FLEET_X_TOL of the lane; K6 at B = 1."""
    for b in FLEET_SINGLES:
        k_expand.reset_launches()
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
            f"{int(res.iterations)} (lane {int(fleet.iterations[b])}), K6 launches {k_expand.launches()}"
        )
        if Status.NUMERIC_ERROR in (st, st_lane) or not dx <= FLEET_X_TOL:
            raise AssertionError(f"lane {b}: single solve differs from the fleet by {dx}, {st.name}")
        if k_expand.launches() == 0:
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


def check_schur_kernel(prob, grouped, dev, rng, extra):
    """schur_corr_cuda against _schur_corr_torch: max|ΔS_corr|/max|S_corr| ≤
    S_BOUND per case (the headline, the examples' ``extra``, random and
    segmented layouts), and two builds of each equal bit for bit; the plan's
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
        **extra,
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


# Phase 26: the Schur matvec's kernels at the benchmark's Venice shape (the
# configuration's first fixed instance), and the tile sizes and lanes a
# landmark they were chosen among.
MATVEC_CONFIG = ROOT / "portbench" / "configs" / "ba-bal-venice1778.json"
MATVEC_TILES = (128, 256, 512, 1024, 2048, 4096, 8192)
MATVEC_GROUPS = (1, 2, 3, 4, 5)
MATVEC_REPS = 20


def venice_problem(dev):
    """The BA problem of the benchmark's Venice configuration, instance
    seed 1, from its start (``portbench.generate``)."""
    from portbench import generate

    cfg = json.loads(MATVEC_CONFIG.read_text())
    d = generate.bal_instance(cfg, cfg["instance_seeds"][0], dev)
    return ba.BAProblem(camera_params=d["cams0"], points=d["pts0"], cam_idx=d["cam_idx"], pt_idx=d["pt_idx"],
                        pixels=d["pixels"], intrinsics=d["intrinsics"], n_fixed_cameras=d["n_fixed"])


def _matvec_error(k, ref, scale, counts):
    """max |k − ref| / ((n + 6)·2⁻²⁴·Σ|terms|) over a half's sums: at most 1
    for any order of n products of 6 or 3 terms each, to first order."""
    bound = (counts.double()[:, None] + 6) * 2.0**-24 * scale
    return float(((k.double() - ref).abs() / bound.clamp_min(torch.finfo(torch.float64).tiny)).max())


def _alternated(fns, reps):
    """Mean ms of each of ``fns`` (a dict), timed in order and then in the
    reverse order (CUDA events)."""
    names = list(fns) + list(fns)[::-1]
    out = {n: [] for n in fns}
    for n in names:
        out[n].append(_time_ms(fns[n], reps))
    return {n: sum(v) / len(v) for n, v in out.items()}


def check_matvec_kernel(dev):
    """The matvec's halves (``kernels/schur_matvec.py``) on the Venice
    instance at its start, against their plain versions (``ba._landmark_sum_plain``,
    ``_camera_sum_plain``) and a float64 sum: each kernel within float32's
    error bound of the float64 sum (``_matvec_error`` ≤ 1), two calls
    bit-equal; the plan's build, W's copy in camera order, each half's ms
    beside its bound and its plain ms, and each half over the tile sizes and
    lane groups around the plan's."""
    prob = venice_problem(dev)
    C, L, O = prob.camera_params.shape[0], prob.points.shape[0], prob.cam_idx.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = ba._plans(prob)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = k_matvec.matvec_plan(prob.cam_idx, prob.pt_idx, C, L)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    mesh, shards = ba._shards(prob)
    rows, _ = ba._linearize_shards(mesh, shards, [plans], prob.camera_params, prob.points)
    p, _, W, W_cam = rows[0]
    copy_ms = _time_ms(lambda: ba._shard_row(p, plans, W), MATVEC_REPS)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.randn(C, 6, generator=g, device=dev)
    s = torch.randn(L, 3, generator=g, device=dev)
    Wd, Wa = W.double(), W.double().abs()
    seg_l, seg_c = plans[1], plans[0]
    halves = dict(
        to_landmarks=dict(
            kernel=lambda: k_matvec.to_landmarks_cuda(plan, W, u),
            plain=lambda: ba._landmark_sum_plain(p, plans, W, u),
            ref=segment_sum(seg_l, torch.sum(Wd * u.double()[p.cam_idx][:, :, None], dim=1)),
            scale=segment_sum(seg_l, torch.sum(Wa * u.double().abs()[p.cam_idx][:, :, None], dim=1)),
            counts=torch.bincount(prob.pt_idx, minlength=L),
            n_bytes=72 * O + 8 * O + 4 * (L + 1) + 24 * C + 12 * L),
        to_cameras=dict(
            kernel=lambda: k_matvec.to_cameras_cuda(plan, W_cam, s),
            plain=lambda: ba._camera_sum_plain(p, plans, W, s),
            ref=segment_sum(seg_c, torch.sum(Wd * s.double()[p.pt_idx][:, None, :], dim=2)),
            scale=segment_sum(seg_c, torch.sum(Wa * s.double().abs()[p.pt_idx][:, None, :], dim=2)),
            counts=torch.bincount(prob.cam_idx, minlength=C),
            n_bytes=72 * O + 4 * O + 4 * (plan.n_tiles + 1) + 4 * (C + 1) + 12 * L + 24 * C),
    )
    del Wd, Wa
    print(f"schur matvec plan at the Venice shape (O={O} C={C} L={L}): built in {plan_s * 1e3:.2f} ms "
          f"({plan.nbytes / 1e6:.2f} MB; the CG engine's plans with it {plans_s * 1e3:.2f} ms), lanes a landmark "
          f"{1 << plan.group_log2}, tile {plan.tile} items, {plan.n_tiles} tiles; W in camera order written in "
          f"{copy_ms:.4f} ms a linearization")
    out = dict(O=O, C=C, L=L, plan_ms=plan_s * 1e3, plan_bytes=plan.nbytes, group=1 << plan.group_log2,
               tile=plan.tile, n_tiles=plan.n_tiles, camera_order_copy_ms=copy_ms)
    for name, h in halves.items():
        k, again, plain = h["kernel"](), h["kernel"](), h["plain"]()
        torch.cuda.synchronize()
        err = _matvec_error(k, h["ref"], h["scale"], h["counts"])
        err_plain = _matvec_error(plain, h["ref"], h["scale"], h["counts"])
        rel = float((k - plain).abs().max()) / float(plain.abs().max())
        same = torch.equal(k.view(torch.int32), again.view(torch.int32))
        t = _alternated(dict(plain=h["plain"], kernel=h["kernel"]), MATVEC_REPS)
        bound_ms = h["n_bytes"] / PEAK_BYTES * 1e3
        print(f"schur matvec {name}: error / float32 bound {err:.3e} (plain {err_plain:.3e}), max|k − plain| / "
              f"max|plain| {rel:.3e}, two calls bit-equal {same}; kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, bound {bound_ms:.4f} ms ({h['n_bytes'] / 1e6:.1f} MB by bytes)")
        if not torch.isfinite(k).all() or not err <= 1.0 or not same:
            raise AssertionError(f"schur matvec {name}: error {err} of its bound, bit-equal {same}")
        out[name] = dict(err=err, plain_err=err_plain, rel_plain=rel, ms=t["kernel"], plain_ms=t["plain"],
                         bound_ms=bound_ms, bytes=h["n_bytes"])
    counts = halves["to_cameras"]["counts"]
    sweep = {}
    for T in MATVEC_TILES:
        n = int(((counts + T - 1) // T).sum())
        tile_ptr, cam_tiles = k_matvec.tiles(counts, T, n)
        plan_t = dataclasses.replace(plan, tile=T, n_tiles=n, tile_ptr=tile_ptr.to(torch.int32),
                                     cam_tiles=cam_tiles.to(torch.int32))
        sweep[f"tile {T}"] = functools.partial(k_matvec.to_cameras_cuda, plan_t, W_cam, s)
    for gl in MATVEC_GROUPS:
        sweep[f"lanes {1 << gl}"] = functools.partial(k_matvec.to_landmarks_cuda,
                                                     dataclasses.replace(plan, group_log2=gl), W, u)
    t = _alternated(sweep, MATVEC_REPS)
    print("schur matvec sweep (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    out["sweep_ms"] = t
    return out


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
    res, _, wall_s = _solve_ba(prob)
    same = _same_bits(res, first)
    print(f"dense BA solved twice: walls {first_wall_s:.4f}, {wall_s:.4f} s; trials {sum(res.trace['trials'].tolist())} "
          f"and {sum(first.trace['trials'].tolist())}; trials, cost trace, cameras and points bit-equal: {same}")
    if not same:
        raise AssertionError("dense BA: a second solve of the same instance differs from the first")


def run_ba(prob):
    """The dense-BA main path: one solve_ba_dense call, as a user makes it
    (host grouping, the S build's plan and the step graph's capture
    included); K11 must launch once per trial inside the replayed graph, one
    S build for all segments, and once a trial of the capture's warm-up."""
    _reset_launches()
    res, cost, wall_s = _solve_ba(prob)
    launches, replayed = k_schur.launches(), k_schur.replayed()
    if k_nn.launches() or k_expand.launches():
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
    print(f"schur kernel launches on the BA path: {launches}: {replayed} replayed for {sum(trials)} trials (S "
          f"builds), {launches - replayed} in the capture's warm-up")
    if status == Status.NUMERIC_ERROR or not np.isfinite(cost):
        raise AssertionError(f"dense BA: status {status.name}, cost {cost}")
    if not torch.equal(res.camera_params[:2], prob.camera_params[:2]):
        raise AssertionError("dense BA: a fixed camera moved")
    if any(b > a for a, b in zip(costs, costs[1:])):
        raise AssertionError(f"dense BA: the accepted cost rose: {costs}")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"dense BA: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if replayed != sum(trials) or replayed == 0:
        raise AssertionError(f"the BA path launched the schur kernel {replayed} times in its graph")
    return res, launches, replayed, wall_s


def _chi2_floor(O, C, L, extra=0):
    """σ²·(2O − 6(C − 2) − 3L − extra): the expected optimum of the
    instance (two cameras fixed)."""
    return BA_SIGMA**2 * (2 * O - 6 * (C - 2) - 3 * L - extra)


def _same_bits(a, b):
    """The same trace (trials, the CG engine's PCG iterations, costs; a
    result with an empty trace, as the self-calibration's, has none),
    status, iterations, cameras, points and final cost, bit for bit."""
    return (
        a.trace.keys() == b.trace.keys()
        and all(torch.equal(_bits(a.trace[k]), _bits(b.trace[k])) for k in a.trace if a.trace[k].is_floating_point())
        and all(torch.equal(a.trace[k], b.trace[k]) for k in a.trace if not a.trace[k].is_floating_point())
        and torch.equal(a.status, b.status)
        and torch.equal(a.iterations, b.iterations)
        and torch.equal(_bits(a.camera_params), _bits(b.camera_params))
        and torch.equal(_bits(a.points), _bits(b.points))
        and torch.equal(_bits(a.cost), _bits(b.cost))
    )


def _solve_cg(prob, engine="cg"):
    """solve_ba through its entry point: (result, cost, wall s, host reads),
    with every kernel count set to 0 before it; no nn kernel may launch."""
    _reset_launches()
    reads = ba.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ba.solve_ba(prob, ba.BAConfig(), engine=engine)
    cost = float(res.cost)
    wall_s = time.perf_counter() - t0
    if k_nn.launches() or k_expand.launches():
        raise AssertionError("the BA path launched an nn kernel")
    return res, cost, wall_s, ba.HOST_READS - reads


def _check_descent(what, prob, res, cost):
    """No NUMERIC_ERROR, a finite cost, the fixed cameras unmoved and an
    accepted cost that never rises: returns the cost trace."""
    run = int(torch.isfinite(res.trace["cost"]).sum())
    costs = res.trace["cost"][:run].tolist() + [cost]
    status = Status(int(res.status))
    if status == Status.NUMERIC_ERROR or not np.isfinite(cost):
        raise AssertionError(f"{what}: status {status.name}, cost {cost}")
    if not torch.equal(res.camera_params[: prob.n_fixed_cameras], prob.camera_params[: prob.n_fixed_cameras]):
        raise AssertionError(f"{what}: a fixed camera moved")
    if any(b > a for a, b in zip(costs, costs[1:])):
        raise AssertionError(f"{what}: the accepted cost rose: {costs}")
    return costs


def _stages_text(stages):
    """A stage-times dict as one line: floats to 4 decimals."""
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in stages.items())


def _cg_stage_times(prob):
    """The CG engine's stages at the start of a solve, on an unsharded or an
    observation-sharded problem: ms (CUDA events over back-to-back calls, so
    the host's launch rate when it is the slower), device ms and launches
    (torch.profiler) of one ``_schur_matvec`` (a PCG iteration's matvec) and
    of one damped solve (``_solve_delta``, cg_iterations PCG iterations),
    and the mesh reductions of one matvec."""
    cfg = ba.BAConfig()
    mesh, shards = ba._shards(prob)
    plans = [ba._plans(s) for s in shards]
    dev = prob.camera_params.device

    def linearize():
        return ba._linearize_shards(mesh, shards, plans, prob.camera_params, prob.points)

    rows, (U, V, g, h, _) = linearize()
    lam = ba._seed_lambda(torch.full((), -1.0, dtype=g.dtype, device=dev), U, V, cfg.init_lambda_factor)
    U_d = ba._damp_blocks(U, lam)
    Vinv = ba._inv3x3(ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=g.dtype, device=dev))
    mask = ba._cam_mask(prob)
    u = torch.randn_like(g)

    def matvec():
        return ba._schur_matvec(u, U_d, Vinv, mesh, rows, mask)

    def solve():
        return ba._solve_delta(prob, U, V, g, h, lam, cfg, mesh, rows)

    solve()
    reductions = mesh_module.REDUCTIONS
    matvec()
    reductions = mesh_module.REDUCTIONS - reductions
    out = dict(matvec_ms=_time_ms(matvec, 20), solve_ms=_time_ms(solve, 3), linearize_ms=_time_ms(linearize, 5))
    out["matvec_launches"], out["matvec_device_ms"] = _device_profile(matvec)
    out["solve_launches"], out["solve_device_ms"] = _device_profile(solve)
    n = cfg.cg_iterations
    out.update(pcg_iteration_ms=out["solve_ms"] / n, pcg_iteration_device_ms=out["solve_device_ms"] / n,
               pcg_iteration_launches=out["solve_launches"] / n, pcg_iteration_reductions=reductions)
    return out


def run_ba_cg(prob, dense_res):
    """(a) the CG engine on the headline instance: within the dense phase's
    χ² band, fixed cameras unmoved, a non-increasing cost trace, no K11
    launch, and a second solve bit-equal."""
    res, cost, wall_s, reads = _solve_cg(prob)
    k11 = k_schur.launches()
    if k11:
        raise AssertionError(f"the CG engine launched the schur kernel {k11} times")
    costs = _check_descent("CG BA", prob, res, cost)
    floor = _chi2_floor(BA_O, BA_C, BA_L)
    run = len(costs) - 1
    trials = res.trace["trials"].tolist()
    print(
        f"CG BA O={BA_O} C={BA_C} L={BA_L} float32: wall {wall_s:.4f} s, outer iterations run {run} "
        f"(iterations {int(res.iterations)}), trials {sum(trials)} {trials[:run]}, "
        f"{wall_s / max(run, 1) * 1e3:.2f} ms per outer iteration, host reads {reads}, status "
        f"{Status(int(res.status)).name}, final cost {cost:.6e} vs chi2 floor {floor:.6e} "
        f"({(cost / floor - 1) * 100:+.4f}%; dense {(float(dense_res.cost) / floor - 1) * 100:+.4f}%)"
    )
    print(f"  cost trace {costs}")
    again, cost2, wall2_s, _ = _solve_cg(prob)
    same = _same_bits(res, again)
    print(f"CG BA solved twice: walls {wall_s:.4f}, {wall2_s:.4f} s; bit-equal: {same}; schur kernel launches 0")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"CG BA: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if not same:
        raise AssertionError("CG BA: a second solve of the same instance differs from the first")
    stages = _cg_stage_times(prob)
    print(f"CG BA stages at the start (CUDA events, launches by torch.profiler): {_stages_text(stages)}")
    return dict(wall_s=[wall_s, wall2_s], outer=run, trials=sum(trials), reads=reads, cost=cost,
                vs_floor=cost / floor - 1, ms_per_outer=wall_s / max(run, 1) * 1e3, k11=k11, **stages), res


def run_ba_routing(prob, dense_res):
    """(b) engine="auto": the headline routes to "dense" and equals the
    dense phase's solve bit for bit; the O=1M, C=4,000 instance routes to
    "cg", ends below its start with a non-increasing trace, launches no K11
    and repeats itself bit for bit."""
    route = ba.select_engine(prob)
    res, _, wall_s, _ = _solve_cg(prob, engine="auto")
    same = _same_bits(res, dense_res)
    print(f"auto routing, headline: {route}; solve_ba(engine='auto') wall {wall_s:.4f} s, K11 launches "
          f"{k_schur.launches()} ({k_schur.replayed()} replayed), bit-equal to solve_ba_dense: {same}")
    if route != "dense" or not same or k_schur.replayed() != sum(res.trace["trials"].tolist()):
        raise AssertionError("auto routing: the headline did not run the dense engine's solve")

    t0 = time.perf_counter()
    big = ba.make_ba_problem(BA_CG_O, BA_CG_C, BA_CG_L, seed=SEED, dtype=torch.float32, device=prob.points.device)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    route = ba.select_engine(big)
    route_s = time.perf_counter() - t0
    if route != "cg":
        raise AssertionError(f"auto routing: C={BA_CG_C} routed to {route}")
    res, cost, wall_s, reads = _solve_cg(big, engine="auto")
    k11 = k_schur.launches()
    if k11:
        raise AssertionError("the CG route launched the schur kernel")
    costs = _check_descent("CG BA (routed)", big, res, cost)
    if not cost < costs[0]:
        raise AssertionError(f"CG BA (routed): final cost {cost} is not below the start {costs[0]}")
    floor = _chi2_floor(BA_CG_O, BA_CG_C, BA_CG_L)
    again, _, wall2_s, _ = _solve_cg(big, engine="auto")
    same = _same_bits(res, again)
    run = len(costs) - 1
    print(
        f"auto routing, O={BA_CG_O} C={BA_CG_C} L={BA_CG_L} float32 (made in {made_s:.3f} s, routed in "
        f"{route_s:.3f} s): {route}; walls {wall_s:.4f}, {wall2_s:.4f} s, outer iterations {run}, trials "
        f"{sum(res.trace['trials'].tolist())}, {wall_s / max(run, 1) * 1e3:.2f} ms per outer iteration, "
        f"host reads {reads}, status {Status(int(res.status)).name}, cost {costs[0]:.6e} -> {cost:.6e}, chi2 "
        f"floor {floor:.6e} ({(cost / floor - 1) * 100:+.4f}%), bit-equal: {same}"
    )
    print(f"  cost trace {costs}")
    if not same:
        raise AssertionError("CG BA (routed): a second solve differs from the first")
    stages = _cg_stage_times(big)
    print(f"  stages at the start: {_stages_text(stages)}")
    return dict(wall_s=[wall_s, wall2_s], outer=run, reads=reads, start=costs[0], cost=cost,
                vs_floor=cost / floor - 1, k11=k11, **stages), big, res


def _selfcal_start(prob):
    """prob with its intrinsics off by SELFCAL_WRONG."""
    wrong = torch.tensor(SELFCAL_WRONG, dtype=prob.intrinsics.dtype).to(prob.intrinsics.device)
    return dataclasses.replace(prob, intrinsics=prob.intrinsics + wrong)


def _solve_selfcal(prob):
    """solve_ba_selfcal through its entry point: (result, θ, cost, wall s,
    host reads, mesh reductions), with every kernel count set to 0 before it;
    no kernel may launch."""
    _reset_launches()
    reads, reductions = ba.HOST_READS, mesh_module.REDUCTIONS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, intr = ba_intrinsics.solve_ba_selfcal(prob, ba.BAConfig())
    cost = float(res.cost)
    wall_s = time.perf_counter() - t0
    if k_schur.launches() or k_nn.launches() or k_expand.launches():
        raise AssertionError("self-calibrating BA launched a kernel of another path")
    return res, intr, cost, wall_s, ba.HOST_READS - reads, mesh_module.REDUCTIONS - reductions


def _selfcal_early(prob):
    """(cost, cost_new) of the first SHARDED_BA_TRACE_ITERS outer iterations
    of ``ba_step_selfcal`` from λ = −1, as ``solve_ba_selfcal`` steps."""
    lam, out = -1.0, []
    for _ in range(SHARDED_BA_TRACE_ITERS):
        cams, pts, intr, lam, _, _, rec = ba_intrinsics.ba_step_selfcal(prob, lam)
        prob = dataclasses.replace(prob, camera_params=cams, points=pts, intrinsics=intr)
        out.append([float(rec["cost"]), float(rec["cost_new"])])
    return out


def _hold_selfcal(what, sp, res, intr, cost, truth):
    """A self-calibration's end: a finite cost within BA_BAND of its χ²
    floor, fixed cameras unmoved, the intrinsics within SELFCAL_INTR_TOL of
    the true ones. Returns (floor, intrinsics error)."""
    floor = _chi2_floor(BA_O, BA_C, BA_L, extra=4)
    err = (intr - truth).abs().max().item()
    if not np.isfinite(cost):
        raise AssertionError(f"{what}: status {Status(int(res.status)).name}, cost {cost}")
    if not torch.equal(res.camera_params[: sp.n_fixed_cameras], sp.camera_params[: sp.n_fixed_cameras]):
        raise AssertionError(f"{what}: a fixed camera moved")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"{what}: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if not err <= SELFCAL_INTR_TOL:
        raise AssertionError(f"{what}: intrinsics {intr.tolist()} are {err} px from the true ones")
    return floor, err


def _selfcal_stage_times(prob):
    """One damped self-calibrating solve (``_solve_delta_full``,
    cg_iterations PCG iterations) at the start, on an unsharded or an
    observation-sharded problem: ms (CUDA events), device ms and launches
    (torch.profiler) a PCG iteration, and the mesh reductions of the solve."""
    cfg = ba.BAConfig()
    mesh, shards = ba._shards(prob)
    plans = [ba._plans(s) for s in shards]
    rows, sums = ba_intrinsics._linearize_shards_full(mesh, shards, plans,
                                                       (prob.camera_params, prob.points, prob.intrinsics))
    blocks = sums[:-1]
    lam = ba._seed_lambda(torch.full((), -1.0, dtype=prob.points.dtype, device=prob.points.device),
                          blocks[0], blocks[1], cfg.init_lambda_factor)

    def solve():
        return ba_intrinsics._solve_delta_full(prob, blocks, lam, cfg, mesh, rows)

    solve()
    reductions = mesh_module.REDUCTIONS
    solve()
    reductions = mesh_module.REDUCTIONS - reductions
    solve_ms = _time_ms(solve, 3)
    launches, device_ms = _device_profile(solve)
    n = cfg.cg_iterations
    return dict(solve_ms=solve_ms, pcg_iteration_ms=solve_ms / n, pcg_iteration_device_ms=device_ms / n,
                pcg_iteration_launches=launches / n, solve_reductions=reductions)


def run_selfcal(prob):
    """(c) solve_ba_selfcal from intrinsics off by SELFCAL_WRONG: within
    ±1% of its χ² floor (4 unknowns more), the intrinsics within
    SELFCAL_INTR_TOL of the true ones, no kernel launch; plain solve_ba from
    the same wrong intrinsics ends above that band. Returns (numbers, the
    start, the result, θ, the first outer iterations' costs)."""
    wrong = _selfcal_start(prob)
    res, intr, cost, wall_s, reads, _ = _solve_selfcal(wrong)
    k11 = k_schur.launches()
    floor, err = _hold_selfcal("self-cal BA", wrong, res, intr, cost, prob.intrinsics)
    status = Status(int(res.status))
    if status == Status.NUMERIC_ERROR:
        raise AssertionError("self-cal BA: status NUMERIC_ERROR")
    # outer iterations run: the terminal one is not counted in `iterations`
    run = int(res.iterations) + (status != Status.MAXIMUM_ITERATIONS_REACHED)
    _, plain_cost, plain_wall_s, _ = _solve_cg(wrong)
    print(
        f"self-calibrating BA O={BA_O} C={BA_C} L={BA_L} float32 from intrinsics {SELFCAL_WRONG} off: wall "
        f"{wall_s:.4f} s, iterations {int(res.iterations)}, host reads {reads}, "
        f"{wall_s / max(run, 1) * 1e3:.2f} ms per outer iteration, status {status.name}, "
        f"cost {cost:.6e} vs chi2 floor {floor:.6e} ({(cost / floor - 1) * 100:+.4f}%), intrinsics "
        f"{intr.tolist()}, max|error| {err:.4e} px (bound {SELFCAL_INTR_TOL:g}); plain solve_ba from them: cost "
        f"{plain_cost:.6e} ({(plain_cost / floor - 1) * 100:+.4f}%), wall {plain_wall_s:.4f} s"
    )
    if not plain_cost > floor * (1 + BA_BAND):
        raise AssertionError(f"plain BA from the wrong intrinsics ended inside the band: {plain_cost}")
    stages = _selfcal_stage_times(wrong)
    print(f"  self-cal stages at the start: {_stages_text(stages)}")
    out = dict(wall_s=wall_s, iterations=int(res.iterations), ms_per_outer=wall_s / max(run, 1) * 1e3, reads=reads,
               cost=cost, vs_floor=cost / floor - 1, k11=k11, intrinsics_err=err,
               plain_vs_floor=plain_cost / floor - 1, **stages)
    return out, wrong, res, intr, _selfcal_early(wrong)


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


# Phase 19: the host calls the profiler counts as launches of work on the card.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def _launch_profile(fn):
    """One fn() under torch.profiler: (its result, the host's launch calls
    by name, the device ms (its device events' durations summed), the
    wall s of the profiled call). Reads the profiler's raw events: building
    its event tree for an eager solve's ~50,000 launches takes longer than
    the solve."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    calls, device_ns = dict.fromkeys(LAUNCH_CALLS, 0), 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device_ns += e.duration_ns()
        elif e.name() in calls:
            calls[e.name()] += 1
    return out, calls, device_ns / 1e6, wall_s


def _timed_solve(fn):
    """(result, wall s, host reads) of fn(), ending in a synchronisation."""
    reads = ba.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ba.HOST_READS - reads


def _ba_result(r):
    """The BAResult of a solve (the self-calibration also returns θ)."""
    return r if isinstance(r, ba.BAResult) else r[0]


def _outer_run(res):
    """Outer iterations a solve ran: the terminal one is not counted in
    ``iterations``."""
    return int(res.iterations) + (Status(int(res.status)) != Status.MAXIMUM_ITERATIONS_REACHED)


def _matvec_runs(res):
    """The PCG iterations and trials of a CG solve's trace, which each run
    both halves of the Schur matvec once a shard (the trials: the rhs and
    the back-substitution); None for a trace without PCG iterations."""
    if "pcg_iterations" not in res.trace:
        return None
    return sum(res.trace["pcg_iterations"].tolist()) + sum(res.trace["trials"].tolist())


def _hold_matvec_launches(what, runs, replayed, eager_in_graph, dense):
    """The matvec kernels' launches in a graph's solve: none eager, 2 a run
    on every shard (``runs`` counts shards × runs; None for a solve whose
    trace counts no PCG iterations, then some), none on a path without the
    CG engine (``dense``)."""
    expected = 0 if dense else None if runs is None else 2 * runs
    print(f"  {what}: schur matvec replayed {replayed} (expected {'some' if expected is None else expected}), "
          f"eager {eager_in_graph}")
    if eager_in_graph or (replayed != expected if expected is not None else replayed <= 0):
        raise AssertionError(f"{what}: schur matvec replayed {replayed}, eager {eager_in_graph}, for {runs} runs")


def _matvec_by_card(groups):
    """The matvec kernels' replayed launches on each card of ``groups``
    (``Mesh.card_groups()``), by the card's name."""
    by_card = k_matvec.replayed_by_card()
    return {str(d): by_card.get(d, 0) for d, _ in groups}


def _matvec_card_runs(res, groups, lm, selfcal):
    """What ``_matvec_by_card`` must read after a graph's solve: 2 a run
    (``_matvec_runs``) for each shard on the card in a CG solve, 0 without
    the CG engine; None for a self-calibration (its trace counts no PCG
    iterations: some on every card)."""
    runs = None if lm else _matvec_runs(res)
    if runs is None and selfcal:
        return None
    return {str(d): 2 * len(js) * (runs or 0) for d, js in groups}


def _matvec_cards_ok(replayed, expected):
    return all(v > 0 for v in replayed.values()) if expected is None else replayed == expected


def run_device_loop(prob, wrong):
    """19: the three BA steps as CUDA-graph replays on the headline. Each
    engine's solve through the graph (host_loop=False, and host_loop=True
    where the entry point has it) must equal its step's body run eagerly on
    the card bit for bit (``device_loop.eager()``), read the device at most
    once (host_loop=False) or once an outer iteration (host_loop=True), and
    one step must be one graph launch; the dense solve's replayed K11
    launches must equal its trials. Reported beside the eager body's
    figures: walls, host reads, launch calls, device ms and busy share, and
    every capture's warm-up, capture and instantiation ms and pool bytes."""
    cfg = ba.BAConfig()
    # cuSOLVER, not MAGMA (whose calls synchronise and cannot be captured),
    # must serve the captured factorizations: the default backend does
    print(f"device loop: linalg backend {torch.backends.cuda.preferred_linalg_library()}")
    cases = (
        ("ba_step", lambda **kw: ba.solve_ba(prob, cfg, **kw), lambda: ba.ba_step(prob, -1.0, cfg)),
        ("ba_step_dense", lambda **kw: ba_dense.solve_ba_dense(prob, **kw),
         lambda: ba_dense.ba_step_dense(prob, ba_dense._grouping(prob), -1.0)),
        ("ba_step_selfcal", lambda **kw: ba_intrinsics.solve_ba_selfcal(wrong, cfg),
         lambda: ba_intrinsics.ba_step_selfcal(wrong, -1.0, cfg)),
    )
    out = {}
    for name, solve, step in cases:
        solve()  # the graph is captured (or was, in an earlier phase)
        _reset_launches()
        graph, graph_s, graph_reads = _timed_solve(solve)
        replayed = k_schur.replayed()
        mv_replayed, mv_eager_in_graph = k_matvec.replayed(), k_matvec.LAUNCHES
        host, host_s, host_reads = _timed_solve(lambda: solve(host_loop=True))
        _reset_launches()
        with device_loop.eager():
            eager, eager_s, eager_reads = _timed_solve(solve)
        eager_k11 = k_schur.launches()
        same = [_same_bits(_ba_result(r), _ba_result(eager)) for r in (graph, host)]
        if name == "ba_step_selfcal":
            same.append(torch.equal(graph[1], eager[1]) and torch.equal(host[1], eager[1]))
        run = _outer_run(_ba_result(graph))
        trials = sum(_ba_result(graph).trace["trials"].tolist()) if _ba_result(graph).trace else None
        _, g_calls, g_dev_ms, g_prof_s = _launch_profile(solve)
        with device_loop.eager():
            _, e_calls, e_dev_ms, e_prof_s = _launch_profile(solve)
        replays = sum(loop.replays for loop, _ in device_loop._LOOPS.values())
        step()
        step_replays = sum(loop.replays for loop, _ in device_loop._LOOPS.values()) - replays
        row = dict(
            outer=run, trials=trials, bit_equal=all(same),
            graph_s=graph_s, host_loop_s=host_s, eager_s=eager_s,
            reads=dict(graph=graph_reads, host_loop=host_reads, eager=eager_reads),
            launches=dict(graph=g_calls, eager=e_calls), step_replays=step_replays,
            device_ms=dict(graph=g_dev_ms, eager=e_dev_ms),
            busy=dict(graph=g_dev_ms / 1e3 / g_prof_s, eager=e_dev_ms / 1e3 / e_prof_s),
            profiled_s=dict(graph=g_prof_s, eager=e_prof_s), k11_replayed=replayed, k11_eager=eager_k11,
            matvec_replayed=mv_replayed, matvec_runs=_matvec_runs(_ba_result(graph)),
        )
        out[name] = row
        print(f"device loop, {name} (headline O={BA_O} C={BA_C} L={BA_L} float32): outer iterations {run}, trials "
              f"{trials}; walls graph {graph_s:.4f} s, host_loop=True {host_s:.4f} s, eager body {eager_s:.4f} s; "
              f"host reads graph {graph_reads}, host_loop=True {host_reads}, eager {eager_reads}; bit-equal to the "
              f"eager body: {all(same)}; K11 replayed {replayed}, eager {eager_k11}")
        print(f"  launch calls a solve: graph {g_calls}, eager {e_calls}; device ms graph {g_dev_ms:.3f} (busy "
              f"{row['busy']['graph']:.3f} of {g_prof_s:.4f} s profiled), eager {e_dev_ms:.3f} (busy "
              f"{row['busy']['eager']:.3f} of {e_prof_s:.4f} s); graph replays of one step {step_replays}")
        if not all(same):
            raise AssertionError(f"device loop, {name}: the graph's solve differs from its eager body")
        if name != "ba_step_selfcal" and graph_reads > 1:
            raise AssertionError(f"device loop, {name}: {graph_reads} host reads with host_loop=False")
        if host_reads != run:
            raise AssertionError(f"device loop, {name}: {host_reads} host reads for {run} outer iterations")
        if name == "ba_step_selfcal" and graph_reads != run:
            raise AssertionError(f"device loop, {name}: {graph_reads} host reads for {run} outer iterations")
        # a replay a step: max_iterations of them a device-loop solve, one an
        # outer iteration run in the self-calibration's host loop
        replays = run if name == "ba_step_selfcal" else cfg.max_iterations
        if step_replays != 1 or g_calls["cudaGraphLaunch"] != replays:
            raise AssertionError(f"device loop, {name}: a step made {step_replays} replays, a solve "
                                 f"{g_calls['cudaGraphLaunch']} graph launches")
        if name == "ba_step_dense" and (replayed != trials or eager_k11 != trials):
            raise AssertionError(f"device loop: K11 replayed {replayed} and eager {eager_k11} for {trials} trials")
        if name != "ba_step_dense" and (replayed or eager_k11):
            raise AssertionError(f"device loop, {name}: K11 launched")
        _hold_matvec_launches(f"device loop, {name}", row["matvec_runs"], mv_replayed, mv_eager_in_graph,
                              dense=name == "ba_step_dense")
    out["captures"] = list(device_loop.CAPTURES)
    for c in device_loop.CAPTURES:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
    return out


# Phase 20: the starts of the multistart, the rational problem's basins (as
# tests/test_torch_batched_solver.py's), and the paths that are profiled.
LM_MULTISTART_X0 = [[0.9, 0.2], [1.9, 1.5], [50.0, -40.0], [-3.0, 0.01]]
LM_PROFILED = ("icp_A", "fleet", "pair_grid", "pair_brute")


def _same_result(a, b):
    """Two results (dataclasses, dicts, sequences of tensors) equal bit for
    bit; what is not a tensor compares by ==."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            _bits(a) if a.is_floating_point() else a, _bits(b) if b.is_floating_point() else b)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(_same_result(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_result(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_result(x, y) for x, y in zip(a, b))
    return a == b


def _lm_timed(fn):
    """(result, wall s, host reads of the LM loops) of fn(), between two
    synchronisations."""
    reads = solver.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, solver.HOST_READS - reads


def _lm_cases(cloud, srcs, tgts, scans, dev):
    """Phase 20's paths: (name, fn, the kernel the path must launch or None,
    the runs it must launch it: a function of the result)."""
    tgt_a = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))
    refs = reference_problems(dev)
    curve = refs[0][1]
    rat = rational.rational_block(torch.as_tensor(rational.SIMPLE_X, device=dev),
                                  torch.as_tensor(rational.SIMPLE_Y, device=dev), analytic=True, dtype=torch.float32)
    starts = torch.as_tensor(LM_MULTISTART_X0, dtype=torch.float32, device=dev)
    zero2 = torch.zeros(2, dtype=torch.float32, device=dev)

    def passes(res):
        return int(torch.isfinite(res.trace["cost"]).any(0).sum())

    cases = [
        ("icp_A", lambda: icp(cloud, tgt_a), k_nn, _outer_run),
        ("fleet", lambda: icp_batched(srcs, tgts, loss=TrivialLoss()), k_expand, passes),
        ("multistart", lambda: solve_multistart(rat, starts, LMConfig(max_iterations=40)), None, None),
        ("lm_step", lambda: lm_step(curve, zero2, -1.0, LMConfig(linear_solver="cholesky")), None, None),
    ]
    for name, block, x0, fields, man, _ in refs:  # state_model and sphere_quaternion: manifold solves
        cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", **fields)
        x0 = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
        cases.append((f"reference_{name}", functools.partial(levenberg_marquardt, block, x0, cfg, manifold=man),
                      None, None))
    seq = [sc.to(dev) for sc in scans[:3]]
    seed = None
    for search, backend in (("grid", "grid"), ("brute", "auto")):  # "auto": K5 at 32,768 targets
        reg = PairwiseRegistrar(config=SLAM_CONFIG, max_corr_dist=SLAM_GATE, nn_backend=backend)
        seed = reg.register(seq[1], seq[0]).x  # the stream's first pair: its grid capacities, a seed
        cases.append((f"pair_{search}", functools.partial(reg.register, seq[2], seq[1], x0=seed),
                      k_nn if search == "brute" else None, _outer_run))
    for name, fn in (("point2plane", point2plane), ("gicp", gicp_solve)):
        cases.append((name, functools.partial(fn, seq[2], seq[1], seed, max_corr_dist=SLAM_GATE), k_nn, _outer_run))
    return cases


def run_lm_device_loop(cloud, srcs, tgts, scans, gt, dev):
    """20: the LM solves as CUDA-graph replays. Each path's solve through its
    graph (captured at its layout's first solve) must equal its step's body
    run eagerly on the card (``device_loop.eager()``, on the capture's
    cuSOLVER and cuBLAS routes: ``capturable_linalg``) bit for bit, read
    the device 0 times, and replay K5 (K6) as often as the eager body
    launches it: once an outer iteration run (a pass). Reported beside the eager
    body's: walls, host reads, and for the paths of LM_PROFILED launch calls,
    device ms and busy share. Then ``scan_slam`` icp over the 64 scans from
    an empty layout cache, by its graphs and eagerly: frames/s each, and
    the run's captures, all made by its first two registrations (the
    first pair's coarse multistart and pair solve); and every capture's
    warm-up, capture and instantiation ms and pool bytes."""
    print(f"LM device loop: linalg backend {torch.backends.cuda.preferred_linalg_library()} (the LM loops capture "
          f"on cuSOLVER and cuBLAS)")
    out, first_capture = {}, len(device_loop.CAPTURES)
    for name, fn, kernel, runs in _lm_cases(cloud, srcs, tgts, scans, dev):
        n0 = len(device_loop.CAPTURES)
        _, first_s, _ = _lm_timed(fn)  # the layout's capture, unless an earlier phase made it
        captured = len(device_loop.CAPTURES) - n0
        _reset_launches()
        graph, graph_s, graph_reads = _lm_timed(fn)
        replayed = kernel.replayed() if kernel else 0
        eager_in_graph = k_nn.LAUNCHES + k_expand.LAUNCHES
        _reset_launches()
        with device_loop.eager(), capturable_linalg(dev):
            eager, eager_s, eager_reads = _lm_timed(fn)
        eager_k = kernel.launches() if kernel else 0
        expect = runs(graph) if runs else 0
        same = _same_result(graph, eager)
        row = dict(first_s=first_s, captured=captured, graph_s=graph_s, eager_s=eager_s,
                   reads=dict(graph=graph_reads, eager=eager_reads), bit_equal=same,
                   kernel_replayed=replayed, kernel_eager=eager_k, kernel_runs=expect)
        if name in LM_PROFILED:
            _, g_calls, g_ms, g_s = _launch_profile(fn)
            with device_loop.eager(), capturable_linalg(dev):
                _, e_calls, e_ms, e_s = _launch_profile(fn)
            row.update(launches=dict(graph=g_calls, eager=e_calls), device_ms=dict(graph=g_ms, eager=e_ms),
                       busy=dict(graph=g_ms / 1e3 / g_s, eager=e_ms / 1e3 / e_s))
        if name == "fleet":
            row["alignments_per_s"] = dict(graph=srcs.shape[0] / graph_s, eager=srcs.shape[0] / eager_s)
        out[name] = row
        print(f"LM device loop, {name}: first call {first_s:.4f} s ({captured} captures), graph {graph_s:.4f} s, "
              f"eager body {eager_s:.4f} s; host reads graph {graph_reads}, eager {eager_reads}; bit-equal "
              f"{same}" + (f"; {kernel.NAME} replayed {replayed}, eager {eager_k}, runs {expect}" if kernel else "")
              + (f"; launch calls graph {row['launches']['graph']}, eager {row['launches']['eager']}; device ms "
                 f"graph {row['device_ms']['graph']:.3f} (busy {row['busy']['graph']:.3f}), eager "
                 f"{row['device_ms']['eager']:.3f} (busy {row['busy']['eager']:.3f})" if "launches" in row else ""))
        if not same:
            raise AssertionError(f"LM device loop, {name}: the graph's solve differs from its eager body")
        if graph_reads != 0 or eager_in_graph:
            raise AssertionError(f"LM device loop, {name}: {graph_reads} host reads, {eager_in_graph} eager "
                                 f"kernel launches by the graph's solve")
        if kernel and not replayed == eager_k == expect > 0:
            raise AssertionError(f"LM device loop, {name}: {kernel.NAME} replayed {replayed}, eager {eager_k}, "
                                 f"for {expect} outer iterations (passes)")
    if out["fleet"]["alignments_per_s"]["graph"] <= 0:
        raise AssertionError("LM device loop: no fleet wall")

    # a SLAM run's captures: made by its first registrations, not one a pair
    device_loop.clear()
    registration._MATCHERS.clear()
    n0 = len(device_loop.CAPTURES)
    _, _, _, graph_run = run_scan_slam(scans, gt, "icp", dev)
    made = [p["captures"] - n0 for p in graph_run["reg"].pairs]
    with device_loop.eager():
        _, _, _, eager_run = run_scan_slam(scans, gt, "icp", dev)
    slam = dict(fps=dict(graph=graph_run["fps"], eager=eager_run["fps"]),
                steady_ms=dict(graph=graph_run["steady_ms"], eager=eager_run["steady_ms"]),
                captures=made[-1], captures_after_pair=made[:3], registrations=len(made))
    out["scan_slam_icp"] = slam
    print(f"LM device loop, scan_slam icp over {len(scans)} scans: frames/s graph {slam['fps']['graph']:.2f}, eager "
          f"body {slam['fps']['eager']:.2f}; steady ms a pair graph {slam['steady_ms']['graph']:.2f}, eager "
          f"{slam['steady_ms']['eager']:.2f}; captures {made[-1]} for {len(made)} registrations (after the first "
          f"three: {made[:3]})")
    if made[-1] != made[1] or made[-1] > 4:
        raise AssertionError(f"LM device loop: the SLAM run's captures grew with its pairs: {made}")
    out["captures"] = device_loop.CAPTURES[first_capture:]
    for c in out["captures"]:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
    return out


def _quat_rot(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def reference_problems(dev):
    """The reference's problem set in float32 on ``dev``: the 9 problems of
    tests/trace_problems.py from their starts, and the Sphere(4) quaternion
    fit of tests/test_state_model.py. Each entry: (name, block, x0, LMConfig
    fields beyond auto/cholesky, manifold, check(x, cost) → (error, bound))."""
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def x_err(ref, bound):
        return lambda x, cost: (float((x.cpu() - torch.as_tensor(ref, dtype=f32)).abs().max()), bound)

    curve = curve_fitting.exponential_curve_block(t(curve_fitting.CERES_CURVE_DATA), dtype=f32)
    cam_block = camera.camera_reprojection_block(t(CAMERA_POINTS), t(CAMERA_PIXELS))
    m = so3.exp(t([0.15, -0.1, 0.2])) @ t(accelerometer.GRAVITY)
    anchor_rot, anchor_lin = t([0.1, 0.2, 0.3]), t(np.concatenate([[-0.4, 0.11, -0.9], np.zeros(9)]))
    R_anchor = so3.exp(anchor_rot)
    src = torch.as_tensor(load_txt_cloud(FACHADA), dtype=f32, device=dev)
    x_p2p = [10.5, 10.2, 0.1, 0.3, 0.4, 0.5]
    T = se3.transform_from_params6(t(x_p2p))
    rng = np.random.default_rng(4)
    q_true = rng.normal(size=4)
    q_true /= np.linalg.norm(q_true)
    vs = t(rng.normal(size=(12, 3)))
    sphere = make_block(lambda q, d: d["m"] - _quat_rot(q) @ d["v"],
                        data=dict(v=vs, m=vs @ _quat_rot(t(q_true)).T))

    def state_err(x, cost):
        e_rot = float((so3.exp(x[:3]) - R_anchor).abs().max())
        return max(e_rot, float((x[3:] - anchor_lin).abs().max())), STATE_F32_BOUND

    def sphere_err(x, cost):
        q = x.cpu().double().numpy()
        q = -q if q @ q_true < 0 else q
        return max(abs(np.linalg.norm(q) - 1.0), float(np.abs(q - q_true).max())), SPHERE_F32_BOUND

    state = product_state_block(anchor_rot, anchor_lin)
    product = manifold.Product(parts=(manifold.SO3(), manifold.Euclidean(12)))
    ceres = F32_CAMERA_CERES
    return [
        ("curve_near", curve, [0.0, 0.0], {}, None, x_err(CURVE_MINIMUM, 5e-5)),
        ("curve_far", curve, [1.2, 2.0], dict(max_iterations=50), None, x_err(CURVE_MINIMUM, 1e-4)),
        ("powell", powell.powell_block(analytic=True), [3.0, -1.0, 0.0, 4.0], dict(max_iterations=25), None,
         x_err(np.zeros(4), 1e-2)),
        ("simple_rational", rational.rational_block(t(rational.SIMPLE_X), t(rational.SIMPLE_Y), analytic=True,
                                                    dtype=f32), [0.9, 0.2], {}, None, x_err([0.362, 0.556], 0.01)),
        ("camera_calibration", cam_block, np.zeros(6), {}, None, x_err(ceres, 2e-3)),
        ("camera_calibration_bad", cam_block, [0.5, 0.5, 0.5, 0.2, 0.5, 0.5], dict(max_iterations=50), None,
         x_err(ceres, 2e-3)),
        ("accelerometer", accelerometer.accelerometer_block(m, analytic=True), [0.1, 0.0, 0.0],
         dict(init_lambda_factor=1e-6), None, lambda x, cost: (cost, 1e-6)),
        ("state_model", state, np.concatenate([[0.9, -0.8, 0.6, 1.5, -2.0, 0.5], np.zeros(9)]),
         dict(max_iterations=10), product, state_err),
        ("point2point", point2point_block(src, se3.apply_transform(T, src)), np.zeros(6), {}, None,
         x_err(x_p2p, 2e-3)),
        ("sphere_quaternion", sphere, [1.0, 0.0, 0.0, 0.0], dict(max_iterations=30), manifold.Sphere(4),
         sphere_err),
    ]


def run_reference_problems(dev):
    """(d) the reference's problem set on the card in float32, by AD with
    the Cholesky solve, each held to its bound of tests/test_f32_envelope.py
    (the state and the Sphere fit to STATE_F32_BOUND and SPHERE_F32_BOUND)."""
    out = {}
    for name, block, x0, fields, man, check in reference_problems(dev):
        cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", **fields)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = levenberg_marquardt(block, torch.as_tensor(np.asarray(x0, np.float32), device=dev), cfg,
                                  manifold=man)
        cost = float(res.cost)
        wall_s = time.perf_counter() - t0
        err, bound = check(res.x, cost)
        status = Status(int(res.status))
        print(f"reference problem {name} float32 on {res.x.device}: status {status.name}, iterations "
              f"{int(res.iterations)}, cost {cost:.4e}, error {err:.3e} (bound {bound:g}), wall {wall_s:.4f} s")
        if res.x.dtype != torch.float32 or res.x.device.type != dev.type:
            raise AssertionError(f"{name}: the solve left float32 on the card")
        if status == Status.NUMERIC_ERROR or not err <= bound:
            raise AssertionError(f"{name}: status {status.name}, error {err} above {bound}")
        out[name] = dict(status=status.name, iterations=int(res.iterations), error=err, bound=bound, wall_s=wall_s)
    return out


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


def _device_profile(fn):
    """(cudaLaunchKernel calls, device ms) of one fn() under torch.profiler:
    the device time is the sum of its device events' durations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device_us = sum(e.time_range.elapsed_us() for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    return sum(e.name == "cudaLaunchKernel" for e in events), device_us / 1e3


def _launches_of(fn):
    """cudaLaunchKernel calls of one fn() under torch.profiler."""
    return _device_profile(fn)[0]


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
    time, its result, the grid host reads it made and the captures of the
    run so far (Python counters: nothing is read from the card while it
    runs), and for the first registration the K5 and K6 launches it made
    and K6's replayed ones (counted on the card when replayed: read after
    its wall is taken)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.pairs = []
        self.redos = 0

    def register(self, src, tgt_cloud, x0=None, *, defer_overflow=False):
        first = not self.pairs
        if first:
            k5, k6, k6_replayed = k_nn.launches(), k_expand.launches(), k_expand.replayed()
        reads = grid_nn.HOST_READS
        t0 = time.perf_counter()
        out = super().register(src, tgt_cloud, x0, defer_overflow=defer_overflow)
        self.pairs.append(dict(
            wall=time.perf_counter() - t0, res=out[0] if defer_overflow else out, deferred=defer_overflow,
            grid_reads=grid_nn.HOST_READS - reads, captures=len(device_loop.CAPTURES),
        ))
        if first:
            self.pairs[0].update(k5=k_nn.launches() - k5, k6=k_expand.launches() - k6,
                                 k6_replayed=k_expand.replayed() - k6_replayed)
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
    _reset_launches()
    grid_nn.HOST_READS = grid_nn.FALLBACKS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, rels = scan_odometry(seq, registrar=reg)
    poses = poses.cpu()
    front_s = time.perf_counter() - t0
    k5, k6, reads, falls = k_nn.launches(), k_expand.launches(), grid_nn.HOST_READS, grid_nn.FALLBACKS
    if k_schur.launches():
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
        _reset_launches()
        reads, n_captures = pose_graph.HOST_READS, len(device_loop.CAPTURES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, poses_odo = odometry.scan_slam(seq, method=method, loop_closures=SLAM_LOOPS, config=SLAM_CONFIG,
                                               information_scale=SLAM_INFORMATION,
                                               loop_information_scale=SLAM_INFORMATION,
                                               nn_backend="auto", max_corr_dist=SLAM_GATE)
        poses = result.poses.cpu()
        wall_s = time.perf_counter() - t0
        k5, k6 = k_nn.launches(), k_expand.launches()
        pgo_reads = pose_graph.HOST_READS - reads
    pgo_captures = sum(c["name"].startswith("pgo_step") for c in device_loop.CAPTURES[n_captures:])
    if k_schur.launches():
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
        f"{pgo_status.name}, iterations {int(result.iterations)}, host reads {pgo_reads}, captures {pgo_captures}; "
        f"K5 launches {k5}, K6 launches {k6} (first pair {pairs[0]['k6']}, {pairs[0]['k6_replayed']} of them "
        f"replayed); ATE odometry {ate_odo:.6f} m, SLAM {ate:.6f} m (align=False); "
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
    # by its graphs the first pair's coarse multistart replays K6
    if device_loop.graphs(poses_odo) and pairs[0]["k6_replayed"] == 0:
        raise AssertionError(f"scan_slam {method}: the first pair replayed no K6 launch")
    run = dict(wall_s=wall_s, front_s=front_s, first_s=first_s, steady_ms=steady_s * 1e3, loops_s=loops_s,
               pgo_s=pgo_s, fps=fps, ate_odo=ate_odo, ate=ate, k5=k5, k6=k6, k6_first_replayed=pairs[0]["k6_replayed"],
               pgo_reads=pgo_reads, pgo_captures=pgo_captures, reg=reg)
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


def _f64_gap(poses, ref):
    return float((poses.double() - ref).abs().max())


def pgo_repeat_and_cg(graph, config, first):
    """The SLAM graph's PGO again (bit-equal poses, equal iterations and
    status), with unit information (shown, not checked), by CG, and in
    float64: the float32 dense and CG solves each within PGO_F64_BOUND of the
    float64 optimum; from the odometry start the solve stopped after one
    outer iteration, and the start itself, are shown against the bound; from
    a drifted start (PGO_DRIFT_SEED) the full float32 solve must end inside
    it and the one stopped after one outer iteration outside. The
    CG-against-dense gap is shown beside PGO_CG_GAP. Returns the CG
    solve."""
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
          f"(PGO_CG_GAP {PGO_CG_GAP:g}, shown)")
    if not same:
        raise AssertionError("PGO: a second solve of the SLAM graph differs from the first")

    g64 = dataclasses.replace(graph, poses=graph.poses.double(), measurements=graph.measurements.double(),
                              information=graph.information.double())
    opt = pose_graph.solve_pgo(g64, config)
    ref = opt.poses
    if int(opt.status) not in (Status.CONVERGED, Status.SMALL_DELTA) or not torch.isfinite(ref).all():
        raise AssertionError(f"PGO float64: {Status(int(opt.status)).name}")
    rows = {"dense": first, "cg": cg}
    for name, res in rows.items():
        ran = torch.isfinite(res.trace["lam"])
        print(f"PGO of the SLAM graph, float32 {name}: {Status(int(res.status)).name} after {int(res.iterations)} "
              f"iterations, final λ {float(res.trace['lam'][ran][-1]):.3e} (seed {float(res.trace['lam'][0]):.3e}), "
              f"max|poses - poses_f64| {_f64_gap(res.poses, ref):.3e} (bound √ε_f32 {PGO_F64_BOUND:.3e})")
    one = dataclasses.replace(config, max_iterations=1)
    rng = np.random.default_rng(PGO_DRIFT_SEED)
    k = graph.poses.shape[0]
    noise = torch.as_tensor(rng.normal(size=(k - 1, 6)), dtype=graph.poses.dtype, device=graph.poses.device)
    drifted = dataclasses.replace(graph, poses=odometry.chain_poses(graph.measurements[:k - 1] + RING_DRIFT * noise))
    worse = {
        "odometry start, one outer iteration": pose_graph.solve_pgo(graph, one).poses,
        "odometry start": graph.poses,
        "drifted start, full solve": pose_graph.solve_pgo(drifted, config).poses,
        "drifted start, one outer iteration": pose_graph.solve_pgo(drifted, one).poses,
        "drifted start": drifted.poses,
    }
    worse = {name: _f64_gap(poses, ref) for name, poses in worse.items()}
    print(f"PGO float64 optimum of the SLAM graph: {Status(int(opt.status)).name}, iterations {int(opt.iterations)}, "
          f"cost {float(opt.cost):.9e} (float32 dense {float(first.cost):.9e}, cg {float(cg.cost):.9e}); other "
          f"float32 solves' max|poses - poses_f64|: " + ", ".join(
              f"{name} {gap:.3e} ({'rejected' if gap > PGO_F64_BOUND else 'inside'})" for name, gap in worse.items()))
    for name, res in rows.items():
        if not _f64_gap(res.poses, ref) <= PGO_F64_BOUND:
            raise AssertionError(f"PGO: the float32 {name} solve is {_f64_gap(res.poses, ref)} from the float64 "
                                 f"optimum (bound {PGO_F64_BOUND})")
    if not (worse["drifted start, full solve"] <= PGO_F64_BOUND < worse["drifted start, one outer iteration"]):
        raise AssertionError(f"PGO: from the drifted start the check holds {worse}")
    return cg


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
    n_captures = len(device_loop.CAPTURES)
    with _slam_stages() as (walls, regs, solves):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = odometry.scan_slam_fixed_lag(seq, window=FIXED_LAG_WINDOW, method="icp", config=SLAM_CONFIG,
                                             nn_backend="auto", max_corr_dist=SLAM_GATE).cpu()
        wall_s = time.perf_counter() - t0
        k5, k6 = k_nn.launches(), k_expand.launches()
    pairs, outer, _, status = _registrations(regs)
    pgo_status = [Status(int(out.status)) for _, _, out in solves]
    ate = float(ate_rmse(poses.double(), gt[:FIXED_LAG_SCANS].double(), align=False))
    # a layout's graph is captured at its first solve: the windows of 2…W+1
    # poses, then the window with the marginal prior, replayed every scan
    captures = [c for c in device_loop.CAPTURES[n_captures:] if c["name"].startswith("pgo_step")]
    layouts = {tuple(device_loop.key_part(k) for k in pose_graph._layout(g, c, pose_graph._EdgePlan(g)))
               for g, c, _ in solves}
    print(f"scan_slam_fixed_lag, window {FIXED_LAG_WINDOW}, {len(seq)} scans: wall {wall_s:.4f} s, "
          f"{wall_s / len(seq) * 1e3:.2f} ms a scan; {len(pairs)} registrations; PGO solves {len(solves)} "
          f"({sum(walls['pgo']):.4f} s, statuses {sorted({s.name for s in pgo_status})}, {len(layouts)} layouts, "
          f"{len(captures)} captures), marginalizations {len(walls['marg'])} ({sum(walls['marg']):.4f} s); K5 {k5}, "
          f"K6 {k6}; ATE {ate:.6f} m (align=False)")
    if len(captures) != len(layouts) or len(layouts) >= len(solves):
        raise AssertionError(f"fixed-lag SLAM: {len(captures)} PGO captures for {len(layouts)} layouts of "
                             f"{len(solves)} solves")
    if poses.shape != (FIXED_LAG_SCANS, 6) or not torch.isfinite(poses).all():
        raise AssertionError(f"fixed-lag SLAM: poses {tuple(poses.shape)}")
    if Status.NUMERIC_ERROR in status + pgo_status or not ate < SLAM_ATE_BOUND:
        raise AssertionError(f"fixed-lag SLAM: ATE {ate}, statuses {set(status)}, {set(pgo_status)}")
    if len(walls["marg"]) != FIXED_LAG_SCANS - FIXED_LAG_WINDOW or k5 < sum(outer):
        raise AssertionError(f"fixed-lag SLAM: {len(walls['marg'])} marginalizations, K5 {k5}")
    return dict(wall_s=wall_s, ate=ate, k5=k5, k6=k6, pgo_s=sum(walls["pgo"]), pgo_layouts=len(layouts),
                pgo_captures=len(captures), first_s=pairs[0]["wall"], k6_first_replayed=pairs[0]["k6_replayed"]), solves


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
    each must end below bound × its start cost. Returns (a record, the
    graph, each solver's result)."""
    graph, _ = make_ring_graph(n, RING_SEED, RING_DRIFT, dtype=torch.float32, device=dev)
    start = float(pose_graph.compute_cost(graph))
    out, results = {}, {}
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
        results[name] = res
    out["max_gap"] = float((results["cg"].poses - results["dense"].poses).abs().max())
    print(f"PGO ring, {n} poses: max|poses cg - poses dense| {out['max_gap']:.3e}")
    return out, graph, results



def _pgo_timed(fn):
    """(result, wall s, host reads of the PGO) of fn(), between two
    synchronisations."""
    reads = pose_graph.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, pose_graph.HOST_READS - reads


def _pgo_loop(graph, config):
    """(the plan's host reads, the cached StepLoop) of a graph whose layout
    was solved through its graph."""
    reads = pose_graph.HOST_READS
    plan = pose_graph._EdgePlan(graph)
    reads = pose_graph.HOST_READS - reads
    key = tuple(device_loop.key_part(p) for p in pose_graph._layout(graph, config, plan))
    return reads, device_loop._LOOPS[key][0]


# Phase 21 profiles a path's solves (graph and eager body) where its eager
# body takes at most this long: a ring's CG solve runs some 10⁵–10⁶ kernels,
# whose trace the profiler does not survive on the card.
PGO_PROFILE_MAX_S = 3.0


def run_pgo_device_loop(slam, rings, lag_solves, slam_runs, lag_run, dev):
    """21: the PGO solves as CUDA-graph replays. Each path's solve through
    its graph (captured at its layout's first solve, unless the layout
    cache dropped it since) must equal its step's body run eagerly on the
    card (``device_loop.eager()``, on the capture's cuSOLVER and cuBLAS
    routes: ``capturable_linalg``) bit for bit (poses, iterations, status,
    trace, cost), and read the device only for its edge plan. The paths: the
    SLAM graph dense and CG, the rings at 300 and 2,000 poses dense and CG
    (phase 12's solves), and every window solve of phase 11's fixed-lag
    stream. Reported beside the eager body's: walls, launch calls (graph
    launches are the replays), captures, each layout's warm-up, capture and
    instantiation ms and pool bytes; the SLAM solves also against the eager
    body on PyTorch's default routes (bits shown); for ``scan_slam`` (icp,
    point2plane, GICP, phase 9) frames/s, the PGO term and the first pair's
    wall with its replayed K6 launches; and every PGO capture of the run."""
    graph, config, first, cg = slam
    paths = [("slam_dense", graph, config, first), ("slam_cg", graph, dataclasses.replace(config, solver="cg"), cg)]
    for n, (ring_graph, results) in rings.items():
        paths += [(f"ring{n}_{name}", ring_graph, RING_CONFIGS[name], results[name]) for name in ("dense", "cg")]
    out = {}
    for name, g, cfg, earlier in paths:
        fn = functools.partial(pose_graph.solve_pgo, g, cfg)
        n0 = len(device_loop.CAPTURES)
        _, first_s, _ = _pgo_timed(fn)  # the layout's capture, if the cache dropped it
        captured = len(device_loop.CAPTURES) - n0
        plan_reads, loop = _pgo_loop(g, cfg)
        replays = loop.replays
        res, graph_s, graph_reads = _pgo_timed(fn)
        replays = loop.replays - replays
        with device_loop.eager(), capturable_linalg(dev):
            eager, eager_s, eager_reads = _pgo_timed(fn)
        same = _same_result(res, eager) and _same_result(res, earlier)
        row = dict(graph_s=graph_s, eager_s=eager_s, first_s=first_s, captured=captured, replays=replays,
                   bit_equal=same, iterations=int(res.iterations), status=Status(int(res.status)).name,
                   reads=dict(plan=plan_reads, loop=graph_reads - plan_reads, eager=eager_reads),
                   launches={}, device_ms={}, busy={}, capture=loop.stats)
        if eager_s <= PGO_PROFILE_MAX_S:
            for side, context in (("graph", contextlib.nullcontext), ("eager", device_loop.eager)):
                with context(), capturable_linalg(dev):
                    _, calls, ms, wall = _launch_profile(fn)
                row["launches"][side], row["device_ms"][side], row["busy"][side] = calls, ms, ms / 1e3 / wall
        if name.startswith("slam"):
            with device_loop.eager():
                row["bit_equal_default_routes"] = _same_result(res, fn())
        out[name] = row
        print(f"PGO device loop, {name} (N={g.poses.shape[0]}, {g.poses.dtype}): {row['status']}, iterations "
              f"{row['iterations']}; first call {first_s:.4f} s ({captured} captures), graph {graph_s:.4f} s, eager "
              f"body {eager_s:.4f} s; host reads: plan {plan_reads}, loop {graph_reads - plan_reads}, eager "
              f"{eager_reads}; bit-equal to the eager body and to the earlier solve: {same}"
              + (f"; on the default routes: {row['bit_equal_default_routes']}" if name.startswith("slam") else ""))
        stats = loop.stats
        print(f"  replays {replays}; launch calls "
              + (" ".join(f"{side} {row['launches'][side]} (device ms {row['device_ms'][side]:.3f}, busy "
                          f"{row['busy'][side]:.3f})" for side in ("graph", "eager")) if row["launches"] else
                 f"not profiled (eager body over {PGO_PROFILE_MAX_S:g} s)")
              + f"; capture: warm-up {stats['warm_ms']:.1f} ms, capture {stats['capture_ms']:.1f} ms, instantiation "
                f"{stats['instantiate_ms']:.1f} ms, pools {stats['pool_bytes'] / 2**20:.1f} MiB")
        if not same:
            raise AssertionError(f"PGO device loop, {name}: the graph's solve differs from its eager body")
        graph_launches = row["launches"].get("graph", {}).get("cudaGraphLaunch", replays)
        if graph_reads != plan_reads or not replays == graph_launches == cfg.max_iterations:
            raise AssertionError(f"PGO device loop, {name}: {graph_reads - plan_reads} host reads in the loop, "
                                 f"{replays} replays ({graph_launches} graph launches) for {cfg.max_iterations} "
                                 f"iterations")

    # the fixed-lag stream's window solves, each by its graph and eagerly; a
    # graph solve that captured (its layout dropped from the cache) is
    # counted apart from those that only replayed
    n0 = len(device_loop.CAPTURES)
    walls = {kind: dict(solves=0, graph=0.0, eager=0.0) for kind in ("captured", "replayed")}
    reads = dict(loop=0, eager=0)
    same = True
    for g, cfg, earlier in lag_solves:
        n1 = len(device_loop.CAPTURES)
        res, graph_s, graph_reads = _pgo_timed(functools.partial(pose_graph.solve_pgo, g, cfg))
        kind = "captured" if len(device_loop.CAPTURES) > n1 else "replayed"
        plan_reads, _ = _pgo_loop(g, cfg)
        with device_loop.eager(), capturable_linalg(dev):
            eager, eager_s, eager_reads = _pgo_timed(functools.partial(pose_graph.solve_pgo, g, cfg))
        same = same and _same_result(res, eager) and _same_result(res, earlier)
        walls[kind]["solves"] += 1
        walls[kind]["graph"] += graph_s
        walls[kind]["eager"] += eager_s
        reads["loop"] += graph_reads - plan_reads
        reads["eager"] += eager_reads
    out["fixed_lag"] = dict(solves=len(lag_solves), walls=walls, reads=reads, bit_equal=same,
                            recaptured=len(device_loop.CAPTURES) - n0, stream_layouts=lag_run["pgo_layouts"],
                            stream_captures=lag_run["pgo_captures"], stream_pgo_s=lag_run["pgo_s"])
    print(f"PGO device loop, fixed-lag windows ({len(lag_solves)} solves; the stream's own PGO term "
          f"{lag_run['pgo_s']:.4f} s, {lag_run['pgo_captures']} captures for {lag_run['pgo_layouts']} layouts): "
          + "; ".join(f"{w['solves']} {kind} by the graph {w['graph']:.4f} s, eager body {w['eager']:.4f} s"
                      for kind, w in walls.items())
          + f"; host reads in the loops {reads['loop']}, eager {reads['eager']}; captured again here "
          f"{len(device_loop.CAPTURES) - n0} (the cache keeps {device_loop.MAX_LOOPS}); bit-equal to the eager "
          f"bodies and the stream's solves: {same}")
    if not same or reads["loop"]:
        raise AssertionError(f"PGO device loop, fixed-lag: bit-equal {same}, {reads['loop']} host reads in the loops")

    for method, run in slam_runs.items():
        print(f"PGO device loop, scan_slam {method}: frames/s {run['fps']:.2f}, PGO {run['pgo_s']:.4f} s "
              f"({run['pgo_captures']} captures), first pair {run['first_s']:.4f} s with {run['k6_first_replayed']} "
              f"K6 launches replayed (its coarse multistart by its graph)")
    out["scan_slam"] = {m: dict(fps=r["fps"], pgo_s=r["pgo_s"], pgo_captures=r["pgo_captures"], first_s=r["first_s"],
                                k6_first_replayed=r["k6_first_replayed"]) for m, r in slam_runs.items()}
    out["captures"] = [c for c in device_loop.CAPTURES if c["name"].startswith("pgo_step")]
    for c in out["captures"]:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
    return out


def _rel_diff(a, b):
    """max|a − b| / max|b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def run_sharded_linearize(cloud):
    """14(a): sharded_linearize and sharded_compute_cost of the fachada
    point2point block over 1, 2 and 4 shards against the unsharded ones."""
    dev = cloud.device
    x = torch.tensor(SHARDED_LIN_X, dtype=torch.float32, device=dev)
    tgt = se3.apply_transform(se3.transform_from_params6(torch.tensor(X_A, device=dev)), cloud)
    blk = point2point_block(cloud, tgt)
    ref = linearize(blk, x)
    ref_cost = compute_cost(blk, x)
    worst = {}
    for n in SHARDED_LIN_SHARDS:
        mesh = make_mesh(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sharded_linearize(blk, x, mesh)
        cost = sharded_compute_cost(blk, x, mesh)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        worst[n] = max([_rel_diff(a, b) for a, b in zip(out, ref)] + [_rel_diff(cost, ref_cost)])
        print(f"sharded_linearize + sharded_compute_cost, fachada {cloud.shape[0]} rows over {n} shard(s)"
              f"{' (padded)' if cloud.shape[0] % n else ''}: {wall_ms:.3f} ms, max relative difference from "
              f"the unsharded (c, H, b) and cost {worst[n]:.3e} (bound {SHARDED_LIN_RTOL:g})")
        if not worst[n] <= SHARDED_LIN_RTOL:
            raise AssertionError(f"sharded linearization over {n} shards differs by {worst[n]}")
    return worst


def run_distributed_icp(cloud, single):
    """14(a): distributed_levenberg_marquardt over the fachada ICP block of
    request A (the same target), as icp() builds it: K5 once per shard per
    outer iteration, x to X_TOL of the truth and DIST_ICP_X_TOL of the
    single-device request."""
    tgt = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))
    x0 = _centroid_seed(cloud, tgt)
    blk = icp_block(cloud, tgt)  # one update hook: a layout a shard count
    out, solves = {}, {}
    for n in DIST_ICP_SHARDS:
        solves[n] = functools.partial(distributed_levenberg_marquardt, problem(blk), x0, make_mesh(n), _icp_config())
        _reset_launches()
        n0 = len(device_loop.CAPTURES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solves[n]()
        x = res.x.cpu()
        wall_s = time.perf_counter() - t0
        launches, replayed, captured = k_nn.launches(), k_nn.replayed(), len(device_loop.CAPTURES) - n0
        outer = int(torch.isfinite(res.trace["cost"]).sum())
        err = float((x.double() - torch.tensor(X_A, dtype=torch.float64)).abs().max())
        dx = float((x - single.x.cpu()).abs().max())
        status = Status(int(res.status))
        print(f"distributed ICP over {n} shards: wall {wall_s:.4f} s ({captured} captures), outer iterations {outer}, "
              f"status {status.name}, K5 launches {launches} ({replayed} replayed, {n} x {outer}), max|x - x_true| "
              f"{err:.3e}, max|x - x_single| {dx:.3e} (bound {DIST_ICP_X_TOL:g})")
        if status == Status.NUMERIC_ERROR or not torch.isfinite(x).all() or err > X_TOL:
            raise AssertionError(f"distributed ICP over {n} shards: {status.name}, error {err}")
        if not dx <= DIST_ICP_X_TOL:
            raise AssertionError(f"distributed ICP over {n} shards differs from the single request by {dx}")
        # a capture's warm-up searches once a shard, eagerly
        if replayed != n * outer or launches - replayed not in (0, n * captured) or k_expand.launches() \
                or k_schur.launches():
            raise AssertionError(f"distributed ICP over {n} shards: K5 launched {launches} times ({replayed} "
                                 f"replayed) for {n} x {outer}")
        out[n] = dict(wall_s=wall_s, captured=captured, outer=outer, launches=launches, replayed=replayed, dx=dx)
    return out, solves


def _solve_sharded(solve):
    """solve(), a solve_ba_dense_sharded as a user calls it: (result, cost,
    wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    cost = float(res.cost)
    return res, cost, time.perf_counter() - t0


def check_shard_k11(prob, grouped, n):
    """K11 at the sharded BA's own shapes: every shard of the n-shard layout
    of ``grouped`` (one K, its own pair plan) at the first linearization and
    λ = 1e-4, against _schur_corr_torch on the shard's segments and
    _schur_corr_pairs_torch on its plan to S_BOUND, and two builds bit-equal.
    Shard 0's build timed by CUDA events. Returns (ms, slot pairs, the
    largest max|ΔS_corr| against the plain version)."""
    worst = 0.0
    mesh = make_mesh(n)
    layout = zip(ba_dense._shard_grids(prob, mesh, grouped, n), ba_dense._shard_points(prob.points, mesh, n))
    for j, (shard, pts) in enumerate(layout):
        _, V, W, _, _, _ = ba_dense._linearize_and_blocks(prob.camera_params, pts, prob.intrinsics, shard, None)
        Linv, _ = ba_dense._damped_landmarks(V, torch.full((), 1e-4, device=V.device))
        G, segments = fold_segments(W, Linv, shard.views)
        plan = shard.schur_plan(BA_C)
        S_k = schur_corr_cuda(plan, G)
        S_again = schur_corr_cuda(plan, G)
        S_p = _schur_corr_torch(segments, BA_C)
        S_pairs = _schur_corr_pairs_torch(plan, G)
        err = float((S_k - S_p).abs().max())
        scale = float(S_p.abs().max())
        rel, rel_pairs = err / scale, float((S_k - S_pairs).abs().max()) / scale
        same = torch.equal(S_k.view(torch.int32), S_again.view(torch.int32))
        print(f"schur kernel, sharded BA shard {j} of {n} ({pts.shape[0]} landmarks, {plan.pairs.shape[0]} plan "
              f"entries): ratio {rel:.3e} to the plain version, {rel_pairs:.3e} to the plain gather over the plan "
              f"(bound {S_BOUND:g}); two builds bit-equal: {same}")
        if not torch.isfinite(S_k).all() or not rel <= S_BOUND or not rel_pairs <= S_BOUND:
            raise AssertionError(f"schur kernel, shard {j} of {n}: max|dS|/max|S| = {rel}, {rel_pairs} > {S_BOUND}")
        if not same:
            raise AssertionError(f"schur kernel, shard {j} of {n}: two builds of S_corr differ")
        worst = max(worst, err)
        if j == 0:
            ms, entries = _time_ms(lambda: schur_corr_cuda(plan, G), 20), plan.pairs.shape[0]
    return ms, entries, worst


def _early_costs(trace):
    """(cost, cost_new) of the first SHARDED_BA_TRACE_ITERS outer iterations."""
    n = SHARDED_BA_TRACE_ITERS
    return [[float(c), float(cn)] for c, cn in zip(trace["cost"][:n].tolist(), trace["cost_new"][:n].tolist())]


def _early_gap(a, b):
    """Largest relative difference between two ``_early_costs`` lists."""
    return max(abs(x / y - 1) for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def run_ba_sharded(prob, grouped, dense_res):
    """14(b): solve_ba_dense_sharded on the headline over 2 and 4 shards:
    the χ² band, fixed cameras unmoved, a non-increasing cost, the first
    outer iterations' costs within BA_COST_RTOL and the final cost within
    SHARDED_BA_COST_RTOL of phase 5's, K11 once per shard per S build, and
    a second 4-shard solve bit-equal; then K11 at every shard's shape."""
    floor = _chi2_floor(BA_O, BA_C, BA_L)
    dense_cost = float(dense_res.cost)
    dense_early = _early_costs(dense_res.trace)
    out, results = {}, {}
    t0 = time.perf_counter()
    single_k = ba_dense.group_by_landmark(prob)
    grouping_s = time.perf_counter() - t0
    print(f"sharded dense BA: the solve's own host grouping (one K, landmark order) takes {grouping_s:.4f} s")
    solves = {}
    for n in SHARDED_BA_SHARDS:
        solves[n] = functools.partial(ba_dense.solve_ba_dense_sharded, prob, make_mesh(n),
                                      **(dict(grouped=grouped) if n == 2 else {}))
        _reset_launches()
        n0 = len(device_loop.CAPTURES)
        res, cost, wall_s = _solve_sharded(solves[n])
        launches, replayed, captured = k_schur.launches(), k_schur.replayed(), len(device_loop.CAPTURES) - n0
        builds = sum(res.trace["trials"].tolist())
        run = int(torch.isfinite(res.trace["cost"]).sum())
        costs = res.trace["cost"][:run].tolist() + [cost]
        rel = abs(cost / dense_cost - 1)
        early = _early_gap(_early_costs(res.trace), dense_early)
        status = Status(int(res.status))
        print(f"sharded dense BA over {n} shards{' (phase 5 segmented grid, flattened)' if n == 2 else ''}: wall "
              f"{wall_s:.4f} s ({captured} captures), outer iterations {run}, S builds {builds}, K11 launches {launches} "
              f"({replayed} replayed, {n} x {builds}), "
              f"status {status.name}, final cost {cost:.6e} ({(cost / floor - 1) * 100:+.4f}% of the chi2 floor; "
              f"{rel:.3e} from solve_ba_dense's {dense_cost:.6e}, bound {SHARDED_BA_COST_RTOL:g}); first "
              f"{SHARDED_BA_TRACE_ITERS} outer iterations' cost and cost_new {early:.3e} from its (bound {BA_COST_RTOL:g})")
        if status == Status.NUMERIC_ERROR or not np.isfinite(cost) or abs(cost / floor - 1) > BA_BAND:
            raise AssertionError(f"sharded BA over {n} shards: {status.name}, cost {cost} vs floor {floor}")
        if not torch.equal(res.camera_params[:2], prob.camera_params[:2]):
            raise AssertionError(f"sharded BA over {n} shards: a fixed camera moved")
        if any(b > a for a, b in zip(costs, costs[1:])):
            raise AssertionError(f"sharded BA over {n} shards: the accepted cost rose: {costs}")
        if not rel <= SHARDED_BA_COST_RTOL:
            raise AssertionError(f"sharded BA over {n} shards: final cost {rel} from solve_ba_dense's")
        if not early <= BA_COST_RTOL:
            raise AssertionError(f"sharded BA over {n} shards: the first iterations' costs are {early} from "
                                 "solve_ba_dense's")
        # a capture's warm-up runs every trial of a step once, eagerly
        warm = n * ba_dense.DenseBAConfig().inner_iterations * captured
        if replayed != n * builds or launches - replayed != warm or k_nn.launches() or k_expand.launches():
            raise AssertionError(f"sharded BA over {n} shards: K11 launched {launches} times ({replayed} replayed) "
                                 f"for {n} x {builds}")
        out[n] = dict(wall_s=wall_s, captured=captured, outer=run, builds=builds, launches=launches,
                      replayed=replayed, cost=cost, rel_dense=rel, early_rel_dense=early)
        results[n] = res
    # a new mesh of the same 4 shards, grouped=None: the loop of the first
    # solve replays (the grouping is kept with it)
    _reset_launches()
    n0 = len(device_loop.CAPTURES)
    again, _, wall_s = _solve_sharded(functools.partial(ba_dense.solve_ba_dense_sharded, prob, make_mesh(4)))
    same = _same_bits(again, results[4])
    captured = len(device_loop.CAPTURES) - n0
    print(f"sharded dense BA over 4 shards again: wall {wall_s:.4f} s, {captured} captures, K11 launches "
          f"{k_schur.launches()} ({k_schur.replayed()} replayed); trials, cost trace, cameras and points bit-equal: "
          f"{same}")
    if not same or captured or k_schur.launches() != k_schur.replayed():
        raise AssertionError(f"sharded dense BA: a second 4-shard solve differs from the first ({same}) or "
                             f"captured again ({captured})")
    out[4]["repeat_wall_s"] = wall_s
    for n in SHARDED_BA_SHARDS:
        ms, pairs, err = check_shard_k11(prob, single_k, n)
        out[n].update(k11_shard_ms=ms, k11_shard_err=err)
        print(f"  K11 of one of {n} shards ({pairs} slot pairs): {ms:.4f} ms an S build (CUDA events)")
    return out, results[4], grouping_s, solves


def run_fleet_sharded(srcs, tgts, fleet, x_true):
    """14(c): icp_batched over make_mesh(4): every lane within
    SHARDED_FLEET_TOL of phase 6's unsharded fleet, K6 once per shard per
    pass, and B − 2 = 62 lanes refused."""
    mesh = make_mesh(FLEET_MESH)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp_batched(srcs, tgts, loss=TrivialLoss(), mesh=mesh)
    x = res.x.cpu()
    wall_s = time.perf_counter() - t0
    launches, replayed = k_expand.launches(), k_expand.replayed()
    lanes = srcs.shape[0] // FLEET_MESH
    finite = torch.isfinite(res.trace["cost"]).cpu()
    passes = [int(finite[j * lanes:(j + 1) * lanes].any(0).sum()) for j in range(FLEET_MESH)]
    dx = float((x - fleet.x.cpu()).abs().max())
    bit_equal = torch.equal(_bits(res.x), _bits(fleet.x))
    err = float((x.double() - x_true).abs().max())
    status = res.status.cpu()
    print(f"sharded fleet B={srcs.shape[0]} over {FLEET_MESH} shards of {lanes} lanes: wall {wall_s:.4f} s, "
          f"{srcs.shape[0] / wall_s:.2f} alignments/s; passes per shard {passes}, K6 launches {launches} "
          f"({replayed} replayed, the shards' one layout replaying one graph); "
          f"max|x - x_unsharded| {dx:.3e} (bound {SHARDED_FLEET_TOL:g}), lanes bit-equal {bit_equal}; "
          f"max|x - x_true| {err:.3e}")
    if (status == Status.NUMERIC_ERROR).any() or not torch.isfinite(x).all() or err > X_TOL:
        raise AssertionError(f"sharded fleet: error {err}")
    if not dx <= SHARDED_FLEET_TOL:
        raise AssertionError(f"sharded fleet: lanes differ from the unsharded fleet by {dx}")
    if replayed != sum(passes) or launches - replayed > 1 or k_nn.launches() or k_schur.launches():
        raise AssertionError(f"sharded fleet: K6 launched {launches} times for passes {passes}")
    try:
        icp_batched(srcs[:-2], tgts[:-2], mesh=mesh)
    except ValueError as e:
        if "must divide" not in str(e):
            raise
        print(f"sharded fleet B={srcs.shape[0] - 2} over {FLEET_MESH} shards refused: {e}")
    else:
        raise AssertionError(f"sharded fleet: B={srcs.shape[0] - 2} over {FLEET_MESH} shards was not refused")
    return dict(wall_s=wall_s, alignments_per_s=srcs.shape[0] / wall_s, passes=passes, launches=launches, dx=dx,
                bit_equal=bit_equal)


def _observation_sharded(prob, mesh, rows=None):
    """prob with cam_idx, pt_idx and pixels as GlobalArrays of the mesh:
    ``rows(a)`` of each (all of them by default, as within one process)."""
    rows = rows or (lambda a: a)
    return dataclasses.replace(
        prob, **{k: multihost.make_global_array(rows(getattr(prob, k)), mesh) for k in ("cam_idx", "pt_idx", "pixels")}
    )


def _hold_sharded_cg(what, sp, res, cost, single, floor):
    """The sharded CG solve against the unsharded one: the χ² band, fixed
    cameras unmoved, a non-increasing cost, no K11, the first outer
    iterations to BA_COST_RTOL and the final cost to SHARDED_BA_COST_RTOL.
    Returns (final-cost gap, early gap)."""
    _check_descent(what, sp, res, cost)
    rel = abs(cost / float(single.cost) - 1)
    early = _early_gap(_early_costs(res.trace), _early_costs(single.trace))
    if k_schur.launches():
        raise AssertionError(f"{what}: the CG engine launched the schur kernel")
    if abs(cost / floor - 1) > BA_BAND:
        raise AssertionError(f"{what}: final cost {cost} is not within {BA_BAND:.0%} of {floor}")
    if not rel <= SHARDED_BA_COST_RTOL:
        raise AssertionError(f"{what}: final cost {rel} from the unsharded CG solve's")
    if not early <= BA_COST_RTOL:
        raise AssertionError(f"{what}: the first iterations' costs are {early} from the unsharded CG solve's")
    return rel, early


def run_ba_cg_sharded(prob, cg_res, big, big_res):
    """16: ``solve_ba`` (the CG engine) with the observations sharded over a
    mesh in one process: the headline over 2 and 4 shards, and again over 4
    (bit-equal), held to phase 5(a)'s unsharded CG solve; the O=1M, C=4,000
    instance over 4 shards, held to phase 5(b)'s routed CG solve. Each
    sharded problem's first solve captures its step; the 4-shard repeat
    solves the same problem and must replay. Returns ({shards or "big":
    numbers}, the 4-shard headline result, {shards or "big": the sharded
    problem})."""
    out, results, problems = {}, {}, {}
    cases = [(n, prob, cg_res, _chi2_floor(BA_O, BA_C, BA_L)) for n in SHARDED_CG_SHARDS]
    cases.append(("big", big, big_res, _chi2_floor(BA_CG_O, BA_CG_C, BA_CG_L)))
    for key, p, single, floor in cases:
        n = SHARDED_CG_BIG_SHARDS if key == "big" else key
        sp = problems[key] = _observation_sharded(p, make_mesh(n))
        n0 = len(device_loop.CAPTURES)
        res, cost, wall_s, reads = _solve_cg(sp, engine="cg")
        captured = len(device_loop.CAPTURES) - n0
        k11 = k_schur.launches()
        rel, early = _hold_sharded_cg(f"sharded CG BA ({key}, {n} shards)", sp, res, cost, single, floor)
        run = int(torch.isfinite(res.trace["cost"]).sum())
        stages = _cg_stage_times(sp)
        O, C, L = p.cam_idx.shape[0], p.camera_params.shape[0], p.points.shape[0]
        print(f"sharded CG BA O={O} C={C} L={L} over {n} shards: wall {wall_s:.4f} s ({captured} captures; unsharded "
              f"CG solve {float(single.cost):.6e}), outer iterations {run}, trials {sum(res.trace['trials'].tolist())}, "
              f"host reads {reads} (the plans'), K11 launches {k11}, status {Status(int(res.status)).name}, final "
              f"cost {cost:.6e} ({(cost / floor - 1) * 100:+.4f}% of the chi2 floor; {rel:.3e} from the unsharded "
              f"CG's, bound {SHARDED_BA_COST_RTOL:g}); first {SHARDED_BA_TRACE_ITERS} outer iterations' cost and "
              f"cost_new {early:.3e} from its (bound {BA_COST_RTOL:g})")
        print(f"  stages at the start: {_stages_text(stages)}")
        out[str(key)] = dict(shards=n, wall_s=wall_s, captured=captured, outer=run, reads=reads, k11=k11, cost=cost,
                             vs_floor=cost / floor - 1, rel_unsharded=rel, early_rel_unsharded=early, **stages)
        results[key] = res
    n0 = len(device_loop.CAPTURES)
    again, _, wall_s, reads = _solve_cg(problems[4], engine="cg")
    captured = len(device_loop.CAPTURES) - n0
    out["4"]["repeat_k11"] = k_schur.launches()
    if k_schur.launches():
        raise AssertionError("sharded CG BA over 4 shards again: the CG engine launched the schur kernel")
    same = _same_bits(again, results[4])
    print(f"sharded CG BA over 4 shards again: wall {wall_s:.4f} s, {captured} captures, host reads {reads}; trials, "
          f"cost trace, cameras and points bit-equal: {same}")
    if not same or captured or reads:
        raise AssertionError(f"sharded CG BA: a second 4-shard solve differs from the first ({same}) or captured "
                             f"again ({captured}, {reads} host reads)")
    out["4"]["repeat_wall_s"] = wall_s
    return out, results[4], problems


def run_selfcal_sharded(prob, wrong, single, single_intr, single_early, single_wall_s):
    """18: solve_ba_selfcal with the observations of 5(c)'s start sharded
    over 2 and 4 shards in one process, held to 5(c)'s unsharded solve
    (``_hold_selfcal``, the first outer iterations to BA_COST_RTOL, the final
    cost to SHARDED_BA_COST_RTOL). Each sharded problem's first solve
    captures its step. Returns ({shards: numbers}, {shards: the sharded
    problem})."""
    out, problems = {}, {}
    for n in SELFCAL_SHARDS:
        what = f"sharded self-cal BA ({n} shards)"
        sp = problems[n] = _observation_sharded(wrong, make_mesh(n))
        n0 = len(device_loop.CAPTURES)
        res, intr, cost, wall_s, reads, _ = _solve_selfcal(sp)
        captured = len(device_loop.CAPTURES) - n0
        k11 = k_schur.launches()
        floor, err = _hold_selfcal(what, sp, res, intr, cost, prob.intrinsics)
        rel = abs(cost / float(single.cost) - 1)
        early = _early_gap(_selfcal_early(sp), single_early)
        d_intr = (intr - single_intr).abs().max().item()
        stages = _selfcal_stage_times(sp)
        print(f"sharded self-calibrating BA O={BA_O} C={BA_C} L={BA_L} over {n} shards: wall {wall_s:.4f} s "
              f"({captured} captures; unsharded {single_wall_s:.4f} s in this run), iterations {int(res.iterations)}, "
              f"host reads {reads} (the plans' and one an outer iteration), K11 launches {k11}, status "
              f"{Status(int(res.status)).name}, final cost {cost:.6e} ({(cost / floor - 1) * 100:+.4f}% of the chi2 "
              f"floor; {rel:.3e} from the unsharded self-cal's, bound {SHARDED_BA_COST_RTOL:g}); first "
              f"{SHARDED_BA_TRACE_ITERS} outer iterations' cost and cost_new {early:.3e} from its (bound "
              f"{BA_COST_RTOL:g}); intrinsics {intr.tolist()}, {err:.4e} px from the true ones, {d_intr:.4e} from "
              f"the unsharded solve's")
        print(f"  stages at the start: {_stages_text(stages)}")
        if not rel <= SHARDED_BA_COST_RTOL:
            raise AssertionError(f"{what}: final cost {rel} from the unsharded self-cal's")
        if not early <= BA_COST_RTOL:
            raise AssertionError(f"{what}: the first iterations' costs are {early} from the unsharded self-cal's")
        out[str(n)] = dict(wall_s=wall_s, captured=captured, iterations=int(res.iterations), reads=reads, k11=k11,
                           cost=cost, vs_floor=cost / floor - 1, rel_unsharded=rel, early_rel_unsharded=early,
                           intrinsics_err=err, intrinsics_vs_unsharded=d_intr, **stages)
    return out, problems


# Phase 22 profiles a sharded path's solves (graph and eager body) where its
# eager body takes at most this long, as phase 21 does, and the graph only
# where its IF nodes nest two deep (the LM and dense steps: step, trial): on
# an H100, after some 40 profiler sessions in one process, the profiled
# replays of the sharded CG graphs (PCG iterations a third level down)
# showed 0.9-18 ms of device time for a 0.4 s solve, and the next profiled
# replay, the self-calibration's, ended in an illegal memory access
# (PERF.md §7; ``chip_profile.py --path sharded_cg`` repeats those profiles
# alone, where they are complete).
SHARDED_PROFILE_MAX_S = PGO_PROFILE_MAX_S


def _loop_timed(fn):
    """(result, wall s, host reads of the LM and BA loops) of fn(), between
    two synchronisations."""
    reads = solver.HOST_READS + ba.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, solver.HOST_READS + ba.HOST_READS - reads


def _latest_loop():
    """The StepLoop of the layout cache's last lookup."""
    return next(reversed(device_loop._LOOPS.values()))[0]


def run_sharded_device_loop(icp_solves, ba_solves, cg_problems, selfcal_problems, dev):
    """22: the one-process sharded solves as CUDA graphs. Each path of
    phases 14, 16 and 18 (the distributed ICP over 2 and 6 shards, the
    sharded dense BA over 2 and 4, the observation-sharded CG over 2 and 4
    and the O=1M instance over 4, the sharded self-calibration over 2 and 4)
    through its graph must equal its step's body run eagerly on the card
    (``device_loop.eager()``, an LM body inside ``capturable_linalg``, on
    which the LM step is captured) bit for bit: x or cameras, points and
    intrinsics, iterations, status and trace. The graph's solve must read
    the device 0 times (the self-calibration once an outer iteration), make
    max_iterations replays (the self-calibration one an outer iteration run)
    and replay K5 (K11) as often as the eager body launches it: shards ×
    outer iterations (S builds). Reported beside the eager body's: walls,
    the mesh reductions it makes (a replay's are not counted: the eager
    body's are the graph's), launch calls, device ms and busy share, and
    each capture's warm-up, capture and instantiation ms and pool bytes."""
    cg_cfg = ba.BAConfig()
    paths = [(f"distributed_icp_{n}", fn, k_nn, n, True) for n, fn in icp_solves.items()]
    paths += [(f"dense_{n}", fn, k_schur, n, False) for n, fn in ba_solves.items()]
    paths += [(f"cg_{key}", functools.partial(ba.solve_ba, sp, cg_cfg), None, sp.cam_idx.mesh.size, False)
              for key, sp in cg_problems.items()]
    paths += [(f"selfcal_{n}", functools.partial(ba_intrinsics.solve_ba_selfcal, sp, cg_cfg), None, n, False)
              for n, sp in selfcal_problems.items()]
    # the layouts the phases before used last first: those the cache still
    # keeps replay, and a capture drops only a layout already checked here
    paths.reverse()
    out, n_start = {}, len(device_loop.CAPTURES)
    for name, fn, kernel, shards, lm in paths:
        pcg = name.startswith(("cg", "selfcal"))
        n0 = len(device_loop.CAPTURES)
        _, first_s, _ = _loop_timed(fn)  # the layout's capture, unless the cache kept it
        captured = len(device_loop.CAPTURES) - n0
        loop = _latest_loop()
        replays = loop.replays
        _reset_launches()
        graph, graph_s, graph_reads = _loop_timed(fn)
        replays = loop.replays - replays
        replayed = kernel.replayed() if kernel else 0
        mv_replayed = k_matvec.replayed()
        eager_in_graph = k_nn.LAUNCHES + k_expand.LAUNCHES + k_schur.LAUNCHES + k_matvec.LAUNCHES
        _reset_launches()
        reductions = mesh_module.REDUCTIONS
        with device_loop.eager(), (capturable_linalg(dev) if lm else contextlib.nullcontext()):
            eager, eager_s, eager_reads = _loop_timed(fn)
        reductions = mesh_module.REDUCTIONS - reductions
        eager_k = kernel.launches() if kernel else 0
        res = _ba_result(graph) if not lm else graph
        selfcal = name.startswith("selfcal")
        run = _outer_run(res)
        if kernel is k_nn:
            expect = shards * int(torch.isfinite(res.trace["cost"]).sum())
        elif kernel is k_schur:
            expect = shards * sum(res.trace["trials"].tolist())
        else:
            expect = 0
        same = _same_result(graph, eager)
        row = dict(shards=shards, first_s=first_s, captured=captured, graph_s=graph_s, eager_s=eager_s,
                   reads=dict(graph=graph_reads, eager=eager_reads), replays=replays, bit_equal=same,
                   iterations=int(res.iterations), status=Status(int(res.status)).name, outer=run,
                   eager_reductions=reductions, kernel_replayed=replayed, kernel_eager=eager_k, kernel_runs=expect,
                   matvec_replayed=mv_replayed,
                   matvec_runs=None if lm or _matvec_runs(res) is None else shards * _matvec_runs(res),
                   launches={}, device_ms={}, busy={}, capture=loop.stats)
        sides = (("graph", contextlib.nullcontext),) * (not pcg) + (("eager", device_loop.eager),)
        for side, context in sides if eager_s <= SHARDED_PROFILE_MAX_S else ():
            with context(), (capturable_linalg(dev) if lm else contextlib.nullcontext()):
                _, calls, ms, wall = _launch_profile(fn)
            row["launches"][side], row["device_ms"][side], row["busy"][side] = calls, ms, ms / 1e3 / wall
        out[name] = row
        stats = loop.stats
        print(f"sharded device loop, {name} ({shards} shards): {row['status']}, iterations {row['iterations']}; first "
              f"call {first_s:.4f} s ({captured} captures), graph {graph_s:.4f} s, eager body {eager_s:.4f} s; host "
              f"reads graph {graph_reads}, eager {eager_reads}; replays {replays}; mesh reductions of the eager body "
              f"{reductions}; bit-equal {same}"
              + (f"; {kernel.NAME} replayed {replayed}, eager {eager_k}, runs {expect}" if kernel else ""))
        print("  launch calls "
              + (" ".join(f"{side} {row['launches'][side]} (device ms {row['device_ms'][side]:.3f}, busy "
                          f"{row['busy'][side]:.3f})" for side in row["launches"]) if row["launches"] else
                 f"not profiled (eager body over {SHARDED_PROFILE_MAX_S:g} s)")
              + ("; graph not profiled (PCG IF nodes three deep)" if pcg else "")
              + f"; capture: warm-up {stats['warm_ms']:.1f} ms, capture {stats['capture_ms']:.1f} ms, instantiation "
                f"{stats['instantiate_ms']:.1f} ms, pools {stats['pool_bytes'] / 2**20:.1f} MiB")
        if not same:
            raise AssertionError(f"sharded device loop, {name}: the graph's solve differs from its eager body")
        reads_expected = run if selfcal else 0
        replays_expected = run if selfcal else loop.trace["cost"].shape[-1]  # max_iterations
        graph_launches = row["launches"].get("graph", {}).get("cudaGraphLaunch", replays)
        if graph_reads != reads_expected or not replays == graph_launches == replays_expected or eager_in_graph:
            raise AssertionError(f"sharded device loop, {name}: {graph_reads} host reads, {replays} replays "
                                 f"({graph_launches} graph launches), {eager_in_graph} eager kernel launches; "
                                 f"expected {reads_expected} reads and {replays_expected} replays")
        if kernel and not replayed == eager_k == expect > 0:
            raise AssertionError(f"sharded device loop, {name}: {kernel.NAME} replayed {replayed}, eager {eager_k}, "
                                 f"for {expect} runs")
        _hold_matvec_launches(f"sharded device loop, {name}", row["matvec_runs"], mv_replayed, 0,
                              dense=lm or name.startswith("dense"))
    out["captures"] = device_loop.CAPTURES[n_start:]
    for c in out["captures"]:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
    out["max_memory_reserved"] = torch.cuda.max_memory_reserved(dev)
    print(f"sharded device loop: torch.cuda.max_memory_reserved {out['max_memory_reserved'] / 2**30:.2f} GiB, "
          f"{len(device_loop._LOOPS)} layouts cached (at most {device_loop.MAX_LOOPS})")
    return out


# Phase 23: the one-process mesh over several cards. Meshes: one shard a
# card over 2 and over min(4, cards) cards, and 4 shards over 2 cards (two
# slots a card); the curve fit's and ICP's x and the BA final costs within
# MULTICARD_RTOL of the unsharded solves', and the BA cameras within
# MULTICARD_CAMERA_BOUND·max(1, max|cameras|) of theirs: √ε_f32, the float32
# SMALL_DELTA threshold (params6: metres and radians), below which the
# solver itself counts a step as no move.
MULTICARD_RTOL = 1e-5
MULTICARD_CAMERA_BOUND = float(np.sqrt(np.finfo(np.float32).eps))
MULTICARD_CURVE_ROWS = 64
MULTICARD_TIMEOUT_S = 2.0
MULTICARD_SIZES = ((6 * BA_C) ** 2, 1001)


def _multicard_meshes():
    """(name, mesh, paths) of phase 23: one shard a card on 2 and on
    min(4, n) cards, every path; 4 shards round-robin on 2 cards (two slots
    a card, K5 and K11 twice a card), the ICP and the dense BA."""
    n = torch.cuda.device_count()
    every = ("curve", "icp", "cg", "selfcal", "dense")
    meshes = [("2 cards", make_mesh(2), every)]
    if n >= 3:
        meshes.append((f"{min(4, n)} cards", make_mesh(min(4, n)), every))
    meshes.append(("4 shards on 2 cards", mesh_module.Mesh(devices=tuple(torch.device("cuda", j % 2)
                                                                         for j in range(4))), ("icp", "dense")))
    return meshes


def _card_bits(loops):
    """Whether every card's replicated carry, done, counter, status and
    trace equal the first card's bit for bit."""
    first = loops.loops[0]
    for c, loop in enumerate(loops.loops[1:], 1):
        mine = [i for i in loops._index[c] if loops.owners[i] is None]
        theirs = [i for i in loops._index[0] if loops.owners[i] is None]
        for i, j in zip(mine, theirs):
            if not _same_result(loop.carry[loops._index[c].index(i)].cpu(), first.carry[loops._index[0].index(j)].cpu()):
                return False
        for a, b in ((loop.done, first.done), (loop.it, first.it), (loop.status, first.status)):
            if not _same_result(a.cpu(), b.cpu()):
                return False
        if not _same_result({k: v.cpu() for k, v in loop.trace.items()}, {k: v.cpu() for k, v in first.trace.items()}):
            return False
    return True


def _first_difference(a, b, path="result"):
    """Where two results first part bit for bit (``_same_result``'s walk),
    with the largest difference there; "" where they agree."""
    if isinstance(a, torch.Tensor):
        if _same_result(a, b):
            return ""
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"{path}: {tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}"
        return f"{path}: max |diff| {float((a.double() - b.double()).abs().nan_to_num(float('inf')).max()):.3e}"
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        items = [(f.name, getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    elif isinstance(a, dict):
        items = [(k, a[k], b[k]) for k in a]
    elif isinstance(a, (tuple, list)):
        items = [(str(i), x, y) for i, (x, y) in enumerate(zip(a, b))]
    else:
        return "" if a == b else f"{path}: {a!r} against {b!r}"
    return next((d for d in (_first_difference(x, y, f"{path}.{k}") for k, x, y in items) if d), "")


def _multicard_path(name, mesh, fn, kernel, lm, reference_gap):
    """23: one path over one mesh: the first call (its capture), the graphs
    again (timed, host reads counted, every kernel count 0 before), the
    mesh's eager body (``device_loop.eager()``); checks and returns its row."""
    dev = mesh.devices[0]
    n0 = len(device_loop.CAPTURES)
    first, first_s, _ = _loop_timed(fn)
    captured = len(device_loop.CAPTURES) - n0
    loops = _latest_loop()
    if not isinstance(loops, device_loop.CardLoops):
        raise AssertionError(f"multi-card {name}: the solve made no loop a card ({type(loops).__name__})")
    replays = [loop.replays for loop in loops.loops]
    _reset_launches()
    graph, graph_s, graph_reads = _loop_timed(fn)
    replays = [loop.replays - r for loop, r in zip(loops.loops, replays)]
    per_card = _card_bits(loops)
    cards = mesh.cards  # the counters of cards off this mesh (earlier meshes') read 0
    k_replayed = {str(d): v for d, v in (kernel.replayed_by_card() if kernel else {}).items() if d in cards}
    k_eager_in_graph = k_nn.LAUNCHES + k_expand.LAUNCHES + k_schur.LAUNCHES + k_matvec.LAUNCHES
    t_replayed = {str(d): v for d, v in k_mesh.replayed_by_card().items() if d in cards}
    t_eager_in_graph = k_mesh.LAUNCHES
    mv_replayed = _matvec_by_card(mesh.card_groups())
    _reset_launches()
    with device_loop.eager(), (capturable_linalg(dev) if lm else contextlib.nullcontext()):
        eager, eager_s, eager_reads = _loop_timed(fn)
    k_eager = {str(d): v for d, v in (kernel.LAUNCHES_BY_CARD if kernel else {}).items()}
    res = graph if lm else _ba_result(graph)
    run = _outer_run(res)
    groups = mesh.card_groups()
    if kernel is k_nn:
        expect = {str(d): len(js) * int(torch.isfinite(res.trace["cost"]).sum()) for d, js in groups}
    elif kernel is k_schur:
        expect = {str(d): len(js) * sum(res.trace["trials"].tolist()) for d, js in groups}
    else:
        expect = {}
    selfcal = name.startswith("selfcal")
    gap, camera_gap = reference_gap(graph)
    camera_bound = None if camera_gap is None else MULTICARD_CAMERA_BOUND * max(
        1.0, float(_ba_result(graph).camera_params.abs().max()))
    row = dict(first_s=first_s, captured=captured, graph_s=graph_s, eager_s=eager_s,
               reads=dict(graph=graph_reads, eager=eager_reads), replays=replays,
               bit_equal_eager=_same_result(graph, eager), bit_equal_repeat=_same_result(graph, first),
               cards_bit_equal=per_card, iterations=int(res.iterations), status=Status(int(res.status)).name,
               outer=run, unsharded_gap=gap, camera_gap=camera_gap, camera_bound=camera_bound, kernel_replayed=k_replayed, kernel_eager=k_eager, kernel_runs=expect,
               transport_replayed=t_replayed, matvec_replayed=mv_replayed,
               matvec_runs=_matvec_card_runs(res, groups, lm, selfcal),
               captures=[dict(c) for c in device_loop.CAPTURES[n0:]])
    print(f"multi-card {name}: {row['status']}, iterations {row['iterations']}; first call {first_s:.4f} s "
          f"({captured} captures), graphs {graph_s:.4f} s, eager body {eager_s:.4f} s; host reads graph {graph_reads}, "
          f"eager {eager_reads}; replays a card {replays}; bit-equal eager {row['bit_equal_eager']}, repeat "
          f"{row['bit_equal_repeat']}, across cards {per_card}; {gap:.3e} from the unsharded solve (bound "
          f"{MULTICARD_RTOL:g})"
          + ("" if camera_gap is None else f", cameras {camera_gap:.3e} (bound {camera_bound:.3e})")
          + f"; transport replayed a card {t_replayed}"
          + (f"; {kernel.NAME} replayed a card {k_replayed}, eager {k_eager}, runs {expect}" if kernel else "")
          + f"; schur matvec replayed a card {mv_replayed} (expected {row['matvec_runs'] or 'some'})")
    for c in row["captures"]:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
    if not (row["bit_equal_eager"] and row["bit_equal_repeat"] and per_card):
        raise AssertionError(f"multi-card {name}: the graphs' solve differs from the eager body "
                             f"({_first_difference(graph, eager)}), its repeat or across cards")
    reads_expected = run if selfcal else 0
    replays_expected = run if selfcal else loops.trace["cost"].shape[-1]
    if graph_reads != reads_expected or set(replays) != {replays_expected} or k_eager_in_graph or t_eager_in_graph:
        raise AssertionError(f"multi-card {name}: {graph_reads} host reads, replays {replays}, eager launches "
                             f"{k_eager_in_graph} (transport {t_eager_in_graph}); expected {reads_expected} reads and "
                             f"{replays_expected} replays a card")
    if kernel and not k_replayed == k_eager == expect or kernel and not all(expect.values()):
        raise AssertionError(f"multi-card {name}: {kernel.NAME} replayed {k_replayed}, eager {k_eager}, for {expect}")
    if not all(t_replayed.get(str(d), 0) > 0 for d, _ in groups):
        raise AssertionError(f"multi-card {name}: the card transport replayed {t_replayed}")
    if not _matvec_cards_ok(mv_replayed, row["matvec_runs"]):
        raise AssertionError(f"multi-card {name}: schur matvec replayed {mv_replayed}, expected {row['matvec_runs']}")
    if not gap <= MULTICARD_RTOL or camera_gap is not None and not camera_gap <= camera_bound:
        raise AssertionError(f"multi-card {name}: {gap} from the unsharded solve, cameras {camera_gap}")
    return row


def _multicard_transport(mesh, timeout=True):
    """23: the card transport of ``mesh`` against its plain version
    (``mesh_reduce.reduce_slots_plain``) bit for bit, sum and max, float32
    and float64, at S's size and 1,001 (partials over 12 decades, a shard
    each); its µs at both sizes (every card's launch enqueued, CUDA events
    on the first card); then, with ``timeout``, a fresh transport with
    MULTICARD_TIMEOUT_S whose second reduction the last card skips:
    ``Mesh.check`` must raise."""
    transport = mesh.card_transport()
    groups = mesh.card_groups()
    rng = np.random.default_rng(SEED + 60)
    cases, worst = [], 0.0
    _reset_launches()
    for n in MULTICARD_SIZES:
        for dtype in (torch.float32, torch.float64):
            parts = [torch.as_tensor(rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, size=n), dtype=dtype, device=d)
                     for d in mesh.devices]
            for op in k_mesh.OPS:
                outs = [transport.reduce([parts[j] for j in js], js, c, op) for c, (_, js) in enumerate(groups)]
                plain = k_mesh.reduce_slots_plain([(js, [parts[j] for j in js]) for _, js in groups], op)[0]
                same = all(_same_result(o.cpu(), plain.cpu()) for o in outs)
                err = max(float((o.double().cpu() - plain.double().cpu()).abs().max()) for o in outs)
                worst = max(worst, err)
                cases.append(dict(n=n, dtype=str(dtype), op=op, bit_equal=same, max_abs_err=err))
                if not same:
                    raise AssertionError(f"card transport ({n}, {dtype}, {op}): differs from its plain version by {err}")
    launches = k_mesh.LAUNCHES
    times = {}
    for key, n in (("s", MULTICARD_SIZES[0]), ("small", MULTICARD_SIZES[1])):
        parts = [torch.ones(n, dtype=torch.float32, device=d) for d in mesh.devices]
        args = [([parts[j] for j in js], js, c) for c, (_, js) in enumerate(groups)]

        def all_cards():
            for flats, js, c in args:
                transport.reduce(flats, js, c, "sum")

        all_cards()
        for d in mesh.cards:
            torch.cuda.synchronize(d)
        reps = 50 if key == "s" else 200
        times[key] = _time_ms(all_cards, reps) * 1e3
        for d in mesh.cards:
            torch.cuda.synchronize(d)
        plain_parts = [(js, [parts[j] for j in js]) for _, js in groups]
        times[f"plain_{key}"] = _time_ms(lambda: k_mesh.reduce_slots_plain(plain_parts, "sum"), 20) * 1e3
    mesh.check()
    bytes_s = MULTICARD_SIZES[0] * 4
    # each card reads its shards' partials and every shard's slot, and writes its result
    bound_ms = max((len(js) + mesh.size + 1) * bytes_s for _, js in groups) / PEAK_BYTES * 1e3
    row = dict(cases=cases, max_abs_err=worst, us=times, bound_ms=bound_ms, launches=launches,
               slot_bytes=transport.slot_bytes, buffers=len(transport.generations))
    print(f"card transport over {len(mesh.cards)} cards, {mesh.size} shards: bit-equal to its plain version in "
          f"{len(cases)} cases (max abs err {worst:.3e}); {times['s']:.1f} µs a reduction of S ({bytes_s} bytes, "
          f"bound {bound_ms * 1e3:.1f} µs), {times['small']:.1f} µs of 1,001 floats, the plain version "
          f"{times['plain_s']:.1f} µs and {times['plain_small']:.1f} µs")
    if not timeout:
        return row
    probe = k_mesh.CardBuffers(mesh.cards, mesh.card_of(), timeout_s=MULTICARD_TIMEOUT_S)
    small = [torch.ones(MULTICARD_SIZES[1], device=d) for d in mesh.devices]
    for c, (_, js) in enumerate(groups):
        probe.reduce([small[j] for j in js], js, c, "sum")
    for c, (_, js) in enumerate(groups[:-1]):  # the last card never arrives
        probe.reduce([small[j] for j in js], js, c, "sum")
    saved = mesh_module._CARD_TRANSPORTS[mesh.devices]
    mesh_module._CARD_TRANSPORTS[mesh.devices] = probe
    t0 = time.perf_counter()
    try:
        mesh.check()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        mesh_module._CARD_TRANSPORTS[mesh.devices] = saved
    row["timeout"] = dict(raised=raised, wall_s=time.perf_counter() - t0)
    probe.close()
    print(f"  a card that never arrives: Mesh.check raised after {row['timeout']['wall_s']:.3f} s: {raised!r}")
    if "epoch" not in raised:
        raise AssertionError(f"card transport: a skipped reduction did not raise through Mesh.check ({raised!r})")
    return row


def run_multicard(dev, cloud, prob=None, refs=None):
    """23: see the module docstring. ``prob``: the headline BA instance;
    ``refs``: its unsharded CG, self-calibrating and dense solves
    ({"cg", "selfcal", "dense"}: BAResult), as phases 12, 18 and 5 made
    them; both made here when not given (``--phase 23``). Returns {mesh
    name: {path: row, "transport": ...}} and the unsharded references'
    walls."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"phase 23: needs 2+ cards, found {n_cards}")
        return None
    t_start = time.perf_counter()

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    curve = problem(make_block(residual, data=torch.as_tensor(
        curve_fitting.CERES_CURVE_DATA[:MULTICARD_CURVE_ROWS], dtype=torch.float64, device=dev)))
    curve_x0, curve_cfg = torch.zeros(2, dtype=torch.float64, device=dev), LMConfig(max_iterations=25)
    tgt = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))
    # an update hook's rows must divide the shards (ROADMAP Queue 3, shared
    # with the JAX package): the source is the scan's first 29,304 points,
    # which 2, 3, 4 and 6 shards divide
    src = cloud[: cloud.shape[0] // 12 * 12]
    icp_x0 = _centroid_seed(src, tgt)
    icp = problem(icp_block(src, tgt))
    if prob is None:
        prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    start = _selfcal_start(prob)
    cg_cfg = ba.BAConfig()
    if refs is None:
        refs = dict(cg=ba.solve_ba(prob, cg_cfg), selfcal=ba_intrinsics.solve_ba_selfcal(start, cg_cfg)[0],
                    dense=ba_dense.solve_ba_dense(prob))
    refs = dict(refs, curve=levenberg_marquardt(curve, curve_x0, curve_cfg).x,
                icp=levenberg_marquardt(icp, icp_x0, _icp_config()).x)
    ref_s = time.perf_counter() - t_start

    def x_gap(key):
        return lambda r: (float((r.x.double().cpu() - refs[key].double().cpu()).abs().max()), None)

    def cost_gap(key):
        def gap(r):
            r, ref = _ba_result(r), refs[key]
            return (abs(float(r.cost) / float(ref.cost) - 1),
                    float((r.camera_params.double() - ref.camera_params.double()).abs().max()))

        return gap

    out = {}
    for k, (mesh_name, mesh, names) in enumerate(_multicard_meshes()):
        sp = _observation_sharded(prob, mesh)
        ssp = _observation_sharded(start, mesh)
        paths = [
            ("curve", functools.partial(distributed_levenberg_marquardt, curve, curve_x0, mesh, curve_cfg), None,
             True, x_gap("curve")),
            ("icp", functools.partial(distributed_levenberg_marquardt, icp, icp_x0, mesh, _icp_config()), k_nn, True,
             x_gap("icp")),
            ("cg", functools.partial(ba.solve_ba, sp, cg_cfg), None, False, cost_gap("cg")),
            ("selfcal", functools.partial(ba_intrinsics.solve_ba_selfcal, ssp, cg_cfg), None, False,
             cost_gap("selfcal")),
            ("dense", functools.partial(ba_dense.solve_ba_dense_sharded, prob, mesh), k_schur, False,
             cost_gap("dense")),
        ]
        rows = {}
        for name, fn, kernel, lm, gap in paths:
            if name in names:
                rows[name] = _multicard_path(f"{name} over {mesh_name}", mesh, fn, kernel, lm, gap)
        rows["transport"] = _multicard_transport(mesh, timeout=k == 0)
        out[mesh_name] = rows
        mesh.close()
    wall = time.perf_counter() - t_start
    print(f"phase 23: {wall:.1f} s ({ref_s:.1f} s of it the unsharded references)")
    return dict(meshes=out, wall_s=wall, reference_s=ref_s, cards=n_cards)


@contextlib.contextmanager
def _timed_all_reduces():
    """The mesh's all-reduces across processes while the block runs: their
    count (``mesh.ALL_REDUCES``) and their summed ms, each timed between two
    synchronisations of the card."""
    stats = dict(count=0, ms=0.0)
    all_reduce, count = mesh_module._all_reduce, mesh_module.ALL_REDUCES

    def timed(tensors, op, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(tensors, op, mesh)
        torch.cuda.synchronize()
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    mesh_module._all_reduce = timed
    try:
        yield stats
    finally:
        mesh_module._all_reduce = all_reduce
        stats["count"] = mesh_module.ALL_REDUCES - count


def _example(out, name, fn, **kwargs):
    """An example's main() on the card, with every kernel count set to 0
    before it: its result; its wall and launches go into out[name]."""
    _reset_launches()
    print(f"--- example {name}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(**kwargs)
    torch.cuda.synchronize()
    out[name] = dict(wall_s=time.perf_counter() - t0, k5=k_nn.launches(), k6=k_expand.launches(),
                     k11=k_schur.launches(), k11_replayed=k_schur.replayed())
    print(f"--- example {name}: wall {out[name]['wall_s']:.3f} s, launches K5 {out[name]['k5']}, K6 "
          f"{out[name]['k6']}, K11 {out[name]['k11']} ({out[name]['k11_replayed']} replayed)")
    return result


def run_examples():
    """17: the six examples' main() on the card at the JAX scripts' sizes,
    with their own asserts, and the kernels each must launch: K5 in the ICP
    example and the fixed-lag SLAM, K6 in the fleet, K11 in the BA
    example's engine="auto" route (one launch a trial) and nowhere else."""
    out = {}
    res = _example(out, "curve_fitting", curve_example.main)
    err = float((res.x.cpu() - torch.tensor(CURVE_MINIMUM)).abs().max())
    if Status(int(res.status)) == Status.NUMERIC_ERROR or err > 5e-5:
        raise AssertionError(f"curve_fitting example: {Status(int(res.status)).name}, x {err} from the minimum")
    if _example(out, "cross_check_scipy", cross_check_scipy.main) != 0:
        raise AssertionError("cross_check_scipy example: a minimum disagrees with SciPy's")
    res, x_true = _example(out, "icp_registration", icp_registration.main)
    err = float((res.x - x_true).abs().max())
    out["icp_registration"].update(x_err=err, iterations=int(res.iterations))
    if Status(int(res.status)) == Status.NUMERIC_ERROR or err > X_TOL:
        raise AssertionError(f"icp_registration example: {Status(int(res.status)).name}, x {err} from the truth")
    start, _, res, res_auto = _example(out, "bundle_adjustment", bundle_adjustment.main)
    route, trials = ba.select_engine(start), sum(res_auto.trace["trials"].tolist())
    out["bundle_adjustment"].update(cost_cg=float(res.cost), cost_auto=float(res_auto.cost), route=route)
    for r in (res, res_auto):
        moved = not torch.equal(r.camera_params[:2], start.camera_params[:2])
        if Status(int(r.status)) == Status.NUMERIC_ERROR or moved:
            raise AssertionError(f"bundle_adjustment example: {Status(int(r.status)).name} or a fixed camera moved")
    if route != "dense" or out["bundle_adjustment"]["k11_replayed"] != trials:
        raise AssertionError(f"bundle_adjustment example: route {route}, K11 {out['bundle_adjustment']['k11']} "
                             f"for {trials} trials")
    err, _, drift = _example(out, "fleet_and_fixed_lag", fleet_and_fixed_lag.main)
    out["fleet_and_fixed_lag"].update(fleet_x_err=err, drift=drift)
    rms, rms_px = _example(out, "sfm_reconstruct", sfm_reconstruct.main)
    out["sfm_reconstruct"].update(aligned_rms=rms, reprojection_rms_px=rms_px)
    print(f"examples: sfm aligned landmark RMS {rms:.4f}, reprojection RMS {rms_px:.4f} px")
    launches = {k: (v["k5"], v["k6"], v["k11"]) for k, v in out.items()}
    expect_k5 = {"icp_registration", "fleet_and_fixed_lag"}
    if any((k in expect_k5) != (v[0] > 0) for k, v in launches.items()):
        raise AssertionError(f"examples: K5 launches {launches}")
    if any((k == "fleet_and_fixed_lag") != (v[1] > 0) for k, v in launches.items()):
        raise AssertionError(f"examples: K6 launches {launches}")
    if any(k != "bundle_adjustment" and v[2] for k, v in launches.items()):
        raise AssertionError(f"examples: K11 launches {launches}")
    return out


def run_blocked(prob, dense_res, dev):
    """17: solve_ba_dense(schur_solver="blocked") on the headline against
    phase 5's "auto" solve (first outer iterations and final cost to
    BA_COST_RTOL, K11 once a trial), and spd_solve_blocked against one
    cholesky_ex solve at BLOCKED_SIZES: relative residuals and CUDA-event
    times."""
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(schur_solver="blocked"))
    cost = float(res.cost)
    wall_s = time.perf_counter() - t0
    rel = abs(cost / float(dense_res.cost) - 1)
    early = _early_gap(_early_costs(res.trace), _early_costs(dense_res.trace))
    trials = sum(res.trace["trials"].tolist())
    k11, replayed = k_schur.launches(), k_schur.replayed()
    print(f"dense BA with schur_solver='blocked': wall {wall_s:.4f} s, trials {trials}, K11 launches "
          f"{k11} ({replayed} replayed), final cost {cost:.6e} ({rel:.3e} from phase 5's 'auto' solve); first "
          f"{SHARDED_BA_TRACE_ITERS} outer iterations' costs {early:.3e} from its (bound {BA_COST_RTOL:g})")
    _check_descent("dense BA (blocked)", prob, res, cost)
    if not rel <= BA_COST_RTOL or not early <= BA_COST_RTOL or replayed != trials:
        raise AssertionError(f"dense BA (blocked): {rel}, {early} from phase 5's; K11 {replayed} replayed")
    out = dict(wall_s=wall_s, cost=cost, rel_auto=rel, early_rel_auto=early, k11=k11, k11_replayed=replayed, spd={})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in BLOCKED_SIZES:
        M = torch.randn(n, n, device=dev, generator=gen)
        A = M @ M.T / n + torch.eye(n, device=dev)
        del M
        b = torch.randn(n, device=dev, generator=gen)
        row = {}
        for name, fn in (("blocked", lambda: spd_solve_blocked(A, b)), ("cholesky_ex", lambda: spd_solve(A, b))):
            x = fn().double()
            resid = float(torch.linalg.vector_norm(A.double() @ x - b.double()) / torch.linalg.vector_norm(b.double()))
            row[name] = dict(residual=resid, ms=_time_ms(fn, 3))
        blk, chol = row["blocked"], row["cholesky_ex"]
        print(f"spd_solve_blocked at n = {n}: relative residual {blk['residual']:.3e} in {blk['ms']:.3f} ms; one "
              f"cholesky_ex + cholesky_solve {chol['residual']:.3e} in {chol['ms']:.3f} ms (CUDA events; bound "
              f"{BLOCKED_RESIDUAL:g})")
        if not max(r["residual"] for r in row.values()) <= BLOCKED_RESIDUAL:
            raise AssertionError(f"spd_solve_blocked at n = {n}: residuals {row}")
        out["spd"][n] = row
        del A
    return out


def _digest(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _host_ms(fn, reps=5):
    """Median ms of fn() between two synchronisations, both processes
    starting together (a gloo barrier before each)."""
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def _rank_path(fn, lm=False):
    """15, in each process: a solve across the processes by its graph twice
    (the first captures its layout in this process) and by its step's body
    run eagerly on the card (an LM body inside ``capturable_linalg``, on
    which its step is captured), every kernel count set to 0 before each
    and read after. Returns (the second graph solve's result, its row)."""
    dev = torch.device("cuda", 0)
    n0 = len(device_loop.CAPTURES)
    _reset_launches()
    first, first_s, _ = _loop_timed(fn)
    transport = k_mesh.launches()
    captured = len(device_loop.CAPTURES) - n0
    loop = _latest_loop()
    replays = loop.replays
    _reset_launches()
    graph, graph_s, graph_reads = _loop_timed(fn)
    replays = loop.replays - replays
    k11, t_replayed, t_eager = k_schur.replayed(), k_mesh.replayed(), k_mesh.LAUNCHES
    k11_eager_in_graph = k_schur.LAUNCHES
    _reset_launches()
    all_reduces = mesh_module.ALL_REDUCES
    with device_loop.eager(), (capturable_linalg(dev) if lm else contextlib.nullcontext()):
        eager, eager_s, eager_reads = _loop_timed(fn)
    res = graph if lm else _ba_result(graph)
    row = dict(first_s=first_s, graph_s=graph_s, eager_s=eager_s, captured=captured,
               captures=[c for c in device_loop.CAPTURES[n0:]], reads=dict(graph=graph_reads, eager=eager_reads),
               replays=replays, iterations=int(res.iterations), status=int(res.status), outer=_outer_run(res),
               bit_equal_eager=_same_result(graph, eager), bit_equal_repeat=_same_result(graph, first),
               k11_replayed=k11, k11_eager_in_graph=k11_eager_in_graph, k11_eager=k_schur.LAUNCHES,
               transport=dict(first=transport, replayed=t_replayed, eager_in_graph=t_eager, eager=k_mesh.LAUNCHES,
                              eager_all_reduces=mesh_module.ALL_REDUCES - all_reduces))
    row["launches"] = transport + t_replayed + t_eager + k_mesh.LAUNCHES
    return graph, row


def _ba_digests(res, intr=None):
    return [_digest(res.cost), _digest(res.camera_params), _digest(res.points)] + ([_digest(intr)] if intr is not None
                                                                                   else [])


def _gloo_mesh():
    """The processes' mesh over gloo: ``global_mesh`` with the placement
    rule patched to pick it."""
    choose = multihost.choose_transport
    multihost.choose_transport = lambda places: "gloo"
    try:
        return multihost.global_mesh(shards_per_process=2)
    finally:
        multihost.choose_transport = choose


def _transport_checks(mesh, dev):
    """15, in each process: the transport kernel (``mesh.link.all_reduce``)
    against its plain version on the card, bit for bit, for sum and max in
    float32 and float64 at TRANSPORT_SIZES (partials over 12 decades, each
    rank its own); its ms at S's size (float32 sum) beside the plain
    version's and gloo's all-reduce of the CUDA tensor, and µs at the small
    size; then a fresh transport with TRANSPORT_TIMEOUT_S whose second
    reduction rank 1 skips: rank 0's check must raise, naming the epoch,
    rank 1's must not."""
    import torch.distributed as dist

    rng = np.random.default_rng(SEED + 40 + mesh.process_index)
    cases, worst = [], 0.0
    for n in TRANSPORT_SIZES:
        for dtype in (torch.float32, torch.float64):
            x = torch.as_tensor(rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, size=n), dtype=dtype, device=dev)
            for op in k_mesh.OPS:
                kernel = mesh.link.all_reduce(x, op)
                plain = mesh_module._all_reduce_plain(x, op, mesh.group)
                same = _same_result(kernel, plain)
                err = float((kernel.double() - plain.double()).abs().max())
                worst = max(worst, err)
                cases.append(dict(n=n, dtype=str(dtype), op=op, bit_equal=same, max_abs_err=err,
                                  digest=_digest(kernel)))
    s = torch.as_tensor(rng.normal(size=TRANSPORT_SIZES[0]), dtype=torch.float32, device=dev)
    small = s[:TRANSPORT_SIZES[1]].clone()
    times = {}
    for name, t, reps in (("kernel", s, 50), ("kernel_small", small, 200)):
        mesh.link.all_reduce(t, "sum")
        torch.cuda.synchronize()
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mesh.link.all_reduce(t, "sum")
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / reps
    times["plain"] = _host_ms(lambda: mesh_module._all_reduce_plain(s, "sum", mesh.group))
    times["library"] = _host_ms(lambda: dist.all_reduce(s.clone()))
    mesh.link.check()

    probe = k_mesh.IpcBuffers(mesh.group, mesh.process_index, mesh.n_processes, dev, timeout_s=TRANSPORT_TIMEOUT_S)
    probe.all_reduce(small, "sum")
    if mesh.process_index == 0:
        probe.all_reduce(small, "sum")  # rank 1 never arrives
    t0 = time.perf_counter()
    try:
        probe.check()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    timeout = dict(raised=raised, wall_s=time.perf_counter() - t0)
    probe.close()
    return dict(cases=cases, max_abs_err=worst, ms=times, timeout=timeout, bytes=s.numel() * 4,
                slot_bytes=mesh.link.buffers[0].slot_bytes, buffers=len(mesh.link.buffers[0].generations))


def rank_main(rank, port):
    """One of phase 15's two processes: both join a gloo group at
    localhost:port and make a global mesh of 2 processes × 2 shards on the
    card, whose transport must be the device all-reduce; over it, the 64-row
    curve fit through make_global_block + distributed_levenberg_marquardt
    (float64, each process feeding its 32 rows), solve_ba_dense_sharded on
    the headline (float32), the observation-sharded CG solve on it (each
    process its own rows) and phase 18's self-calibration, each by its graph
    and eagerly (``_rank_path``); the CG again over a gloo mesh; the
    transport's checks (``_transport_checks``). Prints one RESULT line of
    JSON."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=TWO_PROCESS_TIMEOUT_S)
    mesh = multihost.global_mesh(shards_per_process=2)
    out = dict(rank=rank, shards=mesh.shape["data"], transport=mesh.transport)
    if mesh.transport != "device" or mesh.link is None:
        raise AssertionError(f"rank {rank}: two processes on one card took the {mesh.transport!r} transport")

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    data = torch.as_tensor(curve_fitting.CERES_CURVE_DATA[:64], dtype=torch.float64, device=dev)
    blk = multihost.make_global_block(make_block(residual, data=multihost.host_local_shard(data)), mesh)
    res, row = _rank_path(lambda: distributed_levenberg_marquardt(
        problem(blk), torch.zeros(2, dtype=torch.float64, device=dev), mesh, LMConfig(max_iterations=25)), lm=True)
    out["curve"] = dict(row, x=res.x.tolist(), bits=_digest(res.x), rows=blk.data.shape[0])

    prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    res, row = _rank_path(functools.partial(ba_dense.solve_ba_dense_sharded, prob, mesh))
    out["ba"] = dict(row, cost=float(res.cost), digests=_ba_digests(res), trials=res.trace["trials"].tolist(),
                     early=_early_costs(res.trace),
                     fixed_unmoved=bool(torch.equal(res.camera_params[:2], prob.camera_params[:2])))

    sp = _observation_sharded(prob, mesh, multihost.host_local_shard)
    res, row = _rank_path(functools.partial(ba.solve_ba, sp, ba.BAConfig()))
    try:
        ba.solve_ba(sp, engine="dense")
    except ValueError as e:
        refused = "solve_ba_dense_sharded" in str(e)
    else:
        refused = False
    gloo_sp = _observation_sharded(prob, _gloo_mesh(), multihost.host_local_shard)
    with _timed_all_reduces() as stats:
        gloo, _, gloo_s, gloo_reads = _solve_cg(gloo_sp)
    out["cg"] = dict(row, cost=float(res.cost), digests=_ba_digests(res), trials=res.trace["trials"].tolist(),
                     early=_early_costs(res.trace), dense_refused=refused, rows=sp.pixels.local.shape[0],
                     fixed_unmoved=bool(torch.equal(res.camera_params[:2], prob.camera_params[:2])),
                     gloo=dict(wall_s=gloo_s, reads=gloo_reads, all_reduces=stats, digests=_ba_digests(gloo),
                               transport=gloo_sp.pixels.mesh.transport))

    sp = _observation_sharded(_selfcal_start(prob), mesh, multihost.host_local_shard)
    (res, intr), row = _rank_path(functools.partial(ba_intrinsics.solve_ba_selfcal, sp, ba.BAConfig()))
    out["selfcal"] = dict(row, cost=float(res.cost), intr=intr.tolist(), digests=_ba_digests(res, intr),
                          early=_selfcal_early(sp),
                          fixed_unmoved=bool(torch.equal(res.camera_params[:2], prob.camera_params[:2])))
    out["launches"] = sum(out[k]["launches"] for k in ("curve", "ba", "cg", "selfcal"))
    out["captures"] = len(device_loop.CAPTURES)
    out["check"] = _transport_checks(mesh, dev)
    print("RESULT " + json.dumps(out), flush=True)
    mesh.close()
    dist.destroy_process_group()


def _print_rank_path(rank, name, row):
    t = row["transport"]
    print(f"two processes, rank {rank}, {name}: first call {row['first_s']:.4f} s ({row['captured']} captures), "
          f"graph {row['graph_s']:.4f} s, eager body {row['eager_s']:.4f} s; host reads graph {row['reads']['graph']}, "
          f"eager {row['reads']['eager']}; replays {row['replays']}; iterations {row['iterations']}; bit-equal to "
          f"its eager body {row['bit_equal_eager']}, to its first solve {row['bit_equal_repeat']}; transport launches "
          f"first {t['first']}, graph {t['replayed']} replayed + {t['eager_in_graph']} eager, eager body {t['eager']} "
          f"({t['eager_all_reduces']} all-reduces)" + (f"; K11 replayed {row['k11_replayed']}, eager body "
                                                       f"{row['k11_eager']}" if row["k11_eager"] else ""))
    for c in row["captures"]:
        print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
              f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")


def _hold_rank_path(name, a, b, reads):
    """A path of both processes: captured, bit-equal to its eager body and
    its repeat, ``reads`` host reads in the loop, the transport launched."""
    for res in (a, b):
        row = res[name]
        if not row["captured"] or not row["bit_equal_eager"] or not row["bit_equal_repeat"]:
            raise AssertionError(f"two processes, rank {res['rank']}, {name}: captures {row['captured']}, bit-equal "
                                 f"to its eager body {row['bit_equal_eager']}, to its repeat {row['bit_equal_repeat']}")
        expected = reads(row)
        if row["reads"]["graph"] != expected or not row["transport"]["replayed"] or row["replays"] < 1:
            raise AssertionError(f"two processes, rank {res['rank']}, {name}: {row['reads']['graph']} host reads "
                                 f"(expected {expected}), transport replayed {row['transport']['replayed']}")


def _hold_two_process_selfcal(a, b, truth, single, single_early):
    """18 across processes: ranks a and b's self-calibrations (their bits
    already compared) against 5(c)'s unsharded solve ``single`` and its
    first iterations' costs: the costs to BA_COST_RTOL and
    TWO_PROCESS_BA_RTOL, the χ² band, the intrinsics to SELFCAL_INTR_TOL of
    ``truth``, fixed cameras unmoved, no K11. Returns rank a's numbers."""
    sc = a["selfcal"]
    rel = abs(sc["cost"] / float(single.cost) - 1)
    early = _early_gap(sc["early"], single_early)
    err = max(abs(u - v) for u, v in zip(sc["intr"], truth.tolist()))
    floor = _chi2_floor(BA_O, BA_C, BA_L, extra=4)
    print(f"two processes, sharded self-calibrating BA: cost {rel:.3e} from the unsharded self-cal's "
          f"{float(single.cost):.6e} (bound {TWO_PROCESS_BA_RTOL:g}), its first {SHARDED_BA_TRACE_ITERS} outer "
          f"iterations' costs {early:.3e} from its (bound {BA_COST_RTOL:g}), intrinsics {sc['intr']}, "
          f"{err:.4e} px from the true ones (bound {SELFCAL_INTR_TOL:g})")
    if not early <= BA_COST_RTOL or not rel <= TWO_PROCESS_BA_RTOL:
        raise AssertionError(f"two processes: sharded self-cal BA {rel}, {early} from the unsharded one's")
    if (not err <= SELFCAL_INTR_TOL or not sc["fixed_unmoved"] or sc["k11_eager"] or sc["k11_replayed"]
            or abs(sc["cost"] / floor - 1) > BA_BAND):
        raise AssertionError(f"two processes: sharded self-cal BA {sc}")
    return dict({k: sc[k] for k in ("graph_s", "eager_s", "cost", "iterations", "intr", "launches")},
                rel_unsharded=rel, early_rel_unsharded=early, intrinsics_err=err)


def _hold_transport(a, b):
    """15's transport checks of both processes: every case bit-equal and the
    same bits in both, rank 0's probe raised (naming its epoch) within
    TRANSPORT_TIMEOUT_S + 1 s, rank 1's did not; the transport launched on
    the main path of both."""
    ca, cb = a["check"], b["check"]
    for res in (a, b):
        c = res["check"]
        print(f"two processes, rank {res['rank']}: transport kernel against its plain version: "
              + ", ".join(f"{k['op']} {k['dtype'].split('.')[-1]} n={k['n']} {k['bit_equal']}" for k in c["cases"])
              + f"; all-reduce of S ({c['bytes']} bytes) kernel {c['ms']['kernel']:.4f} ms, plain (all-gather over "
              f"gloo + sum) {c['ms']['plain']:.3f} ms, gloo {c['ms']['library']:.3f} ms; {TRANSPORT_SIZES[1]} "
              f"elements {c['ms']['kernel_small'] * 1e3:.2f} µs; slots {c['slot_bytes']} bytes in {c['buffers']} "
              f"buffers; main-path launches {res['launches']}; probe: raised {bool(c['timeout']['raised'])} in "
              f"{c['timeout']['wall_s']:.3f} s ({c['timeout']['raised'][:120]})")
    same = [x["digest"] == y["digest"] for x, y in zip(ca["cases"], cb["cases"])]
    if not all(k["bit_equal"] for c in (ca, cb) for k in c["cases"]) or not all(same):
        raise AssertionError(f"two processes: the transport kernel differs from its plain version {ca} {cb}")
    t0, t1 = ca["timeout"], cb["timeout"]
    if "epoch 2" not in t0["raised"] or t0["wall_s"] > TRANSPORT_TIMEOUT_S + 1.0 or t1["raised"]:
        raise AssertionError(f"two processes: the skipped reduction: rank 0 {t0}, rank 1 {t1}")
    if not a["launches"] or not b["launches"]:
        raise AssertionError(f"two processes: the transport launched {a['launches']}, {b['launches']} times")


def run_two_processes(ba4, cg4, selfcal):
    """15: this script's rank_main in two processes on the one card. Each
    must exit 0 within TWO_PROCESS_TIMEOUT_S (both are killed otherwise),
    both must print the same bits, every path must capture and equal its
    eager body, the dense BA must agree with 14(b)'s 4-shard solve, the
    sharded CG BA with 16's (and its gloo solve with it bit for bit) and the
    sharded self-cal (18) with 5(c)'s unsharded one: their first iterations'
    costs to BA_COST_RTOL, the final costs to TWO_PROCESS_BA_RTOL. selfcal:
    (the truth's intrinsics, 5(c)'s result, its first iterations' costs)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--port", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TWO_PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    results = {}
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"two processes: rank {r} exited {p.returncode}:\n{text[-4000:]}")
        for line in text.splitlines():
            if line.startswith("RESULT "):
                results[r] = json.loads(line[len("RESULT "):])
    if set(results) != {0, 1}:
        raise AssertionError(f"two processes: results from ranks {sorted(results)}:\n{outs}")
    a, b = results[0], results[1]
    for res in (a, b):
        for name in ("curve", "ba", "cg", "selfcal"):
            _print_rank_path(res["rank"], name, res[name])
    same = all(a[k][f] == b[k][f] for k, fs in (("curve", ("bits", "status", "iterations")),
                                               ("ba", ("digests", "trials")), ("cg", ("digests", "trials")),
                                               ("selfcal", ("digests", "iterations", "early")))
               for f in fs)
    cg_rel = abs(a["cg"]["cost"] / float(cg4.cost) - 1)
    cg_early = _early_gap(a["cg"]["early"], _early_costs(cg4.trace))
    rel = abs(a["ba"]["cost"] / float(ba4.cost) - 1)
    early = _early_gap(a["ba"]["early"], _early_costs(ba4.trace))
    builds = sum(a["ba"]["trials"])
    print(f"two processes: wall {wall_s:.3f} s (start to exit); transport {a['transport']}, {b['transport']}; "
          f"captures {a['captures']}, {b['captures']}; results bit-equal between the ranks: {same}; curve fit x "
          f"{a['curve']['x']}; BA cost {rel:.3e} from the 4-shard solve's {float(ba4.cost):.6e} (bound "
          f"{TWO_PROCESS_BA_RTOL:g}), its first {SHARDED_BA_TRACE_ITERS} outer iterations' costs {early:.3e} from its "
          f"(bound {BA_COST_RTOL:g}), S builds {builds}")
    if not same:
        raise AssertionError(f"two processes: the results differ: {a} {b}")
    _hold_rank_path("curve", a, b, lambda row: 0)
    _hold_rank_path("ba", a, b, lambda row: 0)
    _hold_rank_path("cg", a, b, lambda row: 0)
    _hold_rank_path("selfcal", a, b, lambda row: row["outer"])
    if not early <= BA_COST_RTOL:
        raise AssertionError(f"two processes: the first iterations' costs are {early} from the 4-shard solve's")
    if not rel <= TWO_PROCESS_BA_RTOL or not a["ba"]["fixed_unmoved"]:
        raise AssertionError(f"two processes: BA cost {rel} from the 4-shard solve's, fixed {a['ba']['fixed_unmoved']}")
    for res in (a, b):
        g = res["cg"]["gloo"]
        print(f"two processes, rank {res['rank']}: sharded CG BA over its {res['cg']['rows']} rows on the gloo route: "
              f"wall {g['wall_s']:.4f} s, all-reduces {g['all_reduces']['count']} ({g['all_reduces']['ms']:.1f} ms), "
              f"host reads {g['reads']}; digests equal to the device route's {g['digests'] == res['cg']['digests']}; "
              f"engine='dense' refused: {res['cg']['dense_refused']}")
    print(f"two processes, sharded CG BA: cost {cg_rel:.3e} from the 4-shard solve's {float(cg4.cost):.6e} (bound "
          f"{TWO_PROCESS_BA_RTOL:g}), its first {SHARDED_BA_TRACE_ITERS} outer iterations' costs {cg_early:.3e} from "
          f"its (bound {BA_COST_RTOL:g})")
    if not cg_early <= BA_COST_RTOL or not cg_rel <= TWO_PROCESS_BA_RTOL:
        raise AssertionError(f"two processes: sharded CG BA {cg_rel}, {cg_early} from the 4-shard solve's")
    if any(res["cg"]["gloo"]["digests"] != res["cg"]["digests"] or res["cg"]["gloo"]["transport"] != "gloo"
           for res in (a, b)):
        raise AssertionError("two processes: the CG solve on the gloo route differs from the device route's")
    if (not a["cg"]["fixed_unmoved"] or a["cg"]["k11_replayed"] or a["cg"]["k11_eager"]
            or not (a["cg"]["dense_refused"] and b["cg"]["dense_refused"])):
        raise AssertionError(f"two processes: sharded CG BA {a['cg']} {b['cg']}")
    for res in (a, b):
        d = res["ba"]
        if not d["k11_replayed"] == d["k11_eager"] == 2 * builds or d["k11_eager_in_graph"]:
            raise AssertionError(f"two processes: K11 replayed {d['k11_replayed']}, eager {d['k11_eager']} "
                                 f"({d['k11_eager_in_graph']} eager in the graph solve) for 2 x {builds} S builds")
    if a["curve"]["status"] == Status.NUMERIC_ERROR:
        raise AssertionError("two processes: the curve fit ended NUMERIC_ERROR")
    sc = _hold_two_process_selfcal(a, b, *selfcal)
    curve_err = max(abs(u - v) for u, v in zip(a["curve"]["x"], CURVE_MINIMUM_64))
    if curve_err > 5e-5:
        raise AssertionError(f"two processes: the curve fit is {curve_err} from its minimum")
    _hold_transport(a, b)
    paths = {k: {f: a[k][f] for f in ("first_s", "graph_s", "eager_s", "captured", "reads", "replays", "launches",
                                      "transport")} for k in ("curve", "ba", "cg", "selfcal")}
    return dict(wall_s=wall_s, captures=[a["captures"], b["captures"]], paths=paths, rel_4_shard=rel,
                early_rel_4_shard=early, cg_rel_4_shard=cg_rel, cg_early_rel_4_shard=cg_early, selfcal=sc,
                k11=a["ba"]["k11_replayed"], cg_gloo={r["rank"]: r["cg"]["gloo"] for r in (a, b)},
                transport={r["rank"]: dict(r["check"], launches=r["launches"]) for r in (a, b)})


# Phase 24: the sharded solves across processes on two cards or more. Every
# layout is 2 processes × 2 shards, and so the same split of the rows as
# phase 23's 4 shards: processes that each see only their own card(s)
# (CUDA_VISIBLE_DEVICES a process) take the NCCL transport with no switch,
# processes that see every card the device transport (its grouped form
# with two cards a process); each layout's paths are held as phase 23's
# (bit-equal to the eager body, the repeat, across processes and cards;
# within MULTICARD_RTOL, the cameras MULTICARD_CAMERA_BOUND, of the
# unsharded solves; K5's and K11's replayed launches a card equal to the
# eager body's), and a mesh over NCCL must give the bits of the device
# transport's mesh of the same shape: both combine in rank order.
MULTIPROCESS_TIMEOUT_S = 200
MULTIPROCESS_SHARDS = 2
# name → each rank's CUDA_VISIBLE_DEVICES (cards of the machine, shifted by
# the layout's first card) and its devices among those it sees; the
# transport global_mesh must pick; the cards the layout needs.
MULTIPROCESS_LAYOUTS = {
    "a card a process, NCCL": dict(visible=("0", "1"), devices=((0,), (0,)), transport="nccl", cards=2),
    "a card a process, device": dict(visible=("0,1", "0,1"), devices=((0,), (1,)), transport="device", cards=2),
    "2 cards a process, device": dict(visible=("0,1,2,3", "0,1,2,3"), devices=((0, 1), (2, 3)), transport="device",
                                      cards=4),
    "2 cards a process, NCCL": dict(visible=("0,1", "2,3"), devices=((0, 1), (0, 1)), transport="nccl", cards=4),
}
# the layouts whose processes run the timeout probe and the gloo CG
MULTIPROCESS_PROBED = ("a card a process, NCCL", "2 cards a process, NCCL")
MULTIPROCESS_GLOO = "a card a process, NCCL"
MULTIPROCESS_PATHS = ("curve", "icp", "cg", "selfcal", "dense")


def _link_module(mesh):
    return nccl_transport if mesh.transport == "nccl" else k_mesh


def _mp_path(name, mesh, fn, kernel, lm):
    """24, in each process: one path over the mesh by its graphs twice (the
    first captures) and by its eager body, every count set to 0 before each
    (as ``_multicard_path``); returns its row, with the result's digests."""
    dev = mesh.devices[0]
    link = _link_module(mesh)
    n0 = len(device_loop.CAPTURES)
    _reset_launches()
    first, first_s, _ = _loop_timed(fn)
    captured = len(device_loop.CAPTURES) - n0
    loops = _latest_loop()
    each = loops.loops if isinstance(loops, device_loop.CardLoops) else [loops]
    replays = [loop.replays for loop in each]
    _reset_launches()
    graph, graph_s, graph_reads = _loop_timed(fn)
    replays = [loop.replays - r for loop, r in zip(each, replays)]
    per_card = _card_bits(loops) if len(each) > 1 else True
    cards = mesh.cards
    k_replayed = {str(d): v for d, v in (kernel.replayed_by_card() if kernel else {}).items() if d in cards}
    k_eager_in_graph = k_nn.LAUNCHES + k_expand.LAUNCHES + k_schur.LAUNCHES + k_matvec.LAUNCHES
    mv_replayed = _matvec_by_card(mesh.card_groups())
    t_replayed = {str(d): v for d, v in link.replayed_by_card().items() if d in cards}
    c_replayed = {str(d): v for d, v in k_mesh.replayed_by_card().items() if d in cards} if len(cards) > 1 else {}
    t_eager_in_graph = link.LAUNCHES + (k_mesh.LAUNCHES if link is not k_mesh else 0)
    _reset_launches()
    with device_loop.eager(), (capturable_linalg(dev) if lm else contextlib.nullcontext()):
        eager, eager_s, eager_reads = _loop_timed(fn)
    k_eager = {str(d): v for d, v in (kernel.LAUNCHES_BY_CARD if kernel else {}).items()}
    t_eager = link.LAUNCHES
    res = graph if lm else _ba_result(graph)
    groups = mesh.card_groups()
    if kernel is k_nn:
        expect = {str(d): len(js) * int(torch.isfinite(res.trace["cost"]).sum()) for d, js in groups}
    elif kernel is k_schur:
        expect = {str(d): len(js) * sum(res.trace["trials"].tolist()) for d, js in groups}
    else:
        expect = {}
    run = _outer_run(res)
    if lm:
        digests, value = [_digest(res.x)], dict(x=res.x.double().cpu().tolist())
    else:
        intr = graph[1] if not isinstance(graph, ba.BAResult) else None
        digests = _ba_digests(res, intr)
        value = dict(cost=float(res.cost), cams=res.camera_params.double().cpu().tolist())
    return dict(first_s=first_s, graph_s=graph_s, eager_s=eager_s, captured=captured,
                captures=[dict(c) for c in device_loop.CAPTURES[n0:]], reads=dict(graph=graph_reads, eager=eager_reads),
                replays=replays, trace_len=int(loops.trace["cost"].shape[-1]), outer=run,
                iterations=int(res.iterations), status=Status(int(res.status)).name,
                bit_equal_eager=_same_result(graph, eager), bit_equal_repeat=_same_result(graph, first),
                cards_bit_equal=per_card, difference="" if _same_result(graph, eager) else _first_difference(graph, eager),
                kernel_replayed=k_replayed, kernel_eager=k_eager, kernel_runs=expect,
                kernel_eager_in_graph=k_eager_in_graph, matvec_replayed=mv_replayed,
                matvec_runs=_matvec_card_runs(res, groups, lm, name == "selfcal"),
                transport_replayed=t_replayed, card_replayed=c_replayed,
                transport_eager_in_graph=t_eager_in_graph, transport_eager=t_eager, digests=digests, **value)


def _mp_transport(mesh, dev, probe):
    """24, in each process: the mesh's link against its plain version
    (``_all_reduce_plain``) bit for bit on every card, sum and max, float32
    and float64 at TRANSPORT_SIZES; its µs at both sizes on the first card
    (CUDA events, both processes after a barrier); with ``probe``, a fresh
    link of the same kind with TRANSPORT_TIMEOUT_S whose second reduction
    rank 1 skips: rank 0's check must raise, naming the epoch."""
    import torch.distributed as dist

    link = mesh.link
    rng = np.random.default_rng(SEED + 70 + mesh.process_index)
    cases, worst = [], 0.0
    for c, card in enumerate(mesh.cards):
        for n in TRANSPORT_SIZES:
            for dtype in (torch.float32, torch.float64):
                x = torch.as_tensor(rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, size=n), dtype=dtype,
                                    device=card)
                for op in k_mesh.OPS:
                    got = link.all_reduce(x, op, c)
                    plain = mesh_module._all_reduce_plain(x, op, mesh.group)
                    err = float((got.double() - plain.double()).abs().max())
                    worst = max(worst, err)
                    cases.append(dict(card=c, n=n, dtype=str(dtype), op=op, bit_equal=_same_result(got, plain),
                                      max_abs_err=err, digest=_digest(got)))
    us = {}
    for key, n, reps in (("s", TRANSPORT_SIZES[0], 50), ("small", TRANSPORT_SIZES[1], 200)):
        x = torch.ones(n, dtype=torch.float32, device=dev)
        link.all_reduce(x, "sum", 0)
        torch.cuda.synchronize()
        dist.barrier()
        us[key] = _time_ms(lambda: link.all_reduce(x, "sum", 0), reps) * 1e3
    s = torch.ones(TRANSPORT_SIZES[0], dtype=torch.float32, device=dev)
    us["plain_s"] = _host_ms(lambda: mesh_module._all_reduce_plain(s, "sum", mesh.group)) * 1e3
    mesh.check()
    row = dict(cases=cases, max_abs_err=worst, us=us, bytes=TRANSPORT_SIZES[0] * 4)
    if mesh.transport == "nccl":
        row["nccl_version"] = nccl_transport.version()
    if probe:
        kind = nccl_transport.NcclTransport if mesh.transport == "nccl" else k_mesh.IpcLinks
        fresh = kind(mesh.group, mesh.process_index, mesh.n_processes, mesh.cards, timeout_s=TRANSPORT_TIMEOUT_S)
        small = torch.ones(TRANSPORT_SIZES[1], device=dev)
        fresh.all_reduce(small, "sum", 0)
        if mesh.process_index == 0:
            fresh.all_reduce(small, "sum", 0)  # rank 1 never arrives
        t0 = time.perf_counter()
        try:
            fresh.check()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        row["timeout"] = dict(raised=raised, wall_s=time.perf_counter() - t0)
        fresh.close()
    return row


def multiprocess_rank_main(rank, port, layout):
    """One of phase 24's two processes in ``layout`` (MULTIPROCESS_LAYOUTS):
    a gloo group at localhost:port, a global mesh of 2 processes × 2 shards
    over its devices, whose transport must be the layout's, and over it the
    curve fit (float64, each process its 32 of 64 rows), the distributed
    ICP (K5; the fachada scan's first 29,304 points), the CG and
    self-calibrating BA (each process its rows) and the sharded dense BA
    (K11) at the headline, each by ``_mp_path``; the link's checks
    (``_mp_transport``); in one layout the CG again over a gloo mesh.
    Prints one RESULT line of JSON."""
    import torch.distributed as dist

    spec = MULTIPROCESS_LAYOUTS[layout]
    # every thread's stack, before the parent kills a process that hangs
    faulthandler.dump_traceback_later(MULTIPROCESS_TIMEOUT_S - 30)
    devices = [torch.device("cuda", i) for i in spec["devices"][rank]]
    dev = devices[0]
    torch.cuda.set_device(dev)
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank,
                         initialization_timeout=MULTIPROCESS_TIMEOUT_S)
    t0 = time.perf_counter()
    mesh = multihost.global_mesh(shards_per_process=MULTIPROCESS_SHARDS, device=devices)
    out = dict(rank=rank, layout=layout, transport=mesh.transport, cards=[str(c) for c in mesh.cards],
               mesh_s=time.perf_counter() - t0, visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
               in_if_bodies=getattr(mesh.link, "in_if_bodies", None))
    if mesh.transport != spec["transport"] or mesh.link is None:
        raise AssertionError(f"phase 24 {layout}, rank {rank}: the {mesh.transport!r} transport, link {mesh.link}")

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    data = torch.as_tensor(curve_fitting.CERES_CURVE_DATA[:MULTICARD_CURVE_ROWS], dtype=torch.float64, device=dev)
    curve = problem(multihost.make_global_block(make_block(residual, data=multihost.host_local_shard(data)), mesh))
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    tgt = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))
    src = cloud[: cloud.shape[0] // 12 * 12]
    icp_x0 = _centroid_seed(src, tgt)
    prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    sp = _observation_sharded(prob, mesh, multihost.host_local_shard)
    ssp = _observation_sharded(_selfcal_start(prob), mesh, multihost.host_local_shard)
    cfg = ba.BAConfig()
    paths = {
        "curve": (functools.partial(distributed_levenberg_marquardt, curve, torch.zeros(2, dtype=torch.float64,
                                                                                         device=dev), mesh,
                                    LMConfig(max_iterations=25)), None, True),
        "icp": (functools.partial(distributed_levenberg_marquardt, problem(icp_block(src, tgt)), icp_x0, mesh,
                                  _icp_config()), k_nn, True),
        "cg": (functools.partial(ba.solve_ba, sp, cfg), None, False),
        "selfcal": (functools.partial(ba_intrinsics.solve_ba_selfcal, ssp, cfg), None, False),
        "dense": (functools.partial(ba_dense.solve_ba_dense_sharded, prob, mesh), k_schur, False),
    }
    for name in MULTIPROCESS_PATHS:
        fn, kernel, lm = paths[name]
        print(f"rank {rank} ({layout}): {name} at {time.perf_counter() - t0:.1f} s", flush=True)
        out[name] = _mp_path(name, mesh, fn, kernel, lm)
    out["captures"] = len(device_loop.CAPTURES)
    out["transport_check"] = _mp_transport(mesh, dev, layout in MULTIPROCESS_PROBED)
    if layout == MULTIPROCESS_GLOO:
        gloo_sp = _observation_sharded(prob, _gloo_mesh(), multihost.host_local_shard)
        with _timed_all_reduces() as stats:
            gloo, _, gloo_s, gloo_reads = _solve_cg(gloo_sp)
        out["cg"]["gloo"] = dict(wall_s=gloo_s, reads=gloo_reads, all_reduces=stats, digests=_ba_digests(gloo),
                                 transport=gloo_sp.pixels.mesh.transport)
    print("RESULT " + json.dumps(out), flush=True)
    mesh.close()
    dist.destroy_process_group()


def _spawn_layout(layout, first_card):
    """Start ``layout``'s two processes (``--rank r --port P --layout``),
    their cards shifted by ``first_card``, each writing to a temporary file
    (a pipe that nobody drains would stop a process at its long RESULT
    line); returns [(Popen, file)]."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spec = MULTIPROCESS_LAYOUTS[layout]
    procs = []
    for r in range(2):
        visible = ",".join(str(int(c) + first_card) for c in spec["visible"][r].split(","))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, NCCL_DEBUG="WARN")
        out = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--port", str(port), "--layout",
             layout], stdout=out, stderr=subprocess.STDOUT, text=True, env=env), out))
    return procs


def _collect_layouts(rounds):
    """Run each round's layouts together (each [(layout, first card)]), the
    rounds one after another; every process must exit 0 within
    MULTIPROCESS_TIMEOUT_S (all are killed otherwise). Returns {layout:
    (rank 0's result, rank 1's, wall s)}."""
    results = {}
    for layouts in rounds:
        t0 = time.perf_counter()
        running = [(layout, _spawn_layout(layout, first)) for layout, first in layouts]
        outs = {}
        try:
            for layout, procs in running:
                for p, _ in procs:
                    p.wait(timeout=max(1.0, MULTIPROCESS_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            late = True
        else:
            late = False
        finally:
            for _, procs in running:
                for p, _ in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for layout, procs in running:
            outs[layout] = []
            for _, f in procs:
                f.seek(0)
                outs[layout].append(f.read())
                f.close()
        if late:
            tails = "\n".join(f"--- {layout}, rank {r}:\n{text[-4000:]}" for layout, texts in outs.items()
                               for r, text in enumerate(texts))
            raise AssertionError(f"phase 24: a process ran past {MULTIPROCESS_TIMEOUT_S} s; the output:\n{tails}")
        wall = time.perf_counter() - t0
        for layout, procs in running:
            got = {}
            for r, ((p, _), text) in enumerate(zip(procs, outs[layout])):
                if p.returncode != 0:
                    raise AssertionError(f"phase 24 {layout}: rank {r} exited {p.returncode}:\n{text[-4000:]}")
                for line in text.splitlines():
                    if line.startswith("RESULT "):
                        got[r] = json.loads(line[len("RESULT "):])
            if set(got) != {0, 1}:
                raise AssertionError(f"phase 24 {layout}: results from ranks {sorted(got)}:\n{outs[layout]}")
            results[layout] = (got[0], got[1], wall)
    return results


def _hold_mp_path(layout, name, a, b, ref, lm):
    """24: one path of a layout's two processes against the checks of the
    module docstring; prints its line."""
    ra, rb = a[name], b[name]
    for row, rank in ((ra, 0), (rb, 1)):
        print(f"multi-process {name} over {layout}, rank {rank}: {row['status']}, iterations {row['iterations']}; "
              f"first call {row['first_s']:.4f} s ({row['captured']} captures), graphs {row['graph_s']:.4f} s, eager "
              f"body {row['eager_s']:.4f} s; host reads graph {row['reads']['graph']}, eager {row['reads']['eager']}; "
              f"replays a card {row['replays']}; bit-equal eager {row['bit_equal_eager']}, repeat "
              f"{row['bit_equal_repeat']}, across cards {row['cards_bit_equal']}; link replayed "
              f"{row['transport_replayed']} (+{row['transport_eager_in_graph']} eager after the loop), eager body "
              f"{row['transport_eager']}"
              + (f", card transport replayed {row['card_replayed']}" if row["card_replayed"] else "")
              + (f"; kernel replayed {row['kernel_replayed']}, eager {row['kernel_eager']}, runs {row['kernel_runs']}"
                 if row["kernel_runs"] else "")
              + f"; schur matvec replayed {row['matvec_replayed']} (expected {row['matvec_runs'] or 'some'})")
        for c in row["captures"]:
            print(f"  capture {c['name']}: warm-up {c['warm_ms']:.1f} ms, capture {c['capture_ms']:.1f} ms, "
                  f"instantiation {c['instantiate_ms']:.1f} ms, pools {c['pool_bytes'] / 2**20:.1f} MiB")
        if not (row["bit_equal_eager"] and row["bit_equal_repeat"] and row["cards_bit_equal"] and row["captured"]):
            raise AssertionError(f"multi-process {name} over {layout}, rank {rank}: captures {row['captured']}, the "
                                 f"graphs differ from the eager body ({row['difference']}), the repeat or across cards")
        reads = row["outer"] if name == "selfcal" else 0
        replays = row["outer"] if name == "selfcal" else row["trace_len"]
        if (row["reads"]["graph"] != reads or set(row["replays"]) != {replays} or row["kernel_eager_in_graph"]
                or not all(v > 0 for v in row["transport_replayed"].values())
                or len(row["transport_replayed"]) != len(row["replays"])):
            raise AssertionError(f"multi-process {name} over {layout}, rank {rank}: {row}")
        if row["kernel_runs"] and not (row["kernel_replayed"] == row["kernel_eager"] == row["kernel_runs"]
                                       and all(row["kernel_runs"].values())):
            raise AssertionError(f"multi-process {name} over {layout}, rank {rank}: kernel replayed "
                                 f"{row['kernel_replayed']}, eager {row['kernel_eager']}, for {row['kernel_runs']}")
        if not _matvec_cards_ok(row["matvec_replayed"], row["matvec_runs"]):
            raise AssertionError(f"multi-process {name} over {layout}, rank {rank}: schur matvec replayed "
                                 f"{row['matvec_replayed']}, expected {row['matvec_runs']}")
    if ra["digests"] != rb["digests"]:
        raise AssertionError(f"multi-process {name} over {layout}: the ranks' results differ")
    if lm:
        gap, camera_gap, camera_bound = float(np.abs(np.array(ra["x"]) - np.array(ref)).max()), None, None
    else:
        gap = abs(ra["cost"] / float(ref.cost) - 1)
        cams = np.array(ra["cams"])
        camera_gap = float(np.abs(cams - ref.camera_params.double().cpu().numpy()).max())
        camera_bound = MULTICARD_CAMERA_BOUND * max(1.0, float(np.abs(cams).max()))
    print(f"multi-process {name} over {layout}: ranks bit-equal; {gap:.3e} from the unsharded solve (bound "
          f"{MULTICARD_RTOL:g})" + ("" if camera_gap is None else f", cameras {camera_gap:.3e} (bound "
                                                                  f"{camera_bound:.3e})"))
    if not gap <= MULTICARD_RTOL or camera_gap is not None and not camera_gap <= camera_bound:
        raise AssertionError(f"multi-process {name} over {layout}: {gap} from the unsharded solve, cameras "
                             f"{camera_gap}")
    return dict({k: ra[k] for k in ("first_s", "graph_s", "eager_s", "captured", "reads", "replays", "iterations",
                                    "status", "kernel_replayed", "kernel_eager", "transport_replayed",
                                    "card_replayed", "transport_eager")},
                eager_s_rank1=rb["eager_s"], graph_s_rank1=rb["graph_s"], unsharded_gap=gap, camera_gap=camera_gap,
                digests=ra["digests"])


def _hold_mp_transport(layout, a, b):
    """24: a layout's link checks of both processes: every case bit-equal
    to the plain version and the same bits in both; where probed, rank 0's
    check raised naming an epoch within TRANSPORT_TIMEOUT_S + 1 s (the
    NCCL watchdog polls every 0.25 s), rank 1's did not."""
    ca, cb = a["transport_check"], b["transport_check"]
    for res, c in ((a, ca), (b, cb)):
        print(f"multi-process {layout}, rank {res['rank']}: {res['transport']} link (cards {res['cards']}, made in "
              f"{res['mesh_s']:.3f} s" + (f", NCCL {c['nccl_version']}" if "nccl_version" in c else "")
              + f") against its plain version: {sum(k['bit_equal'] for k in c['cases'])} of {len(c['cases'])} cases "
              f"bit-equal; an all-reduce of S ({c['bytes']} bytes) {c['us']['s']:.1f} µs, of {TRANSPORT_SIZES[1]} "
              f"floats {c['us']['small']:.1f} µs; the plain version (all-gather over gloo + sum) "
              f"{c['us']['plain_s']:.1f} µs at S"
              + (f"; probe: raised {bool(c['timeout']['raised'])} in {c['timeout']['wall_s']:.3f} s "
                 f"({c['timeout']['raised'][:140]})" if "timeout" in c else ""))
    if not all(k["bit_equal"] for c in (ca, cb) for k in c["cases"]) or [k["digest"] for k in ca["cases"]] != [
            k["digest"] for k in cb["cases"]]:
        raise AssertionError(f"multi-process {layout}: the link differs from its plain version or across ranks")
    if "timeout" in ca:
        t0, t1 = ca["timeout"], cb["timeout"]
        if "epoch" not in t0["raised"] or t0["wall_s"] > TRANSPORT_TIMEOUT_S + 1.0 or t1["raised"]:
            raise AssertionError(f"multi-process {layout}: the skipped reduction: rank 0 {t0}, rank 1 {t1}")
    return dict(us=ca["us"], max_abs_err=max(ca["max_abs_err"], cb["max_abs_err"]), timeout=ca.get("timeout"),
                nccl_version=ca.get("nccl_version"), mesh_s=a["mesh_s"])


def run_multiprocess(dev, cloud, prob=None, refs=None):
    """24: see the module docstring. ``prob`` and ``refs`` as
    ``run_multicard``'s (made here when not given, ``--phase 24``). On four
    cards the two one-card layouts run together, on cards 0-1 and 2-3."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"phase 24: needs 2+ cards, found {n_cards}")
        return None
    t_start = time.perf_counter()

    def residual(x, d):
        return torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])])

    curve = problem(make_block(residual, data=torch.as_tensor(
        curve_fitting.CERES_CURVE_DATA[:MULTICARD_CURVE_ROWS], dtype=torch.float64, device=dev)))
    tgt = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))
    src = cloud[: cloud.shape[0] // 12 * 12]
    if prob is None:
        prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    if refs is None:
        cg_cfg = ba.BAConfig()
        refs = dict(cg=ba.solve_ba(prob, cg_cfg), selfcal=ba_intrinsics.solve_ba_selfcal(_selfcal_start(prob),
                                                                                           cg_cfg)[0],
                    dense=ba_dense.solve_ba_dense(prob))
    refs = dict(refs, curve=levenberg_marquardt(curve, torch.zeros(2, dtype=torch.float64, device=dev),
                                                LMConfig(max_iterations=25)).x.double().cpu().tolist(),
                icp=levenberg_marquardt(problem(icp_block(src, tgt)), _centroid_seed(src, tgt),
                                        _icp_config()).x.double().cpu().tolist())
    ref_s = time.perf_counter() - t_start
    one = ["a card a process, NCCL", "a card a process, device"]
    if n_cards >= 4:
        rounds = [[(one[0], 0), (one[1], 2)], [("2 cards a process, device", 0)], [("2 cards a process, NCCL", 0)]]
    else:
        rounds = [[(one[0], 0)], [(one[1], 0)]]
    results = _collect_layouts(rounds)
    out = {}
    for layout, (a, b, wall) in results.items():
        rows = {name: _hold_mp_path(layout, name, a, b, refs[name], name in ("curve", "icp"))
                for name in MULTIPROCESS_PATHS}
        rows["transport"] = _hold_mp_transport(layout, a, b)
        rows["captures"] = [a["captures"], b["captures"]]
        rows["wall_s"] = wall
        print(f"multi-process {layout}: {a['transport']} transport (CUDA_VISIBLE_DEVICES {a['visible']} and "
              f"{b['visible']}), captures {a['captures']} and {b['captures']}, NCCL inside IF nodes: "
              + ("not used" if a["transport"] != "nccl" else "yes (graph mixing off; every path captured, replayed "
                 "and bit-equal)" if a["in_if_bodies"] else "no (the eager body over NCCL)")
              + f"; round wall {wall:.1f} s")
        if "gloo" in a["cg"]:
            for res in (a, b):
                g = res["cg"]["gloo"]
                print(f"multi-process {layout}, rank {res['rank']}: the CG over gloo: wall {g['wall_s']:.4f} s, "
                      f"all-reduces {g['all_reduces']['count']} ({g['all_reduces']['ms']:.1f} ms), host reads "
                      f"{g['reads']}; digests equal to the graphs' {g['digests'] == res['cg']['digests']}")
                if g["digests"] != res["cg"]["digests"] or g["transport"] != "gloo":
                    raise AssertionError(f"multi-process {layout}: the CG over gloo differs from the graphs'")
            rows["cg"]["gloo"] = a["cg"]["gloo"]
        out[layout] = rows
    for nccl, device in ((one[0], one[1]), ("2 cards a process, NCCL", "2 cards a process, device")):
        if nccl in out and device in out:
            same = {p: out[nccl][p]["digests"] == out[device][p]["digests"] for p in MULTIPROCESS_PATHS}
            print(f"multi-process: {nccl} against {device}, bit-equal by path: {same}")
            if not all(same.values()):
                raise AssertionError(f"multi-process: NCCL and the device transport differ: {same}")
    across = {p: len({tuple(rows[p]["digests"]) for rows in out.values()}) == 1 for p in MULTIPROCESS_PATHS}
    print(f"multi-process: every layout bit-equal by path (a card or two a process): {across}")
    wall = time.perf_counter() - t_start
    print(f"phase 24: {wall:.1f} s ({ref_s:.1f} s of it the unsharded references)")
    return dict(layouts=out, wall_s=wall, reference_s=ref_s, cards=n_cards, all_layouts_bit_equal=across)


def multiprocess_main():
    """``--phase 24``: the build and phase 24 alone, on two cards or more."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    _smi()
    _build_all()
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    multiprocess = run_multiprocess(dev, cloud)
    if multiprocess is None:
        raise SystemExit("chip_smoke --phase 24: needs 2+ cards")
    print(json.dumps({"multiprocess": multiprocess}))
    _print_ok()


def transport_entry(two, multicard=None, multiprocess=None):
    """The kernels line's row of the device all-reduce, a graph helper (the
    psum across processes), not a port of a TPU kernel: rank 0's launches on
    phase 15's main path, its worst difference from the plain version, its
    ms at S's size beside the plain version's and gloo's; the bound is the
    bytes (P + 1)·n over the card's rate (the barrier's round trip is
    chip_profile.py --path mesh_barrier's). With two cards or more, phase
    23's card transport too (its µs, bound and replayed launches by mesh),
    and phase 24's links across processes (the device transport's IPC links
    and the NCCL transport, a library's all-gather, not a kernel of the
    port: µs at S and 1,001 floats, replayed launches by path)."""
    c = two["transport"][0]
    n_bytes = (2 + 1) * c["bytes"]
    cards = None if multicard is None else {
        m: dict(us=rows["transport"]["us"], bound_ms=rows["transport"]["bound_ms"],
                max_abs_err=rows["transport"]["max_abs_err"],
                replayed={p: rows[p]["transport_replayed"] for p in rows if p != "transport"})
        for m, rows in multicard["meshes"].items()}
    links = None if multiprocess is None else {
        layout: dict(transport=rows["transport"], replayed={p: rows[p]["transport_replayed"] for p in MULTIPROCESS_PATHS})
        for layout, rows in multiprocess["layouts"].items()}
    return dict(name="mesh_reduce", route="cuda", source="moptimizer_0_tpu_torch/csrc/mesh_reduce.cu",
                replaces="moptimizer_0_tpu/parallel/sharded.py:55", kind="graph helper: the psum across processes",
                launches=c["launches"], max_abs_err=max(c["max_abs_err"], two["transport"][1]["max_abs_err"]),
                ms=c["ms"]["kernel"], plain_ms=c["ms"]["plain"], bound_ms=n_bytes / PEAK_BYTES * 1e3,
                bound_by="bytes", library_ms=c["ms"]["library"], small_ms=c["ms"]["kernel_small"],
                launches_by_path={k: v["launches"] for k, v in two["paths"].items()}, card_transport=cards,
                links=links)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    _smi()
    t_start = time.perf_counter()

    def stamp(phases):
        print(f"time {time.perf_counter() - t_start:.1f} s: phases {phases} done", flush=True)

    _build_all()

    rng = np.random.default_rng(SEED)
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    examples_in = _example_kernel_inputs(dev)
    max_abs_err, nn_t, nn_bound, nn_splits = check_nn_kernel(cloud, rng, examples_in["nn"])
    t0 = time.perf_counter()
    scans, gt = make_sequence(SLAM_K, SLAM_N)
    print(f"SLAM sequence {SLAM_K} x {SLAM_N} points made in {time.perf_counter() - t0:.3f} s (host, numpy)")
    check_grid(cloud, scans, gt, rng)
    srcs, tgts, fleet_x = _fleet_inputs(cloud, np.random.default_rng(SEED + 2))
    e_err, e_t, e_bound = check_expand_kernel(cloud, srcs, tgts, _coarse_seed_search(scans, dev), rng,
                                              examples_in["expand"])
    ba_prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    ba_grouped = ba_dense.group_by_landmark(ba_prob, segments="auto")
    s_err, s_t, s_bound = check_schur_kernel(ba_prob, ba_grouped, dev, rng, examples_in["schur"])
    del examples_in
    matvec = check_matvec_kernel(dev)
    torch.cuda.empty_cache()
    stamp("1-3, 26")

    requests = [
        ("A", X_A, {}),
        ("B", X_B, {}),
        ("A-gated", X_A, dict(loss=GemanMcClure(tau=1.0), max_corr_dist=1.0)),
    ]
    _reset_launches()
    results, outer_total = {}, 0
    for name, x_true, kw in requests:
        results[name], outer = run_request(name, cloud, x_true, np.random.default_rng(SEED + 1), **kw)
        outer_total += outer
    launches, k5_replayed = k_nn.launches(), k_nn.replayed()
    print(f"nn kernel launches on the ICP path: {launches} ({k5_replayed} replayed) for {outer_total} outer "
          f"iterations")
    if launches < outer_total or launches == 0:
        raise AssertionError(f"the ICP path launched the nn kernel {launches} times")
    if k_schur.launches() or k_expand.launches():
        raise AssertionError("the ICP path launched the schur or expansion kernel")

    plain, _ = run_request("A", cloud, X_A, np.random.default_rng(SEED + 1), nn_backend="torch")
    if int(plain.iterations) != int(results["A"].iterations):
        raise AssertionError("plain search: iterations differ from the kernel's run")
    dx = float((plain.x - results["A"].x).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"plain search: x differs from the kernel's run by {dx}")
    print(f"request A with the plain search: same iterations, max|dx| {dx:.3e}")

    stamp(4)
    ba_res, s_launches, s_replayed, ba_wall_s = run_ba(ba_prob)
    ba_repeat(ba_prob, ba_res, ba_wall_s)
    ba_steps(ba_prob, ba_grouped, "auto")
    plain_costs = ba_steps(ba_prob, ba_grouped, "torch")
    kernel_costs = list(zip(ba_res.trace["cost"][:3].tolist(), ba_res.trace["cost_new"][:3].tolist()))
    worst = max(abs(p - k) / abs(k) for pk, kk in zip(plain_costs, kernel_costs) for p, k in zip(pk, kk))
    print(f"plain-S repeat of the first 3 outer iterations: max relative cost difference {worst:.3e} "
          f"(bound {BA_COST_RTOL:g})")
    if not worst <= BA_COST_RTOL:
        raise AssertionError(f"plain-S repeat: costs differ by {worst} > {BA_COST_RTOL}")

    ba_cg, cg_res = run_ba_cg(ba_prob, ba_res)
    ba_routing, cg_big, cg_big_res = run_ba_routing(ba_prob, ba_res)
    selfcal, selfcal_start, selfcal_res, selfcal_intr, selfcal_early = run_selfcal(ba_prob)
    device = run_device_loop(ba_prob, selfcal_start)
    stamp("5, 19")

    fleet, fleet_wall_s, e_launches, e_replayed = run_fleet(srcs, tgts, fleet_x)
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
            slam_pgo = (graph, config, result, pgo_repeat_and_cg(graph, config, result))
    stamp("6-9")
    k9 = surface_times(scans, dev)
    lag, lag_solves = run_fixed_lag(scans, gt, dev)
    ring, ring_solves = {}, {}
    for n, bound in RING_BOUNDS.items():
        ring[n], *ring_solves[n] = run_ring(dev, n, bound)
    pgo_loop = run_pgo_device_loop(slam_pgo, ring_solves, lag_solves, slam, lag, dev)
    del ring_solves, lag_solves
    stamp("10-12, 21")
    references = run_reference_problems(dev)
    lm_loop = run_lm_device_loop(cloud, srcs, tgts, scans, gt, dev)
    stamp("13, 20")

    sharded_lin = run_sharded_linearize(cloud)
    dist_icp, icp_solves = run_distributed_icp(cloud, results["A"])
    ba_sharded, ba4, ba_grouping_s, ba_solves = run_ba_sharded(ba_prob, ba_grouped, ba_res)
    fleet_sharded = run_fleet_sharded(srcs, tgts, fleet, fleet_x)
    cg_sharded, cg4, cg_problems = run_ba_cg_sharded(ba_prob, cg_res, cg_big, cg_big_res)
    del cg_big, cg_big_res
    selfcal_sharded, selfcal_problems = run_selfcal_sharded(ba_prob, selfcal_start, selfcal_res, selfcal_intr,
                                                            selfcal_early, selfcal["wall_s"])
    stamp("14, 16, 18")
    sharded_loop = run_sharded_device_loop(icp_solves, ba_solves, cg_problems, selfcal_problems, dev)
    stamp(22)
    # the later phases capture layouts of their own: give phase 15's two
    # processes the card's memory
    del icp_solves, ba_solves, cg_problems, selfcal_problems
    device_loop.clear()
    torch.cuda.empty_cache()
    two = run_two_processes(ba4, cg4, (ba_prob.intrinsics, selfcal_res, selfcal_early))
    stamp(15)
    examples = run_examples()
    blocked = run_blocked(ba_prob, ba_res, dev)
    stamp(17)
    refs = dict(cg=cg_res, selfcal=selfcal_res, dense=ba_res)
    del ba_grouped, ba_res, cg_res, results
    torch.cuda.empty_cache()
    multicard = run_multicard(dev, cloud, ba_prob, refs)
    stamp(23)
    multiprocess = run_multiprocess(dev, cloud, ba_prob, refs)
    del ba_prob, refs
    stamp(24)
    traced = _phase_process(25)
    stamp(25)

    def entry(name, source, replaces, n_launches, err, t, bound, **extra):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=n_launches,
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound[0],
            bound_by=bound[1], library_ms=t["library"], **extra,
        )

    kernels = [
        entry("nn_bruteforce", "moptimizer_0_tpu_torch/csrc/nn_search.cu",
              "moptimizer_0_tpu/ops/nn_search.py:136", launches, max_abs_err, nn_t, nn_bound,
              replayed_launches=k5_replayed, splits=nn_splits,
              device_loop_replayed_launches={k: r["kernel_replayed"] for k, r in lm_loop.items()
                                             if isinstance(r, dict) and r.get("kernel_replayed") and k != "fleet"}, slam_launches=dict(grid=k5_grid, auto=k5_auto),
              scan_slam_launches={m: r["k5"] for m, r in slam.items()}, fixed_lag_launches=lag["k5"],
              distributed_icp_launches={n: r["launches"] for n, r in dist_icp.items()},
              sharded_device_loop_replayed_launches={k: r["kernel_replayed"] for k, r in sharded_loop.items()
                                                     if k.startswith("distributed_icp")},
              multicard_replayed_launches=_multicard_launches(multicard, "icp"),
              examples_launches={k: v["k5"] for k, v in examples.items() if v["k5"]}),
        entry("nn_expand", "moptimizer_0_tpu_torch/csrc/nn_expand.cu",
              "moptimizer_0_tpu/ops/nn_search.py:43", e_launches, e_err, e_t, e_bound,
              replayed_launches=e_replayed, device_loop_replayed_launches=lm_loop["fleet"]["kernel_replayed"],
              slam_launches=dict(grid=k6_grid, auto=k6_auto),
              scan_slam_launches={m: r["k6"] for m, r in slam.items()}, fixed_lag_launches=lag["k6"],
              sharded_fleet_launches=fleet_sharded["launches"],
              examples_launches={k: v["k6"] for k, v in examples.items() if v["k6"]}),
        entry("schur_pairs", "moptimizer_0_tpu_torch/csrc/schur.cu",
              "benchmarks/schur_pallas_ab.py:38", s_launches,
              max([s_err] + [r["k11_shard_err"] for r in ba_sharded.values()]), s_t, s_bound,
              replayed_launches=s_replayed, warmup_launches=s_launches - s_replayed,
              device_loop_replayed_launches=device["ba_step_dense"]["k11_replayed"],
              ba_cg_launches=ba_cg["k11"], ba_cg_routed_launches=ba_routing["k11"], selfcal_launches=selfcal["k11"],
              sharded_ba_launches={n: r["launches"] for n, r in ba_sharded.items()},
              sharded_device_loop_replayed_launches={k: r["kernel_replayed"] for k, r in sharded_loop.items()
                                                     if k.startswith("dense")},
              multicard_replayed_launches=_multicard_launches(multicard, "dense"),
              sharded_ba_shard_ms={n: r["k11_shard_ms"] for n, r in ba_sharded.items()},
              two_process_replayed_launches=two["k11"],
              sharded_cg_launches={k: r["k11"] for k, r in cg_sharded.items()},
              sharded_selfcal_launches={k: r["k11"] for k, r in selfcal_sharded.items()},
              examples_launches={k: v["k11"] for k, v in examples.items() if v["k11"]},
              blocked_dense_launches=blocked["k11"]),
        transport_entry(two, multicard, multiprocess),
        dict(name="schur_matvec", route="cuda", source="moptimizer_0_tpu_torch/csrc/schur_matvec.cu",
             replaces=None, **{half: matvec[half] for half in ("to_landmarks", "to_cameras")},
             device_loop_replayed_launches={k: r["matvec_replayed"] for k, r in device.items()
                                            if isinstance(r, dict) and r.get("matvec_replayed")},
             sharded_device_loop_replayed_launches={k: r["matvec_replayed"] for k, r in sharded_loop.items()
                                                    if isinstance(r, dict) and r.get("matvec_replayed")}),
    ]
    print(json.dumps({"slam": {
        m: {k: v for k, v in r.items() if k != "reg"} for m, r in slam.items()
    } | {"k9_ms": k9, "fixed_lag": lag, "ring": ring}}))
    print(json.dumps({"ba_cg": ba_cg, "ba_cg_routed": ba_routing, "selfcal": selfcal, "reference_f32": references}))
    print(json.dumps({"sharded": dict(linearize_rel=sharded_lin, distributed_icp=dist_icp, ba=ba_sharded,
                                      ba_grouping_s=ba_grouping_s, fleet=fleet_sharded, cg=cg_sharded,
                                      selfcal=selfcal_sharded, two_processes=two)}))
    print(json.dumps({"examples": examples, "blocked": blocked, "device_loop": device, "lm_device_loop": lm_loop,
                      "pgo_device_loop": pgo_loop, "sharded_device_loop": sharded_loop}))
    print(json.dumps({"multicard": multicard}))
    print(json.dumps({"multiprocess": multiprocess}))
    print(json.dumps(traced))
    print(json.dumps({"kernels": kernels}))
    _print_ok()


def _print_ok():
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


def _smi():
    """The card's name and power limit, as nvidia-smi gives them (printed
    first)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")


def _build_all():
    """Every CUDA source compiled, one nvcc each, all started together; the
    libraries and ptxas's register lines printed."""
    t0 = time.perf_counter()
    kernels = (k_nn, k_expand, k_schur, k_matvec, graph_cond, k_mesh)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        futures = [pool.submit(build.build, k.NAME, k.SOURCES) for k in kernels]
        built = [f.result() for f in futures]
    print(f"build (one nvcc per source, in parallel): {time.perf_counter() - t0:.3f} s")
    for path, log in built:
        print(f"  -> {path.relative_to(ROOT)}")
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line):
                print(f"  {line.strip()}")


def _multicard_launches(multicard, path):
    """K5's or K11's replayed launches a card on phase 23's ``path``, by mesh."""
    if multicard is None:
        return None
    return {m: rows[path]["kernel_replayed"] for m, rows in multicard["meshes"].items()}


# Phase 25: the small CG solve (O, C, L) it profiles with request A.
TRACE_BA = (60_000, 60, 6_000)
# A span's start and end against its range's event (the median, ns).
TRACE_SPAN_OFFSET_NS = 20_000


def _marker_count(cuda_events, name):
    full = "moptimizer_mark_" + name
    return sum(e.name() == full or e.name().startswith(full + "(") for e in cuda_events)


def _span_offsets(events, spans):
    """|start − start| and |end − end| of each span against the profiler's
    event of its range (the events of a name in time order), and the spans
    without an event."""
    ranges = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith(tracing.PREFIX):
            ranges.setdefault(e.name()[len(tracing.PREFIX):], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    offsets, unmatched = [], 0
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = ranges.get(name, [])
        unmatched += abs(len(mine) - len(theirs))
        for s, (a, b) in zip(mine, theirs):
            offsets += [abs(s.start_ns - a), abs(s.end_ns - b)]
    return offsets, unmatched


def run_tracing(dev, cloud):
    """Phase 25 (module docstring): returns its readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prob = ba.make_ba_problem(*TRACE_BA, seed=SEED, dtype=torch.float32, device=dev)
    tgt = _transformed(cloud, X_A, np.random.default_rng(SEED + 1))

    def solve_both():
        return ba.solve_ba(prob), icp(cloud, tgt)

    solve_both()  # captures both layouts
    torch.cuda.synchronize()
    reads = ba.HOST_READS, solver.HOST_READS
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba_res, icp_res = solve_both()
        with record_function("phase25.probe"):  # does a user range reach the device's timeline?
            torch.ones(1024, device=dev).sum()
        torch.cuda.synchronize()
    reads = ba.HOST_READS - reads[0], solver.HOST_READS - reads[1]
    spans = tracing.spans()
    with device_loop.eager():
        ba_eager, icp_eager = solve_both()
    torch.cuda.synchronize()

    events = list(prof.profiler.kineto_results.events())
    cuda = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    counts = {name: _marker_count(cuda, name) for name in graph_cond.MARKS}
    ba_steps = int(torch.isfinite(ba_res.trace["cost"]).sum())
    steps = ba_steps + int(torch.isfinite(icp_res.trace["cost"]).sum())
    trials = int(ba_res.trace["trials"].sum())
    want = dict(step_begin=steps, step_end=steps, ba_linearize_begin=ba_steps, ba_linearize_end=ba_steps,
                ba_pcg_begin=trials, ba_pcg_end=trials, pcg_iteration=int(ba_res.trace["pcg_iterations"].sum()))
    offsets, unmatched = _span_offsets(events, spans)
    names = sorted({s.name for s in spans})
    roots = sorted(s.name for s in spans if s.parent is None)
    by_id = {s.id: s for s in spans}
    nested = all(s.parent is None or (s.parent in by_id and by_id[s.parent].start_ns <= s.start_ns
                                      and s.end_ns <= by_id[s.parent].end_ns) for s in spans)
    on_device = sorted({e.name() for e in cuda if e.name().startswith(tracing.PREFIX)})
    marker_us = [e.duration_ns() / 1e3 for e in cuda if e.name().startswith("moptimizer_mark_")]
    out = dict(
        markers=counts, want=want, host_reads=reads, ba_iterations=int(ba_res.iterations), ba_trials=trials,
        pcg_iterations=ba_res.trace["pcg_iterations"].tolist(), span_names=names, span_roots=roots,
        spans=len(spans), span_offset_ns=dict(median=float(np.median(offsets)) if offsets else None,
                                              max=max(offsets, default=None)),
        unmatched_spans=unmatched, program_ranges_on_device=on_device,
        user_range_on_device=any(e.name() == "phase25.probe" for e in cuda),
        marker_us=dict(n=len(marker_us), mean=float(np.mean(marker_us)) if marker_us else None,
                       max=max(marker_us, default=None)),
        ba_bit_equal=_same_bits(ba_res, ba_eager), icp_bit_equal=_same_result(icp_res, icp_eager),
    )
    print(f"phase 25: markers {counts} (want {want}); host reads (BA, LM) {reads}; spans {len(spans)} "
          f"{names}, roots {roots}, nested {nested}, offsets {out['span_offset_ns']} ns, unmatched {unmatched}; "
          f"program ranges on the device {on_device}, a user range on the device {out['user_range_on_device']}; "
          f"markers' device µs {out['marker_us']}; bit-equal to the eager bodies: BA {out['ba_bit_equal']}, "
          f"ICP {out['icp_bit_equal']}", flush=True)
    if counts != want:
        raise AssertionError(f"phase 25: marker counts {counts} differ from {want}")
    if reads != (0, 0):
        raise AssertionError(f"phase 25: the graph solves read the device {reads} times")
    if not (out["ba_bit_equal"] and out["icp_bit_equal"]):
        raise AssertionError("phase 25: a traced graph solve differs from its eager body")
    if roots != ["icp", "solve_ba"] or names != ["icp", "layout", "lm", "replays", "result", "solve_ba"] or not nested:
        raise AssertionError(f"phase 25: spans {names}, roots {roots}, nested {nested}")
    if unmatched or not out["span_offset_ns"]["median"] <= TRACE_SPAN_OFFSET_NS:
        raise AssertionError(f"phase 25: spans off their ranges: {out['span_offset_ns']}, {unmatched} unmatched")
    if on_device:
        raise AssertionError(f"phase 25: the program's ranges {on_device} are on the device's timeline")
    return out


def _phase_process(phase, timeout=900):
    """``chip_smoke.py --phase <phase>`` in a process of its own, its output
    printed: the JSON object it prints before its ok line."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase", str(phase)],
                          capture_output=True, text=True, timeout=timeout)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        raise AssertionError(f"phase {phase}'s process exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-2])


def tracing_main():
    """``--phase 25``: the build and phase 25 alone."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    _smi()
    _build_all()
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    print(json.dumps({"tracing": run_tracing(dev, cloud)}))
    _print_ok()


def matvec_main():
    """``--phase 26``: the build and phase 26 alone."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    _smi()
    _build_all()
    print(json.dumps({"schur_matvec": check_matvec_kernel(torch.device("cuda", 0))}))
    _print_ok()


def multicard_main():
    """``--phase 23``: the build and phase 23 alone, on two cards or more."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    _smi()
    _build_all()
    cloud = torch.as_tensor(load_txt_cloud(FACHADA), dtype=torch.float32, device=dev)
    multicard = run_multicard(dev, cloud)
    if multicard is None:
        raise SystemExit("chip_smoke --phase 23: needs 2+ cards")
    print(json.dumps({"multicard": multicard}))
    _print_ok()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Drive the port's main paths on one CUDA card and check them.")
    parser.add_argument("--rank", type=int, help="run as one of phase 15's two processes (internal)")
    parser.add_argument("--port", type=int, help="phase 15's group port on localhost (internal)")
    parser.add_argument("--layout", choices=tuple(MULTIPROCESS_LAYOUTS), help="run as one of phase 24's processes in "
                        "this layout (internal)")
    parser.add_argument("--phase", type=int, choices=(23, 24, 25, 26), help="run the build and this phase alone (23: "
                        "the one-process mesh over several cards; 24: meshes across processes over several cards; "
                        "both on two cards or more; 25: the port's tracing; 26: the Schur matvec's kernels at the "
                        "Venice shape)")
    args = parser.parse_args()
    if args.layout is not None:
        multiprocess_rank_main(args.rank, args.port, args.layout)
    elif args.rank is not None:
        rank_main(args.rank, args.port)
    elif args.phase == 23:
        multicard_main()
    elif args.phase == 24:
        multiprocess_main()
    elif args.phase == 25:
        tracing_main()
    elif args.phase == 26:
        matvec_main()
    else:
        main()
