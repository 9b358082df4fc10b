"""The dense-BA solve's first call in a fresh process, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_ba_cold.py [--tree DIR] [--profile]

Imports ``moptimizer_0_tpu_torch`` from DIR (default: this checkout; give
another tree's root to measure its package), builds that package's Schur
kernel with nvcc, makes the O=500k, C=200, L=50k instance of
``chip_smoke.py`` on the card and times ``solve_ba_dense`` twice on the host
clock: the first call in the process, which loads every CUDA kernel the
solve uses, and a second call. Where the package caches the S build's plan
(``GroupedBA.schur_plan``), the plan's first build in each solve is timed
too. With ``--profile`` the first solve's plan build runs under
``torch.profiler`` and its operators are listed by host time. Each run of
the script is one cold process: run it again for another sample.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

# the headline instance of chip_smoke.py
BA_O, BA_C, BA_L = 500_000, 200, 50_000
SEED = 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                        help="root of the tree whose package is measured")
    parser.add_argument("--profile", action="store_true",
                        help="profile the first plan build and list its operators")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_ba_cold: no CUDA device; this runs on a GPU only")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from moptimizer_0_tpu_torch import ba, ba_dense
    from moptimizer_0_tpu_torch.kernels import build
    from moptimizer_0_tpu_torch.kernels import schur as k_schur

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"package {Path(ba_dense.__file__).parent}")
    build.build(k_schur.NAME, k_schur.SOURCES)

    plan_ms = []
    if hasattr(ba_dense.GroupedBA, "schur_plan"):
        build_plan = ba_dense.GroupedBA.schur_plan

        def timed_plan(self, C):
            if C in self._schur_plans:
                return build_plan(self, C)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if args.profile and not plan_ms:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    plan = build_plan(self, C)
                    torch.cuda.synchronize()
            else:
                plan = build_plan(self, C)
                torch.cuda.synchronize()
            plan_ms.append((time.perf_counter() - t0) * 1e3)
            if args.profile and len(plan_ms) == 1:
                print(f"first plan build under the profiler: {plan_ms[0]:.2f} ms")
                print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=30))
            return plan

        ba_dense.GroupedBA.schur_plan = timed_plan

    dev = torch.device("cuda", 0)
    prob = ba.make_ba_problem(BA_O, BA_C, BA_L, seed=SEED, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    for call in ("first", "second"):
        t0 = time.perf_counter()
        res = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(), schur_backend="auto")
        cost = float(res.cost)
        wall_s = time.perf_counter() - t0
        trials = int(res.trace["trials"].sum())
        plan = f"; plan's first build {plan_ms[-1]:.2f} ms" if plan_ms else ""
        print(f"solve_ba_dense O={BA_O} C={BA_C} L={BA_L} float32, {call} call in the process: "
              f"wall {wall_s:.4f} s (host grouping included), {trials} trials, cost {cost:.6e}{plan}")
        if not torch.isfinite(res.cost):
            raise AssertionError(f"dense BA: cost {cost}")


if __name__ == "__main__":
    main()
