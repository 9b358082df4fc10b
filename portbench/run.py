"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``), whose ``loop`` names the closed loop
(``portbench/loops/<loop>.py``). The run makes its inputs from the seed
and warms up the program on them (``setup_s``, counted from the start of the
process), runs the closed loop for ``--seconds`` (the window; a mix with a
``round`` of k units ends it after a whole number of rounds), and with
``--trace 1`` profiles ``trace_units`` more units. Then it reads every metric
of the cell, each from its own reader ``portbench/metrics/<metric>.py``
(``--trace 0``: the end-to-end metrics, ``--trace 1``: the per-layer ones),
frees the program's state and compares sampled outputs with the plain
reference (``portbench/reference/``). The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device, with
``--trace 1`` breakdown, and last ``checks``, each number compared beside its
limit, which also end standard error.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "moptimizer_0_tpu")


def load_file(path):
    """The Python module in ``path`` (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name, bench=None):
    """The cell ``name`` of BENCHMARK.json: its entry, configuration and
    traffic files read, and the metrics it reports (end-to-end and
    per-layer, each a dict of BENCHMARK.json's entry)."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return types.SimpleNamespace(
        name=name, chips=w["chips"],
        config=json.loads((HERE / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
    )


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(specs, ctx):
    """{name: {"value", "unit"}} of every metric in ``specs`` whose reader
    finds something to read (a finite number)."""
    out = {}
    for m in specs:
        value = finite(load_file(HERE / "metrics" / f"{m['name']}.py").read(ctx))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_lines(device):
    """Earlier lines: the card, its power limit and clocks."""
    import torch

    lines = [f"device: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, CUDA {torch.version.cuda}"]
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
                            "temperature.gpu", "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        lines += [f"nvidia-smi (name, power.limit, power.draw, clocks.sm, clocks.max.sm, temperature): {s}"
                  for s in q.stdout.strip().splitlines()]
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: not read ({e})")
    return lines


def program_counters():
    """The port's own counters, for earlier lines: launches of its kernels
    (eager, replayed on the card), host reads of its solve loops, captures."""
    from moptimizer_0_tpu_torch import ba
    from moptimizer_0_tpu_torch.core import solver
    from moptimizer_0_tpu_torch.kernels import nn_expand, nn_search, schur
    from moptimizer_0_tpu_torch.ops import device_loop

    return dict(
        k5=(nn_search.launches(), nn_search.replayed()), k6=(nn_expand.launches(), nn_expand.replayed()),
        k11=(schur.launches(), schur.replayed()), ba_host_reads=ba.HOST_READS,
        lm_host_reads=solver.HOST_READS, captures=len(device_loop.CAPTURES),
    )


def run_cell(c, seed, seconds, trace, device="cuda", log=print):
    """One run of cell ``c`` (from ``cell``) on ``device``: the result dict.
    Everything but the check of a chip is here, so tests drive it on the CPU."""
    import numpy as np
    import torch

    loop = load_file(HERE / "loops" / f"{c.traffic['loop']}.py")
    ctx = types.SimpleNamespace(config=c.config, traffic=c.traffic, seed=seed, device=torch.device(device))
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = loop.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - START
    before = program_counters()

    units, t0 = [], time.perf_counter()
    while True:
        begin = time.perf_counter() - t0
        u = loop.step(state, len(units))
        u.update(t_start=begin, t_end=time.perf_counter() - t0)
        units.append(u)
        if u["t_end"] >= seconds and len(units) % c.traffic.get("round", 1) == 0:
            break
    after = program_counters()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    profile = None
    if trace:
        from torch.profiler import record_function

        from portbench import trace as tracing

        traced = []
        with tracing.profiled(traced) as holder:
            for _ in range(c.traffic["trace_units"]):
                with record_function(tracing.UNIT):
                    traced.append(loop.step(state, len(units) + len(traced)))
        loop.finish(traced)
        profile = holder.profile
    loop.finish(units)
    log(f"window: {len(units)} units in {units[-1]['t_end']:.6f} s; program counters before {before}, after {after}")
    for key in ("instance", "set", "target", "trials", "passes", "searches"):
        if key in units[0]:
            log(f"units' {key}: {[u[key] for u in units[:64]]}")
    log(f"units' seconds: {[round(u['t_end'] - u['t_start'], 6) for u in units[:64]]}")
    log(f"memory: max_memory_allocated {peak} bytes")

    mctx = types.SimpleNamespace(units=units, window_s=units[-1]["t_end"], setup_s=setup_s, profile=profile,
                                 config=c.config, traffic=c.traffic)
    metrics = read_metrics(c.per_layer if trace else c.end_to_end, mctx)
    result = dict(
        correct=False,
        attempted=sum(u["lanes"] for u in units),
        failed=sum(u["lanes"] for u in units if not u["ok"]),
        metrics=metrics,
        device=dict(platform="gpu" if on_card else device, kind=torch.cuda.get_device_name(ctx.device)
                    if on_card else device, count=c.chips, memory_peak_bytes=peak),
    )
    if profile is not None:
        result["device"].update(busy_s=profile.busy_s, window_s=profile.window_s)
        result["breakdown"] = profile.breakdown()
    numbers = loop.check(state, units, np.random.default_rng(seed))
    limits = c.config["limits"]
    log(f"read beside the check, not compared: {({k: v for k, v in numbers.items() if k not in limits})}")
    # a number that is missing or not finite fails, and prints as null
    checks = {k: {"value": finite(numbers.get(k)), "limit": v} for k, v in limits.items()}
    result["correct"] = all(ch["value"] is not None and ch["value"] <= ch["limit"] for ch in checks.values())
    result["checks"] = checks
    return result


def finite(x):
    """x as a float when it is a finite number, else None."""
    return float(x) if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    c = cell(args.workload)
    # the program's kernel and compiler caches stay inside the checkout, at
    # fixed paths (the port's own nvcc builds go to build/kernels/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench-cache" / sub))
    os.environ["USE_FLAX"] = "0"

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {c.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    for line in card_lines(0):
        print(line, flush=True)
    result = run_cell(c, args.seed, args.seconds, args.trace, log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port's benchmark may not", file=sys.stderr)
        return 3
    for name, ch in result["checks"].items():
        print(f"check {name}: {ch['value']!r} limit {ch['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
