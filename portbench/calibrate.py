"""The readings the limits of ``correct`` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9] [--units N]

In one process, for each seed: the cell's inputs and the program's warm-up
as a run makes them, N units of the cell's closed loop (a short window: at
least one unit of each instance or enough for the check's sample), and the
numbers its check compares (the lower readings). For each control seed, the
same, then the reference in the control's precision (float32 with every
matrix product in TF32) in the program's place, judged the same way (the
upper readings). One JSON line a seed: {"seed", "program": {...},
"control": {...}}.
"""

import argparse
import json
import sys

import numpy as np

from portbench import run
from portbench.loops.common import free_program


def readings(c, seed, units_n, control, device="cuda"):
    """{"seed", "program": numbers, ["control": numbers]} of one seed."""
    import torch

    loop = run.load_file(run.HERE / "loops" / f"{c.traffic['loop']}.py")
    ctx = run.types.SimpleNamespace(config=c.config, traffic=c.traffic, seed=seed, device=torch.device(device))
    state = loop.setup(ctx)
    units = [loop.step(state, i) for i in range(units_n)]
    loop.finish(units)
    out = dict(seed=seed, units=len(units), ok=all(u["ok"] for u in units))
    out["program"] = loop.check(state, units, np.random.default_rng(seed))
    if control:
        out["control"] = loop.control(state, units, np.random.default_rng(seed))
    del state
    free_program()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--units", type=int, required=True)
    args = p.parse_args(argv)
    c = run.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + controls:
        print(json.dumps(readings(c, seed, args.units, seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
