"""Closed loop of bundle-adjustment solves: ``ba.solve_ba(problem,
BAConfig(), engine=...)`` on the configuration's BAL-shaped instances
(``instance_seeds``) in turn, in an order drawn from the run's seed, each
solve from its instance's perturbed start. The instances are the same in
every run: a solve's LM trials and PCG iterations, and so its time, swing
by ±20% with the noise drawn (PERF.md), so instances drawn from the run's
seed would change the work from run to run.

Check: for each instance, one of its solves in the window, drawn from the
seed, against the float64 reference (``reference/ba.py``) run from the same
start: ``iter_cost_gap``, the largest relative gap of the cost at the start
of outer iterations 2-4, after each of the first three steps (the program's
trace against the reference's); ``report_gap``, |the program's reported
final cost − f(x)| / f(x), f the reference's float64 cost of the program's
final cameras and points; ``final_gap``, |f(x) − f(x_ref)| / f(x_ref) of
the final states after all outer iterations, so that a solve cut short, or
one that goes wrong after the first steps, fails. On the configuration's
fixed instances the two cost traces agree to a few 1e-6 at every outer
iteration; on other instances two unconverged trajectories can part in a
late trial (PERF.md), which is why the instances are the configuration's.
"""

import numpy as np
import torch

from portbench import generate
from portbench.loops.common import free_program, sample
from portbench.reference import ba as ref
from portbench.reference.precision import CONTROL


def setup(ctx):
    from moptimizer_0_tpu_torch import ba

    insts = [generate.bal_instance(ctx.config, s, ctx.device) for s in ctx.config["instance_seeds"]]
    problems = [
        ba.BAProblem(camera_params=d["cams0"].clone(), points=d["pts0"].clone(), cam_idx=d["cam_idx"],
                     pt_idx=d["pt_idx"], pixels=d["pixels"], intrinsics=d["intrinsics"], n_fixed_cameras=d["n_fixed"])
        for d in insts
    ]
    state = dict(per_instance=ctx.traffic["checked_per_instance"], insts=insts, problems=problems,
                 config=ba.BAConfig(), engine=ctx.traffic["engine"],
                 order=np.random.default_rng(ctx.seed).permutation(len(problems)))
    for i in range(len(problems)):  # capture each instance's layout
        step(state, i)
    return state


def step(state, i):
    from moptimizer_0_tpu_torch import ba

    k = int(state["order"][i % len(state["order"])])
    res = ba.solve_ba(state["problems"][k], state["config"], engine=state["engine"])
    if res.cost.is_cuda:
        torch.cuda.synchronize(res.cost.device)
    return dict(instance=k, lanes=1, result=res)


def finish(units):
    """Per unit: ok (finite cost, no numeric error) and trials (Σ over outer
    iterations), read after the window."""
    from moptimizer_0_tpu_torch.core.solver import Status

    for u in units:
        r = u.pop("result")
        u["output"] = dict(cams=r.camera_params, pts=r.points, cost=float(r.cost),
                           costs=[float(v) for v in r.trace["cost"].tolist()])
        u["trials"] = int(r.trace["trials"].sum())
        u["ok"] = bool(torch.isfinite(r.cost)) and int(r.status) != int(Status.NUMERIC_ERROR)


def _picked(state, units, rng):
    picked = []
    for k in range(len(state["insts"])):
        mine = [u for u in units if u["instance"] == k]
        picked += [mine[j] for j in sample(len(mine), state.get("per_instance", 1), rng)]
    return picked


def _judge(inst, out, refs, key):
    obs = generate.observations(inst)
    if key not in refs:
        refs[key] = ref.solve(inst["cams0"], inst["pts0"], obs, n_fixed=inst["n_fixed"])
    _, _, f_ref, costs_ref = refs[key]
    f = float(ref.cost(out["cams"], out["pts"], obs))
    gaps = [abs(a - b) / b for a, b in zip(out["costs"][1:4], costs_ref[1:4])]
    return dict(
        iter_cost_gap=max(gaps) if len(gaps) == min(3, len(costs_ref) - 1) else float("nan"),
        report_gap=abs(out["cost"] - f) / f,
        final_gap=abs(f - f_ref) / f_ref,
    )


def _worst(rows):
    """The largest reading of each number over the compared solves (NaN,
    from a NaN cost, counts as the largest)."""
    return {name: max(r[name] if r[name] == r[name] else float("inf") for r in rows) for name in rows[0]}


def check(state, units, rng):
    picked = _picked(state, units, rng)
    state.pop("problems", None)
    free_program()
    refs = {}
    return _worst([_judge(state["insts"][u["instance"]], u["output"], refs, u["instance"]) for u in picked])


def control(state, units, rng):
    """The reference in the control's precision in the program's place, on
    the instances the check compares."""
    picked = _picked(state, units, rng)
    state.pop("problems", None)
    free_program()
    refs, rows = {}, []
    for u in picked:
        inst = state["insts"][u["instance"]]
        cams, pts, f, costs = ref.solve(inst["cams0"], inst["pts0"], generate.observations(inst),
                                        n_fixed=inst["n_fixed"], prec=CONTROL)
        rows.append(_judge(inst, dict(cams=cams, pts=pts, cost=f, costs=costs), refs, u["instance"]))
    return _worst(rows)

