"""Closed loop of single registrations, one client: ``registration.icp(src,
tgt)`` with its default arguments (``nn_backend="auto"``), the source the
scan, the targets of a pool of ``pool`` (made in set-up) taken in turn, in an
order drawn from the seed. The pool's transforms and noise come from the
mix's ``noise_seed``, the same in every run, and only the order of each
target's points from the run's seed: a request's outer iterations (3 to
30) follow its noise, and with 64 targets drawn from the seed the 95th
percentile moved from 23 to 33 ms as the share of targets near the
30-iteration cap crossed 5% (PERF.md). With ``round`` equal to the pool the
window holds every target as often. A request's latency ends when its x is
on the host.

Check: ``checked`` requests of the window drawn from the seed, against the
float64 reference ICP (``reference/icp.py``): ``x_gap``.
"""

import time

import numpy as np
import torch

from portbench import generate
from portbench.loops import scan
from portbench.loops.common import free_program, sample


def setup(ctx):
    src = scan.cloud(ctx.config, ctx.device)
    tgts = generate.scan_targets(src, ctx.traffic["pool"], ctx.config, ctx.seed,
                                  noise_seed=ctx.traffic["noise_seed"])[0]
    state = dict(checked=ctx.traffic["checked"], src=src, tgts=tgts,
                 order=np.random.default_rng(ctx.seed).permutation(tgts.shape[0]))
    step(state, -1)  # capture the request's layout
    return state


def step(state, i):
    from moptimizer_0_tpu_torch.registration import icp

    j = int(state["order"][i % len(state["order"])]) if i >= 0 else 0
    t0 = time.perf_counter()
    res = icp(state["src"], state["tgts"][j])
    x = res.x.cpu()
    return dict(target=j, lanes=1, latency_s=time.perf_counter() - t0, x=x, result=res)


def finish(units):
    """Per unit: ok (finite x, no numeric error) and searches (outer
    iterations: one search each), read after the window."""
    from moptimizer_0_tpu_torch.core.solver import Status

    for u in units:
        r = u.pop("result")
        u["searches"] = int(torch.isfinite(r.trace["cost"]).sum())
        u["ok"] = bool(torch.isfinite(u["x"]).all()) and int(r.status) != int(Status.NUMERIC_ERROR)


def _picked(state, units, rng):
    return [(units[k]["target"], units[k]["x"]) for k in sample(len(units), state.get("checked", 16), rng)]


def check(state, units, rng):
    picked = _picked(state, units, rng)
    free_program()
    return scan.judge(state["src"], state["tgts"], picked)


def control(state, units, rng):
    picked = _picked(state, units, rng)
    free_program()
    return scan.judge(state["src"], state["tgts"], [(j, None) for j, _ in picked], control=True)
