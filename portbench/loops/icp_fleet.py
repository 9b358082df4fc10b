"""Closed loop of fleet registrations: ``registration.icp_batched(srcs,
tgts)`` over ``lanes`` lanes with its default ``x0s`` and ``config``, every
lane's source the scan and its target its own, the target sets of a pool of
``pool`` (made in set-up) taken in turn, in an order drawn from the seed.

Check: ``checked`` (step, lane) alignments of the window drawn from the
seed, against the float64 reference ICP (``reference/icp.py``): ``x_gap``.
"""

import numpy as np
import torch

from portbench import generate
from portbench.loops import scan
from portbench.loops.common import free_program, sample


def setup(ctx):
    src = scan.cloud(ctx.config, ctx.device)
    B, pool = ctx.traffic["lanes"], ctx.traffic["pool"]
    # each set its own seed (pool·n + j) for its lanes' order, noise and shuffle; all hold the same transforms
    tgts = torch.stack([generate.scan_targets(src, B, ctx.config, pool * ctx.seed + j)[0] for j in range(pool)])
    state = dict(checked=ctx.traffic["checked"], lanes=B, src=src, srcs=src.expand(B, *src.shape).contiguous(),
                 tgts=tgts, order=np.random.default_rng(ctx.seed).permutation(pool))
    step(state, -1)  # capture the fleet's layout
    return state


def step(state, i):
    from moptimizer_0_tpu_torch.registration import icp_batched

    j = int(state["order"][i % len(state["order"])]) if i >= 0 else 0
    res = icp_batched(state["srcs"], state["tgts"][j])
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    return dict(set=j, lanes=res.x.shape[0], result=res)


def finish(units):
    """Per unit: ok (every lane finite, no numeric error), passes (outer
    passes of the batched loop) and lane_passes (lanes searched while
    running), read after the window."""
    from moptimizer_0_tpu_torch.core.solver import Status

    for u in units:
        r = u.pop("result")
        finite = torch.isfinite(r.trace["cost"])
        u["x"] = r.x
        u["passes"] = int(finite.any(0).sum())  # the trace is (lanes, passes)
        u["lane_passes"] = int(finite.sum())
        u["ok"] = bool(torch.isfinite(r.x).all()) and not bool((r.status == int(Status.NUMERIC_ERROR)).any())


def _picked(state, units, rng):
    B = state["lanes"]
    flat = sample(len(units) * B, state.get("checked", 16), rng)
    return [(units[f // B]["set"], f % B, units[f // B]["x"][f % B]) for f in flat]


def check(state, units, rng):
    picked = _picked(state, units, rng)
    state.pop("srcs", None)
    free_program()
    flat = state["tgts"].reshape(-1, *state["tgts"].shape[2:])
    B = state["tgts"].shape[1]
    return scan.judge(state["src"], flat, [(j * B + b, x) for j, b, x in picked])


def control(state, units, rng):
    picked = _picked(state, units, rng)
    state.pop("srcs", None)
    free_program()
    flat = state["tgts"].reshape(-1, *state["tgts"].shape[2:])
    B = state["tgts"].shape[1]
    return scan.judge(state["src"], flat, [(j * B + b, None) for j, b, _ in picked], control=True)
