"""Each cell's check against a broken timed path: the run past the look for
a card, at a small size on the CPU, with the program's entry point replaced
by a faulty one, must come out not correct; the same run unbroken, correct.
Faults: a solve that returns its state unchanged, half of the batch left
out, a solve cut short after 4 of its outer iterations, an answer altered
where it is produced. (No cell spans chips yet, so
none leaves out an exchange between them; a request is a batch of one.)"""

import dataclasses

import pytest
import torch

from portbench import run


def _cell(name):
    c = run.cell(name)
    if name.startswith("ba-"):
        c.config.update(cameras=24, points=600, observations=3019)
    elif "lanes" in c.traffic:
        c.config.update(points=1000)
        c.traffic.update(pool=2, checked=4, lanes=4)
    else:
        c.config.update(points=1000)
        c.traffic.update(pool=4, round=4, checked=4)
    return c


def _run(c):
    return run.run_cell(c, 2**32 + 3, 0.3, 0, device="cpu", log=lambda s: None)


# --- bundle adjustment -------------------------------------------------------

def _ba_unchanged(solve):
    def broken(problem, config, engine="cg"):
        from moptimizer_0_tpu_torch import ba

        r = solve(problem, config, engine=engine)
        y0 = ba.compute_cost(problem)
        trace = dict(r.trace, cost=torch.full_like(r.trace["cost"], float(y0)))
        return dataclasses.replace(r, camera_params=problem.camera_params.clone(), points=problem.points.clone(),
                                   cost=y0, trace=trace)
    return broken


def _ba_half(solve):
    def broken(problem, config, engine="cg"):
        half = problem.cam_idx.shape[0] // 2
        return solve(dataclasses.replace(problem, cam_idx=problem.cam_idx[:half], pt_idx=problem.pt_idx[:half],
                                         pixels=problem.pixels[:half]), config, engine=engine)
    return broken


def _ba_cut_short(solve):
    def broken(problem, config, engine="cg"):
        return solve(problem, dataclasses.replace(config, max_iterations=4), engine=engine)
    return broken


def _ba_altered(solve):
    def broken(problem, config, engine="cg"):
        r = solve(problem, config, engine=engine)
        cams = r.camera_params.clone()
        cams[2:, :3] += 1e-3
        return dataclasses.replace(r, camera_params=cams)
    return broken


# --- registration ------------------------------------------------------------

def _x0_of(result, srcs, tgts):
    from moptimizer_0_tpu_torch.utils.stats import median

    t = median(tgts, dim=-2) - median(srcs, dim=-2)
    return torch.cat([t, torch.zeros_like(t)], -1).to(result.x.dtype)


def _fleet_unchanged(fleet):
    def broken(srcs, tgts, *a, **k):
        r = fleet(srcs, tgts, *a, **k)
        return dataclasses.replace(r, x=_x0_of(r, srcs, tgts))
    return broken


def _fleet_half(fleet):
    def broken(srcs, tgts, *a, **k):
        B = srcs.shape[0] // 2
        r = fleet(srcs[:B], tgts[:B], *a, **k)
        return dataclasses.replace(r, x=torch.cat([r.x, r.x]), status=torch.cat([r.status, r.status]))
    return broken


def _x_altered(solve):
    def broken(*a, **k):
        r = solve(*a, **k)
        x = r.x.clone()
        x[..., 0] += 1e-2
        return dataclasses.replace(r, x=x)
    return broken


def _request_unchanged(icp):
    def broken(src, tgt, *a, **k):
        r = icp(src, tgt, *a, **k)
        return dataclasses.replace(r, x=_x0_of(r, src, tgt))
    return broken


CASES = [
    ("ba-venice1778.cg", "ba", "solve_ba", _ba_unchanged),
    ("ba-venice1778.cg", "ba", "solve_ba", _ba_half),
    ("ba-venice1778.cg", "ba", "solve_ba", _ba_cut_short),
    ("ba-venice1778.cg", "ba", "solve_ba", _ba_altered),
    ("fachada.fleet64", "registration", "icp_batched", _fleet_unchanged),
    ("fachada.fleet64", "registration", "icp_batched", _fleet_half),
    ("fachada.fleet64", "registration", "icp_batched", _x_altered),
    ("fachada.request", "registration", "icp", _request_unchanged),
    ("fachada.request", "registration", "icp", _x_altered),
]


@pytest.mark.parametrize("name", sorted({c[0] for c in CASES}))
def test_a_sound_run_is_correct(name):
    assert _run(_cell(name))["correct"] is True


@pytest.mark.parametrize("name,module,entry,fault", CASES, ids=[f"{c[0]}-{c[3].__name__}" for c in CASES])
def test_a_broken_run_is_not_correct(monkeypatch, name, module, entry, fault):
    import importlib

    mod = importlib.import_module(f"moptimizer_0_tpu_torch.{module}")
    monkeypatch.setattr(mod, entry, fault(getattr(mod, entry)))
    result = _run(_cell(name))
    assert result["correct"] is False, result["checks"]
