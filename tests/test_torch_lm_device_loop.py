"""The port's LM loops as device loops, against the JAX package's.

On CUDA ``levenberg_marquardt`` and ``lm_step`` run an outer iteration,
and ``levenberg_marquardt_batched`` a pass, as one replay of a CUDA graph
captured once per layout, and a solve as max_iterations replays with no
host read (``core/solver.py``, ``ops/device_loop.py``); ``chip_smoke.py``
phase 20 holds the graphs bit for bit to the same bodies run eagerly on the
card. Here, on the CPU in float64, those bodies run eagerly under the same
``StepLoop`` and are held to the JAX package's jitted ``while_loop`` solves
at the tolerances of test_torch_solver.py (1e-9 relative, ρ with its gain
term), on problems that stop on ``rel_cost_tol``, ``grad_tol`` or
max_iterations before the noise floor. Also: ``StepLoop`` with vector
records, lanes and a data carry; the layout keys of ``icp()``; the reads
of the eager loop; ``verbose=True``, one printed line a trial.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.core.manifold import Euclidean as JEuclidean
from moptimizer_0_tpu.models import powell as jpowell
from moptimizer_0_tpu.models import rational as jrational
from moptimizer_0_tpu.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_0_tpu.registration import _batched_icp_jit
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch import registration as treg
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.core.loss import GemanMcClure, TrivialLoss
from moptimizer_0_tpu_torch.core.manifold import Euclidean
from moptimizer_0_tpu_torch.models import powell as tpowell
from moptimizer_0_tpu_torch.models import rational as trational
from moptimizer_0_tpu_torch.ops import device_loop

from test_torch_batched_solver import ICP_X_TRUE, _icp_scene, _lane, _numpy
from test_torch_solver import _assert_same_solve, _assert_trace_equal, _curve_blocks

RATIONAL_X0 = np.array([[0.9, 0.2], [1.9, 1.5], [50.0, -40.0], [-3.0, 0.01]])


def _rational(analytic=True):
    x, y = np.asarray(jrational.SIMPLE_X), np.asarray(jrational.SIMPLE_Y)
    return (trational.rational_block(torch.as_tensor(x), torch.as_tensor(y), analytic=analytic),
            jrational.rational_block(jnp.asarray(x), jnp.asarray(y), analytic=analytic))


def _two_curves():
    """Two curve blocks over halves of the data: a two-block problem."""
    a, ja = _curve_blocks(CERES_CURVE_DATA[:40])
    b, jb = _curve_blocks(CERES_CURVE_DATA[40:])
    return (a, b), (ja, jb)


CASES = {
    "curve": (lambda: _curve_blocks(), [0.0, 0.0], dict(rel_cost_tol=1e-10), False),
    "curve_manifold": (lambda: _curve_blocks(), [0.0, 0.0], dict(linear_solver="cholesky", rel_cost_tol=1e-10), True),
    "curve_grad_tol": (lambda: _curve_blocks(), [1.2, 2.0], dict(grad_tol=1e-2, max_iterations=40), False),
    "curves_block_costs": (_two_curves, [0.0, 0.0], dict(trace_block_costs=True, inner_iterations=2,
                                                        rel_cost_tol=1e-10), True),
    "powell": (lambda: (tpowell.powell_block(analytic=True), jpowell.powell_block(analytic=True)),
               [3.0, -1.0, 0.0, 4.0], dict(max_iterations=8), False),
    "rational": (_rational, [0.9, 0.2], dict(rel_cost_tol=1e-10), False),
    "rational_manifold": (_rational, [0.9, 0.2], dict(rel_cost_tol=1e-10, trace_block_costs=True), True),
}


def _same(a, b):
    """Equal bit for bit, NaN slots included."""
    def bits(t):
        return t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def _both(case):
    make, x0, fields, manifold = CASES[case]
    t, j = make()
    t, j = (t, j) if isinstance(t, tuple) else ((t,), (j,))
    P = len(x0)
    return (tres.problem(*t), jres.problem(*j), np.asarray(x0, np.float64), fields,
            (Euclidean(P), JEuclidean(P)) if manifold else (None, None))


@pytest.mark.parametrize("case", sorted(CASES))
def test_levenberg_marquardt_matches_jax(case):
    """The restructured eager body, every trial decided on the device, as the
    JAX package's jitted solve; the eager loop's reads: one a trial taken,
    one that finds the trials stopped, one an outer iteration."""
    tp, jp, x0, fields, (tm, jm) = _both(case)
    reads = tsol.HOST_READS
    t = tsol.levenberg_marquardt(tp, torch.as_tensor(x0), interop.config_from_fields(fields), manifold=tm)
    reads = tsol.HOST_READS - reads
    j = jsol.levenberg_marquardt(jp, jnp.asarray(x0), jsol.LMConfig(**fields), manifold=jm)
    _assert_same_solve(t, j)
    n_it = tsol.LMConfig(**fields).max_iterations
    n_inner = tsol.LMConfig(**fields).inner_iterations
    trials = torch.isfinite(t.trace["inner"]["lam"]).sum(-1)[torch.isfinite(t.trace["cost"])]
    outer = trials.numel()
    expected = outer + int((trials + (trials < n_inner)).sum()) + (outer < n_it)
    assert reads == expected


def test_lm_step_chain_equals_the_solve():
    """lm_step fed its own (problem′, x′, λ′) walks the solve's trace bit
    for bit, terminal and status 0-dim tensors."""
    tp, _, x0, fields, _ = _both("rational")
    cfg = interop.config_from_fields(fields)
    res = tsol.levenberg_marquardt(tp, torch.as_tensor(x0), cfg)
    prob, x, lam = tp, torch.as_tensor(x0), -1.0
    for it in range(int(res.iterations) + 1):
        prob, x, lam, terminal, status, record = tsol.lm_step(prob, x, lam, cfg)
        assert terminal.shape == status.shape == () and terminal.dtype == torch.bool
        for key in ("cost", "cost_new", "rho", "lam", "nu", "accepted"):
            assert _same(record[key], res.trace[key][it]), key
        assert _same(record["inner"]["lam"], res.trace["inner"]["lam"][it])
        if bool(terminal):
            break
    assert bool(terminal) and int(status) == int(res.status) and _same(x, res.x)


def _assert_lanes(t, j, trace=True):
    """Every lane of a batched result as the JAX lane: status, iterations,
    x and cost, and (``trace``) the trace at test_torch_solver.py's
    tolerances."""
    t, j = interop.result_to_numpy(t), _numpy(j)
    np.testing.assert_array_equal(t["status"], j["status"])
    np.testing.assert_array_equal(t["iterations"], j["iterations"])
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=1e-9, atol=1e-15 * np.abs(j["trace"]["cost"][:, 0]).max())
    for i in range(t["x"].shape[0] if trace else 0):
        _assert_trace_equal(_lane(t, i)["trace"], _lane(j, i)["trace"])


@pytest.mark.parametrize("manifold", [False, True])
def test_batched_matches_jax(manifold):
    """Curve lanes with their own data (batch_data=True): block costs,
    rel_cost_tol, lanes that stop at different passes."""
    datas = np.stack([CERES_CURVE_DATA[:48], CERES_CURVE_DATA[8:56], CERES_CURVE_DATA[16:64]])
    tb, jb = _curve_blocks(datas)
    x0s = np.array([[0.0, 0.0], [0.3, 0.1], [1.2, 2.0]])
    fields = dict(rel_cost_tol=1e-10, trace_block_costs=True, max_iterations=30)
    t = tsol.levenberg_marquardt_batched(tres.problem(tb), torch.as_tensor(x0s), interop.config_from_fields(fields),
                                         manifold=Euclidean(2) if manifold else None)
    j = jsol.levenberg_marquardt_batched(jres.problem(jb), jnp.asarray(x0s), jsol.LMConfig(**fields),
                                         manifold=JEuclidean(2) if manifold else None)
    assert t.trace["inner"]["lam"].shape == (3, 30, 3) and t.trace["block_costs"].shape == (3, 30, 1)
    _assert_lanes(t, j)


@pytest.mark.parametrize("batch_data", [False, True])
def test_multistart_matches_jax(batch_data):
    """solve_multistart on the rational problem's basins, the data shared or
    given a lane axis; the best lane picked on the device. The far starts
    run their 40 iterations near the noise floor, where λ takes up the
    summation order's roundoff through ρ: lanes and the best are held by
    status, iterations, x and cost, as test_torch_batched_solver.py holds
    them."""
    tb, jb = _rational()
    if batch_data:
        B = RATIONAL_X0.shape[0]
        tb = dataclasses.replace(tb, data=tb.data.expand(B, *tb.data.shape).clone())
        jb = dataclasses.replace(jb, data=jnp.broadcast_to(jb.data, (B, *jb.data.shape)))
    fields = dict(max_iterations=40, rel_cost_tol=1e-10)
    best, allres = tsol.solve_multistart(tres.problem(tb), torch.as_tensor(RATIONAL_X0),
                                         interop.config_from_fields(fields), batch_data=batch_data)
    jbest, jall = jsol.solve_multistart(jres.problem(jb), jnp.asarray(RATIONAL_X0), jsol.LMConfig(**fields),
                                        batch_data=batch_data)
    _assert_lanes(allres, jall, trace=False)
    b, jb = interop.result_to_numpy(best), _numpy(jbest)
    assert int(b["status"]) == int(jb["status"]) and int(b["iterations"]) == int(jb["iterations"])
    np.testing.assert_allclose(b["x"], jb["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(b["cost"], jb["cost"], rtol=1e-9)


def test_icp_batched_matches_batched_icp_jit():
    """icp_batched through the fleet matcher and K6's plain version, against
    the JAX package's compile-once fleet solve, lane by lane."""
    srcs, tgts = _icp_scene()
    srcs, tgts = srcs[:, :400], tgts[:, :400]
    x0s = np.zeros((3, 6))
    x0s[:, :3] = np.median(tgts, 1) - np.median(srcs, 1)
    fields = dict(diff_mode="auto", max_iterations=30, linear_solver="cholesky", rel_cost_tol=1e-10)
    t = treg.icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts), torch.as_tensor(x0s), max_corr_dist=1.0,
                         config=interop.config_from_fields(fields))
    run = _batched_icp_jit(jsol.LMConfig(**fields), 1.0)
    from moptimizer_0_tpu.core.loss import TrivialLoss as JTrivialLoss

    j = run(jnp.asarray(srcs), jnp.asarray(tgts), jnp.asarray(x0s), JTrivialLoss())
    _assert_lanes(t, j)
    np.testing.assert_allclose(t.x.numpy(), ICP_X_TRUE, atol=1e-6)


class _Countdown:
    """A toy outer step over lanes: carry (x (B,), λ, data (B, 3)); each
    iteration x ← x − 1 where x > stop, data ← data + x, terminal once every
    lane reached its stop; records x (B,) and a vector row (B, 2)."""

    def __init__(self, stop):
        self.stop = stop

    def __call__(self, x, lam, data):
        x = torch.where(x > self.stop, x - 1.0, x)
        done = x <= self.stop
        record = dict(x=x, row=torch.stack([x, 2.0 * x], dim=-1))
        return (x, lam * 2.0, data + x[:, None]), done.all(), torch.zeros((), dtype=torch.int32), record


@pytest.mark.parametrize("n", [3, 8])
def test_step_loop_vector_records_lanes_and_data_carry(n):
    """StepLoop eagerly with lanes=1: the trace (B, n, ...) row of each
    iteration at the device counter, the data leaf carried and rewritten,
    a leaf the body returns as the carry's own buffer left in place, one
    read of ¬done an iteration plus one that finds the loop done."""
    reads = []

    def read(t):
        reads.append(1)
        return t.tolist()

    stop = torch.tensor([3.0, 1.0], dtype=torch.float64)
    body = _Countdown(stop)
    record = dict(x=(torch.float64, (2,)), row=(torch.float64, (2, 2)))
    x0 = torch.tensor([5.0, 5.0], dtype=torch.float64)
    carry = (x0, torch.tensor(1.0, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.float64))
    loop = device_loop.StepLoop(body, carry, n, record, 0, lanes=1)
    assert loop.trace["x"].shape == (2, n) and loop.trace["row"].shape == (2, n, 2)
    loop.solve(n, read)
    ran = min(n, 4)  # lane 1 needs 4 iterations
    xs = loop.trace["x"]
    expect = torch.stack([torch.clamp(5.0 - torch.arange(1, ran + 1, dtype=torch.float64), min=s) for s in stop])
    assert torch.equal(xs[:, :ran], expect) and torch.isnan(xs[:, ran:]).all()
    assert torch.equal(loop.trace["row"][:, :ran, 1], 2.0 * expect)
    assert torch.equal(loop.carry[2], expect.sum(1, keepdim=True).expand(2, 3))
    assert int(loop.it) == (ran - 1 if n >= 4 else n) and bool(loop.done) == (n >= 4)
    assert float(loop.carry[1]) == 2.0**ran
    assert len(reads) == ran + (ran < n)
    assert loop.record["row"].shape == (2, 2)


def test_step_loop_vector_records_without_lanes():
    """A record with a trailing shape and no lanes: trace (n, k)."""
    def body(x):
        x = x + 1.0
        return (x,), x[0] >= 3.0, torch.zeros((), dtype=torch.int32), dict(v=x * 10.0)

    loop = device_loop.StepLoop(body, (torch.zeros(3, dtype=torch.float64),), 5, dict(v=(torch.float64, (3,))), 0)
    loop.solve(5, lambda t: t.tolist())
    assert loop.trace["v"].shape == (5, 3)
    assert loop.trace["v"][:3, 0].tolist() == [10.0, 20.0, 30.0] and torch.isnan(loop.trace["v"][3:]).all()


def _icp_key(monkeypatch, src, tgt, **kw):
    """The solver's layout key of an icp() request (``core.solver._layout``)."""
    seen = []
    real = treg.levenberg_marquardt

    def spy(problem, x0, config, manifold=None):
        seen.append(tsol._layout("lm", problem, torch.as_tensor(x0), config, manifold))
        return real(problem, x0, config, manifold)

    monkeypatch.setattr(treg, "levenberg_marquardt", spy)
    treg.icp(src, tgt, **kw)
    return tuple(device_loop.key_part(p) for p in seen[0])


def test_icp_layout_keys(monkeypatch):
    """Two icp() requests of one shape, config and loss have one key (one
    capture on the card); a changed shape, config, loss or max_corr_dist
    gives a new one."""
    srcs, tgts = _icp_scene()
    src, tgt = (torch.as_tensor(a[0, :200]) for a in (srcs, tgts))
    src2, tgt2 = (torch.as_tensor(a[1, :200]) for a in (srcs, tgts))
    kw = dict(loss=GemanMcClure(tau=1.0), max_corr_dist=1.0)
    base = _icp_key(monkeypatch, src, tgt, **kw)
    assert _icp_key(monkeypatch, src2, tgt2, **kw) == base
    changed = [
        _icp_key(monkeypatch, src[:150], tgt, **kw),
        _icp_key(monkeypatch, src, tgt[:150], **kw),
        _icp_key(monkeypatch, src, tgt, config=tsol.LMConfig(max_iterations=7), **kw),
        _icp_key(monkeypatch, src, tgt, loss=GemanMcClure(tau=2.0), max_corr_dist=1.0),
        _icp_key(monkeypatch, src, tgt, loss=TrivialLoss(), max_corr_dist=1.0),
        _icp_key(monkeypatch, src, tgt, loss=GemanMcClure(tau=1.0), max_corr_dist=0.5),
    ]
    assert all(k != base for k in changed)
    assert len(set(changed)) == len(changed)


def test_verbose_prints_one_line_a_trial(capsys):
    """verbose=True runs the eager body (on the card too) and prints one line
    for every trial, single and batched."""
    tp, _, x0, fields, _ = _both("curve")
    res = tsol.levenberg_marquardt(tp, torch.as_tensor(x0), interop.config_from_fields(dict(fields, verbose=True)))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[DEBUG] lm inner: ")]
    assert len(lines) == int(torch.isfinite(res.trace["inner"]["lam"]).sum()) > 0
    tb, _ = _curve_blocks(np.stack([CERES_CURVE_DATA[:48], CERES_CURVE_DATA[8:56]]))
    res = tsol.levenberg_marquardt_batched(tres.problem(tb), torch.zeros(2, 2, dtype=torch.float64),
                                           interop.config_from_fields(dict(fields, verbose=True)))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[DEBUG] lm inner (lanes): ")]
    # one line a trial of the batch: the most trials any lane ran in a pass
    per_pass = torch.isfinite(res.trace["inner"]["lam"]).sum(-1).amax(0)
    assert len(lines) == int(per_pass.sum()) > 0
