"""The port's BA loops against the JAX package's device loops.

On CUDA the port runs an outer LM iteration of ``ba_step``,
``ba_step_dense`` and ``ba_step_selfcal`` as one CUDA-graph replay, and
``solve_ba``/``solve_ba_dense`` with ``host_loop=False`` as max_iterations
replays with no host read (``ops/device_loop.py``); ``chip_smoke.py`` phase
19 holds those graphs bit for bit to the same bodies run eagerly on the
card. Here, on the CPU in float64, the same bodies run eagerly under the
same ``StepLoop``, and are held to the JAX package's jitted
``lax.while_loop`` solves (``solve_ba(host_loop=False)``,
``solve_ba_dense(host_loop=False)``) and to its host-stepped
``solve_ba_selfcal``. Tolerances: test_torch_ba_cg.py's ``_assert_same_solve``
(1e-9 relative, ρ with its gain term), on problems that stop on
``rel_cost_tol`` or max_iterations before the noise floor; the port's two
loops are compared bit for bit, trace and ``trials`` included.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu import ba_intrinsics as jbi
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch import ba_intrinsics as tbi
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.core.solver import Status
from moptimizer_0_tpu_torch.ops import device_loop

from test_ba import make_synthetic_ba
from test_torch_ba_cg import _assert_same_solve, port, rel_err

CG = dict(max_iterations=20, rel_cost_tol=1e-10)
WRONG = jnp.asarray([8.0, -6.0, 3.0, -2.0])


def _problems():
    """(noisy start, ground truth) of make_synthetic_ba at C = 5, L = 40."""
    return make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)


def _solve(engine, prob, cfg, host_loop):
    """The port's solve by engine "cg" (solve_ba) or "dense"
    (solve_ba_dense, with the config's rel_cost_tol)."""
    if engine == "cg":
        return tba.solve_ba(prob, tba.BAConfig(**cfg), host_loop=host_loop)
    return tbd.solve_ba_dense(prob, tbd.DenseBAConfig(**cfg), host_loop=host_loop)


def _jax_solve(engine, jprob, cfg):
    if engine == "cg":
        return jba.solve_ba(jprob, jba.BAConfig(**cfg))
    return jbd.solve_ba_dense(jprob, jbd.DenseBAConfig(**cfg))


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _bit_equal(a, b):
    """The same bits in every field and trace entry (NaN slots included)."""
    fields = ("camera_params", "points", "status", "iterations", "cost")
    return (
        all(torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))) for f in fields)
        and a.trace.keys() == b.trace.keys()
        and all(torch.equal(_bits(a.trace[k]), _bits(b.trace[k])) for k in a.trace)
    )


@pytest.mark.parametrize("host_loop", [False, True])
@pytest.mark.parametrize("engine", ["cg", "dense"])
def test_solve_matches_jax_device_loop(engine, host_loop):
    """Both of the port's loops against the JAX package's single-dispatch
    while_loop solve: every trace entry, the state and the status."""
    jprob, _ = _problems()
    j = _jax_solve(engine, jprob, CG)
    t = _solve(engine, port(jprob), CG, host_loop)
    assert int(j.status) == Status.CONVERGED and int(j.iterations) >= 4
    _assert_same_solve(t, j)
    run = int(t.iterations) + 1
    assert (t.trace["trials"][:run] >= 1).all() and (t.trace["trials"][run:] == 0).all()


@pytest.mark.parametrize("engine", ["cg", "dense"])
def test_solve_ba_engine_loops_match_jax(engine):
    """solve_ba(engine=...) with both loops against the JAX package's
    solve_ba(host_loop=False), three outer iterations (solve_ba passes the
    dense engine no rel_cost_tol)."""
    jprob, _ = _problems()
    cfg = dict(max_iterations=3)
    j = jba.solve_ba(jprob, jba.BAConfig(**cfg), engine=engine)
    for host_loop in (False, True):
        t = tba.solve_ba(port(jprob), tba.BAConfig(**cfg), host_loop=host_loop, engine=engine)
        assert int(j.status) == Status.MAXIMUM_ITERATIONS_REACHED
        _assert_same_solve(t, j)


@pytest.mark.parametrize("engine", ["cg", "dense"])
def test_two_loops_bit_equal(engine):
    """host_loop=False and True: the same bits, trace and trials included."""
    prob = port(_problems()[0])
    a, b = (_solve(engine, prob, CG, hl) for hl in (False, True))
    assert _bit_equal(a, b)
    assert a.trace["trials"].dtype == torch.int32 and a.status.dtype == a.iterations.dtype == torch.int32


@pytest.mark.parametrize("engine", ["cg", "dense", "selfcal"])
def test_converged_at_start(engine):
    """At the ground truth of a noiseless problem y0 < 8ε: no trial, status
    CONVERGED and 0 iterations, as in the JAX package; the trace holds the
    one terminal iteration (its λ the seed, its ρ NaN, no trial)."""
    _, gt = make_synthetic_ba(C=5, L=40, seed=3)
    prob = port(gt)
    if engine == "selfcal":
        jres, _ = jbi.solve_ba_selfcal(gt, jba.BAConfig(**CG))
        t, intr = tbi.solve_ba_selfcal(prob, tba.BAConfig(**CG))
        assert torch.equal(intr, prob.intrinsics)
    else:
        jres = _jax_solve(engine, gt, CG)
        t = _solve(engine, prob, CG, False)
        assert t.trace["trials"].tolist() == [0] * CG["max_iterations"]
        # y0 is roundoff on both sides, summed in other orders
        assert max(float(t.trace["cost"][0]), float(jres.trace["cost"][0])) < 8 * np.finfo(np.float64).eps
        assert torch.isnan(t.trace["rho"][0]) and torch.isnan(t.trace["cost"][1:]).all()
    assert int(t.status) == int(jres.status) == Status.CONVERGED
    assert int(t.iterations) == int(jres.iterations) == 0
    assert torch.equal(t.camera_params, prob.camera_params) and torch.equal(t.points, prob.points)


@pytest.mark.parametrize("engine", ["cg", "dense"])
def test_hits_max_iterations(engine):
    """Two outer iterations from a far start: MAXIMUM_ITERATIONS_REACHED
    and 2 iterations, both loops, equal to the JAX package's."""
    jprob, _ = _problems()
    cfg = dict(max_iterations=2)
    j = _jax_solve(engine, jprob, cfg)
    for host_loop in (False, True):
        t = _solve(engine, port(jprob), cfg, host_loop)
        assert int(t.status) == int(j.status) == Status.MAXIMUM_ITERATIONS_REACHED
        assert int(t.iterations) == int(j.iterations) == 2
        _assert_same_solve(t, j)


def test_selfcal_matches_jax():
    """solve_ba_selfcal, one ba_step_selfcal an outer iteration, against the
    JAX package's host-stepped solve: state, intrinsics, status and
    iterations; and with max_iterations cut to 2."""
    jprob, gt = _problems()
    jprob = dataclasses.replace(jprob, intrinsics=gt.intrinsics + WRONG)
    for cfg in (CG, dict(max_iterations=2)):
        jres, jintr = jbi.solve_ba_selfcal(jprob, jba.BAConfig(**cfg))
        tres, tintr = tbi.solve_ba_selfcal(port(jprob), tba.BAConfig(**cfg))
        assert (int(tres.status), int(tres.iterations)) == (int(jres.status), int(jres.iterations))
        assert rel_err(tintr, jintr) < 1e-9
        assert rel_err(tres.camera_params, jres.camera_params) < 1e-9
        assert rel_err(tres.points, jres.points) < 1e-9
        assert abs(float(tres.cost) / float(jres.cost) - 1) < 1e-9
        assert tres.trace == {} and tres.status.dtype == torch.int32
    assert int(tres.status) == Status.MAXIMUM_ITERATIONS_REACHED


def _steps(prob, jprob, cfg):
    """(port step, JAX step) of each engine from λ = −1."""
    grouped, jgrouped = tbd.group_by_landmark(prob), jbd.group_by_landmark(jprob)
    return {
        "ba_step": (tba.ba_step(prob, -1.0, tba.BAConfig(**cfg)), jba.ba_step(jprob, -1.0, jba.BAConfig(**cfg))),
        "ba_step_dense": (tbd.ba_step_dense(prob, grouped, -1.0, tbd.DenseBAConfig(**cfg)),
                          jbd.ba_step_dense(jprob, jgrouped, jnp.asarray(-1.0), jbd.DenseBAConfig(**cfg))),
        "ba_step_selfcal": (tbi.ba_step_selfcal(prob, -1.0, tba.BAConfig(**cfg)),
                            jbi.ba_step_selfcal(jprob, -1.0, jba.BAConfig(**cfg))),
    }


@pytest.mark.parametrize("start", ["noisy", "converged"])
def test_step_terminal_and_status_are_tensors(start):
    """Each step's terminal and status are 0-dim tensors (bool, int32) with
    the JAX package's values, its record's trials a 0-dim int32; from the
    ground truth the step is terminal and CONVERGED."""
    jprob, gt = _problems()
    if start == "converged":
        jprob = make_synthetic_ba(C=5, L=40, seed=3)[1]
    for name, (t, j) in _steps(port(jprob), jprob, CG).items():
        terminal, status, record = t[-3], t[-2], t[-1]
        assert terminal.shape == status.shape == record["trials"].shape == (), name
        assert terminal.dtype == torch.bool and status.dtype == record["trials"].dtype == torch.int32, name
        assert bool(terminal) == bool(j[-3]) and int(status) == int(j[-2]), name
        if start == "converged":
            assert bool(terminal) and int(status) == Status.CONVERGED and int(record["trials"]) == 0, name
        else:
            assert not bool(terminal) and int(record["trials"]) == 1, name
        for tv, jv in zip(t[:-4], j[:-4]):
            assert rel_err(tv, jv) < 1e-9, name


class _Countdown:
    """A toy outer step: carry (x, λ), x ← x − 1, terminal when x reaches
    ``stop`` (status 7 then, else 0), record x and the one trial."""

    def __init__(self, stop):
        self.stop = stop

    def __call__(self, x, lam):
        x = x - 1.0
        terminal = x <= self.stop
        status = torch.where(terminal, 7, torch.zeros((), dtype=torch.int32))
        return (x, lam * 2.0), terminal, status, dict(x=x, trials=torch.ones((), dtype=torch.int32))


def _countdown_loop(stop, n):
    record = dict(x=torch.float64, trials=torch.int32)
    return device_loop.StepLoop(_Countdown(stop), (torch.tensor(5.0, dtype=torch.float64),
                                                   torch.tensor(1.0, dtype=torch.float64)), n, record, 3)


@pytest.mark.parametrize("stop,n", [(2.0, 6), (-10.0, 4)])
def test_step_loop_counter_trace_and_reads(stop, n):
    """StepLoop run eagerly: the trace row of each iteration at the device
    counter, the terminal iteration written but not counted, the status of
    the last iteration (status0 before any), and one read of ¬done an
    iteration plus one that finds the loop done."""
    reads = []

    def read(t):
        reads.append(1)
        return t.tolist()

    loop = _countdown_loop(stop, n)
    assert int(loop.status) == 3 and torch.isnan(loop.trace["x"]).all()
    loop.solve(n, read)
    ran = 3 if stop == 2.0 else n
    xs = loop.trace["x"].tolist()
    assert xs[:ran] == [4.0 - i for i in range(ran)] and all(np.isnan(xs[ran:]))
    assert loop.trace["trials"].tolist() == [1] * ran + [0] * (n - ran)
    assert int(loop.it) == (ran - 1 if stop == 2.0 else n) and bool(loop.done) == (stop == 2.0)
    assert int(loop.status) == (7 if stop == 2.0 else 0)
    assert float(loop.carry[1]) == 2.0**ran
    assert len(reads) == ran + (ran < n)
    loop.start((5.0, torch.tensor(1.0, dtype=torch.float64)))
    assert not bool(loop.done) and int(loop.it) == 0 and int(loop.status) == 3 and float(loop.carry[0]) == 5.0


def test_cond_reads_through_the_caller_and_cache_keys():
    """cond eagerly: one read, fn run only where it was true. lookup: a hit
    for the same tensors, a miss after an in-place change, eviction of the
    least recently used with its drop called."""
    hits, reads = [], []

    def read(t):
        reads.append(1)
        return t.tolist()

    assert device_loop.cond(torch.tensor(True), lambda: hits.append(1), read)
    assert not device_loop.cond(torch.tensor(False), lambda: hits.append(2), read)
    assert hits == [1] and len(reads) == 2 and not device_loop.tracing()
    assert not device_loop.graphs(torch.zeros(1))
    store, dropped, made = collections.OrderedDict(), [], []
    a, b = torch.zeros(3), torch.zeros(3)

    def make(tag):
        made.append(tag)
        return tag

    assert device_loop.lookup(store, (a, "x"), lambda: make("a"), 2, dropped.append) == "a"
    assert device_loop.lookup(store, (a, "x"), lambda: make("a2"), 2, dropped.append) == "a"
    assert device_loop.lookup(store, (b, "x"), lambda: make("b"), 2, dropped.append) == "b"
    a.add_(1.0)  # a new version: a new key, which evicts the oldest entry
    assert device_loop.lookup(store, (a, "x"), lambda: make("a3"), 2, dropped.append) == "a3"
    assert made == ["a", "b", "a3"] and dropped == ["a"] and len(store) == 2
