"""The port's tracing (``utils/tracing.py``) and the CG engine's PCG count.

* spans log nothing with no profiler session, and under one nest with the
  right parent and root, on the clock of the profiler's own host events;
* ``mark`` does nothing for CPU tensors (the kernels run on the card only:
  ``chip_smoke.py`` phase 25 checks them there);
* ``pcg``'s count and ``solve_ba``'s ``trace["pcg_iterations"]`` equal a
  plain count of the same stopping rule, with the solve still the JAX
  package's (``test_torch_ba_cg.py``'s parity bounds).
"""

import dataclasses
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch.kernels import graph_cond
from moptimizer_0_tpu_torch.ops.pcg import pcg
from moptimizer_0_tpu_torch.utils import tracing

from test_ba import make_synthetic_ba
from test_torch_ba_cg import _assert_same_solve, port


@pytest.fixture(autouse=True)
def _empty_log():
    tracing.clear()
    yield
    tracing.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_log_nothing_without_a_profiler():
    assert tracing.span("a") is tracing.span("b")  # one shared no-op: nothing allocated
    with tracing.span("solve_ba"):
        with tracing.span("replays"):
            torch.ones(3).sum()
    assert tracing.spans() == []


def test_spans_nest_under_a_profiler():
    with _cpu_profile():
        with tracing.span("icp"):
            with tracing.span("lm"):
                with tracing.span("layout"):
                    pass
                with tracing.span("replays"):
                    pass
        with tracing.span("icp"):
            pass
    by_name = {}
    for s in tracing.spans():
        by_name.setdefault(s.name, []).append(s)
    first, second = by_name["icp"]
    (lm,), (layout,), (replays,) = by_name["lm"], by_name["layout"], by_name["replays"]
    assert first.parent is None and first.root == first.id
    assert second.parent is None and second.root == second.id != first.id
    assert lm.parent == first.id and lm.root == first.id
    assert layout.parent == replays.parent == lm.id and layout.root == replays.root == first.id
    assert [s.name for s in tracing.spans()] == ["layout", "replays", "lm", "icp", "icp"]  # logged at their ends
    for s in tracing.spans():
        assert s.start_ns <= s.end_ns
    assert first.start_ns <= lm.start_ns <= layout.start_ns <= layout.end_ns <= replays.start_ns
    assert replays.end_ns <= lm.end_ns <= first.end_ns <= second.start_ns


def test_span_times_share_the_profilers_clock():
    """Each span's start and end against its range's event in the
    profiler's record: the median offset over 9 spans within 20 µs (a
    preempted thread may stretch one), each within 2 ms (another clock
    would be off by far more)."""
    with _cpu_profile() as prof:
        with tracing.span("warm"):
            torch.ones(8).sum()
        for k in range(9):
            with tracing.span(f"s{k}"):
                torch.ones(64).sum()
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith(tracing.PREFIX)}
    offsets = []
    for s in tracing.spans():
        if s.name != "warm":
            start, end = events[tracing.PREFIX + s.name]
            offsets += [abs(s.start_ns - start), abs(s.end_ns - end)]
    assert len(offsets) == 18
    assert statistics.median(offsets) <= 20_000, offsets
    assert max(offsets) <= 2_000_000, offsets


def test_mark_is_a_no_op_on_cpu_tensors(monkeypatch):
    def no_library():
        raise AssertionError("a marker on a CPU tensor reached the CUDA library")

    monkeypatch.setattr(graph_cond, "_library", no_library)
    count = torch.zeros((), dtype=torch.int32)
    for name in graph_cond.MARKS:
        tracing.mark(name, torch.zeros(2))
    tracing.mark("pcg_iteration", torch.zeros(2), count)
    assert int(count) == 0


def _plain_count(matvec, b, precond, iters, tol):
    """The PCG iterations that the stopping test ‖r‖² > tol² lets run, read
    before every iteration (``ops/pcg.py``'s arithmetic)."""
    tiny = torch.finfo(b.dtype).tiny
    r, p = b, precond(b)
    rz = torch.sum(r * p)
    n = 0
    while n < iters and bool(torch.sum(r * r) > tol * tol):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), tiny)
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp_min(rz, tiny) * p
        rz = rz_new
        n += 1
    return n


@pytest.mark.parametrize("tol", [1e-30, 1e-6])
def test_pcg_count_equals_a_plain_count(tol):
    """At every read interval: the iterations past the test that the eager
    loop computes and discards do not count."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(40, 40))
    A = torch.as_tensor(M @ M.T + 0.5 * np.eye(40))
    d = torch.as_tensor(1.0 / np.diag(M @ M.T + 0.5 * np.eye(40)))
    b = torch.as_tensor(rng.normal(size=40))

    def matvec(u):
        return A @ u

    def precond(u):
        return d * u

    want = _plain_count(matvec, b, precond, 60, tol)
    assert want == 60 if tol == 1e-30 else 0 < want < 60
    for check in (1, 3, 7, 32, 64):
        count = torch.zeros((), dtype=torch.int32)
        x = pcg(matvec, b, precond, 60, tol, lambda t: t.tolist(), check=check, count=count)
        assert int(count) == want, check
        assert torch.equal(x, pcg(matvec, b, precond, 60, tol, lambda t: t.tolist(), check=check)), check


@pytest.mark.parametrize("cg_iterations", [50, 4])
def test_solve_ba_counts_pcg_iterations(monkeypatch, cg_iterations):
    """trace["pcg_iterations"] of a CG solve on the CPU: each outer
    iteration's Σ over its trials of a plain count of each PCG solve's
    iterations (every trial one PCG solve, in order), 0 past the last; the
    solve itself as test_torch_ba_cg.py holds it to the JAX package's."""
    counts = []

    def spy(matvec, b, precond, iters, tol, read, count=None):
        counts.append(_plain_count(matvec, b, precond, iters, tol))
        return pcg(matvec, b, precond, iters, tol, read, count=count)

    monkeypatch.setattr(tba, "pcg", spy)
    jprob = make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)[0]
    cfg = jba.BAConfig(max_iterations=20, rel_cost_tol=1e-10, cg_iterations=cg_iterations)
    t = tba.solve_ba(port(jprob), interop.ba_config_from_fields(dataclasses.asdict(cfg)))
    trials = t.trace["trials"].tolist()
    assert sum(trials) == len(counts)
    it = iter(counts)
    want = [sum(next(it) for _ in range(k)) for k in trials]
    got = t.trace["pcg_iterations"]
    assert got.dtype == torch.int32 and got.tolist() == want
    assert max(want) <= cg_iterations * max(trials) and want[0] > 0
    if cg_iterations == 50:
        _assert_same_solve(t, jba.solve_ba(jprob, cfg))
