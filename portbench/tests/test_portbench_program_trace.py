"""The readers of the program's own spans and markers
(``portbench/program_trace.py`` and the six metrics that use it) on
hand-made profiles whose numbers are counted by hand, and on profiles of a
program that logs no spans and replays no markers (an older checkout, or a
CPU run): each reader then returns None."""

import sys
import types

import pytest

from portbench import run, trace
from portbench.trace import Profile

BA_METRICS = ("ba.pcg_iterations_per_solve", "ba.pcg_ms_per_iteration", "ba.linearize_ms_per_step",
              "ba.idle_before_step_ms")
ICP_METRICS = ("icp.idle_before_step_ms", "icp.idle_after_step_ms")


def _read(name, profile):
    ctx = types.SimpleNamespace(profile=profile, units=[], window_s=1.0)
    return run.load_file(run.HERE / "metrics" / f"{name}.py").read(ctx)


def _mark(name, s):
    return (f"moptimizer_mark_{name}", s, s + 1)


def _profile(device, units, bounds):
    host = [(trace.UNIT, s, e) for s, e in units]
    return Profile(window_s=(bounds[1] - bounds[0]) / 1e9, busy_s=1e-9, device=sorted(device, key=lambda r: r[1]),
                   host=host, units=[{} for _ in units], bounds=bounds)


def _spans(monkeypatch, rows):
    """The program's span log replaced by rows of (name, start, end,
    parent)."""
    from moptimizer_0_tpu_torch.utils import tracing

    spans = [tracing.Span(n, s, e, parent, parent or k + 1, k + 1) for k, (n, s, e, parent) in enumerate(rows)]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))


def _ba_profile():
    """Two solves. A: span 100-160; a copy 110-120; a step 130-192 whose
    linearization 131-156 holds two overlapping kernels (union 132-155) and
    whose PCG solve 160-191 runs two iterations with an idle gap 170-180.
    B: span 500-520; its first step at 560 (one iteration), a second, empty
    step at 610."""
    device = [
        ("copy", 110, 120), _mark("step_begin", 130), _mark("ba_linearize_begin", 131), ("lin", 132, 150),
        ("lin2", 140, 155), _mark("ba_linearize_end", 155), _mark("ba_pcg_begin", 160),
        _mark("pcg_iteration", 161), ("mv", 162, 170), ("moptimizer_mark_pcg_iteration(int*)", 180, 181),
        ("mv", 181, 190), _mark("ba_pcg_end", 190), _mark("step_end", 191),
        _mark("step_begin", 560), _mark("ba_linearize_begin", 561), ("lin", 562, 580),
        _mark("ba_linearize_end", 580), _mark("ba_pcg_begin", 581), _mark("pcg_iteration", 582), ("mv", 583, 600),
        _mark("ba_pcg_end", 600), _mark("step_end", 601), _mark("step_begin", 610), _mark("step_end", 611),
    ]
    return _profile(device, [(95, 400), (490, 800)], (0, 1000))


def test_ba_readers_count_by_hand(monkeypatch):
    _spans(monkeypatch, [("layout", 101, 105, 1), ("solve_ba", 100, 160, None), ("solve_ba", 500, 520, None),
                         ("solve_ba", 990, 1100, None)])  # the last ends outside the window
    p = _ba_profile()
    assert _read("ba.pcg_iterations_per_solve", p) == 3 / 2
    # busy in the PCG pairs: 160-191 → 1 + 1 + 8 + 1 + 9 + 1 = 21, 581-601 → 20
    assert _read("ba.pcg_ms_per_iteration", p) == pytest.approx(41 / 3 / 1e6)
    # busy in the linearization pairs: 131-156 → 25, 561-581 → 20; 3 steps
    assert _read("ba.linearize_ms_per_step", p) == pytest.approx(45 / 3 / 1e6)
    # idle before the first step: 100-130 less the copy → 20; 500-560 → 60
    assert _read("ba.idle_before_step_ms", p) == pytest.approx(40 / 1e6)


def test_icp_readers_count_by_hand(monkeypatch):
    """Three requests; a request ends at its unit's end (x on the host),
    after its span's."""
    _spans(monkeypatch, [("icp", 1000, 1010, None), ("lm", 1001, 1009, 1), ("icp", 1200, 1210, None),
                         ("icp", 1400, 1450, None)])
    device = [
        ("seed", 1002, 1004), _mark("step_begin", 1020), ("k", 1021, 1040), _mark("step_end", 1040),
        _mark("step_begin", 1050), _mark("step_end", 1060), ("empty", 1065, 1066), ("memcpy", 1080, 1085),
        _mark("step_begin", 1205), _mark("step_end", 1230),
        _mark("step_begin", 1410), _mark("step_end", 1420),
    ]
    p = _profile(device, [(995, 1100), (1195, 1300), (1395, 1500)], (900, 2000))
    # before: 1000-1020 less 2 → 18; 1200-1205 → 5; 1400-1410 → 10
    assert _read("icp.idle_before_step_ms", p) == pytest.approx(10 / 1e6)
    # after: 1061-1100 less 6 → 33; 1231-1300 → 69; 1421-1500 → 79
    assert _read("icp.idle_after_step_ms", p) == pytest.approx(69 / 1e6)


@pytest.mark.parametrize("name", BA_METRICS + ICP_METRICS)
def test_readers_find_nothing_without_the_programs_spans_and_markers(monkeypatch, name):
    """A program without utils/tracing.py, a profile without markers, and an
    untraced run: None, and nothing raised."""
    assert _read(name, None) is None
    bare = _profile([("k", 10, 20)], [(0, 100)], (0, 100))
    assert _read(name, bare) is None
    monkeypatch.setitem(sys.modules, "moptimizer_0_tpu_torch.utils.tracing", None)  # the import fails
    p = _ba_profile() if name in BA_METRICS else bare
    want = {"ba.pcg_iterations_per_solve": 3 / 2, "ba.pcg_ms_per_iteration": pytest.approx(41 / 3 / 1e6),
            "ba.linearize_ms_per_step": pytest.approx(45 / 3 / 1e6)}
    assert _read(name, p) == want.get(name)  # the readers of spans find none
