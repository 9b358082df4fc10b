"""What the readers of the program's own spans and markers share.

While a profiler records, the port logs host spans on the profiler's clock
(``moptimizer_0_tpu_torch.utils.tracing.spans()``: solve_ba, icp, lm,
layout, replays, result, ...), and its CUDA graphs replay empty marker
kernels, ``moptimizer_mark_<name>``, around each outer step
(``step_begin``/``step_end``), the BA linearization (``ba_linearize_*``),
each PCG solve (``ba_pcg_*``) and at each PCG iteration
(``pcg_iteration``). A program without them gives no span and no marker,
and each reader then returns None. Device busy time in an interval is the
union of the device events inside it, clipped to it; idle is the rest.
"""

import bisect

from portbench import trace

MARK = "moptimizer_mark_"


def markers(profile, name):
    """(start, end) of the device's ``name`` markers in the window, in time
    order."""
    full = MARK + name
    return sorted((s, e) for n, s, e in profile.device if n == full or n.startswith(full + "("))


def pairs(profile, name):
    """(start of ``<name>_begin``, end of the next ``<name>_end``) of each
    begin marker that has an end after it."""
    ends = markers(profile, f"{name}_end")
    starts = [s for s, _ in ends]
    out = []
    for s, _ in markers(profile, f"{name}_begin"):
        k = bisect.bisect_left(starts, s)
        if k < len(ends):
            out.append((s, ends[k][1]))
    return out


def spans(profile, name):
    """The program's outermost spans named ``name`` that lie inside the
    window, in time order; none from a program that logs no spans."""
    try:
        from moptimizer_0_tpu_torch.utils import tracing
    except ImportError:
        return []
    lo, hi = profile.bounds
    return sorted((s for s in tracing.spans() if s.name == name and s.parent is None
                   and lo <= s.start_ns and s.end_ns <= hi), key=lambda s: s.start_ns)


def unit_end(profile, t):
    """The end of the traced unit (``portbench.unit`` range) that holds time
    t, or t itself when none does."""
    return max([e for n, s, e in profile.host if n == trace.UNIT and s <= t < e], default=t)


class Busy:
    """The device's busy intervals in a window (the union of its events),
    for many interval queries."""

    def __init__(self, profile):
        self.intervals = trace._union([(s, e) for _, s, e in profile.device])
        self.starts = [s for s, _ in self.intervals]
        self.before = [0]  # busy ns before each interval
        for s, e in self.intervals:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t):
        k = bisect.bisect_right(self.starts, t)
        if k == 0:
            return 0
        s, e = self.intervals[k - 1]
        return self.before[k - 1] + min(e, t) - s

    def ns(self, lo, hi):
        """Busy ns of [lo, hi]."""
        return self._upto(hi) - self._upto(lo) if hi > lo else 0

    def idle_ns(self, lo, hi):
        """Idle ns of [lo, hi]."""
        return (hi - lo) - self.ns(lo, hi) if hi > lo else 0


def per_span(profile, name, at):
    """For each of the program's ``name`` spans in the window, at(span,
    next): next is the next such span's start (the window's end after the
    last)."""
    found = spans(profile, name)
    nexts = [s.start_ns for s in found[1:]] + [profile.bounds[1]]
    return [at(s, n) for s, n in zip(found, nexts)]


def first_at_or_after(marks, lo, hi):
    """The first marker that starts in [lo, hi), or None."""
    k = bisect.bisect_left(marks, (lo,))
    return marks[k] if k < len(marks) and marks[k][0] < hi else None


def last_before(marks, lo, hi):
    """The last marker that starts in [lo, hi), or None."""
    k = bisect.bisect_left(marks, (hi,))
    return marks[k - 1] if k > 0 and marks[k - 1][0] >= lo else None
