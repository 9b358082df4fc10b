"""ba.idle_before_step_ms: the mean over the traced solves of the device's
idle time from the start of the program's ``solve_ba`` span to the solve's
first ``step_begin`` marker, in ms: the layout lookup, the carry's start and
the first replay's launch, as far as the device waits for them (layer:
device loop, ops/device_loop.py; program_trace.py)."""

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    steps = program_trace.markers(p, "step_begin")
    busy = program_trace.Busy(p)

    def idle(solve, nxt):
        first = program_trace.first_at_or_after(steps, solve.start_ns, nxt)
        return None if first is None else busy.idle_ns(solve.start_ns, first[0])

    gaps = [g for g in program_trace.per_span(p, "solve_ba", idle) if g is not None]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
