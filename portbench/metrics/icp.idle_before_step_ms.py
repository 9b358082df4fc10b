"""icp.idle_before_step_ms: the median over the traced requests of the
device's idle time from the start of the program's ``icp`` span to the
request's first ``step_begin`` marker, in ms: the inputs, the centroid
seed, the layout lookups and the loop's start, as far as the device waits
for them (layer: entry, registration.icp; program_trace.py). The median
keeps one of CUPTI's buffer stalls from moving it."""

import statistics

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    steps = program_trace.markers(p, "step_begin")
    busy = program_trace.Busy(p)

    def idle(request, nxt):
        first = program_trace.first_at_or_after(steps, request.start_ns, nxt)
        return None if first is None else busy.idle_ns(request.start_ns, first[0])

    gaps = [g for g in program_trace.per_span(p, "icp", idle) if g is not None]
    return statistics.median(gaps) / 1e6 if gaps else None
