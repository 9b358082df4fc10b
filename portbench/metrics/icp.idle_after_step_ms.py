"""icp.idle_after_step_ms: the median over the traced requests of the
device's idle time from the request's last ``step_end`` marker to the end
of the request, in ms: the replays left after the last step, the result
and its copy to the host, as far as the device waits for them (layer:
device loop, ops/device_loop.py; program_trace.py). ``icp()`` returns
before its device work ends, so the request ends at the later of its
``icp`` span's end and its traced unit's (the loop's copy of x to the host
included). The median keeps one of CUPTI's buffer stalls from moving it."""

import statistics

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ends = program_trace.markers(p, "step_end")
    busy = program_trace.Busy(p)

    def idle(request, nxt):
        last = program_trace.last_before(ends, request.start_ns, nxt)
        if last is None:
            return None
        return busy.idle_ns(last[1], max(request.end_ns, program_trace.unit_end(p, request.start_ns)))

    gaps = [g for g in program_trace.per_span(p, "icp", idle) if g is not None]
    return statistics.median(gaps) / 1e6 if gaps else None
