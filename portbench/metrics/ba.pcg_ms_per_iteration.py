"""ba.pcg_ms_per_iteration: device busy time inside the PCG solves (from
each ``ba_pcg_begin`` marker to the next ``ba_pcg_end``) over the
``pcg_iteration`` markers, in ms (layer: CG engine, ba._solve_delta and
ops/pcg.py; the program's markers, program_trace.py)."""

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    solves = program_trace.pairs(p, "ba_pcg")
    n = len(program_trace.markers(p, "pcg_iteration"))
    if not solves or not n:
        return None
    busy = program_trace.Busy(p)
    return sum(busy.ns(a, b) for a, b in solves) / 1e6 / n
