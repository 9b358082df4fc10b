"""ba.linearize_ms_per_step: device busy time inside the linearizations
(from each ``ba_linearize_begin`` marker to the next ``ba_linearize_end``:
residuals, Jacobians, the Gauss-Newton blocks, the cost and λ's seed) over
the outer steps run (``step_begin`` markers), in ms (layer: CG engine,
ba._outer_step; the program's markers, program_trace.py)."""

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    linearizations = program_trace.pairs(p, "ba_linearize")
    n = len(program_trace.markers(p, "step_begin"))
    if not linearizations or not n:
        return None
    busy = program_trace.Busy(p)
    return sum(busy.ns(a, b) for a, b in linearizations) / 1e6 / n
