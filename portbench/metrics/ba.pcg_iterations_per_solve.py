"""ba.pcg_iterations_per_solve: PCG iterations a BA solve runs: the
``pcg_iteration`` markers that the device ran in the traced window over its
solves (layer: CG engine, ops/pcg.py; the program's markers,
program_trace.py)."""

from portbench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None or not p.units:
        return None
    n = len(program_trace.markers(p, "pcg_iteration"))
    return n / len(p.units) if n else None
