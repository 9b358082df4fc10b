"""ba_solve_s: time to a solution, the window's elapsed time to the end of
its last solve over the solves completed. Host clock, each solve ended by a
synchronisation."""


def read(ctx):
    return ctx.units[-1]["t_end"] / len(ctx.units)
