"""ba.trials_per_solve: damped solves a BA solve ran, Σ of its
BAResult.trace["trials"] over the outer iterations, averaged over the
window's solves (layer: LM loop, ba._lm_trials_tree)."""


def read(ctx):
    return sum(u["trials"] for u in ctx.units) / len(ctx.units)
