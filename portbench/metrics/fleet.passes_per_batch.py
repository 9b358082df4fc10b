"""fleet.passes_per_batch: outer passes of the batched LM loop a fleet ran
(finite passes of LMResult.trace), averaged over the window's fleets
(layer: LM loop, batched, core/solver.py)."""


def read(ctx):
    return sum(u["passes"] for u in ctx.units) / len(ctx.units)
