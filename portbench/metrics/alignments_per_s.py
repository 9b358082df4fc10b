"""alignments_per_s: lanes aligned over the whole window, to the end of its
last fleet. Host clock, each fleet ended by a synchronisation."""


def read(ctx):
    return sum(u["lanes"] for u in ctx.units) / ctx.units[-1]["t_end"]
