"""ba.device_ms_per_solve: the traced window's device busy time (the union
of its device events) over the solves in it (layer: CG engine, ba.py and
ops/pcg.py)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.units or p.busy_s <= 0:
        return None
    return 1e3 * p.busy_s / len(p.units)
