"""ba.host_launches_per_solve: host calls that put work on the device
(graph launches, kernel launches, async copies and sets; trace.LAUNCH_CALLS)
in the traced window over its solves (layer: device loop,
ops/device_loop.py)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.units:
        return None
    return p.calls() / len(p.units)
