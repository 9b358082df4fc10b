"""icp.device_idle_pct: the share of a request's latency in which no device
operation runs, in % (layer: device): 1 − (device busy time of the traced
requests, the union of their device events, over their count) / (the
window's mean request latency, host clock, untraced). The traced window
itself is no base here: CUPTI stretches each traced request several times
over, with its buffer requests, while the device work stays as it is."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.units or p.busy_s <= 0:
        return None
    mean_latency = sum(u["latency_s"] for u in ctx.units) / len(ctx.units)
    return 100.0 * (1.0 - p.busy_s / len(p.units) / mean_latency)
