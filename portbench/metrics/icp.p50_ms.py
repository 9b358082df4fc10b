"""icp.p50_ms: the median request latency of the window, beside the tail
(layer: entry, registration.icp). Host clock."""

from portbench.metrics_common import quantile


def read(ctx):
    return 1e3 * quantile([u["latency_s"] for u in ctx.units], 0.5)
