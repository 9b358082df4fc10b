"""icp_p95_ms: the 95th percentile of every request's latency in the window
(a closed loop, one client), from the call to its x on the host. Host
clock; linear interpolation between order statistics."""

from portbench.metrics_common import quantile


def read(ctx):
    return 1e3 * quantile([u["latency_s"] for u in ctx.units], 0.95)
