"""The share of the traced window in which no device operation ran, in %
(layer: device)."""

from portbench.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx.profile)
