"""fleet.k6_roofline: K6's share of its roofline in the traced fleets, in
%: the frozen bound of one lane's search (counts/nn.py: 8 flops a pair at
67 TFLOP/s) times the lane searches the fleets needed (each running lane
in each pass, from LMResult.trace), over the device time of the search's
kernels (KERNELS: the expansion kernel and the merge of its target
splits)."""

from portbench.counts import roofline_pct
from portbench.counts.nn import search_bound_s

KERNELS = ("nn_expand_kernel", "merge_splits_kernel")


def read(ctx):
    p = ctx.profile
    if p is None or not p.units:
        return None
    n = ctx.config["points"]
    return roofline_pct(search_bound_s(1, n, n) * sum(u["lane_passes"] for u in p.units), p.device_s(*KERNELS))
