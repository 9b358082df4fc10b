"""icp.k5_roofline: K5's share of its roofline in the traced requests, in
%: the frozen bound of one search (counts/nn.py: 8 flops a pair at 67
TFLOP/s) times the searches the requests made (one an outer iteration, from
LMResult.trace), over the device time of the search's kernels (KERNELS:
the brute-force kernel and the merge of its target splits)."""

from portbench.counts import roofline_pct
from portbench.counts.nn import search_bound_s

KERNELS = ("nn_bruteforce_kernel", "nn_bruteforce_merge_kernel")


def read(ctx):
    p = ctx.profile
    if p is None or not p.units:
        return None
    n = ctx.config["points"]
    return roofline_pct(search_bound_s(1, n, n) * sum(u["searches"] for u in p.units), p.device_s(*KERNELS))
