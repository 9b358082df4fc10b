"""Leveled logger and LM trace formatting.

A copy of ``moptimizer_0_tpu.utils.logging`` (the reference's duna::Logger:
four levels, several sinks, a ``[LEVEL] moptimizer::<name>::`` prefix), with
``format_trace`` reading tensors: the solver returns its per-iteration trace
as tensors, rendered as the reference's "it | prev_cost | new_cost | rho |
lambda | nu" lines.
"""

import sys

import numpy as np
import torch

L_ERROR, L_WARN, L_INFO, L_DEBUG = 0, 1, 2, 3
_NAMES = {L_ERROR: "ERROR", L_WARN: "WARN", L_INFO: "INFO", L_DEBUG: "DEBUG"}


class Logger:
    def __init__(self, sink=sys.stderr, level=L_ERROR, name=""):
        self.sinks = [sink]
        self.level = level
        self.name = name

    def add_sink(self, sink):
        self.sinks.append(sink)

    def log(self, level, *msg):
        if level > self.level:
            return
        text = f"[{_NAMES[level]}] moptimizer::{self.name}:: " + " ".join(str(m) for m in msg)
        for sink in self.sinks:
            print(text, file=sink)


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def format_trace(result, max_rows=None):
    """Render an LMResult trace like the reference's debug lines."""
    tr = {
        k: _numpy(v)
        for k, v in result.trace.items()
        if not isinstance(v, dict)  # skip the nested per-inner-trial record
    }
    n = int(result.iterations) + 1
    n = min(n, len(tr["cost"]))
    if max_rows is not None:
        n = min(n, max_rows)
    has_blocks = "block_costs" in tr  # LMConfig.trace_block_costs
    header = "it | prev_cost | new_cost | rho | lambda | nu | accepted"
    lines = [header + (" | block_costs" if has_blocks else "")]
    for i in range(n):
        if not np.isfinite(tr["cost"][i]) and i > int(result.iterations):
            break
        line = (
            f"{i} | {tr['cost'][i]:.6e} | {tr['cost_new'][i]:.6e} | "
            f"{tr['rho'][i]:.4f} | {tr['lam'][i]:.3e} | {tr['nu'][i]:.1f} | "
            f"{bool(tr['accepted'][i])}"
        )
        if has_blocks:
            line += " | [" + ", ".join(f"{c:.6e}" for c in tr["block_costs"][i]) + "]"
        lines.append(line)
    return "\n".join(lines)
