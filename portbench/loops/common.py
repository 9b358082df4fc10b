"""What the loops share: freeing the program's state before a reference
runs, and drawing the units a check compares."""

import gc

import torch


def free_program():
    """Drop the port's cached layouts (CUDA graphs, buffers) and return
    their memory, so that a reference runs on an emptied card."""
    from moptimizer_0_tpu_torch import registration
    from moptimizer_0_tpu_torch.ops import device_loop

    device_loop.clear()
    registration._MATCHERS.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(n_items, k, rng):
    """k distinct indices of range(n_items) drawn by rng (all when k ≥ n)."""
    if k >= n_items:
        return list(range(n_items))
    return sorted(int(i) for i in rng.choice(n_items, size=k, replace=False))
