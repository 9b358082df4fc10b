"""Order statistics with the JAX package's (``jnp``) semantics."""

import torch


def median(a, dim=0):
    """``jnp.median(a, axis=dim)``: the two middle values of an even count
    averaged (``torch.median`` returns the lower one), and NaN for a slice
    that holds a NaN (``torch.sort`` puts NaN last, which would skip it)."""
    s = torch.sort(a, dim=dim).values
    n = s.shape[dim]
    mid = (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5
    return torch.where(torch.isnan(a).any(dim=dim), torch.nan, mid)
