"""Segment reductions and gathers as one-hot matrix products.

PyTorch counterpart of ``moptimizer_0_tpu.ops.segmented``: a segmented sum
is a product with a one-hot matrix, which the JAX package runs on the TPU's
matrix units instead of row-granular scatters and gathers. These are plain
products outside any Pallas kernel there, so here they are ``torch.matmul``
in the inputs' dtype, with TF32 off for float32 as the package sets it at
import (the JAX package asks for ``Precision.HIGHEST``). No engine calls
them, as in the JAX package.

* ``segment_sum_onehot(values, ids, n)`` = one_hotᵀ @ values, for small
  segment spaces (ids need not be sorted);
* ``gather_onehot(table, ids)`` = one_hot @ table;
* ``segment_sum_sorted(values, ids, n, tile, span)`` for large sorted
  segment spaces: the rows in tiles of ``tile``, each tile reduced by a
  local (tile, span) one-hot, the (n_tiles · span) partials summed into
  their segments; ``required_span(ids, tile)`` gives the span that makes it
  exact.
"""

import numpy as np
import torch


def _one_hot(ids, n, dtype):
    """(len(ids), n): row o is 1 at column ids[o] (no column for an id
    outside [0, n))."""
    return (ids[:, None] == torch.arange(n, dtype=ids.dtype, device=ids.device)[None, :]).to(dtype)


def segment_sum_onehot(values, ids, n_segments):
    """Σ over rows by segment id through one (n_segments, O)·(O, D) product.
    For small n_segments (≲ 1024); ids need not be sorted."""
    flat = values.reshape(values.shape[0], -1)
    out = torch.matmul(_one_hot(ids, n_segments, flat.dtype).T, flat)
    return out.reshape((n_segments,) + tuple(values.shape[1:]))


def gather_onehot(table, ids):
    """table[ids] through one (O, C)·(C, D) product. For small first dims."""
    flat = table.reshape(table.shape[0], -1)
    out = torch.matmul(_one_hot(ids, table.shape[0], flat.dtype), flat)
    return out.reshape((ids.shape[0],) + tuple(table.shape[1:]))


def required_span(ids, tile=4096):
    """Smallest ``span`` for segment_sum_sorted on these sorted ids (on the
    host, once a problem build)."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    span = 1
    for start in range(0, len(ids), tile):
        seg = ids[start : start + tile]
        span = max(span, int(seg[-1]) - int(seg[0]) + 1)
    return span


def segment_sum_sorted(values, ids, n_segments, tile=4096, span=1024):
    """Segment sum for SORTED ids over a large segment space.

    Requires ids sorted ascending and, within any ``tile`` consecutive rows,
    spanning fewer than ``span`` distinct values (``required_span`` picks
    it). Rows whose offset from their tile's first id reaches ``span`` are
    dropped, as in the JAX package: the caller guarantees coverage.
    """
    O = values.shape[0]
    flat = values.reshape(O, -1)
    D = flat.shape[1]
    n_tiles = -(-O // tile)
    pad = n_tiles * tile - O
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad, D)])
        ids = torch.cat([ids, ids.new_full((pad,), n_segments + span)])
    ids_t = ids.reshape(n_tiles, tile)
    vals_t = flat.reshape(n_tiles, tile, D)
    base = ids_t[:, 0]
    local = ids_t - base[:, None]
    in_span = (local >= 0) & (local < span)
    cols = torch.arange(span, dtype=ids.dtype, device=ids.device)
    one_hot = ((local[:, :, None] == cols) & in_span[:, :, None]).to(flat.dtype)  # (n_tiles, tile, span)
    partials = torch.matmul(one_hot.transpose(1, 2), vals_t)  # (n_tiles, span, D)
    seg = torch.clamp(base[:, None] + cols[None, :], max=n_segments).reshape(-1)  # past the end: dropped
    out = flat.new_zeros(n_segments + 1, D).index_add_(0, seg, partials.reshape(-1, D))
    return out[:n_segments].reshape((n_segments,) + tuple(values.shape[1:]))
