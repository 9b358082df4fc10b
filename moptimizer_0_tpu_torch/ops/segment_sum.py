"""Segment sums in one fixed order, with no atomics.

``index_add_`` and ``scatter_add`` on CUDA sum with float atomics, so the
order of a sum, and with it the bits of the result, changes from run to run.
Here the items of each segment are gathered through a plan made once per
layout and summed in chunks of ``CHUNK``, level by level, so a sum is
bitwise repeatable on the card and a level's gather follows the item count,
however many items the busiest segment holds. Dense BA sums each camera's
slots this way (U, g and the rhs), and the pose graph each pose's edge
blocks.
"""

import torch

# Items one chunk sums: a level's gather holds at most n + S·CHUNK items for
# n items and S segments, whatever one segment's count.
CHUNK = 32


def segment_plan(keys, mask, n_segments):
    """The plan of items with segment ids ``keys`` (any shape) for
    ``n_segments`` segments; an item counts where ``mask`` > 0.
    Returns (levels, n_segments), each level an (idx, real) pair of
    (n_chunks, w) tensors.

    Level 0 gathers each segment's real items (flat item indices, in item
    order: a stable sort) in chunks of w ≤ CHUNK; each later level gathers
    the chunk sums of the level before, segment by segment, until every
    segment has one chunk. The last level has n_segments rows in segment
    order (a segment with no item gets one chunk of padding). Two host reads
    a level, and max(1, ⌈log₃₂ n_max⌉) levels for n_max the busiest
    segment's items."""
    real = mask.reshape(-1) > 0
    C = n_segments
    if C == 0 or real.numel() == 0:
        return [], C
    key = torch.where(real, keys.reshape(-1).long(), C)  # padding sorts last
    items = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=C + 1)[:C]
    levels = []
    while True:
        n_max = int(counts.max())
        w = max(1, min(CHUNK, n_max))
        chunks = torch.clamp((counts + w - 1) // w, min=1)
        ends = torch.cumsum(chunks, 0)
        n_chunks = int(ends[-1])
        seg = torch.repeat_interleave(torch.arange(C, device=key.device), chunks, output_size=n_chunks)
        rank = torch.arange(n_chunks, device=key.device) - (ends - chunks)[seg]  # chunk within its segment
        pos = rank[:, None] * w + torch.arange(w, device=key.device)  # item within its segment
        first = (torch.cumsum(counts, 0) - counts)[seg, None]
        levels.append((items[(first + pos).clamp(max=items.numel() - 1)], pos < counts[seg, None]))
        if n_max <= w:
            return levels, C
        items, counts = torch.arange(n_chunks, device=key.device), chunks


def segment_sum(plan, vals):
    """Σ over each segment's real items of vals (n_items, q) → (S, q): each
    level of the plan a gather into (q, n_chunks, w) and a sum along its
    last, contiguous axis, in one fixed order."""
    levels, C = plan
    if not levels:
        return vals.new_zeros(C, vals.shape[1])
    x = vals.T
    for idx, real in levels:
        x = torch.sum(torch.where(real, x[:, idx], 0.0), dim=-1)
    return x.T
