"""K5 (``csrc/nn_search.cu``, one query set against one target set) and K6
(``csrc/nn_expand.cu``, B lanes each against its own targets): an exhaustive
nearest-neighbour search. Per (query, target) pair 8 float32 operations
(3 differences, 3 products summed, a compare and a select); each query and
target point read once (3 float32), each query's (index, d²) written once."""

from portbench.counts import bound_s

FLOPS_PER_PAIR = 8


def search(lanes, n_query, n_points):
    """(flops, bytes) of one search of ``lanes`` lanes."""
    flops = FLOPS_PER_PAIR * lanes * n_query * n_points
    bytes_moved = lanes * (12 * n_query + 12 * n_points + 8 * n_query)
    return flops, bytes_moved


def search_bound_s(lanes, n_query, n_points):
    return bound_s(*search(lanes, n_query, n_points))[0]
