"""The device transport (``csrc/mesh_reduce.cu``): an all-reduce of n bytes
among P processes reads each process's n bytes once and writes the result
once in each: (P + 1)·n bytes at one card's HBM bandwidth."""

from portbench.counts import H100_HBM_BYTES


def all_reduce_bound_s(n_bytes, processes):
    return (processes + 1) * n_bytes / H100_HBM_BYTES
