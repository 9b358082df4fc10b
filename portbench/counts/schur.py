"""K11 (``csrc/schur.cu``): the Schur complement's camera-pair blocks from
the per-slot G buffer. Per real slot pair (cam_k ≤ cam_k′ within a
landmark) 36 products of 2·3 float32 operations; each real slot's G (6×3
float32), camera id (int32) and mask (one byte) read once, and S
(6C × 6C float32) written once. Padding that a plan lays out is the
kernel's cost, not the inputs' need, so it is not counted."""

from portbench.counts import bound_s


def schur_build(slot_pairs, slots, cameras):
    flops = 2 * 3 * 36 * slot_pairs
    bytes_moved = (18 * 4 + 4 + 1) * slots + (6 * cameras) ** 2 * 4
    return flops, bytes_moved


def schur_bound_s(slot_pairs, slots, cameras):
    return bound_s(*schur_build(slot_pairs, slots, cameras))[0]
