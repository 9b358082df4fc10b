"""Frozen operation and byte counts of the port's kernels, and the roofline
arithmetic against an NVIDIA H100 SXM's published peaks (NVIDIA's data
sheet, at its 700 W limit): 67 TFLOP/s float32 outside the tensor cores and
3.35 TB/s of HBM3. Work is counted from shapes, never from launches: each
input read once and each output written once, whatever a kernel reads
again."""

H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12


def bound_s(flops, bytes_moved):
    """The least time the card could take: (seconds, "compute" | "memory")."""
    t_c, t_m = flops / H100_F32_FLOPS, bytes_moved / H100_HBM_BYTES
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")


def roofline_pct(bound_seconds, measured_seconds):
    """The share of its roofline a kernel reached, in %; None without time."""
    if not measured_seconds or measured_seconds <= 0:
        return None
    return 100.0 * bound_seconds / measured_seconds
