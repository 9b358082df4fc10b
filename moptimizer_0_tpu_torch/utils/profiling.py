"""Profiling helpers: a ``torch.profiler`` trace context, a timing harness
and roofline arithmetic.

PyTorch counterpart of ``moptimizer_0_tpu.utils.profiling``. The default
peaks are the published ones of an NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet): 67 TFLOP/s float32 outside the tensor cores and
3.35 TB/s of HBM3. A card set below 700 W runs below them.
"""

import contextlib
import os
import tempfile
import time

import torch

from moptimizer_0_tpu_torch.utils.stopwatch import _wait, cuda_devices

H100_SXM_PEAK_F32_FLOPS = 67e12
H100_SXM_PEAK_HBM_BYTES = 3.35e12


def roofline(seconds, *, flops=0.0, bytes_accessed=0.0, peak_flops=H100_SXM_PEAK_F32_FLOPS,
             peak_bw=H100_SXM_PEAK_HBM_BYTES):
    """Fraction of speed-of-light achieved by a measured kernel.

    Returns achieved GFLOP/s and GB/s, the fraction of each peak, the bound
    ("compute" or "memory": whichever peak predicts the longer time) and
    ``frac_of_light``, the roofline time max(flops/peak_flops,
    bytes/peak_bw) over the measured time (1.0: as fast as the card can).
    """
    t_compute = flops / peak_flops if flops else 0.0
    t_memory = bytes_accessed / peak_bw if bytes_accessed else 0.0
    t_light = max(t_compute, t_memory)
    out = dict(
        seconds=seconds,
        gflops_per_sec=flops / seconds / 1e9 if flops else 0.0,
        gbytes_per_sec=bytes_accessed / seconds / 1e9 if bytes_accessed else 0.0,
        bound="compute" if t_compute >= t_memory else "memory",
        frac_of_light=(t_light / seconds) if t_light else 0.0,
    )
    if flops:
        out["frac_of_peak_flops"] = flops / seconds / peak_flops
    if bytes_accessed:
        out["frac_of_peak_bw"] = bytes_accessed / seconds / peak_bw
    return out


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write a Chrome trace under ``log_dir`` (by default
    ``moptimizer_trace`` in the temporary directory). Yields the profiler:
    its ``key_averages()`` sums time by operator and kernel."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "moptimizer_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark(fn, *args, iters=20, warmup=2, flops=None, bytes_accessed=None):
    """Median time of fn(*args) after ``warmup`` calls (at least one).

    A call that returns CUDA tensors is timed by CUDA events around each
    call on the current stream (``clock="cuda_events"``); any other by the
    host clock (``clock="host"``). Returns seconds, iters_per_sec, the clock
    and, with the caller's cost models, achieved GFLOP/s and GB/s."""
    for _ in range(max(warmup, 1)):
        out = _wait(fn(*args))
    devices = cuda_devices(out)
    times = []
    for _ in range(iters):
        if devices:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    out = dict(seconds=dt, iters_per_sec=1.0 / dt, clock="cuda_events" if devices else "host")
    if flops is not None:
        out["gflops_per_sec"] = flops / dt / 1e9
    if bytes_accessed is not None:
        out["gbytes_per_sec"] = bytes_accessed / dt / 1e9
    return out
