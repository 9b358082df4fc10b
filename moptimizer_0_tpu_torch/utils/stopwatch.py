"""Timing with device synchronisation.

PyTorch counterpart of ``moptimizer_0_tpu.utils.stopwatch``: the reference's
tick()/tock() Stopwatch, and ``time_fn`` in place of ``time_jitted``, which
waits for the card (``torch.cuda.synchronize``) when the call returns CUDA
tensors, since a CUDA call returns before the device is done.
"""

import time

import torch


class Stopwatch:
    """tick()/tock() wall-clock timer (the reference's Stopwatch API)."""

    def __init__(self):
        self._start = None

    def tick(self):
        self._start = time.perf_counter()

    def tock(self):
        if self._start is None:
            raise RuntimeError("tock() before tick()")
        return time.perf_counter() - self._start


def cuda_devices(out):
    """The CUDA devices of the tensors in a nest of dicts, tuples, lists and
    dataclass fields."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "__dataclass_fields__"):
        out = [getattr(out, f) for f in out.__dataclass_fields__]
    if isinstance(out, (tuple, list)):
        return set().union(*(cuda_devices(v) for v in out)) if out else set()
    return set()


def _wait(out):
    for dev in cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn, *args, iters=10, warmup=2):
    """Median wall time of fn(*args), after ``warmup`` calls; each timed
    call ends when the card has finished it."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
