"""The traced window: one ``torch.profiler`` window (CPU and CUDA
activities) around a few units, read from the profiler's raw events.

One profiler window a process: several in one process have lost device
events and faulted on this port's graphs. The reader takes the window from
its ``portbench.window`` range; device time is the union of the device
events' intervals inside it (kernels, copies and sets, graph replays'
kernels included), so overlapping streams count once.
"""

import contextlib
import dataclasses

import torch

WINDOW = "portbench.window"
UNIT = "portbench.unit"
# Host calls that put work on the device.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    device: list  # (name, start_ns, end_ns) of each device event inside the window
    host: list  # (name, start_ns, end_ns) of each host event inside the window
    units: list  # the records of the profiled units
    bounds: tuple  # the window's (start, end) in the profiler's ns

    def device_s(self, *fragments):
        """Seconds of device events whose name holds any of ``fragments``."""
        return sum(e - s for n, s, e in self.device if any(f in n for f in fragments)) / 1e9

    def calls(self):
        """Host calls that put work on the device (LAUNCH_CALLS)."""
        return sum(n in LAUNCH_CALLS for n, _, _ in self.host)

    def breakdown(self, top=10):
        """{"device_ops": the device operations by total seconds,
        "idle_gaps": the longest gaps with no device work, each named by the
        innermost host event at its middle}."""
        by_name = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(_gaps(self.device, self.bounds), key=lambda g: -(g[1] - g[0]))[:top]
        return dict(
            device_ops=[[n[:160], t / 1e9] for n, t in ops],
            idle_gaps=[[self._doing((a + b) // 2), (b - a) / 1e9] for a, b in gaps],
        )

    def _doing(self, t):
        inner = [(e - s, n) for n, s, e in self.host if s <= t < e]
        return min(inner)[1][:160] if inner else "host outside any traced call"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(device, bounds):
    lo, hi = bounds
    busy = _union([(s, e) for _, s, e in device])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


@contextlib.contextmanager
def profiled(units):
    """Profile the block, which appends the profiled units' records to
    ``units``; yields a holder whose ``profile`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"profile": None})()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
            sync()
    holder.profile = read(prof, units)


def read(prof, units):
    """The Profile of a finished profiler whose window range was recorded."""
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == WINDOW and e.device_type() == torch.autograd.DeviceType.CPU]
    units_ns = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                if e.name() == UNIT and e.device_type() == torch.autograd.DeviceType.CPU]
    lo = windows[0].start_ns()
    hi = lo + windows[0].duration_ns()
    device, host = [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if end <= lo or s >= hi or e.is_user_annotation() or e.name().startswith("portbench."):
            continue  # outside the window, or a range's copy on the device timeline
        row = (e.name(), max(s, lo), min(end, hi))
        (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(row)
    host += [(UNIT, s, e) for s, e in units_ns]
    busy = sum(e - s for s, e in _union([(s, e) for _, s, e in device])) / 1e9
    return Profile(window_s=(hi - lo) / 1e9, busy_s=busy, device=device, host=host, units=units, bounds=(lo, hi))
