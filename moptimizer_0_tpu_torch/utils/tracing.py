"""Spans on the host and markers on the device, for reading a profiled run.

* ``span(name)``: a context manager around a layer's host work. While a
  ``torch.profiler`` session records, it appends a ``Span`` (name, start
  and end in ns, the enclosing span's id, the outermost span's id, its own
  id) to an in-memory log of at most ``MAX_SPANS`` entries and opens the
  profiler range ``"moptimizer." + name``, so that an exported Chrome trace
  shows it. The range is a function-scope ``RecordFunction``
  (``_RecordFunctionFast``, a ``cpu_op`` in the trace): a user-scope
  ``record_function`` would also get a copy on the device's timeline,
  spanning the kernels launched inside it, which a reader of device
  events would count as device work. Times are ``time.time_ns()``: the
  Unix clock that the profiler stamps its host events with. With no
  session recording a span costs one flag check: no lock, no allocation.
* ``mark(name, like)``: the empty one-thread kernel
  ``moptimizer_mark_<name>`` (``csrc/graph_cond.cu``) on the current CUDA
  stream of ``like``'s card; nothing for a CPU tensor. Under a CUDA-graph
  capture it becomes a node of the graph, inside the IF body being captured,
  so a replay's device trace shows where each outer step, linearization,
  PCG solve and PCG iteration ran, on the device's clock. ``pcg_iteration``
  also adds one to a 0-dim int32 counter on the card when given one.
  Markers change no result and read nothing back.

The spans, the markers and the metrics that read them: PERF.md, §3.
"""

import collections
import itertools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from moptimizer_0_tpu_torch.kernels import graph_cond

PREFIX = "moptimizer."
# Spans the log keeps, the oldest dropped first.
MAX_SPANS = 16384

Span = collections.namedtuple("Span", "name start_ns end_ns parent root id")

_LOG = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a process whose profiler does not record: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span while the profiler records (module docstring)."""

    __slots__ = ("name", "id", "parent", "root", "range", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if not hasattr(_local, "stack"):
            _local.stack = []
        stack = _local.stack
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else self.id
        stack.append(self)
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()
        _LOG.append(Span(self.name, self.start, end, self.parent, self.root, self.id))
        return False


def span(name):
    """A span of the block named ``name`` (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def spans():
    """The logged spans, oldest first (a span is logged when it ends, so a
    child comes before its parent)."""
    return list(_LOG)


def clear():
    """Empty the log."""
    _LOG.clear()


def mark(name, like, count=None):
    """The marker kernel ``moptimizer_mark_<name>`` on the current stream of
    ``like``'s card (a marker of ``graph_cond.MARKS``); nothing when
    ``like`` is on the CPU. count: for ``pcg_iteration``, a 0-dim int32
    tensor on that card that the kernel adds one to."""
    if not like.is_cuda:
        return
    if like.device.index == torch.cuda.current_device():
        graph_cond.mark(name, torch.cuda.current_stream(), count)
        return
    with torch.cuda.device(like.device):
        graph_cond.mark(name, torch.cuda.current_stream(), count)
