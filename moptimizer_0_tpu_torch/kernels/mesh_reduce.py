"""Binding of ``csrc/mesh_reduce.cu``: the device all-reduce of a mesh whose
processes share one host, through CUDA IPC buffers.

``IpcBuffers`` is one process's side of a mesh's transport
(``parallel.multihost.global_mesh`` makes it for a ``"device"`` mesh on
CUDA): its buffer, every peer's buffer mapped into this process, and
``all_reduce``, which launches the kernel on the current stream and reads
nothing back, so a CUDA graph can capture it (inside IF nodes too). It
takes CUDA tensors only and raises on anything else; the plain version it
must equal bit for bit is ``parallel.mesh._all_reduce_plain``.

The buffer is sized from the reductions that run eagerly: one larger than
its slots makes every process allocate a larger buffer and exchange the
handles again over the gloo group, which every process reaches at the same
reduction because they run in lockstep. Under capture that raises. Every
buffer made stays mapped until ``close()``, since a cached graph may point
into any of them. A peer that does not arrive within ``timeout_s`` sets the
buffer's error word; ``check()`` reads it and raises, naming the epoch.
"""

import ctypes
import functools

import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter

NAME = "mesh_reduce"
SOURCES = ("mesh_reduce.cu",)

# Processes a device transport spans at most (MR_MAX_PROCS in the source).
MAX_PROCESSES = 8
# The dtypes the engines' mesh reductions carry.
DTYPES = {torch.float32: 0, torch.float64: 1}
OPS = ("sum", "max")
# A peer that has not arrived after this long is an error, not a wait.
TIMEOUT_S = 60.0
# Slot bytes of a new transport; a larger reduction grows it (eagerly).
INITIAL_SLOT_BYTES = 1 << 20

# Kernel launches since import, or since ``reset_launches()``: LAUNCHES
# counts the launches made eagerly, ``replayed()`` those that CUDA-graph
# replays made (``kernels.launches``), ``launches()`` both.
LAUNCHES = 0
_REPLAYED = ReplayCounter("mesh_reduce")


def replayed():
    return _REPLAYED.total()


def launches():
    return LAUNCHES + replayed()


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    _REPLAYED.reset()


def _count(device):
    global LAUNCHES
    if not _REPLAYED.captured(device):
        LAUNCHES += 1


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i, u64, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_longlong
    sig = {
        "mr_header_bytes": [], "mr_handle_bytes": [], "mr_max_processes": [],
        "mr_alloc": [i, u64, ctypes.POINTER(p), p],
        "mr_open": [i, p, ctypes.POINTER(p)],
        "mr_close": [p], "mr_free": [p],
        "mr_reduce": [p, p, ll, i, i, ctypes.POINTER(u64), i, i, u64, u64, p],
        "mr_error": [p, ctypes.POINTER(u64), p],
        "mr_pingpong": [p, p, i, ll, ll, u64, p],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    if lib.mr_max_processes() != MAX_PROCESSES:
        raise RuntimeError(f"mesh_reduce.cu takes {lib.mr_max_processes()} processes, the binding {MAX_PROCESSES}")
    return lib


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


class _Generation:
    """One buffer of every process: this process's own pointer and every
    rank's as mapped here, and its slot bytes."""

    def __init__(self, own, bases, cap):
        self.own, self.bases, self.cap = own, bases, cap
        self.array = (ctypes.c_ulonglong * len(bases))(*bases)


class IpcBuffers:
    """One process's side of a device transport over ``group`` (``size``
    processes, this one ``rank``), its buffer on ``device``. Collective:
    every process of the group makes it at the same point."""

    def __init__(self, group, rank, size, device, timeout_s=TIMEOUT_S):
        if not 1 < size <= MAX_PROCESSES:
            raise ValueError(f"a device transport spans 2..{MAX_PROCESSES} processes, not {size}")
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self.timeout_s = float(timeout_s)
        self.generations = []
        self._pings = 0
        self._grow(INITIAL_SLOT_BYTES)

    @property
    def slot_bytes(self):
        return self.generations[-1].cap

    def _grow(self, cap):
        """A new buffer with slots of at least ``cap`` bytes in every process,
        the handles exchanged over the group."""
        lib = _library()
        cap = -(-int(cap) // 4096) * 4096
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(lib.mr_handle_bytes())
        with torch.cuda.device(self.device):
            _ok(lib.mr_alloc(self.device.index, lib.mr_header_bytes() + 2 * cap, ctypes.byref(own), handle),
                "mr_alloc")
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw, group=self.group)
        bases = []
        for r, h in enumerate(handles):
            if r == self.rank:
                bases.append(own.value)
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                _ok(lib.mr_open(self.device.index, h, ctypes.byref(ptr)), f"mr_open of rank {r}'s buffer")
            bases.append(ptr.value)
        self.generations.append(_Generation(own.value, bases, cap))

    def all_reduce(self, flat, op):
        """Σ (op "sum") or max (op "max") of ``flat`` over the processes, in
        rank order, as a new tensor; one kernel launch on the current stream.
        ``flat``: a contiguous 1-D CUDA tensor on the transport's device, of
        a dtype in DTYPES."""
        if not flat.is_cuda or flat.device != self.device:
            raise ValueError(f"mesh_reduce: the tensor is on {flat.device}, the transport on {self.device}")
        if flat.dtype not in DTYPES:
            raise TypeError(f"mesh_reduce: {flat.dtype} is not one of {list(DTYPES)}")
        if flat.ndim != 1 or not flat.is_contiguous():
            raise ValueError("mesh_reduce: the tensor must be 1-D and contiguous")
        if op not in OPS:
            raise ValueError(f"mesh_reduce: op must be one of {OPS}, got {op!r}")
        n_bytes = flat.numel() * flat.element_size()
        if n_bytes > self.slot_bytes:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"mesh_reduce: a {n_bytes}-byte reduction under capture exceeds the {self.slot_bytes}-byte "
                    "slots; the eager warm-up sizes them"
                )
            self._grow(max(n_bytes, 2 * self.slot_bytes))
        gen = self.generations[-1]
        out = torch.empty_like(flat)
        with torch.cuda.device(self.device):
            err = _library().mr_reduce(
                flat.data_ptr(), out.data_ptr(), flat.numel(), DTYPES[flat.dtype], OPS.index(op), gen.array,
                self.size, self.rank, gen.cap, int(self.timeout_s * 1e9), torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"mr_reduce launch failed with code {err}")
        _count(self.device)
        return out

    def check(self):
        """Raise if a reduction of any of the transport's buffers timed out
        waiting for a peer (one read of the device a buffer, after the
        current stream's work)."""
        lib = _library()
        for g in self.generations:
            word = ctypes.c_ulonglong()
            with torch.cuda.device(self.device):
                _ok(lib.mr_error(g.own, ctypes.byref(word), torch.cuda.current_stream().cuda_stream), "mr_error")
            if word.value:
                raise RuntimeError(
                    f"mesh all-reduce: rank {self.rank} waited more than {self.timeout_s:g} s for a peer at epoch "
                    f"{word.value} (a process skipped a reduction, failed or stopped)"
                )

    def pingpong(self, iters, peer=None):
        """``iters`` flag round trips between rank 0 and ``peer`` (rank 1) in
        one launch on the current stream: the barrier's latency, for
        ``chip_profile.py --path mesh_barrier``. Both ranks call it."""
        peer = 1 - self.rank if peer is None else peer
        gen = self.generations[-1]
        with torch.cuda.device(self.device):
            _ok(_library().mr_pingpong(gen.own, gen.bases[peer], self.rank, self._pings, iters,
                                       int(self.timeout_s * 1e9), torch.cuda.current_stream().cuda_stream),
                "mr_pingpong")
        self._pings += iters

    def close(self):
        """Unmap every peer's buffers and free this process's. Collective:
        every process's work is finished before any buffer goes."""
        if not self.generations:
            return
        lib = _library()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for g in self.generations:
                for r, base in enumerate(g.bases):
                    if r != self.rank:
                        _ok(lib.mr_close(base), "mr_close")
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for g in self.generations:
                _ok(lib.mr_free(g.own), "mr_free")
        self.generations = []
