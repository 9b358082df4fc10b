"""The NCCL transport: the all-reduce of a mesh's processes whose cards the
device transport (``kernels/mesh_reduce.py``) cannot join: processes on
other hosts, cards without peer access both ways, or cards one process
cannot see (the usual launch, ``CUDA_VISIBLE_DEVICES`` a rank).

NCCL is a collective library, not a port of a TPU kernel: it stands where
the JAX package's psum across hosts rides XLA's own collectives (ICI/DCN).
``libnccl.so.2``, the one PyTorch's CUDA build brings, is bound through
ctypes and loaded when a transport is made, never at import.

One communicator a card index: process r's card c is rank r of
communicator c, so every process must hold as many cards. A reduction is
an all-gather of every process's partial, enqueued on the current stream
(a CUDA graph records it like a kernel), then the combine in rank order on
each card, (((p0 ∘ p1) ∘ p2) ...): the bits of the device transport and of
``parallel.mesh._all_reduce_plain``, the plain version. NCCL's own
all-reduce sums in its ring's order, which is not rank order, so it is not
used.

Inside IF nodes: with NCCL's graph mixing support on (its default,
``NCCL_GRAPH_MIXING_SUPPORT=1``), a graph whose IF body holds the
all-gather fails to instantiate (invalid argument; NCCL 2.28.9, CUDA 12.8,
on an H100), and so does one whose body holds torch.distributed's NCCL
all-gather; with it off the all-gather records inside IF bodies and
replays there. A transport turns it off for its process where the
environment does not set it, before NCCL reads it, and keeps whether it is
off (``in_if_bodies``): where the environment keeps it on, the mesh's
``captures_on`` says no, before any capture, and the solves run their
eager body over NCCL (still on the device). With it off, no NCCL call of
the process may be in flight in a graph and outside one at once; the
port's are ordered on each card's stream.

A bound on every reduction, as the device transport's bounded spin gives:
each card keeps two device counters, reductions begun and finished, bumped
on the stream around each one (replays bump them too), and a watchdog
thread reads them on a stream of its own. A reduction begun and not
finished for ``timeout_s`` (a peer that never arrives), or an error NCCL
reports (``ncclCommGetAsyncError``), aborts every communicator of the
transport (``ncclCommAbort``, which ends the kernels waiting on a peer) and
is kept; ``check()`` waits for the cards' work (bounded the same way) and
raises, naming the epoch: the count of reductions begun on that card.
"""

import ctypes
import functools
import glob
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter

NAME = "nccl_transport"
# ncclDataType_t of the dtypes the engines' mesh reductions carry
DTYPES = {torch.float32: 7, torch.float64: 8}
OPS = ("sum", "max")
COMBINE = {"sum": torch.add, "max": torch.maximum}
# A reduction begun and unfinished this long is an error, not a wait.
TIMEOUT_S = 60.0
_SUCCESS, _IN_PROGRESS = 0, 7
# CU_STREAM_CAPTURE_MODE_RELAXED: the watchdog's reads may run while the
# host captures a graph
_RELAXED = 2

# Launches since import, or since ``reset_launches()``: LAUNCHES counts the
# all-gathers enqueued eagerly, ``replayed()`` those that CUDA-graph replays
# made (``kernels.launches``), ``launches()`` both.
LAUNCHES = 0
_REPLAYED = ReplayCounter(NAME)


def replayed():
    return _REPLAYED.total()


def launches():
    return LAUNCHES + replayed()


def replayed_by_card():
    return _REPLAYED.by_device()


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    _REPLAYED.reset()


class _UniqueId(ctypes.Structure):
    _fields_ = [("internal", ctypes.c_ubyte * 128)]


def _candidates():
    """libnccl.so.2 as the loader finds it (PyTorch's CUDA build has loaded
    it already), then the copies of the nvidia-nccl wheels on sys.path."""
    yield "libnccl.so.2"
    for base in sys.path:
        yield from sorted(glob.glob(os.path.join(base, "nvidia", "nccl", "lib", "libnccl.so*")))


@functools.lru_cache(maxsize=None)
def library():
    """NCCL through ctypes, loaded at the first call; raises where there is
    none (a CUDA build without it)."""
    tried = []
    for name in _candidates():
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            tried.append(f"{name}: {e}")
    else:
        raise RuntimeError("the NCCL transport needs libnccl.so.2, found none:\n" + "\n".join(tried))
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = {
        "ncclGetVersion": [ctypes.POINTER(i)],
        "ncclGetUniqueId": [ctypes.POINTER(_UniqueId)],
        "ncclCommInitRank": [ctypes.POINTER(p), i, _UniqueId, i],
        "ncclAllGather": [p, p, ctypes.c_size_t, i, p, p],
        "ncclCommGetAsyncError": [p, ctypes.POINTER(i)],
        "ncclCommAbort": [p],
    }
    for fn_name, args in sig.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = args, i
    lib.ncclGetErrorString.argtypes, lib.ncclGetErrorString.restype = [i], ctypes.c_char_p
    return lib


def version():
    """NCCL's version code (e.g. 22105 for 2.21.5)."""
    v = ctypes.c_int()
    _ok(library().ncclGetVersion(ctypes.byref(v)), "ncclGetVersion")
    return v.value


def _ok(err, what):
    if err not in (_SUCCESS, _IN_PROGRESS):
        raise RuntimeError(f"{what} failed: NCCL error {err} ({library().ncclGetErrorString(err).decode()})")


def _relax_capture_mode():
    """Let this thread's CUDA calls run while another thread captures a
    graph (libcuda's per-thread capture mode)."""
    mode = ctypes.c_int(_RELAXED)
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuThreadExchangeStreamCaptureMode.argtypes = [ctypes.POINTER(ctypes.c_int)]
    cuda.cuThreadExchangeStreamCaptureMode.restype = ctypes.c_int
    err = cuda.cuThreadExchangeStreamCaptureMode(ctypes.byref(mode))
    if err != 0:
        raise RuntimeError(f"cuThreadExchangeStreamCaptureMode failed with CUDA error {err}")


class NcclTransport:
    """One process's side of the NCCL transport over ``group`` (``size``
    processes, this one ``rank``): a communicator for each of ``cards``
    (torch.devices, card c in communicator c), made collectively (every
    process of the group at the same point, outside any capture), and the
    watchdog of the module docstring. ``all_reduce(flat, op, card)``
    reduces one partial a process on that card, in rank order."""

    def __init__(self, group, rank, size, cards, timeout_s=TIMEOUT_S):
        if size < 2:
            raise ValueError(f"an NCCL transport spans 2 processes or more, not {size}")
        self.cards = tuple(torch.device(c) for c in cards)
        if not self.cards or any(c.type != "cuda" for c in self.cards):
            raise ValueError(f"an NCCL transport spans CUDA cards, not {self.cards}")
        self.group, self.rank, self.size = group, rank, size
        self.timeout_s = float(timeout_s)
        self.error = None  # (card, epoch, reason) of the first failure
        # every connection made at the communicators' creation, none at a
        # first use inside a capture; graph mixing off (module docstring)
        os.environ.setdefault("NCCL_RUNTIME_CONNECT", "0")
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
        self.in_if_bodies = os.environ["NCCL_GRAPH_MIXING_SUPPORT"] == "0"
        lib = library()
        ids = [None]
        if rank == 0:
            ids[0] = []
            for _ in self.cards:
                uid = _UniqueId()
                _ok(lib.ncclGetUniqueId(ctypes.byref(uid)), "ncclGetUniqueId")
                ids[0].append(bytes(uid))
        dist.broadcast_object_list(ids, src=0, group=group)
        self.comms = []
        for dev, raw in zip(self.cards, ids[0]):
            comm = ctypes.c_void_p()
            with torch.cuda.device(dev):
                _ok(lib.ncclCommInitRank(ctypes.byref(comm), size, _UniqueId.from_buffer_copy(raw), rank),
                    f"ncclCommInitRank on {dev}")
            self.comms.append(comm)
        # reductions begun and finished on each card
        self.progress = [torch.zeros(2, dtype=torch.int64, device=d) for d in self.cards]
        self._side = [torch.cuda.Stream(device=d) for d in self.cards]
        for dev in self.cards:
            _REPLAYED.prepare(dev)
        # one reduction a card, eagerly (epoch 1): NCCL connects its peers
        # here, not inside a capture
        for c, dev in enumerate(self.cards):
            self.all_reduce(torch.zeros(1, device=dev), "sum", c)
            torch.cuda.synchronize(dev)
        self._stop = threading.Event()
        self._watchdog = threading.Thread(target=self._watch, name="nccl-watchdog", daemon=True)
        self._watchdog.start()

    def all_reduce(self, flat, op, card=0):
        """Σ (op "sum") or max (op "max") of ``flat`` over the processes, in
        rank order, as a new tensor on card ``card``: one all-gather on the
        current stream, then the combine. ``flat``: contiguous, 1-D, a dtype
        of DTYPES, on ``self.cards[card]``."""
        global LAUNCHES
        dev = self.cards[card]
        if not flat.is_cuda or flat.device != dev:
            raise ValueError(f"nccl_transport: the tensor is on {flat.device}, card {card} is {dev}")
        if flat.dtype not in DTYPES:
            raise TypeError(f"nccl_transport: {flat.dtype} is not one of {list(DTYPES)}")
        if flat.ndim != 1 or not flat.is_contiguous():
            raise ValueError("nccl_transport: the tensor must be 1-D and contiguous")
        if op not in OPS:
            raise ValueError(f"nccl_transport: op must be one of {OPS}, got {op!r}")
        if self.error is not None:
            self._raise()
        with torch.cuda.device(dev):
            parts = torch.empty((self.size, flat.numel()), dtype=flat.dtype, device=dev)
            self.progress[card][:1].add_(1)
            _ok(library().ncclAllGather(flat.data_ptr(), parts.data_ptr(), flat.numel(), DTYPES[flat.dtype],
                                        self.comms[card], torch.cuda.current_stream(dev).cuda_stream),
                "ncclAllGather")
            if not _REPLAYED.captured(dev):
                LAUNCHES += 1
            acc = parts[0]
            for p in range(1, self.size):
                acc = COMBINE[op](acc, parts[p])
            self.progress[card][1:].add_(1)
        return acc

    def _watch(self):
        _relax_capture_mode()
        pending = {}  # card → (begun, since)
        poll = min(0.25, self.timeout_s / 8)
        lib = library()
        while not self._stop.wait(poll):
            for c, dev in enumerate(self.cards):
                with torch.cuda.device(dev), torch.cuda.stream(self._side[c]):
                    begun, finished = self.progress[c].tolist()
                status = ctypes.c_int()
                lib.ncclCommGetAsyncError(self.comms[c], ctypes.byref(status))
                if status.value not in (_SUCCESS, _IN_PROGRESS):
                    self._fail(c, begun, f"NCCL error {status.value} "
                                         f"({lib.ncclGetErrorString(status.value).decode()})")
                    return
                if begun == finished:
                    pending.pop(c, None)
                elif pending.get(c, (None,))[0] != begun:
                    pending[c] = (begun, time.monotonic())
                elif time.monotonic() - pending[c][1] > self.timeout_s:
                    self._fail(c, begun, f"waited more than {self.timeout_s:g} s for a peer")
                    return

    def _fail(self, card, epoch, reason):
        """Keep the first failure and abort every communicator, which ends
        the kernels that wait on a peer."""
        self.error = (card, epoch, reason)
        for comm in self.comms:
            library().ncclCommAbort(comm)

    def _raise(self):
        card, epoch, reason = self.error
        raise RuntimeError(f"mesh all-reduce over NCCL: rank {self.rank}, card {self.cards[card]}: {reason} at "
                           f"epoch {epoch} (a peer skipped a reduction, failed or stopped)")

    def check(self):
        """Raise if a reduction failed: waits for each card's current stream
        (at most twice the bound: the watchdog aborts a reduction that waits
        longer), then reads the kept failure."""
        deadline = time.monotonic() + 2 * self.timeout_s + 1.0
        for dev in self.cards:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            while not done.query() and self.error is None and time.monotonic() < deadline:
                time.sleep(1e-3)
        if self.error is None and time.monotonic() >= deadline:
            self.error = (0, int(self.progress[0][0]), "the cards' work did not end")
        if self.error is not None:
            self._raise()

    def close(self):
        """Stop the watchdog and free the communicators, collectively: every
        process's work is finished (a barrier over the group) before any
        goes, by ``ncclCommAbort``, which frees them without a handshake
        that a failed peer would never answer (a failure aborted them
        already). Every graph that recorded their all-gathers must be gone
        first: NCCL waits for them (``Mesh.close`` drops the cached ones)."""
        if not self.comms:
            return
        self._stop.set()
        self._watchdog.join()
        if self.error is None:
            for dev in self.cards:
                torch.cuda.synchronize(dev)
        dist.barrier(group=self.group)
        if self.error is None:
            for dev, comm in zip(self.cards, self.comms):
                with torch.cuda.device(dev):
                    _ok(library().ncclCommAbort(comm), "ncclCommAbort")
        self.comms = []
