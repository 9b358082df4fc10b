"""Binding of ``csrc/graph_cond.cu``: IF nodes in a CUDA graph under capture.

``begin_if(parent, child, pred)`` makes the work that ``child`` captures
next the body of an IF node of the graph that ``parent`` is capturing,
taken at replay where the 0-dim bool CUDA tensor ``pred`` is true;
``end_if(child)`` closes the body. ``ops.device_loop.cond`` is the one
caller. ``mark(name, stream, count)`` launches the marker kernel
``moptimizer_mark_<name>`` (a name of MARKS) on ``stream``, for
``utils.tracing.mark``. The library builds at first use, like the kernels.
"""

import ctypes
import functools

import torch

from moptimizer_0_tpu_torch.kernels import build

NAME = "graph_cond"
SOURCES = ("graph_cond.cu",)
# The markers of csrc/graph_cond.cu, in the order of dl_mark's index.
MARKS = ("step_begin", "step_end", "ba_linearize_begin", "ba_linearize_end", "ba_pcg_begin", "ba_pcg_end",
         "pcg_iteration")
_MARK_INDEX = {name: i for i, name in enumerate(MARKS)}


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    lib.dl_begin_if.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.dl_begin_if.restype = ctypes.c_int
    lib.dl_end_if.argtypes = [ctypes.c_void_p]
    lib.dl_end_if.restype = ctypes.c_int
    lib.dl_mark.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.dl_mark.restype = ctypes.c_int
    return lib


def load():
    """Build and load the library (before a capture: nvcc does not belong
    inside one)."""
    _library()


def begin_if(parent, child, pred):
    if not pred.is_cuda or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"begin_if: pred must be one CUDA bool, got {pred.dtype} {tuple(pred.shape)} on {pred.device}")
    err = _library().dl_begin_if(parent.cuda_stream, child.cuda_stream, pred.data_ptr())
    if err != 0:
        raise RuntimeError(f"dl_begin_if failed: {'the stream is not capturing' if err == -1 else f'CUDA error {err}'}")


def end_if(child):
    err = _library().dl_end_if(child.cuda_stream)
    if err != 0:
        raise RuntimeError(f"dl_end_if failed with CUDA error {err}")


def mark(name, stream, count=None):
    if count is not None and (not count.is_cuda or count.dtype != torch.int32 or count.numel() != 1
                              or name != "pcg_iteration"):
        raise ValueError(f"mark: a count is one CUDA int32 for pcg_iteration, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device} for {name}")
    err = _library().dl_mark(_MARK_INDEX[name], stream.cuda_stream, None if count is None else count.data_ptr())
    if err != 0:
        raise RuntimeError(f"dl_mark({name}) failed with CUDA error {err}")
