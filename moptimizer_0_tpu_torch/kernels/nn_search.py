"""Binding of ``csrc/nn_search.cu``: exact brute-force nearest neighbour (K5).

``nn_cuda`` takes CUDA tensors only and raises on anything else; the plain
version it must agree with bit for bit is ``ops.nn_search._nn_torch``.
"""

import ctypes
import functools

import torch

from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter
from moptimizer_0_tpu_torch.kernels.nn_expand import n_splits

NAME = "nn_search"
SOURCES = ("nn_search.cu",)

# Kernel launches since import, or since ``reset_launches()``: LAUNCHES
# counts the launches made eagerly, ``replayed()`` those that CUDA-graph
# replays made (``kernels.launches``), ``launches()`` both.
LAUNCHES = 0
# LAUNCHES by card (a torch.device).
LAUNCHES_BY_CARD = {}
_REPLAYED = ReplayCounter("nn_cuda")


def replayed():
    return _REPLAYED.total()


def launches():
    return LAUNCHES + replayed()


def replayed_by_card():
    """{card: launches that graph replays made there} (one read a card)."""
    return _REPLAYED.by_device()


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_CARD.clear()
    _REPLAYED.reset()


def _count(device):
    global LAUNCHES
    if not _REPLAYED.captured(device):
        LAUNCHES += 1
        LAUNCHES_BY_CARD[device] = LAUNCHES_BY_CARD.get(device, 0) + 1


@functools.lru_cache(maxsize=None)
def _launcher():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    lib.nn_bruteforce_f32.argtypes = [
        ctypes.c_void_p,  # query
        ctypes.c_void_p,  # points
        ctypes.c_int,  # n_query
        ctypes.c_int,  # n_points
        ctypes.c_int,  # n_splits
        ctypes.c_void_p,  # part_idx
        ctypes.c_void_p,  # part_d2
        ctypes.c_void_p,  # out_idx
        ctypes.c_void_p,  # out_d2
        ctypes.c_void_p,  # stream
    ]
    lib.nn_bruteforce_f32.restype = ctypes.c_int
    lib.nn_bruteforce_queries_per_block.restype = ctypes.c_int
    return lib


def _check(name, t):
    if not t.is_cuda:
        raise ValueError(f"nn_cuda: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"nn_cuda: {name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"nn_cuda: {name} must have shape (n, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"nn_cuda: {name} must be contiguous")
    if t.shape[0] == 0 or 3 * t.shape[0] >= 2**31:
        raise ValueError(f"nn_cuda: {name} has {t.shape[0]} points; need 1 to {2**31 // 3}")


def target_splits(query, points):
    """The ranges ``nn_cuda`` cuts the targets into for these inputs on the
    card that holds them (``nn_expand.n_splits``)."""
    n_blocks = -(-query.shape[0] // _launcher().nn_bruteforce_queries_per_block())
    sms = torch.cuda.get_device_properties(query.device).multi_processor_count
    return n_splits(n_blocks, points.shape[0], sms)


def nn_cuda(query, points):
    """For each query point, (index int32, squared distance float32) of its
    nearest point in ``points``. One search launch (and a merge launch when
    ``target_splits`` splits the targets) on the current stream; does not
    synchronise. Captured into a CUDA graph, the launch's error code is
    checked at capture only, and each replay that runs it counts it on the
    card (``replayed()``)."""
    _check("query", query)
    _check("points", points)
    if query.device != points.device:
        raise ValueError(f"nn_cuda: query on {query.device}, points on {points.device}")
    lib = _launcher()
    n_query, n_points = query.shape[0], points.shape[0]
    splits = target_splits(query, points)
    idx = torch.empty(n_query, dtype=torch.int32, device=query.device)
    d2 = torch.empty(n_query, dtype=torch.float32, device=query.device)
    part_idx = part_d2 = None
    if splits > 1:
        part_idx = torch.empty((splits, n_query), dtype=torch.int32, device=query.device)
        part_d2 = torch.empty((splits, n_query), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = lib.nn_bruteforce_f32(
            query.data_ptr(),
            points.data_ptr(),
            n_query,
            n_points,
            splits,
            None if part_idx is None else part_idx.data_ptr(),
            None if part_d2 is None else part_d2.data_ptr(),
            idx.data_ptr(),
            d2.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_bruteforce_f32 launch failed with CUDA error {err}")
    _count(query.device)
    return idx, d2
