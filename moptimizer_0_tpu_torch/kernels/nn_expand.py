"""Binding of ``csrc/nn_expand.cu``: lane-batched NN by the expansion (K6).

``nn_expand_cuda`` takes CUDA tensors only and raises on anything else; the
plain version it must agree with bit for bit is
``ops.nn_search._nn_expand_torch``.
"""

import ctypes
import functools
import math

import torch

from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter

NAME = "nn_expand"
SOURCES = ("nn_expand.cu",)

# Kernel launches since import, or since ``reset_launches()``: LAUNCHES
# counts the launches made eagerly, ``replayed()`` those that CUDA-graph
# replays made (``kernels.launches``), ``launches()`` both.
LAUNCHES = 0
_REPLAYED = ReplayCounter("nn_expand_cuda")


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

_MAX_LANES = 65535  # the grid's y dimension
# A grid of fewer than this many blocks per SM has its targets split.
_MIN_BLOCKS_PER_SM = 2
# About the fewest targets a range holds.
_MIN_SPLIT_POINTS = 256


@functools.lru_cache(maxsize=None)
def _launcher():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    lib.nn_expand_f32.argtypes = [
        ctypes.c_void_p,  # query
        ctypes.c_void_p,  # points
        ctypes.c_int,  # n_lanes
        ctypes.c_int,  # n_query
        ctypes.c_int,  # n_points
        ctypes.c_int,  # n_splits
        ctypes.c_void_p,  # part_idx
        ctypes.c_void_p,  # part_d2
        ctypes.c_void_p,  # out_idx
        ctypes.c_void_p,  # out_d2
        ctypes.c_void_p,  # stream
    ]
    lib.nn_expand_f32.restype = ctypes.c_int
    lib.nn_expand_queries_per_block.restype = ctypes.c_int
    return lib


def n_splits(n_blocks, n_points, n_sms):
    """How many ranges to cut each lane's targets into, for a grid of
    ``n_blocks`` blocks per range on ``n_sms`` SMs. 1 when the grid gives
    every SM ``_MIN_BLOCKS_PER_SM`` blocks. Otherwise, of the S from the
    least that does so to twice that (at most one range per
    ``_MIN_SPLIT_POINTS`` targets), the S whose busiest SM holds the least
    work, ⌈n_blocks·S / n_sms⌉ blocks of 1/S of a lane each; the smaller S
    on a tie."""
    if n_blocks >= _MIN_BLOCKS_PER_SM * n_sms:
        return 1
    most = max(1, n_points // _MIN_SPLIT_POINTS)
    least = min(most, math.ceil(_MIN_BLOCKS_PER_SM * n_sms / n_blocks))
    return min(range(least, min(most, 2 * least) + 1),
               key=lambda s: (math.ceil(n_blocks * s / n_sms) / s, s))


def _check(name, t):
    if not t.is_cuda:
        raise ValueError(f"nn_expand_cuda: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"nn_expand_cuda: {name} must be float32, got {t.dtype}")
    if t.ndim not in (2, 3) or t.shape[-1] != 3:
        raise ValueError(
            f"nn_expand_cuda: {name} must have shape (n, 3) or (lanes, n, 3), got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"nn_expand_cuda: {name} must be contiguous")
    if t.shape[-2] == 0 or 3 * t.shape[-2] >= 2**31:
        raise ValueError(f"nn_expand_cuda: {name} has {t.shape[-2]} points; need 1 to {2**31 // 3}")


def target_splits(query, points):
    """The ranges ``nn_expand_cuda`` cuts each lane's targets into for
    these inputs on the card that holds them (``n_splits``)."""
    n_lanes = query.shape[0] if query.ndim == 3 else 1
    n_blocks = n_lanes * -(-query.shape[-2] // _launcher().nn_expand_queries_per_block())
    sms = torch.cuda.get_device_properties(query.device).multi_processor_count
    return n_splits(n_blocks, points.shape[-2], sms)


def nn_expand_cuda(query, points):
    """For each query point of each lane, (index int32, squared distance
    float32) of its nearest point among the lane's ``points``: query
    (Q, 3) or (B, Q, 3), points (M, 3) or (B, M, 3) with the same B.
    Returns two tensors of shape query.shape[:-1]. One search launch for all
    lanes (and a merge launch when ``target_splits`` splits the targets),
    on the current stream; does not synchronise. Captured into a CUDA
    graph, the launch's error code is checked at capture only, and each
    replay that runs it counts it on the card (``replayed()``)."""
    _check("query", query)
    _check("points", points)
    if query.ndim != points.ndim or query.shape[:-2] != points.shape[:-2]:
        raise ValueError(
            f"nn_expand_cuda: lanes differ: query {tuple(query.shape)}, points {tuple(points.shape)}"
        )
    if query.device != points.device:
        raise ValueError(f"nn_expand_cuda: query on {query.device}, points on {points.device}")
    n_lanes = query.shape[0] if query.ndim == 3 else 1
    if not 0 < n_lanes <= _MAX_LANES:
        raise ValueError(f"nn_expand_cuda: need 1 to {_MAX_LANES} lanes, got {n_lanes}")
    n_query, n_points = query.shape[-2], points.shape[-2]
    lib = _launcher()
    splits = target_splits(query, points)
    idx = torch.empty(query.shape[:-1], dtype=torch.int32, device=query.device)
    d2 = torch.empty(query.shape[:-1], dtype=torch.float32, device=query.device)
    part_idx = part_d2 = None
    if splits > 1:
        part_idx = torch.empty((splits, *idx.shape), dtype=torch.int32, device=query.device)
        part_d2 = torch.empty((splits, *idx.shape), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = lib.nn_expand_f32(
            query.data_ptr(),
            points.data_ptr(),
            n_lanes,
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
        raise RuntimeError(f"nn_expand_f32 launch failed with CUDA error {err}")
    _count(query.device)
    return idx, d2
