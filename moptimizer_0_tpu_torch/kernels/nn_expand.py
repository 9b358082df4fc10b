"""Binding of ``csrc/nn_expand.cu``: lane-batched NN by the expansion (K6).

``nn_expand_cuda`` takes CUDA tensors only and raises on anything else; the
plain version it must agree with bit for bit is
``ops.nn_search._nn_expand_torch``.
"""

import ctypes
import functools

import torch

from moptimizer_0_tpu_torch.kernels import build

NAME = "nn_expand"
SOURCES = ("nn_expand.cu",)

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_MAX_LANES = 65535  # the grid's y dimension


@functools.lru_cache(maxsize=None)
def _launcher():
    path, _ = build.build(NAME, SOURCES)
    fn = ctypes.CDLL(str(path)).nn_expand_f32
    fn.argtypes = [
        ctypes.c_void_p,  # query
        ctypes.c_void_p,  # points
        ctypes.c_int,  # n_lanes
        ctypes.c_int,  # n_query
        ctypes.c_int,  # n_points
        ctypes.c_void_p,  # out_idx
        ctypes.c_void_p,  # out_d2
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


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


def nn_expand_cuda(query, points):
    """For each query point of each lane, (index int32, squared distance
    float32) of its nearest point among the lane's ``points``: query
    (Q, 3) or (B, Q, 3), points (M, 3) or (B, M, 3) with the same B.
    Returns two tensors of shape query.shape[:-1]. One launch for all lanes,
    on the current stream; does not synchronise."""
    global LAUNCHES
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
    launch = _launcher()
    n_query, n_points = query.shape[-2], points.shape[-2]
    idx = torch.empty(query.shape[:-1], dtype=torch.int32, device=query.device)
    d2 = torch.empty(query.shape[:-1], dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = launch(
            query.data_ptr(),
            points.data_ptr(),
            n_lanes,
            n_query,
            n_points,
            idx.data_ptr(),
            d2.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_expand_f32 launch failed with CUDA error {err}")
    LAUNCHES += 1
    return idx, d2
