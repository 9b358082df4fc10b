"""Binding of ``csrc/schur.cu``: the Schur-complement correction S_corr (K11).

``schur_corr_cuda`` takes CUDA tensors only and raises on anything else; the
plain version it must agree with (to float32 summation-order roundoff: the
kernel's atomics sum in no fixed order) is ``ops.schur._schur_corr_torch``.
"""

import ctypes
import functools

import torch

from moptimizer_0_tpu_torch.kernels import build

NAME = "schur"
SOURCES = ("schur.cu",)

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    path, _ = build.build(NAME, SOURCES)
    fn = ctypes.CDLL(str(path)).schur_corr_f32
    fn.argtypes = [
        ctypes.c_void_p,  # G
        ctypes.c_void_p,  # cam_ids
        ctypes.c_void_p,  # mask
        ctypes.c_int,  # L
        ctypes.c_int,  # K
        ctypes.c_int,  # C
        ctypes.c_void_p,  # S_corr
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"schur_corr_cuda: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"schur_corr_cuda: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"schur_corr_cuda: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"schur_corr_cuda: {name} must be contiguous")


def schur_corr_cuda(segments, C):
    """S_corr (6C, 6C) float32 = Σ_l A2_lᵀA2_l in i·C + c order, summed over
    ``segments``, a sequence of (G (L, K, 6, 3) float32, cam_ids (L, K)
    int32, mask (L, K) float32) triples on one CUDA device. One launch per
    segment with L·K > 0, on the current stream; does not synchronise."""
    global LAUNCHES
    if not 0 < C < 2**31 // 6:
        raise ValueError(f"schur_corr_cuda: need 1 <= C < {2**31 // 6}, got {C}")
    if not segments:
        raise ValueError("schur_corr_cuda: no segments")
    device = segments[0][0].device
    for G, cam_ids, mask in segments:
        if cam_ids.ndim != 2:
            raise ValueError(f"schur_corr_cuda: cam_ids must be (L, K), got {tuple(cam_ids.shape)}")
        L, K = cam_ids.shape
        _check("cam_ids", cam_ids, torch.int32, (L, K))
        _check("G", G, torch.float32, (L, K, 6, 3))
        _check("mask", mask, torch.float32, (L, K))
        if not G.device == cam_ids.device == mask.device == device:
            raise ValueError("schur_corr_cuda: all segments' tensors must be on one device")
        if L >= 2**31 or 18 * K >= 2**31:
            raise ValueError(f"schur_corr_cuda: a segment of {L} x {K} slots is too large")
    launch = _launcher()
    S_corr = torch.zeros((6 * C, 6 * C), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for G, cam_ids, mask in segments:
            L, K = cam_ids.shape
            if L == 0 or K == 0:
                continue  # an empty segment (unobserved landmarks) adds nothing
            err = launch(
                G.data_ptr(), cam_ids.data_ptr(), mask.data_ptr(), L, K, C,
                S_corr.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(f"schur_corr_f32 launch failed with CUDA error {err}")
            LAUNCHES += 1
    return S_corr
