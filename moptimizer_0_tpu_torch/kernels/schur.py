"""Binding of ``csrc/schur.cu``: the Schur-complement correction S_corr (K11).

``schur_corr_cuda`` takes CUDA tensors only and raises on anything else. It
gathers over a ``ops.schur.PairPlan`` with no atomics, so two calls on the
same inputs give the same S_corr bit for bit; the plain versions it must
agree with (to float32 summation-order roundoff) are
``ops.schur._schur_corr_torch`` and ``ops.schur._schur_corr_pairs_torch``.
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
        ctypes.c_void_p,  # pairs
        ctypes.c_void_p,  # weight
        ctypes.c_void_p,  # block_ptr
        ctypes.c_void_p,  # block_cam
        ctypes.c_void_p,  # order
        ctypes.c_int,  # n_blocks
        ctypes.c_int,  # C
        ctypes.c_void_p,  # S_corr
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if not t.is_cuda:
        raise ValueError(f"schur_corr_cuda: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"schur_corr_cuda: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"schur_corr_cuda: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"schur_corr_cuda: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"schur_corr_cuda: {name} is on {t.device}, G on {device}")


def schur_corr_cuda(plan, G):
    """S_corr (6C, 6C) float32 = Σ_l A2_lᵀA2_l in i·C + c order, for the
    camera pairs of ``plan`` (``ops.schur.PairPlan``) and G (plan.n_slots,
    6, 3) float32, every segment's W·L⁻ᵀ in the plan's flat slot layout. One
    launch for all segments (none when the plan is empty), on the current
    stream; does not synchronise."""
    global LAUNCHES
    C, P, E = plan.C, plan.block_cam.shape[0], plan.pairs.shape[0]
    _check("G", G, torch.float32, (plan.n_slots, 6, 3), G.device)
    _check("pairs", plan.pairs, torch.int32, (E, 2), G.device)
    _check("weight", plan.weight, torch.float32, (E,), G.device)
    _check("block_ptr", plan.block_ptr, torch.int32, (P + 1,), G.device)
    _check("block_cam", plan.block_cam, torch.int32, (P, 2), G.device)
    _check("order", plan.order, torch.int32, (P,), G.device)
    S_corr = torch.zeros((6 * C, 6 * C), dtype=torch.float32, device=G.device)
    if P == 0:
        return S_corr  # no real slot: nothing to add
    launch = _launcher()
    with torch.cuda.device(G.device):
        err = launch(
            G.data_ptr(), plan.pairs.data_ptr(), plan.weight.data_ptr(), plan.block_ptr.data_ptr(),
            plan.block_cam.data_ptr(), plan.order.data_ptr(), P, C, S_corr.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"schur_corr_f32 launch failed with CUDA error {err}")
    LAUNCHES += 1
    return S_corr
