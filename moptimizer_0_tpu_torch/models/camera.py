"""Pinhole reprojection residual for camera extrinsic calibration.

PyTorch counterpart of ``moptimizer_0_tpu.models.camera``: state x ∈ R⁶ →
T (params6), π = K·T·T_cl·p (homogeneous), r = pixel − (π₀/π₂, π₁/π₂). The
reference fixture's intrinsics K and camera↔laser frame are the defaults.
"""

import numpy as np
import torch

from moptimizer_0_tpu_torch.core.residual import make_block
from moptimizer_0_tpu_torch.lie import se3

# The reference fixture's intrinsics (tst/camera_calibration.cpp:29-30).
DEFAULT_K = np.array(
    [
        [586.122314453125, 0.0, 638.8477694496105, 0.0],
        [0.0, 722.3973388671875, 323.031267074588, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ]
)


def default_camera_laser_frame():
    """Rx(π/2)·Rz(π/2) block-diagonal 4×4."""
    c, s = 0.0, 1.0  # cos(π/2), sin(π/2)
    rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
    T = np.eye(4)
    T[:3, :3] = rx @ rz
    return T


def _prepare(x):
    return se3.transform_from_params6(x)


def _make_residual(K, T_cl):
    def residual(T, data_i):
        proj = K @ (T @ (T_cl @ data_i["point"]))
        return data_i["pixel"] - proj[:2] / proj[2]

    return residual


def camera_reprojection_block(points_h, pixels, *, K=None, camera_laser_frame=None, loss=None,
                              weight_matrix=None):
    """points_h: (N, 4) homogeneous points; pixels: (N, 2). The constants
    land on the device and in the dtype of ``points_h``."""
    points_h = torch.as_tensor(points_h)
    dtype, dev = points_h.dtype, points_h.device

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    K = const(DEFAULT_K if K is None else K)
    T_cl = const(default_camera_laser_frame() if camera_laser_frame is None else camera_laser_frame)
    data = dict(point=points_h, pixel=torch.as_tensor(pixels, dtype=dtype, device=dev))
    return make_block(
        _make_residual(K, T_cl),
        data=data,
        prepare_fn=_prepare,
        loss=loss,
        weight_matrix=weight_matrix,
        name="camera_reprojection",
    )
