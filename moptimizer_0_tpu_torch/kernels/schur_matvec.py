"""Binding of ``csrc/schur_matvec.cu``: the two halves of the CG engine's
matrix-free Schur matvec, and the per-layout plan they walk.

``matvec_plan`` sorts an incidence's observations by landmark and by camera
once per layout (tensor operations on the incidence's device, one host
read), and cuts each camera's items into tiles. ``to_landmarks_cuda``
(t = Σ_{o∈l} W_oᵀ u[cam_o], (L, 3), from W in observation order) and
``to_cameras_cuda`` (y = Σ_{o∈c} W_o s[pt_o], (C, 6), from W's rows in the
plan's camera order, ``W[plan.cam_rows]``) take CUDA float32 tensors only
and raise on anything else. Neither uses atomics: each landmark's and each
camera's sum has one order, fixed by the plan, so two calls give the same
bits. Their plain version is
the CPU path of ``ba._to_landmarks`` and ``ba._to_cameras`` (a gather, a
product and an ``ops.segment_sum``), which they agree with to float32
summation-order roundoff.
"""

import ctypes
import dataclasses
import functools

import torch

from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter

NAME = "schur_matvec"
SOURCES = ("schur_matvec.cu",)

# Tiles a plan aims at: a camera's items are cut into tiles of T = 32·2^k
# items, the least such T that makes at most about this many full tiles, a
# warp each (a camera's last tile adds one more a camera). Long tiles run
# faster than many short ones while a tile's warps still fill the card: at the
# Venice shape T = 2,048 (3,547 tiles) took 0.162-0.174 ms, T = 256 (20,451
# tiles) 0.192-0.201 ms (PERF.md).
TARGET_TILES = 4096
MAX_TILE = 8192

# Calls since import, or since ``reset_launches()``, of either half (a call
# of ``to_cameras_cuda`` is its tile launch and its camera-sum launch,
# counted once): LAUNCHES counts the calls made eagerly, ``replayed()`` those
# that CUDA-graph replays made (``kernels.launches``; the kernel adds to the
# card's counter itself), ``launches()`` both.
LAUNCHES = 0
_REPLAYED = ReplayCounter("schur_matvec")


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
    _REPLAYED.reset()


@dataclasses.dataclass(frozen=True, eq=False)
class MatvecPlan:
    """The observations of one incidence as two CSRs, for the matvec's halves.
    It depends only on the incidence, which does not change during a solve,
    so it is built once per layout. All tensors int32, on the incidence's
    device.

    C, L, n_items: cameras, landmarks, observations (O).
    group_log2:    to landmarks, a landmark's lanes are 2^group_log2: the
                   least power of two ≥ twice the mean track O / L, at most
                   16, so that most landmarks take one round of the lanes.
    lm_ptr:        (L + 1,) landmark l's items are [lm_ptr[l], lm_ptr[l + 1]).
    lm_rows:       (O,) the observations sorted stably by landmark.
    lm_cam:        (O,) each of those items' camera.
    tile:          to cameras, the items of a tile, T (a multiple of 32).
    n_tiles:       Σ_c ⌈count_c / T⌉.
    tile_ptr:      (n_tiles + 1,) tile j's items are [tile_ptr[j], tile_ptr[j + 1]),
                   every camera's items cut into runs of T from its first.
    cam_rows:      (O,) the observations sorted stably by camera (the order
                   of the W_cam that ``to_cameras_cuda`` takes).
    cam_pt:        (O,) each of those items' landmark.
    cam_tiles:     (C + 1,) camera c's tiles are [cam_tiles[c], cam_tiles[c + 1]).
    """

    C: int
    L: int
    n_items: int
    group_log2: int
    lm_ptr: torch.Tensor
    lm_rows: torch.Tensor
    lm_cam: torch.Tensor
    tile: int
    n_tiles: int
    tile_ptr: torch.Tensor
    cam_rows: torch.Tensor
    cam_pt: torch.Tensor
    cam_tiles: torch.Tensor

    @property
    def nbytes(self):
        """Bytes of the plan's tensors."""
        ts = (self.lm_ptr, self.lm_rows, self.lm_cam, self.tile_ptr, self.cam_rows, self.cam_pt, self.cam_tiles)
        return sum(t.numel() * t.element_size() for t in ts)


def _log2_ceil(x):
    """The least k ≥ 0 with 2^k ≥ x."""
    return max(0, int(x) - 1).bit_length()


def tile_size(n_items):
    """T for a layout of n_items observations: 32 × the least power of two
    ≥ n_items / (32 · TARGET_TILES), at most MAX_TILE."""
    return min(32 << _log2_ceil(-(-n_items // (32 * TARGET_TILES))), MAX_TILE)


def _offsets(counts):
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def tiles(cam_counts, tile, n_tiles):
    """(tile_ptr, cam_tiles) of cameras holding ``cam_counts`` items each,
    cut into runs of ``tile``; n_tiles = Σ ⌈count / tile⌉ (int64 tensors)."""
    C = cam_counts.shape[0]
    dev = cam_counts.device
    per_cam = (cam_counts + tile - 1) // tile
    cam_tiles = _offsets(per_cam)
    first = _offsets(cam_counts)[:-1]
    tile_cam = torch.repeat_interleave(torch.arange(C, device=dev), per_cam, output_size=n_tiles)
    rank = torch.arange(n_tiles, device=dev) - cam_tiles[tile_cam]
    end = cam_counts.sum().reshape(1)
    return torch.cat([first[tile_cam] + rank * tile, end]), cam_tiles


def matvec_plan(cam_idx, pt_idx, C, L):
    """The ``MatvecPlan`` of observations with cameras ``cam_idx`` and
    landmarks ``pt_idx`` (integer tensors of O items on one device) for C
    cameras and L landmarks. Raises ValueError for sizes past int32 or an id
    out of range (one host read: that flag and the tile count)."""
    cam, pt = cam_idx.reshape(-1).long(), pt_idx.reshape(-1).long()
    O = cam.numel()
    if pt.numel() != O:
        raise ValueError(f"matvec_plan: {O} camera ids but {pt.numel()} landmark ids")
    if not (0 < C and 6 * C < 2**31 and 0 < L and 3 * L < 2**31 and O < 2**31):
        raise ValueError(f"matvec_plan: need 0 < 6C, 3L < 2**31 and O < 2**31, got C={C}, L={L}, O={O}")
    bad = ((cam < 0) | (cam >= C) | (pt < 0) | (pt >= L)).any()
    cam_counts = torch.bincount(cam.clamp(0, C - 1), minlength=C)
    T = tile_size(O)
    bad, n_tiles = torch.stack([bad.long(), ((cam_counts + T - 1) // T).sum()]).tolist()
    if bad:
        raise ValueError(f"matvec_plan: a camera id outside [0, {C}) or a landmark id outside [0, {L})")
    lm_rows = torch.argsort(pt, stable=True)
    cam_rows = torch.argsort(cam, stable=True)
    tile_ptr, cam_tiles = tiles(cam_counts, T, n_tiles)

    def i32(t):
        return t.to(torch.int32)

    return MatvecPlan(
        C=C, L=L, n_items=O,
        group_log2=min(4, _log2_ceil(-(-2 * O // L))),
        lm_ptr=i32(_offsets(torch.bincount(pt, minlength=L))),
        lm_rows=i32(lm_rows),
        lm_cam=i32(cam[lm_rows]),
        tile=T, n_tiles=n_tiles,
        tile_ptr=i32(tile_ptr),
        cam_rows=i32(cam_rows),
        cam_pt=i32(pt[cam_rows]),
        cam_tiles=i32(cam_tiles),
    )


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # W, u, lm_ptr, lm_rows, lm_cam, L, C, group_log2, t, count, stream
    lib.smv_to_landmarks_f32.argtypes = [p, p, p, p, p, i, i, i, p, p, p]
    lib.smv_to_landmarks_f32.restype = i
    # W_cam, s, tile_ptr, cam_pt, cam_tiles, n_tiles, C, partial, y, count, stream
    lib.smv_to_cameras_f32.argtypes = [p, p, p, p, p, i, i, p, p, p, p]
    lib.smv_to_cameras_f32.restype = i
    return lib


def _check(fn, name, t, dtype, shape, device):
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, W on {device}")


def _check_w(fn, name, plan, W):
    _check(fn, name, W, torch.float32, (plan.n_items, 6, 3), W.device)
    if W.data_ptr() % 8:
        raise ValueError(f"{fn}: {name} must be 8-byte aligned")


def _launch(fn, args, dev):
    """Launch ``fn`` on dev's current stream with the card's replay counter
    under capture; count an eager launch on the host."""
    global LAUNCHES
    counter = _REPLAYED.slot(dev)
    with torch.cuda.device(dev):
        err = fn(*args, None if counter is None else counter.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {err}")
    if counter is None:
        LAUNCHES += 1


def to_landmarks_cuda(plan, W, u):
    """t (L, 3) float32 = Σ_{o∈l} W_oᵀ u[cam_o] over ``plan``
    (``matvec_plan``) for W (O, 6, 3) and u (C, 6) float32 on one card. One
    launch on the current stream; does not synchronise. Captured into a CUDA
    graph, the launch's error code is checked at capture only: a fault at
    replay shows at the next synchronisation."""
    fn = "to_landmarks_cuda"
    _check_w(fn, "W", plan, W)
    dev = W.device
    _check(fn, "u", u, torch.float32, (plan.C, 6), dev)
    for name in ("lm_ptr", "lm_rows", "lm_cam"):
        t = getattr(plan, name)
        _check(fn, name, t, torch.int32, (plan.L + 1,) if name == "lm_ptr" else (plan.n_items,), dev)
    t = torch.empty((plan.L, 3), dtype=torch.float32, device=dev)
    _launch(_library().smv_to_landmarks_f32,
            (W.data_ptr(), u.data_ptr(), plan.lm_ptr.data_ptr(), plan.lm_rows.data_ptr(), plan.lm_cam.data_ptr(),
             plan.L, plan.C, plan.group_log2, t.data_ptr()), dev)
    return t


def to_cameras_cuda(plan, W_cam, s):
    """y (C, 6) float32 = Σ_{o∈c} W_o s[pt_o] over ``plan`` for W_cam (O, 6,
    3), W's rows in the plan's camera order, and s (L, 3) float32 on one
    card: each tile's partial, then each camera's partials in tile order;
    two launches on the current stream, as ``to_landmarks_cuda``."""
    fn = "to_cameras_cuda"
    _check_w(fn, "W_cam", plan, W_cam)
    dev = W_cam.device
    _check(fn, "s", s, torch.float32, (plan.L, 3), dev)
    shapes = dict(tile_ptr=(plan.n_tiles + 1,), cam_pt=(plan.n_items,), cam_tiles=(plan.C + 1,))
    for name, shape in shapes.items():
        _check(fn, name, getattr(plan, name), torch.int32, shape, dev)
    partial = torch.empty((plan.n_tiles, 6), dtype=torch.float32, device=dev)
    y = torch.empty((plan.C, 6), dtype=torch.float32, device=dev)
    _launch(_library().smv_to_cameras_f32,
            (W_cam.data_ptr(), s.data_ptr(), plan.tile_ptr.data_ptr(), plan.cam_pt.data_ptr(),
             plan.cam_tiles.data_ptr(), plan.n_tiles, plan.C, partial.data_ptr(), y.data_ptr()), dev)
    return y
