"""The benchmark's inputs, made on the device from the seed.

``bal_instance`` draws a BAL-shaped bundle-adjustment problem; ``scan_targets``
draws registration targets from a point cloud. Both use one
``torch.Generator`` on the device and a few large calls, in float64, and hand
the program float32 tensors; the references read the same tensors.
"""

import torch

from portbench.reference.ba import residuals, so3_exp


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _fix_total(k, total, lo, hi, g):
    """Add or take one from seeded tracks until Σk = total, every k in [lo, hi]."""
    n = k.shape[0]
    while True:
        diff = total - int(k.sum())
        if diff == 0:
            return k
        perm = torch.randperm(n, generator=g, device=k.device)
        free = perm[k[perm] < hi] if diff > 0 else perm[k[perm] > lo]
        pick = free[: abs(diff)]
        k[pick] += 1 if diff > 0 else -1


def track_lengths(L, O, lo, hi, g, device):
    """L track lengths ≥ lo summing to O: lo plus a geometric draw with mean
    O/L − lo (the heavy tail of real tracks), capped at hi, then corrected
    by one on seeded tracks to the exact total."""
    p = 1.0 / (1.0 + O / L - lo)
    u = torch.rand(L, generator=g, device=device, dtype=torch.float64)
    extra = torch.floor(torch.log1p(-u) / torch.log1p(torch.tensor(-p, dtype=torch.float64, device=device)))
    k = torch.clamp(lo + extra, max=hi).to(torch.int64)
    return _fix_total(k, O, lo, hi, g)


def bal_instance(cfg, seed, device, dtype=torch.float32):
    """A BAL-shaped instance of the configuration ``cfg``: C cameras along a
    line (a trajectory), each landmark seen by a run of neighbouring cameras
    and lying in front of all of them, O observations exactly, pixels
    projected plus Gaussian noise, then the starts perturbed (cameras
    ``fixed_cameras``.. and every landmark). Returns a dict of ``dtype``
    tensors: cams0, pts0, cams_true, pts_true, cam_idx, pt_idx (int64,
    landmark order), pixels, intrinsics; and n_fixed."""
    g = generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    C, L, O = cfg["cameras"], cfg["points"], cfg["observations"]
    lo, hi = cfg["min_track"], min(cfg["max_track"], C)

    def normal(*shape):
        return torch.randn(*shape, generator=g, **f64)

    def uniform(a, b, *shape):
        return a + (b - a) * torch.rand(*shape, generator=g, **f64)

    k = track_lengths(L, O, lo, hi, g, device)
    first = torch.floor(torch.rand(L, generator=g, **f64) * (C - k + 1)).to(torch.int64)
    pt_idx = torch.repeat_interleave(torch.arange(L, device=device), k, output_size=O)
    start = torch.cumsum(k, 0) - k
    cam_idx = first[pt_idx] + torch.arange(O, device=device) - start[pt_idx]

    s = cfg["camera_spacing_m"]
    centers = torch.stack([s * (torch.arange(C, **f64) - C / 2),
                           cfg["camera_height_noise_m"] * normal(C), torch.zeros(C, **f64)], 1)
    w = cfg["camera_rotation_noise_rad"] * normal(C, 3)
    R = so3_exp(w)
    cams = torch.cat([-(R @ centers[:, :, None])[:, :, 0], w], 1)
    mid = first.to(torch.float64) + (k.to(torch.float64) - 1) / 2
    z0, z1 = cfg["point_depth_m"]
    hw, hh = cfg["point_half_width_m"], cfg["point_half_height_m"]
    pts = torch.stack([s * (mid - C / 2) + uniform(-hw, hw, L), uniform(-hh, hh, L), uniform(z0, z1, L)], 1)
    intr = torch.tensor(cfg["intrinsics"], **f64)
    obs = dict(cam_idx=cam_idx, pt_idx=pt_idx, pixels=torch.zeros(O, 2, **f64), intrinsics=intr)
    pixels = -residuals(cams, pts, obs) + cfg["pixel_noise_px"] * normal(O, 2)
    free = (torch.arange(C, device=device) >= cfg["fixed_cameras"]).to(torch.float64)[:, None]
    cams0 = cams + cfg["camera_start_noise"] * normal(C, 6) * free
    pts0 = pts + cfg["point_start_noise_m"] * normal(L, 3)
    out = dict(cams0=cams0, pts0=pts0, cams_true=cams, pts_true=pts, pixels=pixels, intrinsics=intr)
    out = {key: v.to(dtype) for key, v in out.items()}
    out.update(cam_idx=cam_idx, pt_idx=pt_idx, n_fixed=cfg["fixed_cameras"])
    return out


def observations(inst):
    """The reference's view of an instance's observations."""
    return {key: inst[key] for key in ("cam_idx", "pt_idx", "pixels", "intrinsics")}


def _sphere(n, k):
    """Point k of n on the unit sphere's Fibonacci lattice (float64, (..., 3))."""
    z = 1 - (2 * k + 1) / n
    phi = k * torch.pi * (3 - 5 ** 0.5)
    r = torch.sqrt(1 - z * z)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def transforms(n, cfg, device):
    """The n transforms every seed's targets use, (n, 6) float64: |t| at
    max_translation_m·(k + ½)/n and |ω| at max_rotation_rad·(j + ½)/n, j = 23k
    mod n (a fixed pairing), along the k-th and j-th directions of a
    Fibonacci lattice. A target set asks for the same work whatever the
    seed; the seed draws which lane or request gets which transform, the
    noise and the order of the points."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    step = next(a for a in (23, 29, 31, 37, 41, 43, 47, 53, 1) if n % a)
    j = (k * step) % n
    t = _sphere(n, k) * (cfg["max_translation_m"] * (k + 0.5) / n)[:, None]
    w = _sphere(n, j) * (cfg["max_rotation_rad"] * (j + 0.5) / n)[:, None]
    return torch.cat([t, w], 1)


def scan_targets(cloud, n, cfg, seed, dtype=torch.float32, noise_seed=None):
    """n targets made from cloud (N, 3): the n ``transforms`` in an order
    drawn from the seed, each applied to the cloud, plus Gaussian sensor
    noise, its points in their own shuffled order. With ``noise_seed`` the
    order of the transforms and the noise come from that seed and only the
    order of the points from ``seed``: every seed then gets the same
    targets, points in another order. Returns (targets (n, N, 3) ``dtype``,
    x_true (n, 6) float64)."""
    device = cloud.device
    g = generator(seed, device)
    gn = g if noise_seed is None else generator(noise_seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    x = transforms(n, cfg, device)[torch.randperm(n, generator=gn, device=device)]
    c = cloud.to(torch.float64)
    tgt = c @ so3_exp(x[:, 3:]).transpose(1, 2) + x[:, None, :3]
    tgt = tgt + cfg["sensor_noise_m"] * torch.randn(tgt.shape, generator=gn, **f64)
    perm = torch.argsort(torch.rand(n, c.shape[0], generator=g, **f64), dim=1)
    tgt = torch.gather(tgt, 1, perm[:, :, None].expand(-1, -1, 3))
    return tgt.to(dtype).contiguous(), x
