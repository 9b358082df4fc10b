"""What the registration loops share: the scan, its targets, and the
check of alignments against the plain ICP reference."""

import hashlib
from pathlib import Path

import torch

from portbench.reference import icp as ref
from portbench.reference.precision import CONTROL
from portbench.reference.scan import load_cloud

ROOT = Path(__file__).resolve().parents[1]


def cloud(cfg, device):
    """The configuration's scan as a float32 tensor on ``device`` (the first
    ``points`` rows of its file). The file lies outside ``portbench/``, so its
    SHA-256 must be the configuration's ``cloud_sha256``: a changed scan stops
    the run instead of moving the yardstick."""
    path = ROOT / cfg["cloud_file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["cloud_sha256"]:
        raise SystemExit(f"{path}: SHA-256 {digest}, the configuration names {cfg['cloud_sha256']}")
    c = load_cloud(path)[: cfg["points"]]
    return torch.as_tensor(c, dtype=torch.float32, device=device).contiguous()


def judge(src, tgts, picked, control=False):
    """x_gap: the largest |x − x_ref| over the picked alignments, each a
    (target index, x or None): x None for the control, which aligns with the
    reference in its own precision in the program's place. The reference
    aligns each target once."""
    refs, worst = {}, 0.0
    for j, x in picked:
        if j not in refs:
            refs[j] = ref.align(src.double(), tgts[j])[0]
        if control:
            x = ref.align(src, tgts[j], CONTROL)[0]
        gap = float((x.to(refs[j]) - refs[j]).abs().max())
        worst = max(worst, gap if gap == gap else float("inf"))
    return dict(x_gap=worst)
