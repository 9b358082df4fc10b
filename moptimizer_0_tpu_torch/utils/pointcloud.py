"""Point-cloud IO: the whitespace ``x y z [extra...]`` text format."""

import numpy as np


def load_txt_cloud(path, dtype=np.float64):
    """Load an ``x y z [extra...]`` text cloud → (N, 3) numpy array."""
    data = np.loadtxt(str(path), dtype=dtype)
    pts = np.ascontiguousarray(np.atleast_2d(data)[:, :3])
    if pts.shape[0] == 0:
        raise ValueError(f"no points parsed from {path}: not a point-cloud file?")
    return pts
