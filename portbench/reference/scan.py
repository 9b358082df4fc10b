"""The benchmark's own loader of a text point cloud (x y z, then columns
that are ignored), as numpy float64."""

import numpy as np


def load_cloud(path):
    data = np.loadtxt(str(path), dtype=np.float64, ndmin=2)
    return np.ascontiguousarray(data[:, :3])
