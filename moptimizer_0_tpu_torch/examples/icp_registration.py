"""Example: full ICP with nearest-neighbour correspondence search and a
robust loss.

    python -m moptimizer_0_tpu_torch.examples.icp_registration [path/to/cloud.txt]

Loads a cloud (by default the repository's 29,310-point LiDAR scan,
``tests/data/fachada.txt``), applies a known transform, shuffles the target
(destroying index alignment), and recovers the transform with
``registration.icp``. On the card the search is the hand-written
brute-force kernel.
"""

import pathlib
import sys

import numpy as np
import torch

from moptimizer_0_tpu_torch import GemanMcClure, LMConfig, Status
from moptimizer_0_tpu_torch.lie import se3
from moptimizer_0_tpu_torch.registration import icp
from moptimizer_0_tpu_torch.utils.device import require
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud
from moptimizer_0_tpu_torch.utils.stopwatch import Stopwatch

DEFAULT_CLOUD = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / "fachada.txt"
X_TRUE = [10.5, 10.2, 0.1, 0.3, 0.4, 0.5]


def main(path=None, device="cuda"):
    """Register the cloud at ``path`` onto its transformed, shuffled copy on
    ``device``; returns (LMResult, x_true)."""
    dev = require(device)
    path = DEFAULT_CLOUD if path is None else path
    src = torch.as_tensor(load_txt_cloud(path), dtype=torch.float32, device=dev)
    print(f"loaded {src.shape[0]} points from {path}")

    x_true = torch.tensor(X_TRUE, dtype=torch.float32, device=dev)
    T = se3.transform_from_params6(x_true)
    rng = np.random.default_rng(0)
    perm = torch.as_tensor(rng.permutation(src.shape[0]), device=dev)
    tgt = (src @ T[:3, :3].T + T[:3, 3])[perm]

    sw = Stopwatch()
    sw.tick()
    res = icp(
        src,
        tgt,
        loss=GemanMcClure(tau=torch.tensor(1.0, dtype=torch.float32, device=dev)),
        config=LMConfig(diff_mode="auto", max_iterations=100, linear_solver="cholesky"),
    )
    status, iterations = Status(int(res.status)), int(res.iterations)
    dt = sw.tock()
    print(f"status = {status.name}  iterations = {iterations}")
    print(f"estimated params: {res.x.tolist()}")
    print(f"true params:      {x_true.tolist()}")
    print(f"wall time: {dt:.2f}s")
    return res, x_true


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
