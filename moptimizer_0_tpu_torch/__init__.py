"""moptimizer_0_tpu_torch — the nonlinear least-squares engine in PyTorch, for
NVIDIA Hopper GPUs.

The port of ``moptimizer_0_tpu``, held against it by tests that feed both
packages the same inputs. Plain tensor code is PyTorch; each TPU kernel of
the JAX package becomes a kernel written by hand for Hopper (``csrc/``,
bound in ``kernels/``), with its plain PyTorch version beside it.
"""

import torch as _torch

# Full float32 matrix products: ICP stalls short of convergence when the 3×3
# rotation and moment products run in TF32 (about three decimal digits).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from moptimizer_0_tpu_torch.core.loss import (  # noqa: E402
    Cauchy,
    GemanMcClure,
    Huber,
    TrivialLoss,
)
from moptimizer_0_tpu_torch.core.residual import ResidualBlock, Problem  # noqa: E402
from moptimizer_0_tpu_torch.core.linearize import linearize, compute_cost  # noqa: E402
from moptimizer_0_tpu_torch.core.solver import (  # noqa: E402
    LMConfig,
    LMResult,
    Status,
    levenberg_marquardt,
    levenberg_marquardt_batched,
    lm_step,
    solve_multistart,
)
from moptimizer_0_tpu_torch.registration import icp, icp_batched  # noqa: E402
from moptimizer_0_tpu_torch.core import manifold  # noqa: E402
from moptimizer_0_tpu_torch import lie  # noqa: E402
from moptimizer_0_tpu_torch import parallel  # noqa: E402

__version__ = "0.1.0"
