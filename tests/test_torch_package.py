"""Package-level properties of moptimizer_0_tpu_torch that need no JAX."""

import subprocess
import sys

import pytest
import torch

import moptimizer_0_tpu_torch
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.ops.nn_search import nearest_neighbors


def test_import_leaves_jax_out():
    code = (
        "import sys, moptimizer_0_tpu_torch, moptimizer_0_tpu_torch.registration, "
        "moptimizer_0_tpu_torch.interop, moptimizer_0_tpu_torch.kernels.nn_search, "
        "moptimizer_0_tpu_torch.ba, moptimizer_0_tpu_torch.ba_dense, moptimizer_0_tpu_torch.ops.schur, "
        "moptimizer_0_tpu_torch.ops.block_cholesky, moptimizer_0_tpu_torch.kernels.schur, "
        "moptimizer_0_tpu_torch.kernels.nn_expand, moptimizer_0_tpu_torch.ops.small_solve, "
        "moptimizer_0_tpu_torch.models.curve_fitting, moptimizer_0_tpu_torch.models.powell, "
        "moptimizer_0_tpu_torch.models.rational, moptimizer_0_tpu_torch.utils.device, "
        "moptimizer_0_tpu_torch.ops.grid_nn, moptimizer_0_tpu_torch.odometry, "
        "moptimizer_0_tpu_torch.evaluation, moptimizer_0_tpu_torch.utils.stats, "
        "moptimizer_0_tpu_torch.pose_graph, moptimizer_0_tpu_torch.core.prior, moptimizer_0_tpu_torch.ops.surface, "
        "moptimizer_0_tpu_torch.ops.segment_sum, moptimizer_0_tpu_torch.models.point2plane, "
        "moptimizer_0_tpu_torch.models.gicp; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'moptimizer_0_tpu.'))"
        " or m == 'moptimizer_0_tpu'); print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fp32_matmul_precision_is_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_public_names_mirror_the_jax_package():
    names = {
        "Cauchy", "GemanMcClure", "Huber", "TrivialLoss", "ResidualBlock", "Problem",
        "linearize", "compute_cost", "LMConfig", "LMResult", "Status",
        "levenberg_marquardt", "levenberg_marquardt_batched", "lm_step", "solve_multistart", "lie",
        "icp", "icp_batched",
    }
    missing = [n for n in names if not hasattr(moptimizer_0_tpu_torch, n)]
    assert not missing


@pytest.mark.parametrize(
    "query,points,error",
    [
        (torch.rand(4, 3), torch.rand(5, 3), ValueError),  # CPU tensors
        (torch.rand(4, 3, dtype=torch.float64), torch.rand(5, 3), ValueError),
    ],
)
def test_nn_cuda_refuses_cpu_tensors_without_building(query, points, error):
    """No card here: the wrapper refuses before it builds or launches."""
    before = k_nn.LAUNCHES
    with pytest.raises(error, match="CUDA tensor"):
        k_nn.nn_cuda(query, points)
    assert k_nn.LAUNCHES == before
    assert k_nn._launcher.cache_info().currsize == 0


def test_auto_backend_on_cpu_never_reaches_the_kernel():
    before = k_nn.LAUNCHES
    nearest_neighbors(torch.rand(8, 3), torch.rand(9, 3))
    assert k_nn.LAUNCHES == before
    assert k_nn._launcher.cache_info().currsize == 0


def test_library_name_is_keyed_by_source_hash():
    path = build.library_path(k_nn.NAME, k_nn.SOURCES)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libnn_search-") and path.suffix == ".so"
    assert path == build.library_path(k_nn.NAME, k_nn.SOURCES)
    assert (build.CSRC_DIR / "nn_search.cu").is_file()


def test_expansion_library_has_its_own_name_and_source():
    path = build.library_path(k_expand.NAME, k_expand.SOURCES)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libnn_expand-") and path.suffix == ".so"
    assert path != build.library_path(k_nn.NAME, k_nn.SOURCES)
    assert (build.CSRC_DIR / "nn_expand.cu").is_file()
