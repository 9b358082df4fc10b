"""The whole slice: the port's ``icp()`` against the JAX package's ICP solve.

The real LiDAR scan ``tests/data/fachada.txt``, every 16th point (1,832),
moved by a known transform and shuffled, is registered by both packages.
The JAX side builds its ICP block around the TPU kernel K5 run in interpret
mode, with the same configuration and centroid seed as ``icp()`` uses; the
port runs ``icp()`` itself, whose searcher on CPU tensors is the kernel's
plain version. float64: status, iterations and accept flags equal, x within
1e-9, costs within rtol 1e-9 (atol 1e-15 × the first cost for the final
costs at roundoff, ≈1e-23), ρ, λ and ν within rtol 1e-9.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import GemanMcClure as JGemanMcClure
from moptimizer_0_tpu.core.residual import problem as jproblem
from moptimizer_0_tpu.core.solver import LMConfig as JLMConfig
from moptimizer_0_tpu.core.solver import levenberg_marquardt as jlm
from moptimizer_0_tpu.lie import se3 as jse3
from moptimizer_0_tpu.ops.nn_search import _nn_pallas_vpu
from moptimizer_0_tpu.registration import _icp_block_with_searcher
from moptimizer_0_tpu_torch.interop import config_from_fields, loss_from_numpy, result_to_numpy
from moptimizer_0_tpu_torch.registration import _median, icp
from moptimizer_0_tpu_torch.utils.pointcloud import load_txt_cloud

FACHADA = pathlib.Path(__file__).parent / "data" / "fachada.txt"
X_TRUE = np.array([0.4, -0.3, 0.2, 0.05, -0.04, 0.06])


@pytest.fixture(scope="module")
def scene():
    cloud = load_txt_cloud(FACHADA)[::16]
    T = np.array(jse3.transform_from_params6(jnp.asarray(X_TRUE)))
    tgt = cloud @ T[:3, :3].T + T[:3, 3]
    tgt = tgt[np.random.default_rng(0).permutation(len(tgt))]
    return cloud, tgt


def _flatten(trace, prefix=""):
    out = {}
    for k, v in trace.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "geman_mcclure_gated"])
def test_icp_matches_jax_iteration_for_iteration(scene, gated):
    src, tgt = scene
    cfg = JLMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")

    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    x0 = jnp.zeros(6).at[0:3].set(jnp.median(jtgt, axis=0) - jnp.median(jsrc, axis=0))
    jkw = dict(loss=JGemanMcClure(tau=jnp.asarray(1.0)), max_corr_dist=1.0) if gated else {}
    blk = _icp_block_with_searcher(
        jsrc, jtgt, lambda w: _nn_pallas_vpu(w, jtgt, interpret=True), **jkw
    )
    j = jlm(jproblem(blk), x0, cfg)

    tkw = (
        dict(loss=loss_from_numpy("GemanMcClure", {"tau": np.asarray(1.0)}), max_corr_dist=1.0)
        if gated
        else {}
    )
    t = result_to_numpy(
        icp(torch.as_tensor(src), torch.as_tensor(tgt), config=config_from_fields(dataclasses.asdict(cfg)), **tkw)
    )

    assert int(t["status"]) == int(j.status) == 0  # CONVERGED
    assert int(t["iterations"]) == int(j.iterations)
    np.testing.assert_allclose(t["x"], np.asarray(j.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t["x"], X_TRUE, atol=1e-9)
    jt, tt = _flatten(j.trace), _flatten(t["trace"])
    assert sorted(jt) == sorted(tt)
    scale = 1e-15 * float(jt["cost"][0])
    for k in jt:
        if jt[k].dtype == bool:
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(tt[k]), np.isnan(jt[k]), err_msg=k)
            np.testing.assert_allclose(tt[k], jt[k], rtol=1e-9, atol=scale, err_msg=k)


def test_centroid_seed_is_the_median_of_jax():
    """torch.median takes the lower middle value of an even count; the seed
    averages the two middle values as jnp.median does."""
    rng = np.random.default_rng(1)
    for n in (6, 7, 1832):
        a = rng.normal(size=(n, 3))
        np.testing.assert_array_equal(
            _median(torch.as_tensor(a)).numpy(), np.asarray(jnp.median(jnp.asarray(a), axis=0))
        )


def test_icp_float32_recovers_the_transform(scene):
    """The precision the GPU path runs in."""
    src, tgt = scene
    res = icp(torch.as_tensor(src, dtype=torch.float32), torch.as_tensor(tgt, dtype=torch.float32))
    assert res.x.dtype == torch.float32
    assert int(res.status) != 3  # not NUMERIC_ERROR
    np.testing.assert_allclose(res.x.numpy(), X_TRUE, atol=2e-3)
