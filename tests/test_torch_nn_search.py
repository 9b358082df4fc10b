"""The plain nearest-neighbour search of the port against the TPU kernel K5.

``_nn_torch`` is held against ``_nn_pallas_vpu`` run in interpret mode and
against a numpy argmin. Indices must be equal. The numpy reference rounds
every operation in float32 like ``_nn_torch`` does, so d² is bit-equal to it;
against the interpreted kernel d² is held to rtol 1e-6, since XLA on the CPU
may contract the sum into fused multiply-adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops.nn_search import _nn_pallas_vpu
from moptimizer_0_tpu_torch.ops.nn_search import _nn_torch, nearest_neighbors
from moptimizer_0_tpu_torch.registration import GRID_AUTO_MIN_TARGETS, make_searcher


def _numpy_nn(q, p):
    q = q.astype(np.float32)
    p = p.astype(np.float32)
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    d2 = dx * dx + dy * dy + dz * dz
    d2[np.isnan(d2)] = np.inf
    return d2.argmin(1), d2.min(1)


def _check_all_three(q, p):
    idx, d2 = _nn_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    n_idx, n_d2 = _numpy_nn(q, p)
    np.testing.assert_array_equal(idx.numpy(), n_idx)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    j_idx, j_d2 = _nn_pallas_vpu(jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=1e-6)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize(
    "n_query,n_points",
    [
        (600, 1100),
        (33, 77),
        (513, 4097),  # one past the Pallas kernel's 512×4096 tile
        (129, 2049),  # one past the CUDA kernel's 128-thread block and 2048-point tile
    ],
)
def test_nn_torch_matches_pallas_and_numpy(n_query, n_points):
    rng = np.random.default_rng(n_query + n_points)
    q = rng.uniform(0, 10, (n_query, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (n_points, 3)).astype(np.float32)
    _check_all_three(q, p)


def test_nn_ties_go_to_the_smallest_index():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    p = np.concatenate([base, base, base])  # every target three times
    q = np.concatenate([base[:50], rng.uniform(0, 10, (70, 3)).astype(np.float32)])
    idx, d2 = _check_all_three(q, p)
    assert (idx < len(base)).all()
    np.testing.assert_array_equal(idx[:50], np.arange(50))
    np.testing.assert_array_equal(d2[:50], 0.0)


def test_nn_nan_query_row_gives_index_0_and_inf():
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    q[7] = np.nan
    q[11, 1] = np.nan
    p = rng.uniform(0, 10, (90, 3)).astype(np.float32)
    idx, d2 = _check_all_three(q, p)
    for row in (7, 11):
        assert idx[row] == 0 and d2[row] == np.inf


def test_nn_searches_in_float32_whatever_the_input_dtype():
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 10, (50, 3))
    p = rng.uniform(0, 10, (80, 3))
    i64, d64 = nearest_neighbors(torch.as_tensor(q), torch.as_tensor(p))
    i32, d32 = nearest_neighbors(
        torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(p, dtype=torch.float32)
    )
    assert d64.dtype == torch.float32
    torch.testing.assert_close(i64, i32, rtol=0, atol=0)
    torch.testing.assert_close(d64, d32, rtol=0, atol=0)


def test_nn_backend_routing_and_errors():
    q = torch.rand(10, 3)
    p = torch.rand(20, 3)
    auto = nearest_neighbors(q, p)  # CPU tensors: the plain version
    plain = _nn_torch(q, p)
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_neighbors(q, p, backend="cuda")
    # the expansion: K6 on CUDA tensors only, its plain version under "xla"
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_neighbors(q, p, backend="pallas_mxu")
    xla = nearest_neighbors(q, p, backend="xla")
    torch.testing.assert_close(xla[0], plain[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown"):
        nearest_neighbors(q, p, backend="grid")
    with pytest.raises(ValueError, match="non-empty"):
        nearest_neighbors(q[:0], p)


def test_grid_searcher_is_not_ported_yet():
    p = torch.zeros(GRID_AUTO_MIN_TARGETS, 3)
    with pytest.raises(NotImplementedError, match="grid"):
        make_searcher(p[:100], "grid", 1.0)
    with pytest.raises(NotImplementedError, match="grid"):
        make_searcher(p, "auto", 1.0)  # large gated target: the JAX package routes to the grid
    make_searcher(p, "auto", None)  # ungated stays brute force
