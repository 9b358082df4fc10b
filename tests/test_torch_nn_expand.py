"""The plain expansion search of the port against the TPU kernel K6.

``_nn_expand_torch`` is held against ``_nn_pallas`` (K6) run in interpret
mode and against ``_nn_xla``, the expansion that the JAX package's fleet ICP
runs. Indices must be equal. d² is held to 8·2⁻²⁴·(‖q‖² + ‖p‖²): the
expansion cancels, so its roundoff scales with the squared norms, not with
d², and the three sum the cross term in different orders. A numpy version
that rounds each float32 operation in the port's order must match d² bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops.nn_search import _nn_pallas, _nn_xla
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.ops.nn_search import _nn_expand_torch, _nn_torch, nearest_neighbors
from moptimizer_0_tpu_torch.registration import make_searcher

EPS32 = 2.0**-24


def _numpy_expand(q, p):
    q = q.astype(np.float32)
    p = p.astype(np.float32)
    qn = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    pn = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    cross = (q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1]) + q[:, None, 2] * p[None, :, 2]
    d2 = (qn[:, None] - np.float32(2.0) * cross) + pn[None, :]
    d2[np.isnan(d2)] = np.inf
    return d2.argmin(1), d2.min(1)


def _bound(q, p, idx):
    """8·2⁻²⁴·(‖q‖² + ‖p_idx‖²) per query."""
    q = q.astype(np.float64)
    p = p.astype(np.float64)
    return 8 * EPS32 * ((q * q).sum(-1) + (p[idx] * p[idx]).sum(-1))


def _check_against_jax(q, p):
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    idx, d2 = idx.numpy(), d2.numpy()
    n_idx, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(idx, n_idx)
    np.testing.assert_array_equal(d2, n_d2)
    bound = _bound(q, p, idx)
    for name, (j_idx, j_d2) in {
        "pallas": _nn_pallas(jnp.asarray(q), jnp.asarray(p), block_q=256, block_p=512, interpret=True),
        "xla": _nn_xla(jnp.asarray(q), jnp.asarray(p)),
    }.items():
        np.testing.assert_array_equal(idx, np.asarray(j_idx), err_msg=name)
        assert (np.abs(d2 - np.asarray(j_d2)) <= bound).all(), name
    return idx, d2


@pytest.mark.parametrize(
    "n_query,n_points",
    [
        (600, 1100),
        (33, 77),  # ragged against every tile
        (129, 2049),  # one past the CUDA kernel's 128-thread block and 2048-point tile
    ],
)
def test_nn_expand_torch_matches_pallas_and_xla(n_query, n_points):
    rng = np.random.default_rng(n_query + n_points)
    q = rng.uniform(0, 10, (n_query, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (n_points, 3)).astype(np.float32)
    _check_against_jax(q, p)


def test_nn_expand_lanes_search_only_their_own_points():
    """B = 3 lanes of different clouds of one shape: each lane equals its
    own single search, and a lane offset error would pick another lane's
    indices or distances."""
    rng = np.random.default_rng(7)
    q = rng.uniform(0, 10, (3, 200, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (3, 300, 3)).astype(np.float32)
    p[1] += 50.0  # lane 1's targets far from the others
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.shape == d2.shape == (3, 200)
    for b in range(3):
        i1, d1 = _nn_expand_torch(torch.as_tensor(q[b]), torch.as_tensor(p[b]))
        torch.testing.assert_close(idx[b], i1, rtol=0, atol=0)
        torch.testing.assert_close(d2[b], d1, rtol=0, atol=0)
        j_idx, _ = _nn_xla(jnp.asarray(q[b]), jnp.asarray(p[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
    assert float(d2[1].min()) > 1000.0  # lane 1 saw only its own, distant targets


def test_nn_expand_chunks_agree_with_one_block(monkeypatch):
    """The chunked plain version gives the same result as one block."""
    rng = np.random.default_rng(8)
    q = torch.as_tensor(rng.uniform(-5, 5, (2, 130, 3)), dtype=torch.float32)
    p = torch.as_tensor(rng.uniform(-5, 5, (2, 70, 3)), dtype=torch.float32)
    whole = _nn_expand_torch(q, p)
    monkeypatch.setattr("moptimizer_0_tpu_torch.ops.nn_search._CHUNK_ELEMS", 2 * 70 * 9)
    chunked = _nn_expand_torch(q, p)
    torch.testing.assert_close(whole, chunked, rtol=0, atol=0)


def test_nn_expand_ties_go_to_the_smallest_index():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    p = np.concatenate([base, base, base])  # every target three times
    q = np.concatenate([base[:50], rng.uniform(0, 10, (70, 3)).astype(np.float32)])
    idx, _ = _check_against_jax(q, p)
    assert (idx < len(base)).all()
    np.testing.assert_array_equal(idx[:50], np.arange(50))


def test_nn_expand_nan_query_and_the_routes():
    """A NaN query gives (0, +inf) in the port and in the Pallas kernel;
    ``_nn_xla`` gives (0, NaN). Both are invalid under either gate rule
    (d² < mcd², isfinite), so the fleet's correspondences agree."""
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    q[7] = np.nan
    q[11, 1] = np.nan
    p = rng.uniform(0, 10, (90, 3)).astype(np.float32)
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    n_idx, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(idx.numpy(), n_idx)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    j_idx, j_d2 = _nn_pallas(jnp.asarray(q), jnp.asarray(p), block_q=256, block_p=512, interpret=True)
    x_idx, x_d2 = _nn_xla(jnp.asarray(q), jnp.asarray(p))
    for row in (7, 11):
        assert int(idx[row]) == int(j_idx[row]) == int(x_idx[row]) == 0
        assert float(d2[row]) == float(j_d2[row]) == np.inf
        assert np.isnan(float(x_d2[row]))
        for value in (float(d2[row]), float(x_d2[row])):
            assert not value < 1.0**2 and not np.isfinite(value)


def test_nn_expand_d2_is_not_clamped():
    """A query on a target far from the origin: the expansion's d² may be
    slightly negative, and stays so, as in the JAX package."""
    p = np.array([[100.0, 100.0, 100.0], [0.0, 0.0, 0.0]], np.float32)
    q = (p[:1] + np.float32(1e-3)).astype(np.float32)
    _, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    _, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    assert abs(float(d2[0]) - 3e-6) > 1e-4  # roundoff of ε·(‖q‖² + ‖p‖²), far above d²


def test_expansion_backend_routing():
    q = torch.rand(10, 3)
    p = torch.rand(20, 3)
    before = k_expand.LAUNCHES
    torch.testing.assert_close(nearest_neighbors(q, p, backend="xla"), _nn_expand_torch(q, p), rtol=0, atol=0)
    torch.testing.assert_close(nearest_neighbors(q, p), _nn_torch(q, p), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_neighbors(q, p, backend="pallas_mxu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_expand.nn_expand_cuda(q[None], p[None])
    searcher = make_searcher(p, "xla", None)
    torch.testing.assert_close(searcher(q), _nn_expand_torch(q, p), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        make_searcher(p, "pallas_mxu", None)(q)
    assert k_expand.LAUNCHES == before
    assert k_expand._launcher.cache_info().currsize == 0
