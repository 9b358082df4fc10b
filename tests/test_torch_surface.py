"""The port's surface statistics (``ops/surface.py``, with ``ops/nn_search.knn``)
against the JAX package's, float64 on 500–2,000-point clouds with no
duplicate points.

Both ``knn`` search in float32 by the expansion ‖q‖² − 2q·p + ‖p‖², whose
cross term JAX sums in a matrix product and the port elementwise: the d²
differ by float32 roundoff of ‖q‖² + ‖p‖², so the neighbour sets are held
equal (these clouds have no near-tie at the k-th neighbour) and d² to that
roundoff. The PCA runs in float64 over the same sets: eigenvalues and
covariances to atol 1e-12; normals up to sign (|n·n′| ≥ 1 − 1e-12), since
each eigensolver picks its own signs (LAPACK in JAX, Jacobi in the port),
and with ``orient_to`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops import surface as J
from moptimizer_0_tpu.ops.nn_search import knn as jknn
from moptimizer_0_tpu_torch.ops import surface as P
from moptimizer_0_tpu_torch.ops.nn_search import knn
from test_slam_sequence import make_world

ATOL = 1e-12


def _plane(n=2000, seed=20):
    """tests/test_registration.py's tilted plane z = 0.3x + 0.1y, jittered."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, size=(n, 2))
    return np.column_stack([xy, 0.3 * xy[:, 0] + 0.1 * xy[:, 1] + 0.001 * rng.normal(size=n)])


CLOUDS = {
    "uniform_500": lambda: np.random.default_rng(1).uniform(-5, 5, (500, 3)),
    "plane_2000": _plane,
    "courtyard_1500": lambda: make_world(np.random.default_rng(42), 1500),
}


@pytest.fixture(scope="module", params=sorted(CLOUDS))
def cloud(request):
    c = CLOUDS[request.param]()
    assert len(np.unique(c, axis=0)) == len(c)
    return c


@pytest.mark.parametrize("k", [8, 10])
def test_knn_matches_jax(cloud, k):
    ji, jd = jknn(jnp.asarray(cloud), jnp.asarray(cloud), k)
    ti, td = knn(torch.as_tensor(cloud), torch.as_tensor(cloud), k)
    assert ti.shape == (len(cloud), k) and ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(np.sort(ti.numpy(), axis=1), np.sort(np.asarray(ji), axis=1))
    scale = np.abs(cloud).max() ** 2  # the expansion's float32 roundoff scale
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=8 * 2.0**-23 * scale)
    assert np.all(np.diff(td.numpy(), axis=1) >= 0)  # nearest first


def test_neighborhood_pca_matches_jax(cloud):
    jw, jv = J.neighborhood_pca(jnp.asarray(cloud), 10)
    tw, tv = P.neighborhood_pca(torch.as_tensor(cloud), 10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=ATOL)
    # each eigenvector up to its sign, where its eigenvalue is simple
    dots = np.abs(np.einsum("nik,nik->nk", tv.numpy(), np.asarray(jv)))
    gap = np.diff(np.asarray(jw), axis=1)
    simple = np.column_stack([gap[:, 0], np.minimum(gap[:, 0], gap[:, 1]), gap[:, 1]]) > 1e-6
    assert np.all(dots[simple] >= 1 - ATOL)


def test_estimate_normals_match_jax_up_to_sign(cloud):
    jn = np.asarray(J.estimate_normals(jnp.asarray(cloud), k=10))
    tn = P.estimate_normals(torch.as_tensor(cloud), k=10).numpy()
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=ATOL)
    assert np.all(np.abs(np.sum(tn * jn, axis=1)) >= 1 - ATOL)


def test_estimate_normals_oriented_match_jax_exactly(cloud):
    vp = [0.0, 0.0, 100.0]
    jn = np.asarray(J.estimate_normals(jnp.asarray(cloud), k=10, orient_to=vp))
    tn = P.estimate_normals(torch.as_tensor(cloud), k=10, orient_to=vp).numpy()
    np.testing.assert_allclose(tn, jn, rtol=0, atol=ATOL)


@pytest.mark.parametrize("epsilon", [1e-3, 0.05])
def test_gicp_covariances_match_jax(cloud, epsilon):
    jc = np.asarray(J.gicp_covariances(jnp.asarray(cloud), k=10, epsilon=epsilon))
    tc = P.gicp_covariances(torch.as_tensor(cloud), k=10, epsilon=epsilon).numpy()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=ATOL)


def test_plane_normals_and_covariances():
    """tests/test_registration.py's plane: oriented PCA normals along its
    true normal, and the covariance's smallest eigenpair (ε, the normal)."""
    cloud = torch.as_tensor(_plane())
    n_true = np.array([-0.3, -0.1, 1.0]) / np.linalg.norm([-0.3, -0.1, 1.0])
    normals = P.estimate_normals(cloud, k=12, orient_to=[0, 0, 100.0]).numpy()
    assert np.mean(normals @ n_true > 0.99) > 0.95
    w, v = np.linalg.eigh(P.gicp_covariances(cloud, k=12, epsilon=1e-3).numpy()[0])
    np.testing.assert_allclose(w[0], 1e-3, rtol=1e-3)
    assert abs(v[:, 0] @ n_true) > 0.99


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 4e-6)])
def test_jacobi_eigh_matches_lapack(dtype, tol):
    """_eigh_sym3 against numpy's LAPACK on random scatter matrices, flat
    ones (a plane's) and degenerate ones (a multiple eigenvalue): the
    eigenvalues to tol·‖C‖, orthonormal eigenvectors that rebuild C, and
    the eigenvector of every simple eigenvalue up to its sign."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3000, 10, 3)) * np.array([1.0, 0.5, 1e-3])
    X = X @ np.linalg.qr(rng.normal(size=(3000, 3, 3)))[0]
    C = X.transpose(0, 2, 1) @ X / 10
    C[:50] = np.eye(3)
    C[50:100] = np.diag([1.0, 1.0, 2.0])
    C[100:150] = 0.0
    w, V = P._eigh_sym3(torch.as_tensor(C, dtype=dtype))
    assert w.dtype == V.dtype == dtype
    w, V = w.double().numpy(), V.double().numpy()
    wl, Vl = np.linalg.eigh(C)
    scale = np.abs(C).max(axis=(1, 2), keepdims=True)[:, :, 0]
    assert np.all(np.abs(w - wl) <= tol * np.maximum(scale, 1e-300))
    np.testing.assert_allclose(V.transpose(0, 2, 1) @ V, np.broadcast_to(np.eye(3), C.shape), atol=4 * tol)
    np.testing.assert_allclose(V @ (w[:, :, None] * V.transpose(0, 2, 1)), C, atol=4 * tol * scale.max())
    gap = np.diff(wl, axis=1)
    simple = np.column_stack([gap[:, 0], np.minimum(gap[:, 0], gap[:, 1]), gap[:, 1]]) > 1e-3 * scale
    dots = np.abs(np.einsum("nik,nik->nk", V, Vl))
    assert np.all(dots[simple] >= 1 - 1e3 * tol)
