"""The one-hot segment ops (``ops/segmented.py``) against the JAX
package's, on the same seeded numpy inputs in float64: the sums and the
gather to rtol 1e-12 (one matrix product each, summed in another order by
each library), ``required_span`` exactly; the sorted sum also with ids
that leave segments empty and a span that drops rows, where both packages
drop the same ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops import segmented as jax_segmented
from moptimizer_0_tpu_torch.ops import segmented

RTOL = 1e-12


def _both(rng, shape):
    x = rng.normal(size=shape)
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("O,C,tail", [(5000, 64, (2, 3)), (777, 5, ()), (40, 300, (6,))],
                         ids=["5000x64", "777x5", "40x300"])
def test_segment_sum_onehot(O, C, tail):
    rng = np.random.default_rng(O + C)
    jv, tv = _both(rng, (O,) + tail)
    ids = rng.integers(0, C, O)
    want = np.asarray(jax_segmented.segment_sum_onehot(jv, jnp.asarray(ids), C))
    got = segmented.segment_sum_onehot(tv, torch.as_tensor(ids), C).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("C,O", [(64, 5000), (7, 31)], ids=["64x5000", "7x31"])
def test_gather_onehot(C, O):
    rng = np.random.default_rng(C * O)
    jt, tt = _both(rng, (C, 6))
    ids = rng.integers(0, C, O)
    want = np.asarray(jax_segmented.gather_onehot(jt, jnp.asarray(ids)))
    got = segmented.gather_onehot(tt, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got, tt.numpy()[ids])


@pytest.mark.parametrize("O,L,tile,span", [(50_000, 5_000, 4096, None), (777, 50, 256, None), (6, 12, 4, 16),
                                           (3000, 3000, 512, 64)],
                         ids=["50000-4096", "777-256", "empty-segments", "span-drops-rows"])
def test_segment_sum_sorted(O, L, tile, span):
    rng = np.random.default_rng(O + L + tile)
    ids = np.array([1, 1, 4, 4, 4, 9]) if O == 6 else np.sort(rng.integers(0, L, O))
    jv, tv = _both(rng, (O, 4))
    need = jax_segmented.required_span(ids, tile)
    assert segmented.required_span(ids, tile) == need
    assert segmented.required_span(torch.as_tensor(ids), tile) == need
    span = max(128, need) if span is None else span
    want = np.asarray(jax_segmented.segment_sum_sorted(jv, jnp.asarray(ids), L, tile=tile, span=span))
    got = segmented.segment_sum_sorted(tv, torch.as_tensor(ids), L, tile=tile, span=span).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    if span < need:  # rows dropped: not the full segment sum
        full = np.zeros((L, 4))
        np.add.at(full, ids, tv.numpy())
        assert not np.allclose(got, full)
