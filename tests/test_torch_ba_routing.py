"""engine="auto" routing and the engines behind solve_ba, against the JAX
package's: the routing tests of tests/test_ba_dense.py and
tests/test_ba_dense_segmented.py on the same problems (float64, CPU).
Routing is host arithmetic on the incidence, so the decisions and the
estimates are equal; "auto" and "dense" run solve_ba_dense bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import ba as jba
from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu_torch import ba as tba
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch import interop

from test_ba import make_synthetic_ba
from test_ba_dense import make_hub_ba
from test_torch_ba_cg import port


# the problems of tests/test_ba_dense.py's and tests/test_ba_dense_segmented.py's
# routing tests
ROUTING = {
    "synthetic": lambda: make_synthetic_ba(C=4, L=30)[0],
    "synthetic_noisy": lambda: make_synthetic_ba(C=5, L=40, noise=0.2, seed=3)[0],
    "hub": make_hub_ba,
    "hub_segmented": lambda: make_hub_ba(C=25, L=2000),
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_select_engine_matches_jax(name):
    jprob = ROUTING[name]()
    expected = {"synthetic": "dense", "synthetic_noisy": "dense", "hub": "cg", "hub_segmented": "dense"}
    assert tba.select_engine(port(jprob)) == jba.select_engine(jprob) == expected[name]


def test_select_engine_oom_guard(monkeypatch):
    """Past DENSE_MAX_BYTES "auto" routes to CG in both packages; the
    constants are the JAX package's."""
    jprob = make_synthetic_ba(C=4, L=30)[0]
    prob = port(jprob)
    for name in ("DENSE_MAX_CAMERAS", "DENSE_MAX_PADDING", "DENSE_MAX_BYTES"):
        assert getattr(tba, name) == getattr(jba, name)
    est = tbd.dense_memory_bytes(prob)
    assert est == jbd.dense_memory_bytes(jprob) == 250.0 * 30 * 4 + 8.0 * (6 * 4) ** 2
    monkeypatch.setattr(tba, "DENSE_MAX_BYTES", est - 1)
    monkeypatch.setattr(jba, "DENSE_MAX_BYTES", est - 1)
    assert tba.select_engine(prob) == jba.select_engine(jprob) == "cg"


def test_engines_and_routes():
    """engine="auto" and "dense" run solve_ba_dense, bit for bit; the CG
    engine reaches the same cost; the hub problem routes to CG and solves;
    an unknown engine raises."""
    start, _ = make_synthetic_ba(C=5, L=24, noise=0.3, seed=17)
    prob = port(start)
    cfg = tba.BAConfig(max_iterations=8)
    res_auto = tba.solve_ba(prob, cfg, engine="auto")
    res_dense = tbd.solve_ba_dense(prob, tbd.DenseBAConfig(max_iterations=8))
    res_cg = tba.solve_ba(prob, cfg, engine="cg")
    assert torch.equal(res_auto.camera_params, res_dense.camera_params)
    assert float(res_auto.cost) <= 1.001 * float(res_cg.cost) + 1e-9
    with pytest.raises(ValueError, match="unknown engine"):
        tba.solve_ba(prob, cfg, engine="bogus")

    hub = make_hub_ba(C=6, L=60)
    hub = dataclasses.replace(
        hub,
        camera_params=hub.camera_params
        + 0.01 * jnp.asarray(np.random.default_rng(0).normal(size=hub.camera_params.shape))
        * (jnp.arange(6) >= 2)[:, None],
    )
    res = tba.solve_ba(port(hub), tba.BAConfig(max_iterations=12), engine="auto")
    assert tba.select_engine(port(hub)) == jba.select_engine(hub)
    assert float(res.cost) < 1e-6
    res = tba.solve_ba(port(hub), tba.BAConfig(max_iterations=12), engine="cg")
    assert float(res.cost) < 1e-6


def test_ba_config_interop():
    jcfg = jba.BAConfig(max_iterations=7, inner_iterations=2, init_lambda_factor=1e-6,
                        cg_iterations=30, cg_tol=1e-9, rel_cost_tol=1e-5)
    tcfg = interop.ba_config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tba.BAConfig()) == dataclasses.asdict(jba.BAConfig())
