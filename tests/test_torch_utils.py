"""The port's ``utils`` against the JAX package's, in float64 on the CPU.

Checkpoints are exchanged between the packages (same archive layout, same
leaf paths); ``format_trace`` and ``roofline`` are compared as text and
numbers on the same inputs, equal. ``checked_linearize`` must name the same
non-finite output as JAX's.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu import levenberg_marquardt as j_lm
from moptimizer_0_tpu.core.residual import make_block as j_make_block
from moptimizer_0_tpu.core.residual import problem as j_problem
from moptimizer_0_tpu.models.rational import rational_block as j_rational_block
from moptimizer_0_tpu.utils import checkpoint as j_checkpoint
from moptimizer_0_tpu.utils.checks import checked_linearize as j_checked_linearize
from moptimizer_0_tpu.utils.logging import format_trace as j_format_trace
from moptimizer_0_tpu.utils.profiling import roofline as j_roofline
from moptimizer_0_tpu_torch.core.linearize import linearize
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, LMResult, levenberg_marquardt
from moptimizer_0_tpu_torch.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_0_tpu_torch.utils import Logger, Stopwatch, checkpoint, format_trace, time_fn
from moptimizer_0_tpu_torch.utils.checks import checked_linearize
from moptimizer_0_tpu_torch.utils.logging import L_DEBUG, L_ERROR
from moptimizer_0_tpu_torch.utils.profiling import benchmark, roofline, trace


@pytest.fixture(scope="module")
def solves():
    """The reference's rational fit by both packages (trace_block_costs on)."""
    j_res = j_lm(j_problem(j_rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)), jnp.array([0.9, 0.2]),
                 JLMConfig(trace_block_costs=True))
    t_res = levenberg_marquardt(problem(rational_block(SIMPLE_X, SIMPLE_Y, dtype=torch.float64)),
                                torch.tensor([0.9, 0.2], dtype=torch.float64), LMConfig(trace_block_costs=True))
    return j_res, t_res


def _as_port_result(j_res):
    def t(v):
        return {k: t(u) for k, u in v.items()} if isinstance(v, dict) else torch.as_tensor(np.array(v))

    return LMResult(**{f.name: t(getattr(j_res, f.name)) for f in dataclasses.fields(j_res)})


def test_checkpoint_round_trip_and_mismatch(tmp_path, solves):
    _, res = solves
    path = tmp_path / "state.npz"
    checkpoint.save(path, res)
    template = LMResult(**{
        f.name: (
            {k: (torch.zeros_like(v) if not isinstance(v, dict) else {q: torch.zeros_like(u) for q, u in v.items()})
             for k, v in res.trace.items()}
            if f.name == "trace" else torch.zeros_like(getattr(res, f.name))
        )
        for f in dataclasses.fields(res)
    })
    restored = checkpoint.load(path, template)
    for f in dataclasses.fields(res):
        if f.name != "trace":
            assert torch.equal(getattr(restored, f.name), getattr(res, f.name)), f.name
            assert getattr(restored, f.name).dtype == getattr(res, f.name).dtype
    assert torch.equal(restored.trace["inner"]["rho"].nan_to_num(), res.trace["inner"]["rho"].nan_to_num())
    assert list(restored.trace) == list(res.trace)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load(path, {"wrong": torch.zeros(2)})
    tree = {"b": (torch.zeros(3), None), "a": torch.ones(2)}
    checkpoint.save(tmp_path / "tree.npz", tree)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(tmp_path / "tree.npz", {"b": (torch.zeros(4), None), "a": torch.ones(2)})
    back = checkpoint.load(tmp_path / "tree.npz", tree)
    assert list(back) == ["b", "a"] and back["b"][1] is None


def test_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s) for s in ((2, 3), (4,), (1,))]
    j_tree = {"z": jnp.asarray(arrays[0]), "a": (jnp.asarray(arrays[1]), {"k": jnp.asarray(arrays[2])})}
    t_tree = {"z": torch.as_tensor(arrays[0]), "a": (torch.as_tensor(arrays[1]), {"k": torch.as_tensor(arrays[2])})}
    j_checkpoint.save(tmp_path / "j.npz", j_tree)
    got = checkpoint.load(tmp_path / "j.npz", jax.tree_util.tree_map(torch.zeros_like, t_tree,
                                                                     is_leaf=lambda v: isinstance(v, torch.Tensor)))
    np.testing.assert_array_equal(got["a"][1]["k"].numpy(), arrays[2])
    checkpoint.save(tmp_path / "t.npz", t_tree)
    back = j_checkpoint.load(tmp_path / "t.npz", jax.tree_util.tree_map(jnp.zeros_like, j_tree))
    np.testing.assert_array_equal(np.asarray(back["z"]), arrays[0])
    with np.load(tmp_path / "j.npz", allow_pickle=True) as a, np.load(tmp_path / "t.npz", allow_pickle=True) as b:
        assert list(a["__keys__"]) == list(b["__keys__"])


# (message, JAX residual, port residual): a NaN cost from log of a negative
# number; a finite cost (r = √(0·x₀) = 0) with an infinite derivative
NON_FINITE = [
    ("non-finite cost", lambda x, d: jnp.array([jnp.log(x[0] * d[0] - 10.0)]),
     lambda x, d: torch.log(x[0:1] * d[0] - 10.0)),
    ("non-finite Hessian", lambda x, d: jnp.array([jnp.sqrt(0.0 * x[0] * d[0])]),
     lambda x, d: torch.sqrt(0.0 * x[0:1] * d[0])),
]


@pytest.mark.parametrize("message,j_fn,t_fn", NON_FINITE, ids=["cost", "hessian"])
def test_checked_linearize_names_the_output_like_jax(message, j_fn, t_fn):
    data = np.random.default_rng(0).random((5, 2))
    with pytest.raises(Exception, match=message):
        j_checked_linearize(j_problem(j_make_block(j_fn, data=jnp.asarray(data))), jnp.ones(2))
    with pytest.raises(ValueError, match=message):
        checked_linearize(make_block(t_fn, data=torch.as_tensor(data)), torch.ones(2, dtype=torch.float64))
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=torch.float64)
    x = torch.tensor([0.9, 0.2], dtype=torch.float64)
    for a, b in zip(checked_linearize(problem(blk), x), linearize(problem(blk), x)):
        assert torch.equal(a, b)


def test_format_trace_matches_jax(solves):
    j_res, t_res = solves
    text = format_trace(_as_port_result(j_res))
    assert text == j_format_trace(j_res)
    assert "block_costs" in text and len(text.splitlines()) == int(j_res.iterations) + 2
    assert format_trace(_as_port_result(j_res), max_rows=2) == j_format_trace(j_res, max_rows=2)
    assert format_trace(t_res).splitlines()[0] == text.splitlines()[0]


def test_logger_levels_and_sinks():
    buf, buf2 = io.StringIO(), io.StringIO()
    log = Logger(sink=buf, level=L_ERROR, name="Optimizer")
    log.log(L_DEBUG, "hidden")
    log.log(L_ERROR, "shown", 42)
    assert "hidden" not in buf.getvalue()
    assert "[ERROR] moptimizer::Optimizer:: shown 42" in buf.getvalue()
    log.add_sink(buf2)
    log.log(L_ERROR, "both")
    assert "both" in buf.getvalue() and "both" in buf2.getvalue()


def test_stopwatch_and_timers(tmp_path):
    sw = Stopwatch()
    with pytest.raises(RuntimeError, match="tick"):
        sw.tock()
    sw.tick()
    assert sw.tock() >= 0.0
    assert time_fn(lambda x: x * 2, torch.ones(8), iters=3, warmup=1) >= 0.0
    out = benchmark(lambda x: x @ x, torch.ones(16, 16), iters=3, warmup=1, flops=2 * 16**3, bytes_accessed=2048)
    assert out["clock"] == "host" and out["seconds"] > 0 and out["gflops_per_sec"] > 0
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "prof" / "trace.json").is_file() and len(prof.key_averages()) > 0


@pytest.mark.parametrize("flops,n_bytes", [(2e9, 0.0), (0.0, 4e8), (6e9, 5e8)])
def test_roofline_arithmetic_matches_jax(flops, n_bytes):
    peaks = dict(peak_flops=1e12, peak_bw=2e11)
    assert roofline(0.01, flops=flops, bytes_accessed=n_bytes, **peaks) == j_roofline(
        0.01, flops=flops, bytes_accessed=n_bytes, **peaks
    )
    h100 = roofline(1e-3, flops=67e9, bytes_accessed=3.35e9)
    assert h100["frac_of_peak_flops"] == pytest.approx(1.0) and h100["frac_of_peak_bw"] == pytest.approx(1.0)
