"""The port's manifolds, tangent-space linearization and manifold LM against
the JAX package's.

Both packages get the same seeded numpy inputs in float64 on the CPU; the
manifolds cross by ``interop.manifold_from_fields``. Tolerances and why:

* retract and local: 1e-12 relative, 1e-14 absolute: the same closed forms
  (Rodrigues, the quaternion log, the Householder basis) in another
  evaluation order;
* ``linearize_tangent``: cost, H and b to 1e-11 relative to the largest
  entry: forward AD of the same functions, summed in another order;
* LM solves: status and iterations equal, x to 1e-9; the mirrors of
  tests/test_state_model.py keep that file's own bounds.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import LMConfig as JLMConfig
from moptimizer_0_tpu.core import linearize as jlin
from moptimizer_0_tpu.core import manifold as jman
from moptimizer_0_tpu.core import residual as jres
from moptimizer_0_tpu.core import solver as jsol
from moptimizer_0_tpu.models.accelerometer import accelerometer_block as j_accel
from moptimizer_0_tpu.models.state import product_state_block as j_state
from moptimizer_0_tpu_torch import interop
from moptimizer_0_tpu_torch import manifold as tman
from moptimizer_0_tpu_torch.core import linearize as tlin
from moptimizer_0_tpu_torch.core import residual as tres
from moptimizer_0_tpu_torch.core import solver as tsol
from moptimizer_0_tpu_torch.lie import so3
from moptimizer_0_tpu_torch.models.accelerometer import accelerometer_block as t_accel
from moptimizer_0_tpu_torch.models.state import product_state_block as t_state


def port_manifold(jm):
    """The port's copy of a JAX manifold, through interop by class name and
    fields (a Product's parts one by one)."""
    kind = type(jm).__name__
    if kind == "Product":
        return interop.manifold_from_fields(
            kind, {"parts": [(type(p).__name__, dataclasses.asdict(p)) for p in jm.parts]}
        )
    return interop.manifold_from_fields(kind, dataclasses.asdict(jm))


STATE = jman.Product(parts=(jman.SO3(), jman.Euclidean(dim=12)))


def _inputs(jm, rng, case):
    """(x, δ, y) for a manifold: a generic point and step, or a step in
    the small-angle branch, or (Sphere) a point with x[-1] < 0."""
    n, t = jm.dim, jm.tangent_dim
    x = rng.normal(size=n) * 0.5
    d = rng.normal(size=t) * (1e-9 if case == "small" else 0.3)
    if isinstance(jm, jman.Sphere):
        x = x / np.linalg.norm(x)
        x[-1] = -abs(x[-1]) if case == "negative" else abs(x[-1])
    y = np.asarray(jm.retract(jnp.asarray(x), jnp.asarray(rng.normal(size=t) * 0.2)))
    if case == "small":
        y = np.asarray(jm.retract(jnp.asarray(x), jnp.asarray(d)))
    return x, d, y


MANIFOLDS = {
    "euclidean": jman.Euclidean(dim=3),
    "so3": jman.SO3(),
    "se3": jman.SE3(),
    "product": STATE,
    "sphere4": jman.Sphere(dim=4),
    "sphere3": jman.Sphere(dim=3),
}


@pytest.mark.parametrize("case", ["generic", "small", "negative"])
@pytest.mark.parametrize("name", sorted(MANIFOLDS))
def test_retract_and_local_match_jax(name, case):
    jm = MANIFOLDS[name]
    if case == "negative" and not isinstance(jm, jman.Sphere):
        case = "generic"
    tm = port_manifold(jm)
    assert (tm.dim, tm.tangent_dim) == (jm.dim, jm.tangent_dim)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{case}".encode()))
    for _ in range(4):
        x, d, y = _inputs(jm, rng, case)
        jr = np.asarray(jm.retract(jnp.asarray(x), jnp.asarray(d)))
        tr = tm.retract(torch.as_tensor(x), torch.as_tensor(d)).numpy()
        np.testing.assert_allclose(tr, jr, rtol=1e-12, atol=1e-14)
        jl = np.asarray(jm.local(jnp.asarray(x), jnp.asarray(y)))
        tl = tm.local(torch.as_tensor(x), torch.as_tensor(y)).numpy()
        np.testing.assert_allclose(tl, jl, rtol=1e-12, atol=1e-14)


def quat_rot(q, xp):
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return xp.stack([xp.stack(r) for r in rows])


def quaternion_blocks(seed=4, n=12):
    """tests/test_state_model.py's attitude fit: m_i = R(q_true) v_i."""
    rng = np.random.default_rng(seed)
    q_true = rng.normal(size=4)
    q_true /= np.linalg.norm(q_true)
    vs = rng.normal(size=(n, 3))
    ms = vs @ np.asarray(quat_rot(jnp.asarray(q_true), jnp)).T
    jb = jres.make_block(lambda q, d: d["m"] - quat_rot(q, jnp) @ d["v"],
                         data=dict(v=jnp.asarray(vs), m=jnp.asarray(ms)))
    tb = tres.make_block(lambda q, d: d["m"] - quat_rot(q, torch) @ d["v"],
                         data=dict(v=torch.as_tensor(vs), m=torch.as_tensor(ms)))
    return tb, jb, q_true


STATE_ANCHOR = (np.array([0.1, 0.2, 0.3]), np.concatenate([[-0.4, 0.11, -0.9], np.zeros(9)]))


@pytest.mark.parametrize(
    "case,mode",
    [("state", "auto"), ("state", "fd"), ("sphere", "auto"), ("sphere", "fd"),
     ("accelerometer", "auto"), ("accelerometer", "fd"), ("accelerometer", "analytic")],
)
def test_linearize_tangent_matches_jax(case, mode):
    """JAX's quirks kept: "analytic" takes the block's x-Jacobian as it
    stands, every other mode ("fd" too) differentiates r(retract(x, δ)) by
    AD at δ = 0."""
    rng = np.random.default_rng(7)
    if case == "state":
        jm, jb, tb = STATE, j_state(*STATE_ANCHOR), t_state(*STATE_ANCHOR)
        x = np.concatenate([[0.9, -0.8, 0.6], rng.normal(size=12)])
    elif case == "sphere":
        jm = jman.Sphere(dim=4)
        tb, jb, _ = quaternion_blocks()
        x = rng.normal(size=4)
        x /= np.linalg.norm(x)
    else:
        jm = jman.SO3()
        m = np.array([0.3, -2.0, 9.5])
        jb, tb = j_accel(m, analytic=True), t_accel(m, analytic=True)
        x = np.array([0.1, -0.05, 0.2])
    tm = port_manifold(jm)
    jretract = lambda xx, dd: jm.retract(xx, dd)  # noqa: E731
    jretract.tangent_dim = jm.tangent_dim
    tretract = lambda xx, dd: tm.retract(xx, dd)  # noqa: E731
    tretract.tangent_dim = tm.tangent_dim
    j = jax.jit(jlin.linearize_tangent, static_argnums=(2,), static_argnames=("mode",))(
        jres.problem(jb), jnp.asarray(x), jretract, mode=mode
    )
    t = tlin.linearize_tangent(tres.problem(tb), torch.as_tensor(x), tretract, mode=mode)
    for tv, jv in zip(t, j):
        jv = np.asarray(jv)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-11 * max(np.abs(jv).max(), 1e-300))
    assert t[1].shape == (jm.tangent_dim, jm.tangent_dim)


def _same_solve(t, j, x_atol=1e-9):
    assert int(t.status) == int(j.status)
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=x_atol)


def test_product_state_converges_to_anchor():
    """tests/test_state_model.py: fd, no manifold, to its bounds, ending with
    the JAX package's status. Iterations and x are not compared: once the
    linear part nears 0, the fd steps h = √ε·|x_j| shrink with x_j and the
    columns they give are roundoff, different in each package (the second
    outer iteration lands at 2.2e-11 in one and 1.7e-4 in the other)."""
    anchor_rot, anchor_lin = np.array([0.1, 0.2, 0.3]), np.zeros(12)
    x0 = np.concatenate([[0.6, 0.8, 0.3], np.zeros(12)])
    x0[3] = -0.4
    cfg = dict(diff_mode="fd", max_iterations=15)
    t = tsol.levenberg_marquardt(t_state(anchor_rot, anchor_lin), torch.as_tensor(x0), tsol.LMConfig(**cfg))
    j = jsol.levenberg_marquardt(jres.problem(j_state(anchor_rot, anchor_lin)), jnp.asarray(x0), JLMConfig(**cfg))
    np.testing.assert_allclose(so3.exp(t.x[:3]).numpy(), so3.exp(torch.as_tensor(anchor_rot)).numpy(), atol=1e-6)
    np.testing.assert_allclose(t.x[3:].numpy(), anchor_lin, atol=1e-6)
    assert int(t.status) == int(j.status)


def test_manifold_lm_on_product_state():
    """The product-state LM with the Product(SO3, Euclidean(12)) retraction:
    JAX's status, iterations and x, stopping before the noise floor."""
    anchor_rot, anchor_lin = STATE_ANCHOR
    x0 = np.concatenate([[0.9, -0.8, 0.6, 1.5, -2.0, 0.5], np.zeros(9)])
    cfg = dict(diff_mode="auto", max_iterations=20, rel_cost_tol=1e-10)
    t = tsol.levenberg_marquardt(t_state(anchor_rot, anchor_lin), torch.as_tensor(x0),
                                 interop.config_from_fields(cfg), manifold=port_manifold(STATE))
    j = jsol.levenberg_marquardt(jres.problem(j_state(anchor_rot, anchor_lin)), jnp.asarray(x0),
                                 JLMConfig(**cfg), manifold=STATE)
    _same_solve(t, j)
    np.testing.assert_allclose(so3.exp(t.x[:3]).numpy(), so3.exp(torch.as_tensor(anchor_rot)).numpy(), atol=1e-6)
    np.testing.assert_allclose(t.x[3:].numpy(), anchor_lin[:], atol=1e-6)


def test_sphere_quaternion_fit_matches_jax():
    """tests/test_state_model.py's unit-quaternion fit with Sphere(4): unit
    norm kept, q_true recovered up to sign; and JAX's solve."""
    tb, jb, q_true = quaternion_blocks()
    cfg = dict(diff_mode="auto", max_iterations=30, rel_cost_tol=1e-12)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    t = tsol.levenberg_marquardt(tb, torch.as_tensor(q0), interop.config_from_fields(cfg),
                                 manifold=tman.Sphere(dim=4))
    j = jsol.levenberg_marquardt(jres.problem(jb), jnp.asarray(q0), JLMConfig(**cfg), manifold=jman.Sphere(dim=4))
    _same_solve(t, j)
    q = t.x.numpy()
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)
    q = -q if q @ q_true < 0 else q
    np.testing.assert_allclose(q, q_true, atol=1e-8)
    # the plain configuration runs to its noise floor, as the JAX test's
    t = tsol.levenberg_marquardt(tb, torch.as_tensor(q0), tsol.LMConfig(max_iterations=30),
                                 manifold=tman.Sphere(dim=4))
    assert float(t.cost) < 1e-20


def test_manifold_batched_and_multistart_match_jax():
    """levenberg_marquardt_batched with a manifold (retraction lane by lane)
    against JAX's vmapped solve, and solve_multistart's pick."""
    anchor_rot, anchor_lin = STATE_ANCHOR
    rng = np.random.default_rng(3)
    x0 = np.concatenate([rng.normal(size=(3, 3)) * 0.6, rng.normal(size=(3, 12))], axis=1)
    cfg = dict(diff_mode="auto", max_iterations=10, rel_cost_tol=1e-10)
    tb, jb = t_state(anchor_rot, anchor_lin), j_state(anchor_rot, anchor_lin)
    t = tsol.levenberg_marquardt_batched(tb, torch.as_tensor(x0), interop.config_from_fields(cfg),
                                         manifold=port_manifold(STATE), batch_data=False)
    j = jsol.levenberg_marquardt_batched(jres.problem(jb), jnp.asarray(x0), JLMConfig(**cfg),
                                         manifold=STATE, batch_data=False)
    np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)
    best, _ = tsol.solve_multistart(tb, torch.as_tensor(x0), interop.config_from_fields(cfg),
                                    manifold=port_manifold(STATE))
    i = int(np.argmin(np.asarray(j.cost)))
    np.testing.assert_allclose(best.x.numpy(), np.asarray(j.x)[i], rtol=0, atol=1e-9)


def test_euclidean_manifold():
    m = tman.Euclidean(dim=3)
    x = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    d = torch.tensor([0.5, 0.25, -1.0], dtype=torch.float64)
    assert torch.equal(m.retract(x, d), x + d)
    assert torch.equal(m.local(x, x + d), d)


def test_so3_manifold_matches_quaternion_construction():
    """SO(3) ⊞ through exp against the small-angle unit-quaternion rotation
    (tests/test_state_model.py, its bound)."""
    R = so3.exp(tman.SO3().retract(torch.zeros(3, dtype=torch.float64),
                                   torch.tensor([0.02, 0.0, 0.0], dtype=torch.float64)))
    q = np.array([0.01, 0.0, 0.0])
    w = np.sqrt(1 - q @ q)
    R_q = np.asarray(quat_rot(np.array([w, *q]), np))
    np.testing.assert_allclose(R.numpy(), R_q, atol=5e-6)


def test_se3_product_and_sphere_round_trips():
    m = tman.SE3()
    x = torch.tensor([1.0, 2.0, 3.0, 0.3, -0.2, 0.1], dtype=torch.float64)
    d = torch.tensor([0.1, -0.1, 0.2, 0.05, 0.02, -0.03], dtype=torch.float64)
    np.testing.assert_allclose(m.local(x, m.retract(x, d)).numpy(), d.numpy(), atol=1e-10)

    p = port_manifold(STATE)
    assert p.dim == 15 and p.tangent_dim == 15
    d = torch.cat([torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64), torch.ones(12, dtype=torch.float64)])
    y = p.retract(torch.zeros(15, dtype=torch.float64), d)
    assert torch.equal(y[3:], torch.ones(12, dtype=torch.float64))
    np.testing.assert_allclose(p.local(torch.zeros(15, dtype=torch.float64), y).numpy(), d.numpy(), atol=1e-10)

    s = tman.Sphere(dim=4)
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = torch.as_tensor(rng.normal(size=4))
        x = x / torch.linalg.norm(x)
        d = torch.as_tensor(0.3 * rng.normal(size=3))
        y = s.retract(x, d)
        np.testing.assert_allclose(float(torch.linalg.norm(y)), 1.0, atol=1e-12)
        np.testing.assert_allclose(s.local(x, y).numpy(), d.numpy(), atol=1e-9)
    np.testing.assert_allclose(s.retract(x, torch.zeros(3, dtype=torch.float64)).numpy(), x.numpy(), atol=1e-12)
    np.testing.assert_allclose(s.local(x, x).numpy(), 0.0, atol=1e-9)
    import moptimizer_0_tpu_torch as top

    assert top.manifold is tman and top.lie.se3_exp is not None
