"""Preconditioned conjugate gradients, with the JAX package's stopping test.

The JAX package's ``_pcg`` is a ``lax.while_loop`` that tests ‖r‖² > tol²
before every iteration. Under a CUDA-graph capture (``ops.device_loop``)
each iteration is the body of an IF node on that test: the device decides,
and an iteration past it is skipped. Run eagerly, a host read at every
iteration would stop the device once an iteration, so the test is read every
``check`` iterations; once it fails, the iterations up to the next read are
computed and discarded (x, r, p and rz are frozen by ``torch.where``). Both
give the x of a test at every iteration, bit for bit. The BA CG engines and
the pose graph's CG solve share it.

Every iteration body starts with the marker ``pcg_iteration``
(``utils.tracing.mark``); with a ``count`` the iterations that ran are
added to it on the device: under capture by that marker (one graph node an
iteration does both), eagerly by adding the test's flag, so the iterations
computed past the test and discarded do not count.
"""

import torch

from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.utils import tracing

# iterations between two host reads of the stopping test
CHECK = 32


def pcg(matvec, b, precond, iters, tol, read, check=CHECK, count=None):
    """x ≈ A⁻¹ b from x = 0 by at most ``iters`` iterations, stopping when
    ‖r‖² ≤ tol². matvec(u) = A·u and precond(u) = M⁻¹·u on tensors shaped
    like b; ``read(flag)`` brings a 0-dim bool to the host (the caller
    counts it). Both divisions are guarded by the dtype's ``tiny``.
    count: a 0-dim int32 tensor on b's device to which the iterations that
    ran are added (module docstring), or None."""
    tiny = torch.full((), torch.finfo(b.dtype).tiny, dtype=b.dtype, device=b.device)
    tol_sq = tol * tol

    def advance(x, r, p, rz):
        """One iteration's (x, r, p, rz)."""
        Ap = matvec(p)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.maximum(rz, tiny)
        return x + alpha * p, r_n, z + beta * p, rz_n

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    active = torch.sum(r * r) > tol_sq
    if device_loop.tracing():
        state = (x, r.clone(), p.clone(), rz)

        def iteration():
            tracing.mark("pcg_iteration", b, count)
            for old, new in zip(state, advance(*state)):
                old.copy_(new)
            active.copy_(torch.sum(state[1] * state[1]) > tol_sq)

        for _ in range(iters):
            device_loop.cond(active, iteration)
        return x
    for k in range(iters):
        if k % check == 0 and not read(active):
            break
        tracing.mark("pcg_iteration", b)
        if count is not None:
            count += active
        x, r, p, rz = (torch.where(active, new, old) for new, old in zip(advance(x, r, p, rz), (x, r, p, rz)))
        active = active & (torch.sum(r * r) > tol_sq)
    return x
