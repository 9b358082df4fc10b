"""Cross-check the LM solver against SciPy's independent implementation.

The reference keeps Ceres comparison programs beside its tests; this script
is the same idea with SciPy as the external oracle: it runs
``scipy.optimize.least_squares`` (its trust-region LM, 'lm' → MINPACK) on
the reference workloads and compares the minima with ours, in float64.

    python -m moptimizer_0_tpu_torch.examples.cross_check_scipy
"""

import numpy as np
import scipy.optimize
import torch

from moptimizer_0_tpu_torch import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.core.residual import make_block, problem
from moptimizer_0_tpu_torch.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_0_tpu_torch.models.powell import powell_block
from moptimizer_0_tpu_torch.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_0_tpu_torch.utils.device import require


def check(name, ours, scipys, tol):
    ours = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    diff = float(np.max(np.abs(ours - np.asarray(scipys))))
    flag = "OK " if diff < tol else "FAIL"
    print(f"[{flag}] {name}: ours={ours} scipy={np.asarray(scipys)} max|Δ|={diff:.2e} (tol {tol:g})")
    return diff < tol


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


def curve_fitting(dev):
    """Exponential fit on the 67-observation Ceres dataset."""
    data = np.asarray(CERES_CURVE_DATA, dtype=np.float64)
    blk = make_block(lambda x, d: torch.stack([d[1] - torch.exp(x[0] * d[0] + x[1])]), data=_t(data, dev))
    res = levenberg_marquardt(problem(blk), _t(np.zeros(2), dev), LMConfig())
    sp = scipy.optimize.least_squares(
        lambda x: data[:, 1] - np.exp(x[0] * data[:, 0] + x[1]), np.zeros(2), method="lm"
    )
    return check("curve fitting", res.x, sp.x, 1e-6)


def powell(dev):
    """Powell's singular function (x0 = (3, −1, 0, 4), 25 iterations,
    minimum 0 ± 5e-5)."""
    res = levenberg_marquardt(problem(powell_block()), _t([3.0, -1.0, 0.0, 4.0], dev), LMConfig(max_iterations=25))

    def f(x):
        return np.array([
            x[0] + 10.0 * x[1],
            np.sqrt(5.0) * (x[2] - x[3]),
            (x[1] - 2.0 * x[2]) ** 2,
            np.sqrt(10.0) * (x[0] - x[3]) ** 2,
        ])

    sp = scipy.optimize.least_squares(f, np.array([3.0, -1.0, 0.0, 4.0]), method="lm", xtol=1e-15, ftol=1e-15)
    # both converge toward the singular minimum at 0: compare to 0, the known
    # analytic answer, at each solver's own achievable tolerance
    ok1 = check("powell (ours vs 0)", res.x, np.zeros(4), 5e-5)
    ok2 = check("powell (scipy vs 0)", sp.x, np.zeros(4), 5e-3)
    return ok1 and ok2


def rational(dev):
    """The rational model on the reference's 7-point dataset (minimum ≈
    (0.362, 0.556))."""
    x_data, y_data = np.asarray(SIMPLE_X), np.asarray(SIMPLE_Y)
    res = levenberg_marquardt(
        problem(rational_block(_t(x_data, dev), _t(y_data, dev))), _t([0.9, 0.8], dev), LMConfig(max_iterations=25)
    )
    sp = scipy.optimize.least_squares(
        lambda x: y_data - x[0] * x_data / (x[1] + x_data), np.array([0.9, 0.8]), method="lm"
    )
    return check("rational model", res.x, sp.x, 1e-5)


def main(device="cuda"):
    """The three checks on ``device``; returns 0 when all agree, else 1."""
    dev = require(device)
    ok = all([curve_fitting(dev), powell(dev), rational(dev)])
    print("cross-check:", "ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
