"""The port's entry points run on the card unless the caller asks for the CPU.

``device="cpu"`` or CPU tensors give CPU tensors. The default asks for the
card: with one, the result lies on it; without one, the call raises and
never returns CPU tensors. Whether there is a card is decided inside each
test.
"""

import numpy as np
import pytest
import torch

from moptimizer_0_tpu_torch import ba, interop
from moptimizer_0_tpu_torch.registration import icp, icp_batched
from moptimizer_0_tpu_torch.utils.device import as_input, require


def _on_the_card_or_raises(call, device_of):
    if torch.cuda.is_available():
        assert device_of(call()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _bench_arrays():
    p = ba.make_ba_problem(300, 4, 40, seed=1, dtype=torch.float64, device="cpu")
    keys = ("camera_params", "points", "cam_idx", "pt_idx", "pixels", "intrinsics")
    return {k: getattr(p, k).numpy() for k in keys}


def test_make_ba_problem_defaults_to_the_card():
    cpu = ba.make_ba_problem(300, 4, 40, seed=1, device="cpu")
    assert cpu.points.device.type == "cpu" and cpu.cam_idx.device.type == "cpu"
    _on_the_card_or_raises(lambda: ba.make_ba_problem(300, 4, 40, seed=1), lambda p: p.points.device)


def test_ba_problem_from_numpy_defaults_to_the_card():
    arrays = _bench_arrays()
    cpu = interop.ba_problem_from_numpy(**arrays, device="cpu")
    assert all(getattr(cpu, k).device.type == "cpu" for k in arrays)
    _on_the_card_or_raises(lambda: interop.ba_problem_from_numpy(**arrays), lambda p: p.pixels.device)


def _pair(n=200, seed=2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 5, (n, 3))
    return src, src + np.array([0.05, -0.02, 0.01])


def test_icp_puts_numpy_inputs_on_the_card_and_keeps_tensors_where_they_are():
    src, tgt = _pair()
    res = icp(torch.as_tensor(src), torch.as_tensor(tgt))
    assert res.x.device.type == "cpu"
    _on_the_card_or_raises(lambda: icp(src, tgt), lambda r: r.x.device)
    _on_the_card_or_raises(lambda: icp(src.tolist(), tgt.tolist()), lambda r: r.x.device)


def test_icp_batched_puts_numpy_inputs_on_the_card_and_keeps_tensors_where_they_are():
    pairs = [_pair(seed=s) for s in (3, 4)]
    srcs, tgts = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    res = icp_batched(torch.as_tensor(srcs), torch.as_tensor(tgts))
    assert res.x.device.type == "cpu" and res.x.shape == (2, 6)
    np.testing.assert_allclose(res.x[:, :3].numpy(), [[0.05, -0.02, 0.01]] * 2, atol=1e-9)
    _on_the_card_or_raises(lambda: icp_batched(srcs, tgts), lambda r: r.x.device)


def test_device_helpers():
    t = torch.zeros(2)
    assert as_input(t) is t
    assert as_input(np.ones(2), "cpu").device.type == "cpu"
    assert require("cpu") == torch.device("cpu")
    _on_the_card_or_raises(lambda: as_input(np.ones(2)), lambda r: r.device)
