"""Where the port's entry points put their inputs.

The entry points run on the card unless the caller asks for the CPU: with
``device="cpu"``, or by passing tensors that lie on the CPU. Without a card
a request for it raises; nothing falls back to the CPU.
"""

import numpy as np
import torch


def require(device):
    """``torch.device(device)``; raises RuntimeError for a CUDA device when
    there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device}: pass device='cpu' or CPU tensors to run on the CPU"
        )
    return device


def as_input(a, device="cuda"):
    """A tensor stays on its own device; anything else (numpy arrays, lists)
    becomes a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=require(device))


def as_float64(a):
    """A tensor stays as it is; anything else (numpy arrays, lists) becomes
    a float64 tensor on the CPU, as the JAX package's constants are float64
    in its tests' x64 mode. Models cast such constants to x's dtype and
    device where they use them."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a, dtype=np.float64))
