"""The arithmetic a reference runs in.

``Precision(torch.float64)`` is the reference. ``Precision(torch.float32,
tf32=True)`` is the control: the nearest precision below the configurations'
float32 with TF32 off. Every matrix product of a reference goes through
``mm``/``bmv``, which round both operands to TF32 (10 explicit mantissa
bits, round to nearest even) before an exact product summed in float32, as
the tensor cores do with TF32 on. Rounding by hand makes the control
independent of which kernel cuBLAS picks for a shape.
"""

import dataclasses

import torch


def round_tf32(x):
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -8192).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def _in(self, a):
        a = a.to(self.dtype)
        return round_tf32(a) if self.tf32 else a

    def mm(self, a, b):
        """a @ b for large matrices (torch.matmul; with TF32 off, as
        PyTorch's default, the rounded operands' products are exact)."""
        return torch.matmul(self._in(a), self._in(b))

    def small_mm(self, a, b):
        """Batched small products (..., i, k) · (..., k, j) → (..., i, j),
        as a broadcast sum over k (a batch of millions of tiny matrices)."""
        return torch.sum(self._in(a)[..., :, :, None] * self._in(b)[..., None, :, :], dim=-2)

    def bmv(self, M, v):
        """(..., i, j) · (..., j) → (..., i)."""
        return torch.sum(self._in(M) * self._in(v)[..., None, :], dim=-1)


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, tf32=True)
