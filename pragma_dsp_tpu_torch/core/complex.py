"""Split real/imag complex representation on PyTorch tensors.

Counterpart of ``pragma_dsp_tpu/core/complex.py``. A complex array is two
real tensors of one shape, never a ``torch.complex`` tensor: that is the
layout the CUDA kernels read. Arbitrary leading batch dimensions are
allowed; the complex-element axis is the last one. A tensor's device
decides where work runs; host input goes to the default device
(``core/device.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device, to_tensor

__all__ = [
    "ComplexArray",
    "create_complex_array",
    "as_complex_array",
    "ensure_float",
    "is_power_of_two",
    "next_power_of_two",
]


class _ComplexArrayFields(NamedTuple):
    real: torch.Tensor
    imag: torch.Tensor


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a numpy array on the host (bfloat16 via float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class ComplexArray(_ComplexArrayFields):
    """Split-plane complex array (``real`` and ``imag`` of one shape).

    Planes must be real floating tensors: a complex plane drops half the
    data, and integer or bool planes truncate twiddle products, both
    silently. Only tensors are checked (the port has no pytree rebuilds
    that pass placeholders through the constructor).
    """

    def __new__(cls, real, imag):
        for name, p in (("real", real), ("imag", imag)):
            if not isinstance(p, torch.Tensor):
                continue
            if p.is_complex():
                raise TypeError(
                    f"ComplexArray.{name} plane has complex dtype {p.dtype}; "
                    "planes must be real. Pass the complex tensor through "
                    "as_complex_array() (it splits complex input into "
                    "real/imag planes).")
            if not p.is_floating_point():
                raise TypeError(
                    f"ComplexArray.{name} plane has non-float dtype {p.dtype}; "
                    "integer/bool planes silently truncate twiddle "
                    "products. Pass the input through as_complex_array() "
                    "(it coerces to the default float dtype).")
        if (isinstance(real, torch.Tensor) and isinstance(imag, torch.Tensor)
                and real.shape != imag.shape):
            raise TypeError(
                f"ComplexArray plane shapes differ: real {tuple(real.shape)} "
                f"vs imag {tuple(imag.shape)}")
        return super().__new__(cls, real, imag)

    @property
    def shape(self):
        return self.real.shape

    @property
    def dtype(self):
        return self.real.dtype

    @property
    def device(self):
        return self.real.device

    def __len__(self) -> int:
        return self.real.shape[-1]

    def to_numpy_complex(self) -> np.ndarray:
        """Copy to a numpy complex ndarray on the host."""
        return tensor_to_numpy(self.real) + 1j * tensor_to_numpy(self.imag)

    @staticmethod
    def from_numpy_complex(x, dtype=None, device=None) -> "ComplexArray":
        x = np.asarray(x)
        device = resolve_device(device)
        re = torch.as_tensor(np.ascontiguousarray(x.real), dtype=dtype, device=device)
        im = torch.as_tensor(np.ascontiguousarray(x.imag), dtype=dtype, device=device)
        return ComplexArray(re, im)


def create_complex_array(size, fill: float = 0.0, dtype=torch.float32,
                         device=None) -> ComplexArray:
    """Allocate a complex array of ``size`` (int or shape tuple) filled with
    ``fill`` in both planes (reference createComplexArray)."""
    shape = (size,) if isinstance(size, int) else tuple(size)
    re = torch.full(shape, fill, dtype=dtype, device=resolve_device(device))
    return ComplexArray(re, re.clone())


def as_complex_array(x, dtype=None) -> ComplexArray:
    """Coerce input into a ComplexArray.

    Accepted forms: ComplexArray (returned as is), a ``(re, im)`` pair of
    real arrays, a numpy complex ndarray, a complex torch tensor or Python
    complex values (split into planes of the matching real dtype), or any
    real array-like (imag = zeros on the same device). Integer and bool
    input is coerced to the default float dtype.
    """
    if isinstance(x, ComplexArray):
        return x
    if dtype is not None and not dtype.is_floating_point:
        raise TypeError(
            f"ComplexArray planes must be floating; requested dtype {dtype}")

    def plane(a):
        # A complex plane passes through so the constructor rejects it.
        return ensure_float(to_tensor(a, dtype))

    if isinstance(x, tuple) and len(x) == 2 and not isinstance(x[0], (int, float)):
        return ComplexArray(plane(x[0]), plane(x[1]))
    if not isinstance(x, torch.Tensor) and np.iscomplexobj(x):
        # numpy complex arrays, Python complex scalars and lists
        return ComplexArray.from_numpy_complex(x, dtype=dtype)
    if isinstance(x, torch.Tensor) and x.is_complex():
        re, im = x.real.contiguous(), x.imag.contiguous()
        if dtype is not None:
            re, im = re.to(dtype), im.to(dtype)
        return ComplexArray(re, im)
    re = plane(x)
    return ComplexArray(re, torch.zeros_like(re))


def ensure_float(x) -> torch.Tensor:
    """Coerce int/bool input to the default float dtype; floating and
    complex tensors pass through unchanged (complex input keeps flowing to
    the caller's own complex handling)."""
    t = to_tensor(x)
    if not t.is_floating_point() and not t.is_complex():
        t = t.to(torch.get_default_dtype())
    return t


def is_power_of_two(n: int) -> bool:
    """Parity: ``isPowerOfTwo`` (reference src/core/fft.ts:16)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Parity: ``nextPowerOfTwo`` (reference src/core/fft.ts:18-23)."""
    if n <= 1:
        return 1
    p = 1
    while p < n:
        p <<= 1
    return p
