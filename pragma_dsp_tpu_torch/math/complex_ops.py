"""Pure complex-vector arithmetic on the split-plane representation.

Counterpart of ``pragma_dsp_tpu/math/complex_ops.py`` (parity with
reference src/math/complex.ts:26-241). The reference ships each op in an
allocating and an in-place ``*Into`` form; as in the JAX package every op
here is functional and returns new planes. All ops broadcast over leading
batch axes, keep the input dtype and run on the input's device.
"""

from __future__ import annotations

import torch

from ..core.complex import ComplexArray

__all__ = [
    "scale", "add", "sub", "mul", "mul_scalar", "div", "div_scalar",
    "conj", "mag", "arg", "copy", "zero",
]


def scale(a: ComplexArray, s) -> ComplexArray:
    """Multiply every element by a real scalar (reference complex.ts:26-41)."""
    return ComplexArray(a.real * s, a.imag * s)


def add(a: ComplexArray, b: ComplexArray) -> ComplexArray:
    """Element-wise complex addition (reference complex.ts:45-60)."""
    return ComplexArray(a.real + b.real, a.imag + b.imag)


def sub(a: ComplexArray, b: ComplexArray) -> ComplexArray:
    """Element-wise complex subtraction (reference complex.ts:64-79)."""
    return ComplexArray(a.real - b.real, a.imag - b.imag)


def mul(a: ComplexArray, b: ComplexArray) -> ComplexArray:
    """Hadamard complex multiply: (a+ib)(c+id) (reference complex.ts:83-107)."""
    return ComplexArray(
        a.real * b.real - a.imag * b.imag,
        a.real * b.imag + a.imag * b.real,
    )


def mul_scalar(a: ComplexArray, re, im) -> ComplexArray:
    """Multiply every element by one complex scalar (reference complex.ts:111-134)."""
    return ComplexArray(a.real * re - a.imag * im, a.real * im + a.imag * re)


def div(a: ComplexArray, b: ComplexArray) -> ComplexArray:
    """Element-wise complex division a/b (reference complex.ts:138-166)."""
    denom = b.real * b.real + b.imag * b.imag
    return ComplexArray(
        (a.real * b.real + a.imag * b.imag) / denom,
        (a.imag * b.real - a.real * b.imag) / denom,
    )


def div_scalar(a: ComplexArray, re, im) -> ComplexArray:
    """Divide by one complex scalar, implemented as multiply by its inverse,
    matching the reference exactly (complex.ts:172-182)."""
    denom = re * re + im * im
    return mul_scalar(a, re / denom, -im / denom)


def conj(a: ComplexArray) -> ComplexArray:
    """Complex conjugate (reference complex.ts:186-196)."""
    return ComplexArray(a.real, -a.imag)


def mag(a: ComplexArray) -> torch.Tensor:
    """Element-wise magnitude, hypot semantics (reference complex.ts:200-208)."""
    return torch.hypot(a.real, a.imag)


def arg(a: ComplexArray) -> torch.Tensor:
    """Element-wise phase via atan2 (reference complex.ts:211-219)."""
    return torch.atan2(a.imag, a.real)


def copy(a: ComplexArray) -> ComplexArray:
    """Deep copy (reference complex.ts:223-227). Tensors are mutable, so
    unlike the JAX identity this clones both planes."""
    return ComplexArray(a.real.clone(), a.imag.clone())


def zero(a: ComplexArray) -> ComplexArray:
    """Zeros with the same shape, dtype and device (reference
    complex.ts:236-241); the planes are separate tensors."""
    return ComplexArray(torch.zeros_like(a.real), torch.zeros_like(a.imag))
