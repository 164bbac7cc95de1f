"""Pure complex-vector math (reference src/math/index.ts)."""

from .complex_ops import (
    add, arg, conj, copy, div, div_scalar, mag, mul, mul_scalar, scale, sub, zero,
)

__all__ = [
    "add", "arg", "conj", "copy", "div", "div_scalar", "mag", "mul",
    "mul_scalar", "scale", "sub", "zero",
]
