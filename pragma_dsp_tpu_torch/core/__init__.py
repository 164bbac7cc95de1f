"""Core layer — split-complex tensors + batched radix-2 FFT (expert rung)."""

from .complex import (
    ComplexArray,
    as_complex_array,
    create_complex_array,
    ensure_float,
    is_power_of_two,
    next_power_of_two,
)
from .device import default_device, resolve_device, set_default_device, to_tensor
from .fft import Radix2Fft, fft, fft_axis0, ifft

__all__ = [
    "ComplexArray",
    "as_complex_array",
    "create_complex_array",
    "ensure_float",
    "is_power_of_two",
    "next_power_of_two",
    "default_device",
    "set_default_device",
    "resolve_device",
    "to_tensor",
    "Radix2Fft",
    "fft",
    "fft_axis0",
    "ifft",
]
