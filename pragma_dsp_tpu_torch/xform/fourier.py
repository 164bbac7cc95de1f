"""Power-rung Fourier surface: windows, projections, shifts, frequency axes.

Counterpart of ``pragma_dsp_tpu/xform/fourier.py``. Window values are
computed in float64 with numpy by the same formulas as the JAX package
(bit-equal) and rounded once to the compute dtype on the target device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ..core.complex import (ComplexArray, as_complex_array,
                            create_complex_array, is_power_of_two)
from ..core.device import resolve_device, to_tensor
from ..core.fft import Radix2Fft

WindowType = Literal["rect", "hann", "hamming", "blackman"]
FftSides = Literal["one", "two"]

__all__ = [
    "WindowType",
    "FftSides",
    "window_values",
    "create_window",
    "apply_window",
    "FFT",
    "magnitude",
    "phase",
    "fft_shift",
    "fft_shift_complex",
    "coherent_gain",
    "enbw",
    "bin_frequencies",
]


def window_values(window_type: str, size: int) -> np.ndarray:
    """Symmetric (``sym=True``) window as a float64 numpy array.

    Formulas match reference src/xform/fourier.ts:14-52 and scipy's
    symmetric windows (denominator N-1); size 1 returns [1].
    """
    if size <= 0:
        raise ValueError(f"Window size must be positive, got {size}")
    if size == 1:
        return np.ones(1, dtype=np.float64)
    i = np.arange(size, dtype=np.float64)
    f = 2.0 * np.pi * i / (size - 1)
    if window_type == "rect":
        return np.ones(size, dtype=np.float64)
    if window_type == "hann":
        return 0.5 * (1.0 - np.cos(f))
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(f)
    if window_type == "blackman":
        return 0.42 - 0.5 * np.cos(f) + 0.08 * np.cos(2.0 * f)
    raise ValueError(f"Unsupported window type: {window_type}")


def create_window(window_type: str, size: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Window function as a tensor (reference createWindow, fourier.ts:14-52)."""
    return torch.from_numpy(window_values(window_type, size)).to(
        device=resolve_device(device), dtype=dtype)


def apply_window(x, window) -> torch.Tensor:
    """Element-wise window multiply over the last axis (fourier.ts:54-67)."""
    x = to_tensor(x)
    window = torch.as_tensor(window).to(device=x.device, dtype=x.dtype)
    if x.shape[-1] != window.shape[-1]:
        raise ValueError("Window length must match input length.")
    return x * window


class FFT:
    """Power-rung FFT facade (reference fourier.ts:69-96): re-validates
    power-of-two size and offers a complex-array factory."""

    def __init__(self, size: int):
        if not is_power_of_two(size):
            raise ValueError(f"FFT size must be power of two, got {size}")
        self.size = size
        self._kernel = Radix2Fft(size)

    def forward(self, x) -> ComplexArray:
        return self._kernel.forward(x)

    def forward_complex(self, x) -> ComplexArray:
        return self._kernel.forward_complex(x)

    def inverse(self, x) -> ComplexArray:
        return self._kernel.inverse(x)

    def create_complex_array(self, fill: float = 0.0, dtype=torch.float32,
                             device=None) -> ComplexArray:
        return create_complex_array(self.size, fill, dtype=dtype, device=device)


def magnitude(x) -> torch.Tensor:
    """Per-bin |X| with hypot semantics (reference fourier.ts:98-109)."""
    xc = as_complex_array(x)
    return torch.hypot(xc.real, xc.imag)


def phase(x) -> torch.Tensor:
    """Per-bin arg(X) via atan2 (reference fourier.ts:111-120)."""
    xc = as_complex_array(x)
    return torch.atan2(xc.imag, xc.real)


def fft_shift(x, axis: int = -1) -> torch.Tensor:
    """Left roll by floor(N/2) (reference fourier.ts:122-133):
    result[i] = input[(i + N//2) % N]."""
    x = to_tensor(x)
    n = x.shape[axis]
    return torch.roll(x, -(n // 2), dims=axis)


def fft_shift_complex(x, axis: int = -1) -> ComplexArray:
    """fft_shift applied to both planes (reference fourier.ts:135-145)."""
    xc = as_complex_array(x)
    return ComplexArray(fft_shift(xc.real, axis), fft_shift(xc.imag, axis))


def coherent_gain(window_type: str, size: int) -> float:
    """Window coherent gain sum(w)/N."""
    w = window_values(window_type, size)
    return float(np.sum(w) / size)


def enbw(window_type: str, size: int) -> float:
    """Equivalent noise bandwidth N*sum(w^2)/sum(w)^2 in bins."""
    w = window_values(window_type, size)
    return float(size * np.sum(w * w) / np.sum(w) ** 2)


def bin_step(size: int, sample_rate: float) -> float:
    """The spacing sample_rate/N of :func:`bin_frequencies`, in float64;
    ValueError where either is not positive."""
    if size <= 0:
        raise ValueError(f"FFT size must be positive, got {size}")
    if sample_rate <= 0:
        raise ValueError(f"Sample rate must be positive, got {sample_rate}")
    return float(sample_rate) / size


def bin_frequencies(size: int, sample_rate: float, sides: str = "one",
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Bin index -> Hz axis (reference fourier.ts:147-165): one-sided has
    floor(N/2)+1 bins, two-sided N bins, spacing sample_rate/N. Bin k is
    k * :func:`bin_step` in float64, rounded once to ``dtype`` (K1's peak
    instance writes the same floats)."""
    step = bin_step(size, sample_rate)
    bin_count = size // 2 + 1 if sides == "one" else size
    # Built on the device: a copy from pageable host memory would
    # synchronise the stream. One float64 multiply, as numpy does it.
    freqs = torch.arange(bin_count, dtype=torch.float64,
                         device=resolve_device(device))
    return (freqs * step).to(dtype)
