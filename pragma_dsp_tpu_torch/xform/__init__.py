"""Power rung — Fourier transforms, windows, and projections."""

from .fourier import (
    FFT,
    FftSides,
    WindowType,
    apply_window,
    bin_frequencies,
    coherent_gain,
    create_window,
    enbw,
    fft_shift,
    fft_shift_complex,
    magnitude,
    phase,
    window_values,
)
from .fluent import FluentFFT

__all__ = [
    "FFT",
    "FftSides",
    "WindowType",
    "apply_window",
    "bin_frequencies",
    "coherent_gain",
    "create_window",
    "enbw",
    "fft_shift",
    "fft_shift_complex",
    "magnitude",
    "phase",
    "window_values",
    "FluentFFT",
]
