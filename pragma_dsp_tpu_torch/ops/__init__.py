"""Ops layer: the hand-written CUDA kernels and FFT dispatch."""

from .dispatch import (fft, get_fft_impl, get_fft_precision, ifft,
                       set_fft_impl, set_fft_precision)
from .fft_cuda import (LAUNCHES, fft_rows_cuda, framed_spectrum_amp_phase_cuda,
                       framed_spectrum_amplitude_cuda, framed_spectrum_supported,
                       resolve_precision, spectrum_amp_phase_cuda,
                       spectrum_amplitude_cuda)

__all__ = [
    "fft",
    "ifft",
    "set_fft_impl",
    "get_fft_impl",
    "set_fft_precision",
    "get_fft_precision",
    "LAUNCHES",
    "fft_rows_cuda",
    "resolve_precision",
    "spectrum_amp_phase_cuda",
    "spectrum_amplitude_cuda",
    "framed_spectrum_supported",
    "framed_spectrum_amplitude_cuda",
    "framed_spectrum_amp_phase_cuda",
]
