"""Streaming rung — caching service, streaming spectra, batched STFT."""

from .scan import jit_stream_step, scan_stream
from .service import FourierService, default_service, spectrum_fx, spectrum_stream
from .stft import (
    StftState,
    frame_signal,
    istft,
    spectrogram,
    spectrogram_amplitude,
    stft,
    stft_step,
    stft_stream_init,
    welch_psd,
)

__all__ = [
    "jit_stream_step",
    "scan_stream",
    "FourierService",
    "default_service",
    "spectrum_fx",
    "spectrum_stream",
    "StftState",
    "frame_signal",
    "istft",
    "spectrogram",
    "spectrogram_amplitude",
    "stft",
    "stft_step",
    "stft_stream_init",
    "welch_psd",
]
