"""Ops layer: the hand-written CUDA kernels, FFT dispatch (row, column,
large, four-step and real-input transforms) and the DSP blocks ported so
far (FIR, the channelizer)."""

from .channelizer import (PfbFramesState, PfbState, pfb_channelize,
                          pfb_channelize_frames, pfb_channelize_frames_step,
                          pfb_channelize_step, pfb_frames_stream_init,
                          pfb_stream_init, pfb_taps)
from .conv_cuda import circular_convolve_cuda
from .dispatch import (fft, get_fft_impl, get_fft_precision, ifft,
                       set_fft_impl, set_fft_precision)
from .fft_big import (big_split, fft_big, fft_big_permuted, ifft_big,
                      ifft_big_from_permuted)
from .fft_cuda import (LAUNCHES, fft_cols_cuda, fft_rows_cuda,
                       framed_spectrum_amp_phase_cuda,
                       framed_spectrum_amplitude_cuda, framed_spectrum_supported,
                       resolve_precision, spectrum_amp_phase_cuda,
                       spectrum_amplitude_cuda)
from .fft_fourstep import fft_fourstep, ifft_fourstep
from .fir import FirState, fir_filter, fir_step, fir_stream_init, overlap_save_filter
from .pfb_cuda import pfb_channelize_cuda, pfb_channelize_frames_cuda
from .polyphase import design_lowpass
from .rfft import irfft, rfft

__all__ = [
    "fft",
    "ifft",
    "set_fft_impl",
    "get_fft_impl",
    "set_fft_precision",
    "get_fft_precision",
    "LAUNCHES",
    "fft_rows_cuda",
    "fft_cols_cuda",
    "fft_fourstep",
    "ifft_fourstep",
    "rfft",
    "irfft",
    "big_split",
    "fft_big",
    "fft_big_permuted",
    "ifft_big",
    "ifft_big_from_permuted",
    "resolve_precision",
    "spectrum_amp_phase_cuda",
    "spectrum_amplitude_cuda",
    "framed_spectrum_supported",
    "framed_spectrum_amplitude_cuda",
    "framed_spectrum_amp_phase_cuda",
    "circular_convolve_cuda",
    "pfb_channelize_cuda",
    "pfb_channelize_frames_cuda",
    "fir_filter",
    "overlap_save_filter",
    "FirState",
    "fir_stream_init",
    "fir_step",
    "design_lowpass",
    "pfb_taps",
    "pfb_channelize",
    "pfb_channelize_frames",
    "PfbState",
    "pfb_stream_init",
    "pfb_channelize_step",
    "PfbFramesState",
    "pfb_frames_stream_init",
    "pfb_channelize_frames_step",
]
