"""Utilities: numpy interop with the JAX package."""

from .interop import (complex_from_numpy, fir_state_from_numpy, fir_state_to_numpy,
                      pfb_frames_state_from_numpy, pfb_frames_state_to_numpy,
                      pfb_state_from_numpy, pfb_state_to_numpy, result_to_numpy,
                      stft_state_from_numpy, stft_state_to_numpy, to_numpy)

__all__ = ["complex_from_numpy", "result_to_numpy", "stft_state_from_numpy",
           "stft_state_to_numpy", "fir_state_from_numpy", "fir_state_to_numpy",
           "pfb_state_from_numpy", "pfb_state_to_numpy",
           "pfb_frames_state_from_numpy", "pfb_frames_state_to_numpy", "to_numpy"]
