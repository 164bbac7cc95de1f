"""Utilities: numpy interop with the JAX package."""

from .interop import (cascade_state_from_numpy, cascade_state_to_numpy,
                      complex_from_numpy, fir_state_from_numpy, fir_state_to_numpy,
                      fm_demod_state_from_numpy, fm_demod_state_to_numpy,
                      pfb_frames_state_from_numpy, pfb_frames_state_to_numpy,
                      pfb_state_from_numpy, pfb_state_to_numpy, result_to_numpy,
                      stft_state_from_numpy, stft_state_to_numpy, to_numpy,
                      upfirdn_state_from_numpy, upfirdn_state_to_numpy,
                      wbfm_stream_state_from_numpy, wbfm_stream_state_to_numpy)

__all__ = ["complex_from_numpy", "result_to_numpy", "stft_state_from_numpy",
           "stft_state_to_numpy", "fir_state_from_numpy", "fir_state_to_numpy",
           "pfb_state_from_numpy", "pfb_state_to_numpy",
           "pfb_frames_state_from_numpy", "pfb_frames_state_to_numpy",
           "upfirdn_state_from_numpy", "upfirdn_state_to_numpy",
           "cascade_state_from_numpy", "cascade_state_to_numpy",
           "fm_demod_state_from_numpy", "fm_demod_state_to_numpy",
           "wbfm_stream_state_from_numpy", "wbfm_stream_state_to_numpy", "to_numpy"]
