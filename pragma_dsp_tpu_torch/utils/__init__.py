"""Utilities: fixture/SNR harness, roofline bench harness, profiling,
sanitizer mode, checkpointing, and numpy interop with the JAX package."""

from .benchharness import BenchContext, BenchResult, checksum, device_specs
from .checkpoint import restore_state, save_state
from .debug import check_finite, debug_nans, sanitizer_mode
from .fixtures import (
    assert_close,
    assert_snr,
    fixtures_dir,
    load_json,
    max_abs_error,
    rms_error,
    snr_db,
)
from .interop import (cascade_state_from_numpy, cascade_state_to_numpy,
                      complex_from_numpy, fir_state_from_numpy, fir_state_to_numpy,
                      fm_demod_state_from_numpy, fm_demod_state_to_numpy,
                      pfb_frames_state_from_numpy, pfb_frames_state_to_numpy,
                      pfb_state_from_numpy, pfb_state_to_numpy, result_to_numpy,
                      stft_state_from_numpy, stft_state_to_numpy, to_numpy,
                      upfirdn_state_from_numpy, upfirdn_state_to_numpy,
                      wbfm_stream_state_from_numpy, wbfm_stream_state_to_numpy)
from .profiling import annotate, device_idle_share, timed, trace

__all__ = [
    "BenchContext",
    "BenchResult",
    "checksum",
    "device_specs",
    "assert_close",
    "assert_snr",
    "fixtures_dir",
    "load_json",
    "max_abs_error",
    "rms_error",
    "snr_db",
    "save_state",
    "restore_state",
    "check_finite",
    "debug_nans",
    "sanitizer_mode",
    "annotate",
    "timed",
    "trace",
    "device_idle_share",
    "complex_from_numpy", "result_to_numpy", "stft_state_from_numpy",
    "stft_state_to_numpy", "fir_state_from_numpy", "fir_state_to_numpy",
    "pfb_state_from_numpy", "pfb_state_to_numpy",
    "pfb_frames_state_from_numpy", "pfb_frames_state_to_numpy",
    "upfirdn_state_from_numpy", "upfirdn_state_to_numpy",
    "cascade_state_from_numpy", "cascade_state_to_numpy",
    "fm_demod_state_from_numpy", "fm_demod_state_to_numpy",
    "wbfm_stream_state_from_numpy", "wbfm_stream_state_to_numpy", "to_numpy",
]
