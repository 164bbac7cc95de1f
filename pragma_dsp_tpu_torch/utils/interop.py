"""Carrying state between the JAX package and the port through numpy.

The system has no learned weights: its state is its inputs and the plan
constants (windows, twiddle tables), which both packages build from the
same numpy float64 formulas. Inputs, results and streaming carries cross
as numpy arrays.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..core.complex import ComplexArray, tensor_to_numpy
from ..core.device import resolve_device
from ..models.fm_receiver import WbfmStreamState
from ..ops.channelizer import PfbFramesState, PfbState
from ..ops.demod import FmDemodState
from ..ops.fir import FirState
from ..ops.polyphase import CascadeState, UpfirdnState
from ..public.spectrum import SpectrumPeak, SpectrumResult
from ..stream.stft import StftState

__all__ = ["complex_from_numpy", "to_numpy", "result_to_numpy",
           "state_to_numpy", "state_from_numpy", "stft_state_to_numpy", "stft_state_from_numpy",
           "fir_state_to_numpy", "fir_state_from_numpy",
           "pfb_state_to_numpy", "pfb_state_from_numpy",
           "pfb_frames_state_to_numpy", "pfb_frames_state_from_numpy",
           "upfirdn_state_to_numpy", "upfirdn_state_from_numpy",
           "cascade_state_to_numpy", "cascade_state_from_numpy",
           "fm_demod_state_to_numpy", "fm_demod_state_from_numpy",
           "wbfm_stream_state_to_numpy", "wbfm_stream_state_from_numpy"]


def complex_from_numpy(z, dtype=None, device=None) -> ComplexArray:
    """A numpy complex (or real) array as split planes on ``device`` (None:
    the default device)."""
    return ComplexArray.from_numpy_complex(np.asarray(z), dtype=dtype,
                                           device=device)


def to_numpy(x):
    """A ComplexArray as a numpy complex array; a tensor as a numpy array."""
    if isinstance(x, ComplexArray):
        return x.to_numpy_complex()
    return tensor_to_numpy(x)


def result_to_numpy(r: SpectrumResult) -> SpectrumResult:
    """Every field of a SpectrumResult (and its peak) as numpy arrays."""
    return SpectrumResult(
        frequencies=to_numpy(r.frequencies),
        amplitude=to_numpy(r.amplitude),
        phase=to_numpy(r.phase),
        peak=SpectrumPeak(*(to_numpy(f) for f in r.peak)))


def _leaf_to_numpy(a) -> np.ndarray:
    return tensor_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _leaf_from_numpy(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))


# The carries of this package by name: a nested carry of the JAX twin
# (WbfmStreamState's UpfirdnStates, CascadeState's stages) becomes this
# package's class of the same name.
_CARRIES = {c.__name__: c for c in (StftState, FirState, PfbState, PfbFramesState,
                                     UpfirdnState, CascadeState, FmDemodState,
                                     WbfmStreamState)}


def _map_carry(fn, state, cls=None):
    """``fn`` on every leaf of a carry, rebuilt as ``cls`` at the top;
    nested NamedTuples as this package's class of their name, tuples as
    tuples."""
    if cls is None and isinstance(state, tuple) and hasattr(state, "_fields"):
        cls = _CARRIES.get(type(state).__name__, type(state))
    if cls is not None:
        return cls(*(_map_carry(fn, f) for f in state))
    if isinstance(state, (tuple, list)):
        return tuple(_map_carry(fn, f) for f in state)
    return fn(state)


def state_to_numpy(cls, state):
    """A streaming carry (this package's ``cls`` or the JAX package's twin,
    nested carries included) as a ``cls`` of numpy arrays."""
    return _map_carry(_leaf_to_numpy, state, cls)


def state_from_numpy(cls, state, dtype=None, device=None):
    """A carry of array-likes (numpy, or the JAX twin's arrays; nested
    carries included) as a ``cls`` of tensors on ``device`` (None: the
    default device)."""
    return _map_carry(lambda a: _leaf_from_numpy(a, dtype, device), state, cls)


# The named converters of each streaming carry: StftState (tail), FirState
# (tail), PfbState (flat tail planes), PfbFramesState ([..., T-1, C] planes),
# UpfirdnState (tail), CascadeState (a tuple of UpfirdnStates), FmDemodState
# (the last IQ sample), WbfmStreamState (three UpfirdnStates, an
# FmDemodState and the de-emphasis output).
stft_state_to_numpy = partial(state_to_numpy, StftState)
stft_state_from_numpy = partial(state_from_numpy, StftState)
fir_state_to_numpy = partial(state_to_numpy, FirState)
fir_state_from_numpy = partial(state_from_numpy, FirState)
pfb_state_to_numpy = partial(state_to_numpy, PfbState)
pfb_state_from_numpy = partial(state_from_numpy, PfbState)
pfb_frames_state_to_numpy = partial(state_to_numpy, PfbFramesState)
pfb_frames_state_from_numpy = partial(state_from_numpy, PfbFramesState)
upfirdn_state_to_numpy = partial(state_to_numpy, UpfirdnState)
upfirdn_state_from_numpy = partial(state_from_numpy, UpfirdnState)
cascade_state_to_numpy = partial(state_to_numpy, CascadeState)
cascade_state_from_numpy = partial(state_from_numpy, CascadeState)
fm_demod_state_to_numpy = partial(state_to_numpy, FmDemodState)
fm_demod_state_from_numpy = partial(state_from_numpy, FmDemodState)
wbfm_stream_state_to_numpy = partial(state_to_numpy, WbfmStreamState)
wbfm_stream_state_from_numpy = partial(state_from_numpy, WbfmStreamState)
