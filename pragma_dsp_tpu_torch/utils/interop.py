"""Carrying state between the JAX package and the port through numpy.

The system has no learned weights: its state is its inputs and the plan
constants (windows, twiddle tables), which both packages build from the
same numpy float64 formulas. Inputs, results and streaming carries cross
as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.complex import ComplexArray, tensor_to_numpy
from ..public.spectrum import SpectrumPeak, SpectrumResult
from ..stream.stft import StftState

__all__ = ["complex_from_numpy", "to_numpy", "result_to_numpy",
           "stft_state_to_numpy", "stft_state_from_numpy"]


def complex_from_numpy(z, dtype=None, device=None) -> ComplexArray:
    """A numpy complex (or real) array as split planes on ``device``."""
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


def stft_state_to_numpy(state) -> StftState:
    """A streaming STFT carry (this package's ``StftState`` or the JAX
    package's twin) with its tail as a numpy array."""
    tail = state.tail
    return StftState(tail=tensor_to_numpy(tail) if isinstance(tail, torch.Tensor)
                     else np.asarray(tail))


def stft_state_from_numpy(state, dtype=None, device=None) -> StftState:
    """A carry whose tail is array-like (numpy, or the JAX twin's array) as
    a ``StftState`` of a tensor on ``device``."""
    return StftState(tail=torch.as_tensor(np.array(state.tail), dtype=dtype,
                                          device=device))
