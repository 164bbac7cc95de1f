"""Golden-fixture loading + SNR-bound comparison harness.

Counterpart of ``pragma_dsp_tpu/utils/fixtures.py`` (a copy: the port
imports nothing of the JAX package). The reference validates in float64
with absolute tolerances down to 1e-10 (reference
test/reallife/helpers.ts:97-136). On the card the compute dtype is
float32, where those tolerances are unreachable, so this harness offers
both:

* absolute/relative closeness for float64 runs (the CPU tests)
* SNR bounds in dB for float32 runs on the card (BASELINE.json "within
  SNR bound")

Array arguments may be numpy arrays, lists or tensors on any device.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.complex import tensor_to_numpy

__all__ = [
    "load_json",
    "fixtures_dir",
    "snr_db",
    "max_abs_error",
    "rms_error",
    "assert_close",
    "assert_snr",
]


def fixtures_dir() -> str:
    """Repo-root tests/fixtures directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "tests", "fixtures"))


def load_json(path: str) -> Dict[str, Any]:
    """Load a fixture JSON; transparently handles .gz and bare .json paths."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return json.load(f)
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = tensor_to_numpy(a)
    return np.asarray(a, dtype=np.float64)


def max_abs_error(ref, test) -> float:
    """Parity: maxAbsError (reference test/reallife/helpers.ts:139-149)."""
    ref = _f64(ref)
    test = _f64(test)
    return float(np.max(np.abs(ref - test))) if ref.size else 0.0


def rms_error(ref, test) -> float:
    """Parity: rmsError (reference test/reallife/helpers.ts:151-161)."""
    ref = _f64(ref)
    test = _f64(test)
    return float(np.sqrt(np.mean((ref - test) ** 2))) if ref.size else 0.0


def snr_db(ref, test) -> float:
    """Signal-to-error ratio in dB; +inf for exact match, -inf when the
    reference is zero but the output is not."""
    ref = _f64(ref)
    test = _f64(test)
    sig = float(np.sum(np.abs(ref) ** 2))
    err = float(np.sum(np.abs(ref - test) ** 2))
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(sig / err)


def assert_close(ref, test, abs_tol: float = 0.0, rel_tol: float = 0.0,
                 label: str = "") -> None:
    """Element-wise |ref-test| <= abs_tol + rel_tol*|ref| with a readable
    failure message (reference expectCloseArray/Relative semantics,
    test/reallife/helpers.ts:97-136)."""
    ref = _f64(ref)
    test = _f64(test)
    assert ref.shape == test.shape, f"{label}: shape {ref.shape} vs {test.shape}"
    bound = abs_tol + rel_tol * np.abs(ref)
    err = np.abs(ref - test)
    bad = err > bound
    if np.any(bad):
        i = int(np.argmax(err - bound))
        raise AssertionError(
            f"{label}: {int(bad.sum())}/{ref.size} elements out of tolerance; "
            f"worst at flat index {i}: ref={ref.flat[i]!r} test={test.flat[i]!r} "
            f"err={err.flat[i]:.3e} bound={np.asarray(bound).flat[i]:.3e}")


def assert_snr(ref, test, min_db: float, label: str = "") -> None:
    got = snr_db(ref, test)
    assert got >= min_db, f"{label}: SNR {got:.1f} dB < required {min_db:.1f} dB"
