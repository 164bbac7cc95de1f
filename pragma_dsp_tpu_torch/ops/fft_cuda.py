"""Hand-written CUDA kernels of the spectrum path, each beside its plain
PyTorch version.

Counterpart of the K1/K2 part of ``pragma_dsp_tpu/ops/fft_pallas.py``:

* K1 ``spectrum_onesided`` (``csrc/spectrum_onesided.cu``) replaces
  ``_spectrum_onesided_kernel`` + ``_onesided_body``: window -> FFT ->
  one-sided scaled amplitude, optionally phase, natural bin order.
* K2 ``fft_rows`` (``csrc/fft_rows.cu``) replaces ``_fft2d_kernel``: a
  batched complex FFT over the last axis, natural order in and out.

Each wrapper takes its plain version only because the tensor it was given
lies on the CPU. For a CUDA tensor it launches its kernel or raises; there
is no fallback. ``LAUNCHES`` counts kernel launches, one per launch and
nowhere else.

Precision: "auto" and None (with the global policy at "auto") resolve to
"highest". "bf16x3" is accepted for API parity with the JAX package but
runs the same f32 kernels here; a tensor-core mode is later work.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import is_power_of_two
from ..core.fft import _twiddles64, fft_axis0
from ..xform.fourier import create_window, window_values
from . import _build

__all__ = [
    "LAUNCHES",
    "MAX_ROWS_N",
    "MIN_ONESIDED_N",
    "resolve_precision",
    "spectrum_amplitude_cuda",
    "spectrum_amp_phase_cuda",
    "spectrum_amp_phase_plain",
    "fft_rows_cuda",
    "fft_rows_plain",
]

# A row of complex f32 must fit one block's shared memory (8*n bytes).
MAX_ROWS_N = 16384
# Below this the JAX package uses its two-sided kernel K3 (not yet ported).
MIN_ONESIDED_N = 256

LAUNCHES = {"spectrum_onesided": 0, "fft_rows": 0}

_PRECISIONS = ("highest", "bf16x3")


def resolve_precision(precision: Optional[str]) -> str:
    """None -> the global policy (``ops.dispatch.set_fft_precision``);
    "auto" -> "highest". "bf16x3" runs the f32 kernels in this port."""
    if precision is None:
        from .dispatch import get_fft_precision

        precision = get_fft_precision()
    if precision == "auto":
        return "highest"
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return precision


# ── constant tables (numpy float64, rounded once to f32) ─────────────


def onesided_window(n: int, window: str) -> np.ndarray:
    """The f32 window row K1 multiplies in: bit-equal to the one the JAX
    plan ``_onesided_plan`` builds."""
    return window_values(window, n).reshape(1, n).astype(np.float32)


def row_twiddles(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of -2*pi*k/n, k < n/2, as f32: the table both kernels
    read, bit-equal to the Stockham twiddles of size n."""
    c, s = _twiddles64(n, -1.0)
    return c[:, 0].astype(np.float32), s[:, 0].astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_tables(n: int, window: Optional[str], device: torch.device):
    twc, tws = row_twiddles(n)
    tabs = [torch.from_numpy(twc), torch.from_numpy(tws)]
    if window is not None:
        tabs.append(torch.from_numpy(onesided_window(n, window)[0]))
    return tuple(t.to(device) for t in tabs)


# ── K1: one-sided spectrum ───────────────────────────────────────────


def spectrum_amp_phase_plain(x: torch.Tensor, n: int, window: str,
                             with_phase: bool = True):
    """K1's plain version: window -> Stockham FFT -> hypot -> one-sided
    scaling (DC and Nyquist /n, others 2/n) -> atan2, on [B, n] frames.
    DC and Nyquist are made exactly real, as the kernel makes them."""
    xw = (x * create_window(window, n, dtype=x.dtype, device=x.device)).T
    re, im = fft_axis0(xw, torch.zeros_like(xw))
    bins = n // 2 + 1
    re = re[:bins].T
    im = im[:bins].T.clone()
    im[:, 0] = 0.0
    im[:, -1] = 0.0
    amp = torch.hypot(re, im) * (2.0 / n)
    amp[:, 0] *= 0.5  # exact: DC and Nyquist are scaled by 1/n
    amp[:, -1] *= 0.5
    return (amp, torch.atan2(im, re)) if with_phase else (amp, None)


def _launch_spectrum_onesided(x: torch.Tensor, n: int, window: str,
                              with_phase: bool):
    if x.dtype != torch.float32:
        raise TypeError(f"the one-sided spectrum kernel takes float32, got {x.dtype}")
    if n > MAX_ROWS_N:
        raise NotImplementedError(
            f"one-sided spectrum kernel covers n <= {MAX_ROWS_N}, got {n}: "
            "larger frames are still to be ported (ROADMAP queue 2, K1)")
    x = x.contiguous()
    batch = x.shape[0]
    amp = torch.empty((batch, n // 2 + 1), dtype=torch.float32, device=x.device)
    ph = torch.empty_like(amp) if with_phase else None
    if batch == 0:
        return amp, ph
    lib = _build.library()
    twc, tws, win = _device_tables(n, window, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.spectrum_onesided_f32(
            x.data_ptr(), win.data_ptr(), amp.data_ptr(),
            ph.data_ptr() if with_phase else None,
            twc.data_ptr(), tws.data_ptr(), batch, n, stream)
    _build.check(lib, code, "spectrum_onesided")
    LAUNCHES["spectrum_onesided"] += 1
    return amp, ph


def _onesided(x, n: int, window: str, precision: Optional[str],
              with_phase: bool):
    resolve_precision(precision)
    x = torch.as_tensor(x)
    if x.shape[-1] != n:
        raise ValueError(f"frame length {x.shape[-1]} != n {n}")
    if not is_power_of_two(n):
        raise ValueError(f"spectrum size must be a power of two, got {n}")
    if n < MIN_ONESIDED_N:
        raise NotImplementedError(
            f"n={n} <= 128 runs the two-sided spectrum kernel K3 in the JAX "
            "package, which is not yet ported (ROADMAP queue 2, K3)")
    shape = x.shape
    frames = x.reshape(-1, n)
    if frames.is_cuda:
        amp, ph = _launch_spectrum_onesided(frames, n, window, with_phase)
    else:
        amp, ph = spectrum_amp_phase_plain(frames, n, window, with_phase)
    out_shape = shape[:-1] + (n // 2 + 1,)
    return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)


def spectrum_amplitude_cuda(x, n: int, window: str = "rect",
                            sides: str = "one",
                            precision: Optional[str] = None) -> torch.Tensor:
    """Fused one-sided amplitude spectrum of real frames [batch..., n]:
    [..., n//2+1] with DC and Nyquist /n and other bins 2/n
    (reference src/public/spectrum.ts:45-61). Power-of-two n in
    256..16384 on CUDA (any power-of-two n >= 256 on the CPU).

    sides="two" and n <= 128 run K3 in the JAX package, which is not yet
    ported: they raise NotImplementedError.
    """
    if sides != "one":
        raise NotImplementedError(
            "two-sided fused spectra run kernel K3 in the JAX package, "
            "which is not yet ported (ROADMAP queue 2, K3)")
    return _onesided(x, n, window, precision, with_phase=False)[0]


def spectrum_amp_phase_cuda(x, n: int, window: str = "rect",
                            precision: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused one-sided amplitude and phase of real frames [batch..., n] in
    one kernel: (amplitude, phase), both [..., n//2+1], natural bin order.
    Phase is atan2(im, re) of the unnormalised FFT; DC and Nyquist phase is
    exactly 0 or +pi."""
    return _onesided(x, n, window, precision, with_phase=True)


# ── K2: row FFT ──────────────────────────────────────────────────────


def fft_rows_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: the Stockham FFT over the last axis of [B, n]."""
    ore, oim = fft_axis0(re.T, im.T, inverse)
    return ore.T.contiguous(), oim.T.contiguous()


def _launch_fft_rows(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                     donate: bool):
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the row FFT kernel takes float32 planes, got "
                        f"{re.dtype}/{im.dtype}")
    if not (re.is_cuda and im.is_cuda and re.device == im.device):
        raise ValueError("the row FFT kernel needs both planes on one CUDA device")
    n = re.shape[-1]
    if n > MAX_ROWS_N:
        raise NotImplementedError(
            f"row FFT kernel covers n <= {MAX_ROWS_N}, got {n}: larger "
            "transforms are still to be ported (ROADMAP queue 1, step 12)")
    if donate and not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("donate=True needs contiguous input planes")
    re, im = re.contiguous(), im.contiguous()
    ore, oim = (re, im) if donate else (torch.empty_like(re), torch.empty_like(im))
    batch = re.shape[0]
    if batch == 0:
        return ore, oim
    lib = _build.library()
    twc, tws = _device_tables(n, None, re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = lib.fft_rows_f32(re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                                oim.data_ptr(), twc.data_ptr(), tws.data_ptr(),
                                batch, n, int(inverse), stream)
    _build.check(lib, code, "fft_rows")
    LAUNCHES["fft_rows"] += 1
    return ore, oim


def fft_rows_cuda(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                  donate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over the last axis of split planes [B, n],
    natural order in and out. The forward transform is unnormalised; the
    inverse scales by 1/n. Power-of-two n up to 16384 on CUDA.

    donate=True lets the kernel write the result into ``re``/``im``
    (which must be contiguous): each block reads its whole row into
    shared memory before it writes, so in place is safe. The inputs must
    be dead after the call. On the CPU, donate has no effect.
    """
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"fft_rows takes two [B, n] planes, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    n = re.shape[-1]
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    if re.is_cuda or im.is_cuda:
        return _launch_fft_rows(re, im, inverse, donate)
    return fft_rows_plain(re, im, inverse)
