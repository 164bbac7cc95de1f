"""Hand-written CUDA circular convolution of real frames (K5a, K5b), beside
its plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/conv_pallas.py``: ``csrc/osconv.cu``
computes y = Re ifft(fft(x) * H) for each real frame in one kernel, the
transform, the product and the inverse all in shared memory. One frame
runs K5a; a batch of two or more runs K5b, which pairs frames as one
complex signal a + ib. It carries the overlap-save FIR path
(``ops/fir.py``).

H is given in natural order, as the (n,) spectrum of a real filter
(``ops.dispatch.fft`` of the zero-padded taps). The JAX entry takes the
digit-permuted (n/128, 128) layout of its TPU kernels and rejects natural
order; this one is the mirror image and rejects any other shape, so a
permuted spectrum cannot be taken for a natural one.

The wrapper runs the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. Launches are counted in
``ops.fft_cuda.LAUNCHES`` under "osconv" (K5a) and "osconv_pair" (K5b).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.complex import ComplexArray, is_power_of_two
from ..core.device import to_tensor
from ..core.fft import fft_axis0
from . import _build
from .fft_cuda import LAUNCHES, MAX_DFT_N, MAX_ROWS_N, _device_tables, resolve_precision

__all__ = ["circular_convolve_cuda", "circular_convolve_plain"]


def circular_convolve_plain(frames: torch.Tensor, hspec: ComplexArray,
                            n: int) -> torch.Tensor:
    """K5's plain version: the Stockham FFT of each real frame [..., n],
    times H, the inverse FFT, real part; in the frames' dtype."""
    f = frames.reshape(-1, n).T
    fre, fim = fft_axis0(f, torch.zeros_like(f))
    hr = hspec.real.to(dtype=f.dtype, device=f.device).reshape(n, 1)
    hi = hspec.imag.to(dtype=f.dtype, device=f.device).reshape(n, 1)
    y, _ = fft_axis0(fre * hr - fim * hi, fre * hi + fim * hr, inverse=True)
    return y.T.reshape(frames.shape)


def _launch_osconv(f2: torch.Tensor, hspec: ComplexArray, n: int,
                   donate: bool) -> torch.Tensor:
    if f2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the convolution kernel takes float32 frames, got {f2.dtype}")
    if n > MAX_ROWS_N:
        raise ValueError(
            f"the convolution kernel covers n <= {MAX_ROWS_N}, got {n}: "
            "ops.fir runs larger blocks as fft x H -> ifft through ops.dispatch")
    if donate and not f2.is_contiguous():
        raise ValueError("donate=True needs contiguous frames")
    # The kernel computes in float32; bfloat16 is cast around it, as the
    # TPU kernel reads its frames as float32 and stores the input dtype.
    work = f2.float().contiguous()
    # In place when the caller donates, or when ``work`` is already a copy.
    out = work if donate or work.data_ptr() != f2.data_ptr() else torch.empty_like(work)
    hre = hspec.real.to(device=f2.device, dtype=torch.float32).contiguous()
    him = hspec.imag.to(device=f2.device, dtype=torch.float32).contiguous()
    batch = work.shape[0]
    if batch == 0:
        return out.to(f2.dtype)
    pair = batch >= 2
    lib = _build.library()
    twc, tws = _device_tables(n, None, f2.device)
    with torch.cuda.device(f2.device):
        stream = torch.cuda.current_stream(f2.device).cuda_stream
        code = lib.osconv_f32(work.data_ptr(), out.data_ptr(), hre.data_ptr(),
                              him.data_ptr(), twc.data_ptr(), tws.data_ptr(),
                              batch, n, int(pair), stream)
    key = "osconv_pair" if pair else "osconv"
    _build.check(lib, code, key)
    LAUNCHES[key] += 1
    return out.to(f2.dtype)


def circular_convolve_cuda(frames, hspec: ComplexArray, n: int,
                           precision: Optional[str] = None,
                           donate: bool = False) -> torch.Tensor:
    """Circular convolution of real frames [batch..., n] with a filter
    given by its natural-order spectrum H, an (n,) ComplexArray, fused in
    one kernel (numpy convention: Re ifft(fft(x) * H), the inverse's 1/n
    folded in). Needs a power-of-two n > 128; on CUDA, n <= 16384.

    hspec must be the spectrum of a real filter (H[k] = conj H[n-k]): a
    batch of two or more frames runs K5b, which pairs frames a, b as one
    complex signal a + ib, and that is exact only for such an H. For any
    other H the pair gives Re(conv a) - Im(conv b) in row a, where a single
    frame (K5a) gives Re(conv a); the JAX kernels behave the same way.

    donate=True lets the kernel write the result into ``frames`` (which
    must be contiguous and dead after the call). "bf16x3" runs the float32
    kernel. A CPU tensor runs :func:`circular_convolve_plain`.
    """
    resolve_precision(precision)
    frames = to_tensor(frames)
    if frames.shape[-1] != n:
        raise ValueError(f"frame length {frames.shape[-1]} != n {n}")
    if n <= MAX_DFT_N or not is_power_of_two(n):
        raise ValueError(
            f"fused convolution needs a power-of-two n > {MAX_DFT_N}, got {n}")
    if tuple(hspec.real.shape) != (n,):
        raise ValueError(
            "hspec must be the natural-order (n,) spectrum of a real filter "
            f"(ops.dispatch.fft of the zero-padded taps); got shape "
            f"{tuple(hspec.real.shape)} for n={n}")
    f2 = frames.reshape(-1, n)
    if not f2.is_cuda:
        return circular_convolve_plain(frames, hspec, n)
    return _launch_osconv(f2, hspec, n, donate).reshape(frames.shape)
