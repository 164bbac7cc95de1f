"""Hand-written CUDA circular convolution of real frames (K5a, K5b), beside
its plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/conv_pallas.py``: ``csrc/osconv.cu``
computes y = Re ifft(fft(x) * H) for each real frame in one kernel, both
transforms on the register core of ``csrc/fft_regs.cuh`` and the product
in registers between them. Frames are paired as one complex signal
a + ib (K5b); one frame alone is the same kernel with a zero partner
(K5a). It carries the overlap-save FIR path (``ops/fir.py``), which hands
it the signal itself: :func:`overlap_save_cuda` reads each block at its
offset in the signal and writes only the block's valid samples, so the
overlapping frames are never materialised.

H is given in natural order, as the (n,) spectrum of a real filter
(``ops.dispatch.fft`` of the zero-padded taps). The JAX entry takes the
digit-permuted (n/128, 128) layout of its TPU kernels and rejects natural
order; this one is the mirror image and rejects any other shape, so a
permuted spectrum cannot be taken for a natural one.

``circular_convolve_steps`` repeats the kernel's arithmetic step by step
in PyTorch (pairing, register order, product, swapped-plane inverse, the
1/n at the store): the tests hold it against the JAX package here and
the kernel against it on the card.

The wrappers run a plain version only for a tensor on the CPU; for a
CUDA tensor they launch the kernel or raise. Launches are counted in
``ops.fft_cuda.LAUNCHES`` under "osconv" (K5a: one block in the launch)
and "osconv_pair" (K5b: two or more), whichever entry launched.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.complex import ComplexArray, is_power_of_two
from ..core.device import to_tensor
from ..core.fft import fft_axis0
from . import _build
from .fft_cuda import (LAUNCHES, MAX_DFT_N, MAX_ROWS_N, _device_pass_twiddles,
                       _fft_regs_steps, _plan_code_of, pass_twiddles,
                       points_per_thread, resolve_precision)

__all__ = ["circular_convolve_cuda", "circular_convolve_plain",
           "circular_convolve_steps", "overlap_save_cuda", "overlap_save_plain"]


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


def circular_convolve_steps(frames: torch.Tensor, hspec: ComplexArray,
                            n: int) -> torch.Tensor:
    """K5's arithmetic step by step in PyTorch, for the tests
    (``csrc/osconv.cu``): rows 2p and 2p + 1 of [B, n] as the planes of one
    complex signal (zeros beside an odd batch's last row), thread tid's
    register q holding sample tid + T*q, the register core forward, times
    H[k] in the same registers (the core is self-sorting, so register q
    holds bin tid + T*q again), the core once more on the swapped planes,
    the re plane times 1/n to row 2p and the im plane to row 2p + 1."""
    f2 = frames.reshape(-1, n)
    batch = f2.shape[0]
    pairs = (batch + 1) // 2
    a = f2[0::2]
    b = torch.zeros_like(a)
    b[: batch // 2] = f2[1::2]
    regs = points_per_thread(n)
    lanes = n // regs
    tid = torch.arange(lanes, device=f2.device)
    xr = [a[:, tid + lanes * q] for q in range(regs)]
    xi = [b[:, tid + lanes * q] for q in range(regs)]
    cast = np.float32 if f2.dtype == torch.float32 else np.float64
    tw = torch.from_numpy(pass_twiddles(n, cast)).to(f2)
    _fft_regs_steps(xr, xi, n, tw)
    hr, hi = hspec.real.to(f2), hspec.imag.to(f2)
    for q in range(regs):
        wr, wi = hr[tid + lanes * q], hi[tid + lanes * q]
        xr[q], xi[q] = xr[q] * wr - xi[q] * wi, xr[q] * wi + xi[q] * wr
    _fft_regs_steps(xi, xr, n, tw)            # n * ifft: the planes change places
    out = torch.empty((2 * pairs, n), dtype=f2.dtype, device=f2.device)
    for q in range(regs):
        out[0::2, tid + lanes * q] = xr[q] * (1.0 / n)     # exact: n = 2^k
        out[1::2, tid + lanes * q] = xi[q] * (1.0 / n)
    return out[:batch].reshape(frames.shape)


def overlap_save_plain(x: torch.Tensor, hspec: ComplexArray, n: int,
                       overlap: int) -> torch.Tensor:
    """:func:`overlap_save_cuda`'s plain version: the signal [..., L] padded
    by ``overlap`` zeros on the left and to whole blocks on the right, the
    overlapping blocks of n materialised, :func:`circular_convolve_plain`,
    the first ``overlap`` samples of each block dropped."""
    length = x.shape[-1]
    hop = n - overlap
    n_blocks = -(-length // hop)
    xp = torch.nn.functional.pad(x, (overlap, n_blocks * hop - length))
    y = circular_convolve_plain(xp.unfold(-1, n, hop), hspec, n)[..., overlap:]
    return y.reshape(x.shape[:-1] + (n_blocks * hop,))[..., :length]


def _check_block(dtype: torch.dtype, n: int) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the convolution kernel takes float32 frames, got {dtype}")
    if n > MAX_ROWS_N:
        raise ValueError(
            f"the convolution kernel covers n <= {MAX_ROWS_N}, got {n}: "
            "ops.fir runs larger blocks as fft x H -> ifft through ops.dispatch")


def _launch(entry: str, work: torch.Tensor, out: torch.Tensor, hspec: ComplexArray,
            n: int, blocks: int, *shape: int) -> None:
    """Launch the C entry ``entry`` of csrc/osconv.cu on float32 ``work`` into
    ``out``; ``shape`` is what the entry takes between the plan and the
    stream. Counted as K5a when the launch holds one block of n, K5b else."""
    hre, him = (p.to(device=work.device, dtype=torch.float32).contiguous()
                for p in (hspec.real, hspec.imag))
    lib = _build.library()
    tw = _device_pass_twiddles(n, work.device)
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        code = getattr(lib, entry)(work.data_ptr(), out.data_ptr(), hre.data_ptr(),
                                   him.data_ptr(), tw.data_ptr(), _plan_code_of(n),
                                   *shape, stream)
    key = "osconv_pair" if blocks >= 2 else "osconv"
    _build.check(lib, code, key)
    LAUNCHES[key] += 1


def _launch_osconv(f2: torch.Tensor, hspec: ComplexArray, n: int,
                   donate: bool) -> torch.Tensor:
    _check_block(f2.dtype, n)
    if donate and not f2.is_contiguous():
        raise ValueError("donate=True needs contiguous frames")
    # The kernel computes in float32; bfloat16 is cast around it, as the
    # TPU kernel reads its frames as float32 and stores the input dtype.
    work = f2.float().contiguous()
    # In place when the caller donates, or when ``work`` is already a copy.
    out = work if donate or work.data_ptr() != f2.data_ptr() else torch.empty_like(work)
    batch = work.shape[0]
    if batch > 0:
        _launch("osconv_f32", work, out, hspec, n, batch, batch, n)
    return out.to(f2.dtype)


def _launch_osconv_signal(x2: torch.Tensor, hspec: ComplexArray, n: int,
                          overlap: int) -> torch.Tensor:
    _check_block(x2.dtype, n)
    work = x2.float().contiguous()
    out = torch.empty_like(work)    # blocks overlap: never in place
    rows, length = work.shape
    _launch("osconv_signal_f32", work, out, hspec, n,
            rows * -(-length // (n - overlap)), rows, length, n, overlap)
    return out.to(x2.dtype)


def overlap_save_cuda(x: torch.Tensor, hspec: ComplexArray, n: int,
                      overlap: int) -> torch.Tensor:
    """The overlap-save filter of a real signal [batch..., L] in one kernel,
    without the frame tensor: block j of a row is its n samples from
    j*(n - overlap) - overlap (zeros before the row's start and past its
    end), convolved circularly with the filter whose natural-order
    spectrum is ``hspec`` (as :func:`circular_convolve_cuda` takes it), and
    its samples from ``overlap`` on are written at j*(n - overlap) of the
    [batch..., L] result. With the spectrum of k zero-padded taps and
    overlap >= k - 1 that is the causal FIR filter of the signal.

    Equal to :func:`overlap_save_plain`, which a CPU tensor runs; K5b's
    arithmetic on the same samples as the materialised blocks would give
    it. Needs a power-of-two n in 256..16384 and 0 <= overlap < n."""
    if n <= MAX_DFT_N or not is_power_of_two(n):
        raise ValueError(
            f"fused convolution needs a power-of-two n > {MAX_DFT_N}, got {n}")
    if not 0 <= overlap < n:
        raise ValueError(f"overlap must lie in 0..{n - 1}, got {overlap}")
    if x.numel() == 0:
        return x.clone()
    if not x.is_cuda:
        return overlap_save_plain(x, hspec, n, overlap)
    return _launch_osconv_signal(x.reshape(-1, x.shape[-1]), hspec, n,
                                 overlap).reshape(x.shape)


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
    frame (K5a, the same kernel beside a zero partner) gives Re(conv a); the
    JAX kernels behave the same way.

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
