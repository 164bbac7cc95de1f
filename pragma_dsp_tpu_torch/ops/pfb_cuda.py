"""Hand-written CUDA polyphase filterbank channelizer (K6), beside its
plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/pfb_pallas.py``: ``csrc/pfb.cu``
runs the T-tap branch filter out[m, p] = sum_t hp[t, p] * x[m - t, p] and
the C-point forward DFT across branches in one kernel, channels in natural
order, over complex frames [..., M, C] (frame m holds stream samples
[m*C, (m+1)*C)). Same convention as ``ops/channelizer.py``.

The wrappers run the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. Launches are counted in
``ops.fft_cuda.LAUNCHES`` under "pfb".
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.complex import ComplexArray, is_power_of_two
from ..core.device import resolve_device
from ..core.fft import fft_axis0
from . import _build
from .fft_cuda import LAUNCHES, MAX_ROWS_N, _device_tables, resolve_precision

__all__ = ["MIN_CHANNELS", "pfb_tap_table", "branch_filter_plain",
           "pfb_channelize_plain", "pfb_channelize_cuda",
           "pfb_channelize_frames_cuda"]

# The JAX kernel's bound (one 128-lane tile, pfb_pallas.py:211); kept as the
# port's public contract.
MIN_CHANNELS = 128


def pfb_tap_table(taps, channels: int, device=None) -> Tuple[torch.Tensor, int]:
    """The polyphase tap table hp[t, p] = h[t*C + p], zero-padded to T*C
    taps, T = ceil(K / C), in the taps' dtype; and T. A tensor of taps stays
    on its device; other taps go to ``device`` (the signal's, where a
    caller has one; None: the default device)."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.as_tensor(taps, device=resolve_device(device))
    k = taps.shape[0]
    t_taps = -(-k // channels)
    hp = torch.zeros(t_taps * channels, dtype=taps.dtype, device=taps.device)
    hp[:k] = taps
    return hp.reshape(t_taps, channels), t_taps


def branch_filter_plain(re: torch.Tensor, im: torch.Tensor, hp: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branch filtering of complex frames [..., M, C] by a [T, C] tap table:
    entry [m, p] = sum_t hp[t, p] * x[m - t, p], zero history, summed from
    t = 0 upward as T weighted shifted slices (the JAX package's order)."""
    t_taps = hp.shape[0]
    m = re.shape[-2]

    def one_plane(xb):
        xp = torch.nn.functional.pad(xb, (0, 0, t_taps - 1, 0))
        w = hp.to(dtype=xb.dtype, device=xb.device)
        acc = None
        for t in range(t_taps):
            term = xp[..., t_taps - 1 - t: t_taps - 1 - t + m, :] * w[t]
            acc = term if acc is None else acc + term
        return acc

    return one_plane(re), one_plane(im)


def pfb_channelize_plain(re: torch.Tensor, im: torch.Tensor, hp: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: :func:`branch_filter_plain`, then the Stockham
    FFT over the channel axis; frames [..., M, C] in and out."""
    vr, vi = branch_filter_plain(re, im, hp)
    c = vr.shape[-1]
    ore, oim = fft_axis0(vr.reshape(-1, c).T, vi.reshape(-1, c).T)
    return ore.T.reshape(vr.shape), oim.T.reshape(vi.shape)


def _prepare(taps, channels: int, precision: Optional[str], device
             ) -> Tuple[torch.Tensor, int]:
    """The JAX ``_pfb_prepare`` checks, and the float32 [T, C] tap table."""
    c = channels
    if c < MIN_CHANNELS or not is_power_of_two(c):
        raise ValueError(
            f"fused PFB needs a power-of-two channel count >= {MIN_CHANNELS}, "
            f"got {c}")
    resolve_precision(precision)
    hp, t_taps = pfb_tap_table(taps, c, device)
    return hp.to(torch.float32), t_taps


def _launch_pfb(xr: torch.Tensor, xi: torch.Tensor, hp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"the PFB kernel takes float32 planes, got "
                        f"{xr.dtype}/{xi.dtype}")
    if not (xr.is_cuda and xi.is_cuda and xr.device == xi.device):
        raise ValueError("the PFB kernel needs both planes on one CUDA device")
    t_taps, c = hp.shape
    if c > MAX_ROWS_N:
        raise ValueError(
            f"the PFB kernel covers C <= {MAX_ROWS_N}, got {c}: "
            "ops.channelizer runs more channels as a branch filter and "
            "ops.dispatch.fft")
    b, m, _ = xr.shape
    xr, xi = xr.contiguous(), xi.contiguous()
    ore, oim = torch.empty_like(xr), torch.empty_like(xi)
    if b * m == 0:
        return ore, oim
    hp = hp.to(xr.device).contiguous()
    lib = _build.library()
    twc, tws = _device_tables(c, None, xr.device)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        code = lib.pfb_f32(xr.data_ptr(), xi.data_ptr(), ore.data_ptr(),
                           oim.data_ptr(), hp.data_ptr(), twc.data_ptr(),
                           tws.data_ptr(), b * m, m, c, t_taps, stream)
    _build.check(lib, code, "pfb")
    LAUNCHES["pfb"] += 1
    return ore, oim


def pfb_channelize_frames_cuda(x: ComplexArray, taps, channels: int,
                               precision: Optional[str] = None) -> ComplexArray:
    """Fused PFB channelizer over an (M, C) frame view: IQ frames
    [..., M, C] -> [..., M, C] natural-order complex channel samples, one
    K6 launch for the whole batch. Needs a power-of-two C >= 128 (on CUDA,
    C <= 16384, float32). "bf16x3" runs the float32 kernel. CPU tensors
    run :func:`pfb_channelize_plain`."""
    c = channels
    if x.real.ndim < 2 or x.real.shape[-1] != c:
        raise ValueError(
            f"frames input must be [..., M, {c}], got {tuple(x.real.shape)}")
    hp, _ = _prepare(taps, c, precision, x.real.device)
    shape = x.real.shape
    batch = math.prod(shape[:-2])
    xr = x.real.reshape(batch, shape[-2], c)
    xi = x.imag.reshape(batch, shape[-2], c)
    if xr.is_cuda or xi.is_cuda:
        ore, oim = _launch_pfb(xr, xi, hp)
    else:
        ore, oim = pfb_channelize_plain(xr, xi, hp)
    return ComplexArray(ore.reshape(shape), oim.reshape(shape))


def pfb_channelize_cuda(x: ComplexArray, taps, channels: int,
                        precision: Optional[str] = None) -> ComplexArray:
    """Fused PFB channelizer: IQ [..., L] (L a multiple of C) -> [..., M, C]
    natural-order complex channel samples; the flat stream is viewed as
    frames (no copy) and goes to :func:`pfb_channelize_frames_cuda`."""
    c = channels
    length = x.real.shape[-1]
    if length % c != 0:
        raise ValueError(f"input length {length} not a multiple of C={c}")
    shape = x.real.shape[:-1] + (length // c, c)
    return pfb_channelize_frames_cuda(
        ComplexArray(x.real.reshape(shape), x.imag.reshape(shape)), taps, c,
        precision)
