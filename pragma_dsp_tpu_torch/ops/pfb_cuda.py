"""Hand-written CUDA polyphase filterbank channelizer (K6), beside its
plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/pfb_pallas.py``: ``csrc/pfb.cu``
runs the T-tap branch filter out[m, p] = sum_t hp[t, p] * x[m - t, p] and
the C-point forward DFT across branches in one kernel, channels in natural
order, over complex frames [..., M, C] (frame m holds stream samples
[m*C, (m+1)*C)). Same convention as ``ops/channelizer.py``.

The kernel sums a block of consecutive frames' branches from registers
(each frame read once, not T times) and transforms them on the register
core of ``csrc/fft_regs.cuh``; :func:`pfb_channelize_steps` repeats its
arithmetic step by step in PyTorch (block, thread, register and
shared-memory address included) for the tests.

The wrappers run the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. Launches are counted in
``ops.fft_cuda.LAUNCHES`` under "pfb".
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import ComplexArray, is_power_of_two
from ..core.device import resolve_device
from ..core.fft import fft_axis0
from . import _build
from .fft_cuda import (LAUNCHES, MAX_RADIX, MAX_ROWS_N, _device_pass_twiddles,
                       _fft_regs_steps, _plan_code_of, exchange_pad,
                       pass_twiddles, resolve_precision)

__all__ = ["MIN_CHANNELS", "pfb_tap_table", "branch_filter_plain",
           "pfb_channelize_plain", "pfb_channelize_steps", "pfb_channelize_cuda",
           "pfb_channelize_frames_cuda"]

# The JAX kernel's bound (one 128-lane tile, pfb_pallas.py:211); kept as the
# port's public contract.
MIN_CHANNELS = 128
# Complex points a block of K6 owns where C allows (kBlockPoints of
# csrc/pfb.cu), and the longest filter it sums from registers (kWindowTaps).
BLOCK_POINTS = 4096
WINDOW_TAPS = 8


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


def pfb_block_shape(channels: int) -> Tuple[int, int, int, int]:
    """How a block of K6 is cut (``BlockShape`` of csrc/pfb.cu): (F, L, B,
    stride). A block owns F = max(1, 4096 / C) consecutive frames of one
    batch row and has F * C/16 threads; in the filter phase a thread sums
    a run of L = min(F, 16) frames of each of its B = 16 / L branches; rows
    of the exchange lie ``stride`` floats apart (the padded row, skewed by
    its C/16 threads where those are fewer than a warp)."""
    frames = max(1, BLOCK_POINTS // channels)
    run = min(frames, MAX_RADIX)
    lanes = channels // MAX_RADIX
    return (frames, run, MAX_RADIX // run,
            exchange_pad(channels) + (lanes if lanes < 32 else 0))


def pfb_channelize_steps(re: torch.Tensor, im: torch.Tensor, hp: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's arithmetic step by step in PyTorch, for the tests: what
    ``csrc/pfb.cu`` does to frames [..., M, C] with a [T, C] tap table (a
    power-of-two C >= 128).

    A block owns F consecutive frames of one batch row
    (:func:`pfb_block_shape`). Filter phase: thread (run, slot) takes
    branches p = slot + (C/B)*b and frames run*L .. run*L + L - 1 of the
    block. For T <= 8 it holds the L + 7 samples from 7 frames before its
    run in a window, zeros where a frame lies before the row's start,
    beyond the filter's reach or past the row's end, and sums
    hp[t, p] * window[l + 7 - t] from t = 0 upward over the taps t < T; a
    longer filter sums min(T, frames so far) products straight from the
    input. The sums go to shared memory at row (run*L + l), word
    exchange_pad(p); thread tid of frame ``local`` reloads words
    tid + (C/16)*q into register q and the register core transforms them
    (with one frame a block, C >= 4096, the thread's 16 branches are its
    own transform's registers, summed a tap at a time over the frames that
    exist: the same sums in the same order, nothing staged).
    Frames past the row's end are computed on zeros and not stored."""
    t_taps, c = hp.shape
    shape = re.shape
    m = shape[-2]
    xr, xi = re.reshape(-1, m, c), im.reshape(-1, m, c)
    dev, dtype = re.device, re.dtype
    hp = hp.to(device=dev, dtype=dtype)
    frames, run_len, branches, stride = pfb_block_shape(c)
    lanes = c // MAX_RADIX
    slots = c // branches
    blocks = -(-m // frames)
    thread = torch.arange(frames * lanes, device=dev)
    run, slot = thread // slots, thread % slots
    m0 = torch.arange(blocks, device=dev)[:, None] * frames      # [blocks, 1]
    first = m0 + run * run_len                                   # [blocks, threads]
    valid = torch.clamp(m - first, max=run_len)
    history = WINDOW_TAPS - 1

    def sums(plane, p):
        """acc[l] of every thread for its branch p: [rows, blocks, threads]
        each."""
        def sample(f, keep):
            at = torch.where(keep, first + f, torch.zeros_like(first))
            got = plane[:, at, p.expand_as(at)]
            return torch.where(keep, got, torch.zeros_like(got))

        acc = []
        if t_taps <= WINDOW_TAPS:
            reach = torch.clamp(first, max=t_taps - 1)
            window = [sample(i - history, (i - history >= -reach) & (i - history < valid))
                      for i in range(run_len + history)]
            for l in range(run_len):
                a = torch.zeros_like(window[0])
                for t in range(t_taps):
                    a = a + hp[t, p] * window[l + history - t]
                acc.append(a)
        else:
            for l in range(run_len):
                taps = torch.where(l < valid, torch.clamp(l + first + 1, max=t_taps),
                                   torch.zeros_like(first))
                a = torch.zeros((plane.shape[0],) + first.shape, dtype=dtype, device=dev)
                for t in range(t_taps):
                    a = a + hp[t, p] * sample(l - t, t < taps)
                acc.append(a)
        return acc

    rows = xr.shape[0]
    tid = torch.arange(lanes, device=dev)
    if frames == 1 and t_taps <= WINDOW_TAPS:
        # p = tid + (C/16)*b: the sums are the registers of the thread's transform
        regs_r = [sums(xr, slot + b * slots)[0] for b in range(branches)]
        regs_i = [sums(xi, slot + b * slots)[0] for b in range(branches)]
    else:
        smem = torch.zeros((2, rows, blocks, frames * stride), dtype=dtype, device=dev)
        for b in range(branches):
            p = slot + b * slots
            for plane, x in enumerate((xr, xi)):
                for l, a in enumerate(sums(x, p)):
                    smem[plane][..., (run * run_len + l) * stride + exchange_pad(p)] = a
        local = torch.arange(frames, device=dev)[:, None] * stride
        regs_r, regs_i = ([smem[plane][..., local + exchange_pad(tid)
                                       + exchange_pad(lanes * q)].reshape(rows, blocks, -1)
                           for q in range(MAX_RADIX)] for plane in (0, 1))
    tw = torch.from_numpy(pass_twiddles(
        c, np.float32 if dtype == torch.float32 else np.float64)).to(dev)
    regs_r = [v.reshape(rows, blocks, frames, lanes) for v in regs_r]
    regs_i = [v.reshape(rows, blocks, frames, lanes) for v in regs_i]
    _fft_regs_steps(regs_r, regs_i, c, tw)
    ore = torch.empty((rows, blocks, frames, c), dtype=dtype, device=dev)
    oim = torch.empty_like(ore)
    for q in range(MAX_RADIX):
        ore[..., tid + lanes * q], oim[..., tid + lanes * q] = regs_r[q], regs_i[q]
    return (ore.reshape(rows, -1, c)[:, :m].reshape(shape),
            oim.reshape(rows, -1, c)[:, :m].reshape(shape))


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
    tw = _device_pass_twiddles(c, xr.device)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        code = lib.pfb_f32(xr.data_ptr(), xi.data_ptr(), ore.data_ptr(),
                           oim.data_ptr(), hp.data_ptr(), tw.data_ptr(),
                           _plan_code_of(c), b * m, m, c, t_taps, stream)
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
