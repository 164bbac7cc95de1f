"""Driver entry points: the flagship forward step and the multi-card dry
run, as ``__graft_entry__`` defines them for the JAX package.

:func:`entry` is the 1024-point Hann one-sided spectrum (BASELINE config 1)
built from window, ``ops.dispatch.fft``, magnitude, one-sided scaling and
the peak rule. :func:`dryrun_multichip` runs one full sharded pipeline step
on every rank of the process group at tiny shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .ops.dispatch import fft as _fft
from .public.spectrum import find_peak, scale_amplitude_one_sided
from .xform.fourier import bin_frequencies, create_window, magnitude

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(step, example_args) on ``device`` (None: the default device, the
    card): the same step and the same four-row batch (sine at bin 32, noise,
    ones, zeros) as the JAX entry."""
    device = resolve_device(device)
    n = 1024
    sample_rate = 48000.0
    win = create_window("hann", n, device=device)
    freqs = bin_frequencies(n, sample_rate, "one", device=device)

    def step(x):
        spec = _fft(x * win)
        amp = scale_amplitude_one_sided(magnitude(spec), n)
        peak = find_peak(amp, freqs)
        return amp, peak.index, peak.frequency, peak.amplitude

    rng = np.random.default_rng(0)
    t = np.arange(n) / sample_rate
    batch = np.stack([
        0.8 * np.sin(2 * np.pi * 1500.0 * t),
        rng.standard_normal(n),
        np.ones(n),
        np.zeros(n),
    ]).astype(np.float32)
    return step, (torch.from_numpy(batch).to(device),)


def dryrun_multichip(device=None) -> dict:
    """Run ONE full sharded step on every rank of the default process group
    (call it on each rank; ``device`` None is the default device, whose
    type names the mesh's): the time-sharded spectrogram, the halo FIR, the
    distributed FFT and its inverse, the WBFM chain, the channel-sharded
    PFB with its corner turn, the resampler, the frames-sharded PFB and the
    no-turn channel power, at the JAX dry run's tiny shapes and inputs
    (each rank takes its block of the same seeded arrays). With four or
    more ranks, an even number, the 2-D (host, chip) steps too: the PFB,
    channel power and FIR over the joint axis, and a batched FFT with the
    batch over "host". Returns the local result shapes and prints them."""
    import torch.distributed as dist

    from .core.complex import ComplexArray
    from .ops.polyphase import design_lowpass
    from .parallel import (data_mesh, dist_fft, dist_fft_shape, dist_ifft,
                           make_mesh, sharded_channel_power, sharded_fir_filter,
                           sharded_pfb_channelize, sharded_pfb_channelize_frames,
                           sharded_resample_poly, sharded_spectrogram,
                           sharded_wbfm_demod)

    device = resolve_device(device)
    mesh = data_mesh(device_type=device.type)
    d = mesh.size()
    p = dist.get_rank()
    rng = np.random.default_rng(0)

    def piece(a, axis=-1, parts=d, index=p):
        return np.split(np.asarray(a, np.float32), parts, axis=axis)[index]

    def block(a, axis=-1):
        return torch.from_numpy(np.ascontiguousarray(piece(a, axis))).to(device)

    # 1. time-block-sharded spectrogram
    n_fft, hop = 128, 32
    xs = block(rng.standard_normal(d * 8 * hop))
    r = sharded_spectrogram(xs, n_fft, hop, "hann", 48000.0, mesh=mesh)
    # 2. halo-exchange FIR
    taps = torch.as_tensor(design_lowpass(31, 0.25), dtype=torch.float32, device=device)
    y = sharded_fir_filter(xs, taps, mesh)
    # 3. distributed four-step FFT and its inverse (all-to-all corner turns)
    n2, n1 = dist_fft_shape(max(4096, d * d * 64), d)
    z = block(rng.standard_normal((n2, n1)))
    pf = dist_fft(ComplexArray(z, torch.zeros_like(z)), mesh)
    rt = dist_ifft(pf, mesh)
    # 3b. time-sharded WBFM chain (warm-up halo)
    wl = d * 800
    wiq = ComplexArray(block(rng.standard_normal(wl)), block(rng.standard_normal(wl)))
    wa = sharded_wbfm_demod(wiq, mesh, halo=400)
    # 4. channel-sharded PFB channelizer (corner turn)
    c = 4 * d
    iq = rng.standard_normal(d * c * 4) + 1j * rng.standard_normal(d * c * 4)
    iqc = ComplexArray(block(iq.real), block(iq.imag))
    ch = sharded_pfb_channelize(iqc, c, taps_per_branch=4, mesh=mesh,
                                channels_sharded_out=True)
    # 3c. time-sharded rational resampler
    rs = sharded_resample_poly(block(rng.standard_normal(d * 320)), 3, 4,
                               num_taps=25, mesh=mesh)
    # 4b. frames-sharded PFB and the no-turn consumer (an all-reduce only)
    mfr = d * 8
    iqf = rng.standard_normal(mfr * c) + 1j * rng.standard_normal(mfr * c)
    fr = ComplexArray(block(iqf.real.reshape(mfr, c), axis=0),
                      block(iqf.imag.reshape(mfr, c), axis=0))
    chf = sharded_pfb_channelize_frames(fr, c, taps_per_branch=4, mesh=mesh,
                                        channels_sharded_out=False)
    pw = sharded_channel_power(fr, c, taps_per_branch=4, mesh=mesh, n_fft=8)
    shapes = {"spectrogram": r.amplitude.shape, "fir": y.shape,
              "dist_fft": pf.real.shape, "roundtrip": rt.real.shape,
              "wbfm": wa.shape, "pfb": ch.real.shape, "resample": rs.shape,
              "pfb_frames": chf.real.shape, "power": pw.shape}
    # 5. the 2-D (host, chip) mesh: time over the host-major joint axis
    if d >= 4 and d % 2 == 0:
        mesh2 = make_mesh((2, d // 2), ("host", "chip"), device_type=device.type)
        joint = ("host", "chip")
        shapes["pfb2d"] = sharded_pfb_channelize(
            iqc, c, taps_per_branch=4, mesh=mesh2, axis=joint,
            channels_sharded_out=True).real.shape
        shapes["power2d"] = sharded_channel_power(
            fr, c, taps_per_branch=4, mesh=mesh2, axis=joint, n_fft=8).shape
        shapes["fir2d"] = sharded_fir_filter(iqc.real, taps, mesh2, axis=joint).shape
        # batched dist_fft: the batch over "host", the corner turn on "chip"
        host, chip = mesh2.get_coordinate()
        nb2, nb1 = dist_fft_shape(4096, d // 2)
        zb = piece(piece(rng.standard_normal((2, nb2, nb1)), 0, 2, host), -1, d // 2, chip)
        zb = torch.from_numpy(np.ascontiguousarray(zb)).to(device)
        shapes["fft2d"] = dist_fft(ComplexArray(zb, torch.zeros_like(zb)), mesh2,
                                   axis="chip", batch_axis="host").real.shape
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    shapes = {k: tuple(v) for k, v in shapes.items()}
    print(f"dryrun_multichip({d}) on rank {p}: "
          + ", ".join(f"{k} {v}" for k, v in shapes.items()) + " — OK", flush=True)
    return shapes
