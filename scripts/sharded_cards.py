#!/usr/bin/env python3
"""Hold every entry of the port's parallel/ against its direct op on
several CUDA cards, one process per card:

    python3 scripts/sharded_cards.py [--world 4] [--only dist_ifft,fir_auto,...]
        [--small]

Every entry runs on three mesh axes: the 1-D axis "x" over the ranks, and
the 2 x 2 ("host", "chip") mesh's joint axis in both orders (("host",
"chip") and ("chip", "host"): the second lists the ranks out of the
process group's order). The inputs are the one-card cells' widths split
over the ranks: [128, 480000] for the FIR filter (both methods) and the
resamplers ([128, 479232], 468 hops, for the spectrogram: a block must be
a multiple of hop), 393216 frames of 256 channels (1.007e8 IQ samples) for
the channelizer, its frames entry and the channel power, [64, 2.4e6] FM IQ
for the receiver, and dist_fft_1m_b256_4chip's [256, 1024, 1024] for
dist_fft and dist_ifft, which run first. Each rank makes the whole seeded
input on its card (the same numbers on every rank), takes its block at its
position along the axis, runs the sharded entry, and holds its block of
the result to two gates:

* the same entry's one-card port call on the whole input, on its card:
  ``torch.equal`` for the spectrogram (K4) and the channelizer (K6, frames
  and channels out), where a frame's result does not depend on the block
  it lies in; else >= 125 dB; the channel power (replicated) also equal
  on every rank. dist_ifft's input is the sharded forward's output
  gathered (``all_gather``), its one-card call ``ifft_big_from_permuted``
  of it;
* a float64 numpy/scipy oracle at bench.py's gates (FIR 110 dB; the
  spectrogram, channelizer, channel power and FFT 105; the resamplers and
  the receiver 100) on a few rows or frames of the rank's block. dist_ifft
  is held to ``numpy.fft.ifft`` of the forward's output in natural order,
  and its roundtrip to the input.

Prints the card (nvidia-smi name and power limit), one line for each entry
and axis (every rank's readings, the sharded and direct call's ms on rank
0), and one JSON object last; exits 1 if a gate fails on any rank.
``--small`` runs four gloo ranks on the CPU at tiny shapes (the plain
versions of the kernels) to rehearse the script. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 1337
AXES = {"x": ("1d", "x"), "host,chip": ("2d", ("host", "chip")),
        "chip,host": ("2d", ("chip", "host"))}
VS_DIRECT_DB = 125.0          # chip_smoke.py's PAR_VS_DIRECT_DB
FIR_GATE_DB, GATE_DB, C34_GATE_DB = 110.0, 105.0, 100.0     # bench.py's gates
# Full width (the one-card cells split over the ranks) and the CPU rehearsal.
SHAPES = {
    False: dict(rows=128, length=480000, spec_len=479232, n_fft=4096, hop=1024,
                c=256, tpb=8, frames=393216, n_pow=128, rx_rows=64, rx_len=2400000,
                fft=(256, 1024, 1024), check_rows=(0, 127), check_frames=1024,
                fft_rows=(0, 255), rx_check=(0, 63), runs=5),
    True: dict(rows=4, length=4 * 3200, spec_len=4 * 1024, n_fft=256, hop=64,
               c=16, tpb=8, frames=4 * 32, n_pow=8, rx_rows=2, rx_len=4 * 20000,
               fft=(2, 256, 256), check_rows=(0, 3), check_frames=16, fft_rows=(0, 1),
               rx_check=(0, 1), runs=1),
}
ENTRIES = ("dist_ifft", "dist_fft", "fir_auto", "fir_direct", "spectrogram",
           "pfb_turn", "pfb_frames_out", "pfbf_turn", "pfbf_frames_out", "channel_power",
           "upfirdn", "resample_poly", "wbfm")


def snr_db(ref, got) -> float:
    ref = np.asarray(ref)
    got = np.asarray(got)
    if np.iscomplexobj(ref) or np.iscomplexobj(got):
        ref = np.stack([ref.real, ref.imag]).astype(np.float64)
        got = np.stack([np.real(got), np.imag(got)]).astype(np.float64)
    err = float(((got.astype(np.float64) - ref.astype(np.float64)) ** 2).sum())
    return float("inf") if err == 0.0 else 10 * np.log10(
        float((ref.astype(np.float64) ** 2).sum()) / err)


def onesided_oracle(frames: np.ndarray, window: np.ndarray) -> np.ndarray:
    n = frames.shape[-1]
    ref = np.abs(np.fft.rfft(frames.astype(np.float64) * window, axis=-1))
    scale = np.full(n // 2 + 1, 2.0 / n)
    scale[0] = scale[-1] = 1.0 / n
    return ref * scale


def pfb_oracle(z: np.ndarray, taps: np.ndarray, c: int, skip: int = 0) -> np.ndarray:
    """bench.py's config-5 oracle in float64: frames ``skip``.. of the
    channelizer of ``z`` (the first ``skip`` frames are history)."""
    tpb = -(-taps.shape[0] // c)
    m = z.shape[-1] // c
    hp = np.zeros((tpb, c))
    hp.ravel()[:taps.shape[0]] = taps
    xb = np.concatenate([np.zeros((tpb - 1) * c, complex), z]).reshape(tpb - 1 + m, c)
    v = np.zeros((m, c), complex)
    for t in range(tpb):
        v += hp[t] * xb[tpb - 1 - t: tpb - 1 - t + m]
    return np.fft.fft(v[skip:], axis=-1)


class Rank:
    """One rank's state: its card, meshes and what its entries keep."""

    def __init__(self, args):
        import torch

        from pragma_dsp_tpu_torch import parallel as par
        from pragma_dsp_tpu_torch import set_default_device

        self.torch, self.par, self.args = torch, par, args
        self.small = args.small
        self.s = SHAPES[args.small]
        par.init_multihost(f"file://{os.path.join(args.dir, 'rendezvous')}", args.world,
                           args.rank, backend="gloo" if args.small else "nccl")
        if args.small:
            torch.set_num_threads(1)
            self.dev = torch.device("cpu")
        else:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        set_default_device(self.dev)
        kind = "cpu" if args.small else "cuda"
        self.meshes = {"1d": par.data_mesh(device_type=kind),
                       "2d": par.make_mesh((2, 2), ("host", "chip"), device_type=kind)}
        # dist_ifft's input on the axis being run: the sharded forward's
        # output "p" and it gathered, "full"; the float64 channel power
        self.ifft, self.power = {}, {}

    def sync(self):
        if not self.small:
            self.torch.cuda.synchronize()

    def ms(self, fn) -> float:
        """The median ms of ``runs`` calls (CUDA events; wall on the CPU)."""
        torch = self.torch
        times = []
        for _ in range(self.s["runs"]):
            self.torch.distributed.barrier()
            if self.small:
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
                continue
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def randn(self, shape, salt: int):
        gen = self.torch.Generator(device=self.dev).manual_seed(SEED + salt)
        return self.torch.randn(shape, generator=gen, device=self.dev)

    def host(self, t) -> np.ndarray:
        return t.detach().to("cpu").numpy()


def block(t, pos: int, d: int, dim: int):
    """Block ``pos`` of ``d`` along ``dim`` of a tensor or an array."""
    n = t.shape[dim] // d
    index = [slice(None)] * t.ndim
    index[dim] = slice(pos * n, (pos + 1) * n)
    return t[tuple(index)]


def planes(o):
    """The tensors of a result: a spectrogram's amplitude and phase, a
    ComplexArray's planes, or the tensor."""
    from pragma_dsp_tpu_torch.core import ComplexArray
    if hasattr(o, "amplitude"):
        return (o.amplitude, o.phase)
    if isinstance(o, ComplexArray):
        return (o.real, o.imag)
    return (o,)


def dev_snr_db(refs, gots) -> float:
    """SNR of ``gots`` against ``refs`` in float64 on their device."""
    sig = sum(float((r.double() ** 2).sum()) for r in refs)
    err = sum(float(((g.double() - r.double()) ** 2).sum()) for r, g in zip(refs, gots))
    return float("inf") if err == 0.0 else 10 * np.log10(sig / err)


def run_entry(rk: Rank, name: str, axis_label: str) -> dict:
    """One entry on one axis: this rank's readings."""
    torch = rk.torch
    from pragma_dsp_tpu_torch.parallel.mesh import _flat_index
    s = rk.s
    mesh_key, axis = AXES[axis_label]
    mesh = rk.meshes[mesh_key]
    d = rk.args.world
    pos = _flat_index(mesh, axis)
    e = ENTRY_DEFS[name]
    x = e["input"](rk)
    mine = e["split"](x, pos, d)
    got = e["sharded"](rk, mine, mesh, axis)
    rk.sync()
    direct_out = e["direct"](rk, x)
    want = e["slice"](rk, direct_out, pos, d)
    gp, wp = planes(got), planes(want)
    shapes_ok = all(tuple(a.shape) == tuple(b.shape) for a, b in zip(gp, wp))
    equal = shapes_ok and all(torch.equal(a, b) for a, b in zip(gp, wp))
    vs_direct = dev_snr_db(wp, gp) if shapes_ok else -1.0
    oracle_db = e["oracle"](rk, x, got, pos, d)
    ok_direct = equal if e["equal"] else (shapes_ok and vs_direct >= VS_DIRECT_DB)
    extra = e.get("extra", lambda *a: {})(rk, got, mesh, axis)
    ok = ok_direct and oracle_db >= e["gate"] and extra.get("ok", True)
    row = {"entry": name, "axis": axis_label, "rank": rk.args.rank, "position": pos,
           "shape": list(gp[0].shape), "equal": equal, "vs_direct_db": vs_direct,
           "oracle_db": oracle_db, "gate_db": e["gate"], "equal_required": e["equal"],
           "ok": bool(ok), **{k: v for k, v in extra.items() if k != "ok"}}
    row["sharded_ms"] = rk.ms(lambda: e["sharded"](rk, mine, mesh, axis))
    row["direct_ms"] = rk.ms(lambda: e["direct"](rk, x))
    del x, mine, got, direct_out, want
    if not rk.small:
        torch.cuda.empty_cache()
    return row


# ── the entries ──────────────────────────────────────────────────────
#
# input(rk) -> the whole input on this rank's card; split(x, pos, d) -> this
# rank's block; sharded(rk, block, mesh, axis); direct(rk, x) -> the
# one-card call; slice(rk, out, pos, d) -> its part of the direct result
# that this rank's block must equal; oracle(rk, x, got, pos, d) -> dB.

def _cplx(rk, shape, salt):
    from pragma_dsp_tpu_torch.core import ComplexArray
    return ComplexArray(rk.randn(shape, salt), rk.randn(shape, salt + 1))


def _csplit(x, pos, d, dim=-1):
    from pragma_dsp_tpu_torch.core import ComplexArray
    return ComplexArray(block(x.real, pos, d, dim).contiguous(),
                        block(x.imag, pos, d, dim).contiguous())


def _chost(rk, z, idx=...):
    return rk.host(z.real[idx]).astype(np.float64) + 1j * rk.host(z.imag[idx])


# dist_fft / dist_ifft: [B, N2, N1], a rank [B, N2, N1/D] (columns), its
# output [B, N2/D, N1] (permuted k2 rows)

def fft_input(rk):
    return _cplx(rk, rk.s["fft"], 10)


def _perm_ref(z_rows: np.ndarray) -> np.ndarray:
    """The permuted spectrum X[k2 + N2*k1] at [k2, k1] of natural (N2, N1)
    views, float64."""
    b, n2, n1 = z_rows.shape
    return np.swapaxes(np.fft.fft(z_rows.reshape(b, -1), axis=-1).reshape(b, n1, n2), -1, -2)


def fft_direct(rk, x):
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops.fft_big import fft_big_permuted
    b = x.real.shape[0]
    return fft_big_permuted(ComplexArray(x.real.reshape(b, -1), x.imag.reshape(b, -1)))


def fft_oracle(rk, x, got, pos, d):
    rows = list(rk.s["fft_rows"])
    ref = _perm_ref(_chost(rk, x, rows))
    return snr_db(block(ref, pos, d, 1), _chost(rk, got, rows))


def _gather_rows(rk, p, mesh, axis, d):
    """The permuted forward output of every position, gathered in the
    axis' order: [B, N2, N1] on this rank's card."""
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.parallel.mesh import _flat_index
    torch, tdist = rk.torch, rk.torch.distributed
    world = tdist.get_world_size()
    positions = [None] * world
    tdist.all_gather_object(positions, _flat_index(mesh, axis))
    out = []
    for plane in (p.real, p.imag):
        bufs = [torch.empty_like(plane) for _ in range(world)]
        tdist.all_gather(bufs, plane.contiguous())
        ordered = [bufs[positions.index(q)] for q in range(d)]
        out.append(torch.cat(ordered, dim=-2))
    return ComplexArray(*out)


def ifft_sharded(rk, mine, mesh, axis):
    return rk.par.dist_ifft(rk.ifft["p"], mesh, axis)


def ifft_direct(rk, x):
    """ifft_big_from_permuted of the sharded forward's output, gathered."""
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops.fft_big import ifft_big_from_permuted
    full = rk.ifft["full"]
    out = ifft_big_from_permuted(full)
    return ComplexArray(*(t.reshape(full.real.shape) for t in (out.real, out.imag)))


def ifft_oracle(rk, x, got, pos, d):
    """numpy.fft.ifft of the sharded forward's output in natural order, and
    the roundtrip to the input (the smaller of the two readings)."""
    rows = list(rk.s["fft_rows"])
    full = rk.ifft["full"]
    b, n2, n1 = full.real.shape
    nat = np.swapaxes(_chost(rk, full, rows), -1, -2).reshape(len(rows), -1)
    ref = np.fft.ifft(nat, axis=-1).reshape(len(rows), n2, n1)
    cols = slice(pos * n1 // d, (pos + 1) * n1 // d)
    got_rows = _chost(rk, got, rows)
    vs_ifft = snr_db(ref[:, :, cols], got_rows)
    vs_input = snr_db(_chost(rk, x, rows)[:, :, cols], got_rows)
    rk.ifft["readings"] = (vs_ifft, vs_input)
    return min(vs_ifft, vs_input)


# The filters and resamplers: [rows, length] float32, blocks along time.

def signal_input(rk):
    return rk.randn((rk.s["rows"], rk.s["length"]), 20)


def time_split(x, pos, d):
    return block(x, pos, d, -1).contiguous()


def fir_taps():
    from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass
    return design_lowpass(127, 0.2).astype(np.float32)


def fir_oracle(rk, x, got, pos, d):
    from scipy.signal import lfilter
    rows = list(rk.s["check_rows"])
    ref = lfilter(fir_taps().astype(np.float64), 1.0, rk.host(x[rows]).astype(np.float64),
                  axis=-1)
    return snr_db(block(ref, pos, d, -1), rk.host(got[rows]))


def spec_input(rk):
    return rk.randn((rk.s["rows"], rk.s["spec_len"]), 30)


def spec_slice(rk, r, pos, d):
    """This rank's frames, amplitude and phase: block/hop of them from
    pos*block/hop (the last rank's run to the end)."""
    per = rk.s["spec_len"] // d // rk.s["hop"]
    stop = r.amplitude.shape[-2] if pos == d - 1 else (pos + 1) * per
    return type(r)(r.frequencies, r.amplitude[..., pos * per:stop, :],
                   r.phase[..., pos * per:stop, :], r.peak)


def spec_oracle(rk, x, got, pos, d):
    from pragma_dsp_tpu_torch.xform import window_values
    s = rk.s
    rows = list(s["check_rows"])
    per = s["spec_len"] // d // s["hop"]
    f0 = pos * per
    nf = got.amplitude.shape[-2]
    idx = (f0 + np.arange(nf))[:, None] * s["hop"] + np.arange(s["n_fft"])[None, :]
    ref = onesided_oracle(rk.host(x[rows]).astype(np.float64)[:, idx],
                          window_values("hann", s["n_fft"]))
    return snr_db(ref, rk.host(got.amplitude[rows]))


# The channelizer: 393216 frames of 256 channels.

def pfb_input(rk):
    s = rk.s
    return _cplx(rk, (s["frames"] * s["c"],), 40)


def pfb_taps64(rk):
    from pragma_dsp_tpu_torch.ops.channelizer import pfb_taps
    return pfb_taps(rk.s["c"], rk.s["tpb"])


def pfb_slice_turn(rk, y, pos, d):
    return _csplit(y, pos, d, -1)


def pfb_slice_frames(rk, y, pos, d):
    return _csplit(y, pos, d, -2)


def _pfb_check(rk, z_host_fn, got, pos, d, turn):
    """float64 channelizer of check_frames frames: the stream's first ones
    for channels out (this rank's channels), this rank's first ones (with
    their history) for frames out."""
    s = rk.s
    c, tpb, nchk = s["c"], s["tpb"], s["check_frames"]
    taps = pfb_taps64(rk)
    if turn:
        ref = pfb_oracle(z_host_fn(0, nchk), taps, c)
        ref = ref[:, pos * c // d:(pos + 1) * c // d]
    else:
        f0 = pos * (s["frames"] // d)
        start = max(0, f0 - (tpb - 1))
        ref = pfb_oracle(z_host_fn(start, f0 + nchk), taps, c, skip=f0 - start)
    return snr_db(ref, _chost(rk, got, (slice(0, nchk),)))


def pfb_oracle_db(turn):
    def fn(rk, x, got, pos, d):
        c = rk.s["c"]
        return _pfb_check(rk, lambda a, b: _chost(rk, x, slice(a * c, b * c)), got, pos, d,
                          turn)
    return fn


def pfbf_input(rk):
    s = rk.s
    return _cplx(rk, (s["frames"], s["c"]), 50)


def pfbf_oracle_db(turn):
    def fn(rk, x, got, pos, d):
        return _pfb_check(rk, lambda a, b: _chost(rk, x, slice(a, b)).ravel(), got, pos, d,
                          turn)
    return fn


def power_direct(rk, x):
    """The same Welch over the direct channelizer, in torch (chip_smoke.py
    phase 21's)."""
    from pragma_dsp_tpu_torch.core import ComplexArray
    from pragma_dsp_tpu_torch.ops import dispatch, pfb_channelize_frames
    from pragma_dsp_tpu_torch.xform import create_window, window_values
    s = rk.s
    y = pfb_channelize_frames(x, s["c"])
    nseg = s["frames"] // s["n_pow"]
    seg = (nseg, s["n_pow"], s["c"])
    w = create_window("hann", s["n_pow"], device=rk.dev)[:, None]
    spec = dispatch.fft(ComplexArray(y.real.reshape(seg) * w, y.imag.reshape(seg) * w), axis=-2)
    wpow = float(np.sum(window_values("hann", s["n_pow"]) ** 2))
    return rk.torch.sum(spec.real * spec.real + spec.imag * spec.imag, dim=-3) / (
        nseg * s["n_pow"] * wpow)


def power_oracle(rk, x, got, pos, d):
    """float64 numpy Welch over the float64 channelizer of every frame
    (made once a rank)."""
    from pragma_dsp_tpu_torch.xform import window_values
    s = rk.s
    if "p64" not in rk.power:
        y64 = pfb_oracle(_chost(rk, x).ravel(), pfb_taps64(rk), s["c"])
        nseg = s["frames"] // s["n_pow"]
        wv = window_values("hann", s["n_pow"])
        segs = np.fft.fft(y64.reshape(nseg, s["n_pow"], s["c"]) * wv[None, :, None], axis=1)
        rk.power["p64"] = (np.abs(segs) ** 2).mean(axis=0) / (s["n_pow"] * np.sum(wv ** 2))
    return snr_db(rk.power["p64"], rk.host(got))


def power_extra(rk, got, mesh, axis):
    """The replicated result is the same on every rank."""
    tdist = rk.torch.distributed
    first = got.clone()
    tdist.broadcast(first, src=0)
    same = bool(rk.torch.equal(first, got))
    return {"same_on_every_rank": same, "ok": same}


# upfirdn 1/10 (the receiver's channel stage) and resample_poly 147/160

def up_taps():
    from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass
    return design_lowpass(127, 0.1)


def prefix_slice(up, down):
    def fn(rk, y, pos, d):
        per = rk.s["length"] // d * up // down
        return y[..., pos * per:(pos + 1) * per]
    return fn


def up_oracle(taps_fn, up, down):
    def fn(rk, x, got, pos, d):
        from scipy.signal import upfirdn as sp_upfirdn
        rows = list(rk.s["check_rows"])
        xr = rk.host(x[rows]).astype(np.float64)
        ref = np.stack([sp_upfirdn(taps_fn(), r, up, down) for r in xr])
        per = got.shape[-1]
        return snr_db(ref[:, pos * per:(pos + 1) * per], rk.host(got[rows]))
    return fn


def rs_taps():
    from pragma_dsp_tpu_torch.ops.polyphase import resampler_taps
    return resampler_taps(147, 160)


# The receiver: [64, 2.4e6] FM IQ (chip_smoke.py phase 20's signal)

def rx_input(rk):
    from pragma_dsp_tpu_torch.core import ComplexArray
    torch, s = rk.torch, rk.s
    n = s["rx_len"]
    t = torch.arange(n, device=rk.dev, dtype=torch.float64) / 2.4e6
    tone = 1000.0 + 50.0 * torch.arange(s["rx_rows"], device=rk.dev, dtype=torch.float64)
    ph = 0.5 + 2 * np.pi * 75e3 * torch.cumsum(
        0.7 * torch.sin(2 * np.pi * tone[:, None] * t)
        + 0.2 * torch.sin(2 * np.pi * 4000.0 * t), dim=-1) / 2.4e6
    noise = 0.001 * rk.randn((2, s["rx_rows"], n), 60)
    return ComplexArray(torch.cos(ph).float() + noise[0], torch.sin(ph).float() + noise[1])


def rx_direct(rk, x):
    from pragma_dsp_tpu_torch.models import wbfm_demod
    return wbfm_demod(x)[..., :rk.s["rx_len"] // 50]        # the quantum, up = 1


def rx_slice(rk, y, pos, d):
    per = rk.s["rx_len"] // d // 50
    return y[..., pos * per:(pos + 1) * per]


def rx_oracle(rk, x, got, pos, d):
    """bench.py's independent float64 scipy/numpy chain."""
    from scipy.signal import lfilter, upfirdn as sp_upfirdn

    from pragma_dsp_tpu_torch.models import FmReceiver
    rx = FmReceiver(device="cpu")
    alpha = float(np.exp(-1.0 / (240e3 * 75e-6)))
    refs = []
    for r in rk.s["rx_check"]:
        z = _chost(rk, x, r)
        chan = sp_upfirdn(rx._chan_taps, z, 1, 10)
        prev = np.concatenate([[1.0 + 0.0j], chan[:-1]])
        xif = np.angle(chan * np.conj(prev)) * (240e3 / (2 * np.pi)) / 75e3
        refs.append(sp_upfirdn(rx._audio_taps, lfilter([1.0 - alpha], [1.0, -alpha], xif),
                               1, 5))
    per = got.shape[-1]
    ref = np.stack(refs)[:, pos * per:(pos + 1) * per]
    return snr_db(ref, rk.host(got[list(rk.s["rx_check"])]))


def _defs():
    def par(rk):
        return rk.par

    return {
        "dist_ifft": dict(input=fft_input, split=lambda x, pos, d: _csplit(x, pos, d),
                          sharded=ifft_sharded,
                          direct=ifft_direct, slice=lambda rk, y, pos, d: _csplit(y, pos, d),
                          oracle=ifft_oracle, gate=GATE_DB, equal=False),
        "dist_fft": dict(input=fft_input, split=lambda x, pos, d: _csplit(x, pos, d),
                         sharded=lambda rk, m, mesh, axis: par(rk).dist_fft(m, mesh, axis),
                         direct=fft_direct,
                         slice=lambda rk, y, pos, d: _csplit(y, pos, d, -2),
                         oracle=fft_oracle, gate=GATE_DB, equal=False),
        "fir_auto": dict(input=signal_input, split=time_split,
                         sharded=lambda rk, m, mesh, axis: par(rk).sharded_fir_filter(
                             m, fir_taps(), mesh, axis, "auto"),
                         direct=lambda rk, x: _fir(rk, x, "auto"),
                         slice=lambda rk, y, pos, d: block(y, pos, d, -1),
                         oracle=fir_oracle, gate=FIR_GATE_DB, equal=False),
        "fir_direct": dict(input=signal_input, split=time_split,
                           sharded=lambda rk, m, mesh, axis: par(rk).sharded_fir_filter(
                               m, fir_taps(), mesh, axis, "direct"),
                           direct=lambda rk, x: _fir(rk, x, "direct"),
                           slice=lambda rk, y, pos, d: block(y, pos, d, -1),
                           oracle=fir_oracle, gate=FIR_GATE_DB, equal=False),
        "spectrogram": dict(input=spec_input, split=time_split,
                            sharded=lambda rk, m, mesh, axis: par(rk).sharded_spectrogram(
                                m, rk.s["n_fft"], rk.s["hop"], "hann", 48000.0, mesh=mesh,
                                axis=axis),
                            direct=lambda rk, x: _spectrogram(rk, x),
                            slice=spec_slice, oracle=spec_oracle, gate=GATE_DB, equal=True),
        "pfb_turn": dict(input=pfb_input, split=lambda x, pos, d: _csplit(x, pos, d),
                         sharded=lambda rk, m, mesh, axis: par(rk).sharded_pfb_channelize(
                             m, rk.s["c"], mesh=mesh, axis=axis, channels_sharded_out=True),
                         direct=lambda rk, x: _pfb(rk, x), slice=pfb_slice_turn,
                         oracle=pfb_oracle_db(True), gate=GATE_DB, equal=True),
        "pfb_frames_out": dict(input=pfb_input, split=lambda x, pos, d: _csplit(x, pos, d),
                               sharded=lambda rk, m, mesh, axis:
                               par(rk).sharded_pfb_channelize(
                                   m, rk.s["c"], mesh=mesh, axis=axis,
                                   channels_sharded_out=False),
                               direct=lambda rk, x: _pfb(rk, x), slice=pfb_slice_frames,
                               oracle=pfb_oracle_db(False), gate=GATE_DB, equal=True),
        "pfbf_turn": dict(input=pfbf_input, split=lambda x, pos, d: _csplit(x, pos, d, -2),
                          sharded=lambda rk, m, mesh, axis:
                          par(rk).sharded_pfb_channelize_frames(
                              m, rk.s["c"], mesh=mesh, axis=axis, channels_sharded_out=True),
                          direct=lambda rk, x: _pfbf(rk, x), slice=pfb_slice_turn,
                          oracle=pfbf_oracle_db(True), gate=GATE_DB, equal=True),
        "pfbf_frames_out": dict(input=pfbf_input,
                                split=lambda x, pos, d: _csplit(x, pos, d, -2),
                                sharded=lambda rk, m, mesh, axis:
                                par(rk).sharded_pfb_channelize_frames(
                                    m, rk.s["c"], mesh=mesh, axis=axis,
                                    channels_sharded_out=False),
                                direct=lambda rk, x: _pfbf(rk, x), slice=pfb_slice_frames,
                                oracle=pfbf_oracle_db(False), gate=GATE_DB, equal=True),
        "channel_power": dict(input=pfbf_input, split=lambda x, pos, d: _csplit(x, pos, d, -2),
                              sharded=lambda rk, m, mesh, axis:
                              par(rk).sharded_channel_power(
                                  m, rk.s["c"], mesh=mesh, axis=axis, n_fft=rk.s["n_pow"]),
                              direct=power_direct, slice=lambda rk, p, pos, d: p,
                              oracle=power_oracle, gate=GATE_DB, equal=False,
                              extra=power_extra),
        "upfirdn": dict(input=signal_input, split=time_split,
                        sharded=lambda rk, m, mesh, axis: par(rk).sharded_upfirdn(
                            m, up_taps(), 1, 10, mesh=mesh, axis=axis),
                        direct=lambda rk, x: _upfirdn(x, up_taps(), 1, 10),
                        slice=prefix_slice(1, 10), oracle=up_oracle(up_taps, 1, 10),
                        gate=C34_GATE_DB, equal=False),
        "resample_poly": dict(input=signal_input, split=time_split,
                              sharded=lambda rk, m, mesh, axis: par(rk).sharded_resample_poly(
                                  m, 147, 160, mesh=mesh, axis=axis),
                              direct=lambda rk, x: _resample(x),
                              slice=prefix_slice(147, 160), oracle=up_oracle(rs_taps, 147, 160),
                              gate=C34_GATE_DB, equal=False),
        "wbfm": dict(input=rx_input, split=lambda x, pos, d: _csplit(x, pos, d),
                     sharded=lambda rk, m, mesh, axis: par(rk).sharded_wbfm_demod(m, mesh, axis),
                     direct=rx_direct, slice=rx_slice, oracle=rx_oracle, gate=C34_GATE_DB,
                     equal=False),
    }


def _fir(rk, x, method):
    from pragma_dsp_tpu_torch.ops import fir_filter
    return fir_filter(x, fir_taps(), method)


def _spectrogram(rk, x):
    from pragma_dsp_tpu_torch.stream import spectrogram
    return spectrogram(x, rk.s["n_fft"], rk.s["hop"], "hann", 48000.0)


def _pfb(rk, x):
    from pragma_dsp_tpu_torch.ops import pfb_channelize
    return pfb_channelize(x, rk.s["c"])


def _pfbf(rk, x):
    from pragma_dsp_tpu_torch.ops import pfb_channelize_frames
    return pfb_channelize_frames(x, rk.s["c"])


def _upfirdn(x, taps, up, down):
    from pragma_dsp_tpu_torch.ops import upfirdn
    return upfirdn(x, taps, up, down)


def _resample(x):
    from pragma_dsp_tpu_torch.ops import resample_poly
    return resample_poly(x, 147, 160)


ENTRY_DEFS = _defs()


def rank_main(args) -> int:
    rk = Rank(args)
    tdist = rk.torch.distributed
    names = args.only.split(",") if args.only else list(ENTRIES)
    for name in names:
        for axis_label in AXES:
            try:
                if name == "dist_ifft":
                    # the forward's output on this axis, gathered for the
                    # direct call and the oracle
                    mesh_key, axis = AXES[axis_label]
                    mesh = rk.meshes[mesh_key]
                    x = fft_input(rk)
                    from pragma_dsp_tpu_torch.parallel.mesh import _flat_index
                    mine = _csplit(x, _flat_index(mesh, axis), args.world)
                    rk.ifft.clear()
                    rk.ifft["p"] = rk.par.dist_fft(mine, mesh, axis)
                    rk.ifft["full"] = _gather_rows(rk, rk.ifft["p"], mesh, axis,
                                                      args.world)
                    del x, mine
                row = run_entry(rk, name, axis_label)
                if name == "dist_ifft":
                    row["vs_ifft_db"], row["roundtrip_db"] = rk.ifft["readings"]
                    rk.ifft.clear()
            except Exception as exc:  # noqa: BLE001 - reported, and the run fails
                row = {"entry": name, "axis": axis_label, "rank": args.rank, "ok": False,
                       "error": f"{type(exc).__name__}: {exc}",
                       "trace": traceback.format_exc()[-1500:]}
            everyone = [None] * args.world
            tdist.all_gather_object(everyone, row)
            if args.rank == 0:
                with open(os.path.join(args.dir, "rows.jsonl"), "a", encoding="utf-8") as f:
                    f.write(json.dumps(everyone) + "\n")
    tdist.barrier()
    tdist.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "pragma_dsp_tpu"))
    if loaded:
        raise SystemExit(f"rank {args.rank} loaded {loaded}")
    return 0


def describe(rows) -> str:
    r0 = rows[0]
    if any("error" in r for r in rows):
        return "; ".join(f"rank {r['rank']}: {r.get('error')}" for r in rows if "error" in r)
    parts = []
    for r in rows:
        direct = "torch.equal" if r["equal"] else f"{r['vs_direct_db']:.1f} dB"
        extra = ""
        if "vs_ifft_db" in r:
            extra = (f", vs numpy ifft {r['vs_ifft_db']:.2f} dB, "
                     f"roundtrip {r['roundtrip_db']:.2f} dB")
        if "same_on_every_rank" in r:
            extra = f", same on every rank {r['same_on_every_rank']}"
        parts.append(f"rank {r['rank']} (position {r['position']}): {r['shape']} vs direct "
                     f"{direct}, float64 {r['oracle_db']:.2f} dB{extra}")
    return (f"sharded {r0['sharded_ms']:.4f} ms, direct {r0['direct_ms']:.4f} ms on rank 0; "
            + "; ".join(parts))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--only", default="", help="comma-separated entries: " + ",".join(ENTRIES))
    parser.add_argument("--small", action="store_true",
                        help="four gloo ranks on the CPU at tiny shapes")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dir", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.world != 4:
        parser.error("the 2 x 2 mesh needs --world 4")
    unknown = set(filter(None, args.only.split(","))) - set(ENTRIES)
    if unknown:
        parser.error(f"unknown entries {sorted(unknown)}")
    if args.rank is not None:
        return rank_main(args)
    if not args.small:
        import torch
        if torch.cuda.device_count() < args.world:
            print(f"sharded_cards: needs {args.world} CUDA cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu (gloo ranks, --small)"
    print(card, flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as folder:
        procs, logs = [], []
        try:
            for r in range(args.world):
                cmd = [sys.executable, os.path.abspath(__file__), "--world", str(args.world),
                       "--only", args.only, "--rank", str(r), "--dir", folder] + (
                           ["--small"] if args.small else [])
                logs.append(open(os.path.join(folder, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen(cmd, stdout=logs[-1], stderr=logs[-1],
                                              env={**os.environ, "LOCAL_RANK": str(r)}))
            codes = [p.wait(timeout=3000) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        rows = []
        path = os.path.join(folder, "rows.jsonl")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                rows = [json.loads(line) for line in f]
        if any(codes):
            for r in range(args.world):
                with open(os.path.join(folder, f"rank{r}.log"), encoding="utf-8") as f:
                    print(f"rank {r} (exit {codes[r]}): {f.read()[-3000:]}", file=sys.stderr)
    ok = not any(codes) and bool(rows)
    for everyone in rows:
        good = all(r["ok"] for r in everyone)
        ok = ok and good
        print(f"{everyone[0]['entry']} on {everyone[0]['axis']}: "
              f"{'ok' if good else 'FAILED'}: {describe(everyone)}", flush=True)
        for r in everyone:
            if "trace" in r:
                print(r["trace"], file=sys.stderr)
    strict = [{k: ("inf" if v == float("inf") else v) for k, v in r.items() if k != "trace"}
              for everyone in rows for r in everyone]
    print(json.dumps({"ok": ok, "card": card, "world": args.world, "small": args.small,
                      "seconds": round(time.time() - t0, 1), "rows": strict}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
