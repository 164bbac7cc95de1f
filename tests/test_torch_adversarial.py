"""Seeded adversarial sweep of the public spectrum, spectrogram, FIR and
channelizer entries in both packages.

For each entry (spectrum, spectrogram_amplitude, spectrogram, stft), input
(zeros, a NaN, +/- constants, int, float64, a signal shorter than the
frame) and size n in {100, 128, 256}: either both packages raise the same
exception type, or both give the same numbers, to 1e-10 where both compute
in float64 and to the float32 tolerances otherwise (amplitude 2e-6,
phase 1e-4 rad where the amplitude exceeds 1e-3).

The DSP entries (fir_filter with 65 taps, overlap-save or direct by the
auto rule; pfb_channelize at 16 channels; upfirdn by 3/2 with the same
taps; resample_poly 147/160; fm_discriminate; wbfm_demod; istft of each
package's own stft; welch_psd; am_demod; am_receive; iir_one_pole;
deemphasis; decimate by 4; interpolate by 3; the (3,4)(7,8)(7,5)
resample_poly_cascade) run over the same inputs: both raise the same
exception type or give the same numbers. So do the streaming steps
(stft_step, fir_step, upfirdn_step, resample_cascade_step,
fm_discriminate_step, pfb_channelize_step, FmReceiver.stream_step), fed
the input in chunks and compared chunk by chunk. One case differs by
design: a NaN reaches every output of the banded product's frames that
hold it (NaN times a zero tap), and the port's frames of upfirdn at 3/2
hold 33 outputs where the JAX package's hold 129 (the grouping is chosen
from H100 times), tiling the JAX package's frames. There, and in the
other entries whose frames are smaller than the JAX package's at this
input (decimate, interpolate, the cascade and the two resampling steps),
the port's NaNs must lie inside the JAX package's and every other number
must agree; every other entry, banded or not, gives the same NaNs.
istft of int input is held to the JAX istft of the same signal in
float32, the dtype the port coerces int input to (PORT.md): its edge
samples divide by a window energy near 0, which magnifies the float32
rounding past the sweep's tolerance.

So do the FFT-family entries: ``ops.rfft`` followed by ``ops.irfft``,
``ops.fft`` pinned to the two-kernel route (``impl="big"``, 2^16 points;
the short input is outside its range in both packages) and a
``FluentFFT`` chain with its bound inverse. The JAX two-kernel route
computes a float64 operand in float32 (its kernels cast); the port keeps
float64 there, so that one case is checked against numpy instead.

One long input per kind (a NaN, a +inf) reaches the IIR's carries past
their first group of 128 blocks: iir_one_pole and deemphasis over 40000
samples, bad at 30000, and the FM receiver over one IQ row of 384000
samples, bad at 300000. The IIR's non-finite places are the JAX
package's; the receiver's lie inside them.

One known fault of the JAX package is held apart instead of enshrined:
its ``spectrogram_amplitude`` raises on float64 input at one-sided
n > 128 (the Pallas kernel K1 stores float32 into a float64 output). The
port answers those cases; they are checked against a float64 numpy
oracle, and the JAX error is asserted so that a fix there shows up here.

One deliberate difference of the port is held apart too: its float64
``spectrogram_amplitude`` goes stft -> |X| -> scaling through
``ops.dispatch``, which (like both packages' ``stft``) has no
non-power-of-two size, so n = 100 raises ValueError there where the JAX
package reaches its dense-DFT kernel K3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu as jpd
import pragma_dsp_tpu.stream as jstream
import pragma_dsp_tpu_torch as pt
from pragma_dsp_tpu.xform.fourier import window_values
from pragma_dsp_tpu_torch import set_default_device

pstream = importlib.import_module("pragma_dsp_tpu_torch.stream")
jops = importlib.import_module("pragma_dsp_tpu.ops")
pops = importlib.import_module("pragma_dsp_tpu_torch.ops")
jmodels = importlib.import_module("pragma_dsp_tpu.models")
pmodels = importlib.import_module("pragma_dsp_tpu_torch.models")

SR = 48000.0
SIZES = (100, 128, 256)
INPUTS = ("zeros", "nan", "pos_const", "neg_const", "int", "f64", "short")
ENTRIES = ("spectrum", "spectrogram_amplitude", "spectrogram", "stft")
F64_TOL, AMP_TOL, PHASE_TOL = 1e-10, 2e-6, 1e-4
# (entry, input) pairs where the JAX package fails at one-sided n > 128.
JAX_F64_FAULT = {("spectrogram_amplitude", "f64"), ("spectrogram_amplitude", "int")}
# The port's float64 spectrogram rule: ops.dispatch, power-of-two n only.
PORT_F64_RULE = ("spectrogram_amplitude", "f64")


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _signal(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + n)
    length = n // 2 if kind == "short" else 3 * n
    t = np.arange(length) / SR
    noisy = 0.5 * np.sin(2 * np.pi * 2300.0 * t) + 0.05 * rng.standard_normal(length)
    if kind == "zeros":
        return np.zeros(length, np.float32)
    if kind == "nan":
        x = noisy.astype(np.float32)
        x[length // 3] = np.nan
        return x
    if kind in ("pos_const", "neg_const"):
        return np.full(length, 0.75 if kind == "pos_const" else -0.75, np.float32)
    if kind == "int":
        return rng.integers(-8, 8, size=length).astype(np.int32)
    if kind == "f64":
        return noisy
    return noisy.astype(np.float32)            # short


def _call(mod, entry: str, x, n: int):
    hop = n // 4
    if entry == "spectrum":
        return mod.spectrum(x, sample_rate=SR, fft_size=n, window="hann")
    if entry == "spectrogram_amplitude":
        return mod.spectrogram_amplitude(x, n, hop, "hann")
    if entry == "spectrogram":
        return mod.spectrogram(x, n, hop, "hann", SR)
    return mod.stft(x, n, hop, "hann")


def _port(entry, x, n):
    mod = pt if entry == "spectrum" else pstream
    return _call(mod, entry, torch.from_numpy(x), n)


def _jax(entry, x, n):
    mod = jpd if entry == "spectrum" else jstream
    return _call(mod, entry, jnp.asarray(x), n)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _arrays(out) -> dict:
    """The numbers of either package's result, by name, as numpy arrays."""
    if hasattr(out, "peak"):
        return {"amplitude": _np(out.amplitude), "phase": _np(out.phase),
                "frequencies": _np(out.frequencies),
                "peak_index": _np(out.peak.index),
                "peak_amplitude": _np(out.peak.amplitude)}
    if isinstance(out, tuple):                  # a ComplexArray of either package
        return {"spec": _np(out.real) + 1j * _np(out.imag)}
    return {"amplitude": _np(out)}


def _assert_same(got: dict, ref: dict, tol: float, label: str):
    assert got.keys() == ref.keys(), label
    scale = max(1.0, float(np.nanmax(np.abs(ref.get("amplitude", ref.get("spec"))),
                                     initial=0.0)))
    for key in ("amplitude", "spec", "peak_amplitude"):
        if key in ref:
            assert got[key].shape == ref[key].shape, (label, key)
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=tol * scale,
                                       equal_nan=True, err_msg=f"{label} {key}")
    for key in ("frequencies", "peak_index"):
        if key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{label} {key}")
    if "phase" in ref:
        amp = ref["amplitude"]
        mask = np.isfinite(amp) & (amp > (1e-3 if tol > F64_TOL else 1e-6) * scale)
        d = np.abs(np.angle(np.exp(1j * (got["phase"][mask] - ref["phase"][mask]))))
        assert d.size == 0 or d.max() <= (PHASE_TOL if tol > F64_TOL else 1e-8), label
        assert np.array_equal(np.isnan(got["phase"]), np.isnan(ref["phase"])), label


def _oracle_amplitude(x: np.ndarray, n: int) -> np.ndarray:
    hop = n // 4
    frames = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), n)[::hop]
    mags = np.abs(np.fft.rfft(frames * window_values("hann", n), axis=-1))
    scale = np.full(n // 2 + 1, 2.0 / n)
    scale[0] = scale[-1] = 1.0 / n
    return mags * scale


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_port_agrees_with_jax(entry, kind, n):
    x = _signal(kind, n)
    label = f"{entry}({kind}, n={n})"
    try:
        ref = _jax(entry, x, n)
        jax.block_until_ready(jax.tree_util.tree_leaves(ref))
        jax_err = None
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        jax_err = e
    if jax_err is not None and (entry, kind) in JAX_F64_FAULT and n > 128:
        assert isinstance(jax_err, ValueError) and "dtype" in str(jax_err), label
        got = _port(entry, x, n).numpy()
        assert got.dtype == (np.float64 if kind == "f64" else np.float32), label
        np.testing.assert_allclose(got, _oracle_amplitude(x, n), rtol=0,
                                   atol=F64_TOL if kind == "f64" else AMP_TOL,
                                   err_msg=label)
        return
    if (entry, kind) == PORT_F64_RULE and n & (n - 1):
        assert jax_err is None, label
        with pytest.raises(ValueError, match="power of two"):
            _port(entry, x, n)
        return
    if jax_err is not None:
        with pytest.raises(type(jax_err)):
            _port(entry, x, n)
        return
    got = _port(entry, x, n)
    both_f64 = (kind == "f64" and entry != "spectrogram_amplitude")
    _assert_same(_arrays(got), _arrays(ref),
                 F64_TOL if both_f64 else AMP_TOL, label)


DSP_ENTRIES = ("fir_filter", "pfb_channelize", "upfirdn", "resample_poly",
               "fm_discriminate", "wbfm_demod", "istft", "welch_psd", "am_demod",
               "am_receive", "iir_one_pole", "deemphasis", "decimate", "interpolate",
               "resample_poly_cascade")
DSP_N = 256            # signals of 3*256 samples ("short": 128)
NAN_FRAMES = ("upfirdn", "nan")
INT_AS_F32 = ("istft", "int")
# Entries whose banded product's frames are smaller than the JAX
# package's at these inputs: a NaN spreads over a subset of its outputs.
BANDED = {"upfirdn", "decimate", "interpolate", "resample_poly_cascade",
          "upfirdn_step", "resample_cascade_step"}
FIR_TAPS = np.hamming(65) / np.hamming(65).sum()
PFB_CHANNELS = 16
# istft and welch_psd frame as the stft cases at n = 256 do, stft_step's
# buffer of 96 + 288 samples as those at n = 128 (the JAX package compiles
# its transforms once a shape).
STFT_N, STFT_HOP = 256, 64
STEP_N, STEP_HOP = 128, 32
CASCADE = ((3, 4), (7, 8), (7, 5))
IIR_ALPHA = 0.9


def _packages(mod):
    """(ops, stream, models) of the package ``mod`` (an ops module) is in."""
    return (jops, jstream, jmodels) if mod is jops else (pops, pstream, pmodels)


def _dsp_call(mod, entry: str, x):
    ops, stream, models = _packages(mod)
    if entry == "fir_filter":
        return ops.fir_filter(x, FIR_TAPS)
    if entry == "upfirdn":
        return ops.upfirdn(x, FIR_TAPS, 3, 2)
    if entry == "resample_poly":
        return ops.resample_poly(x, 147, 160)
    if entry == "fm_discriminate":
        return ops.fm_discriminate(x, sample_rate=SR)
    if entry == "wbfm_demod":
        return models.wbfm_demod(x)
    if entry == "istft":
        return stream.istft(stream.stft(x, STFT_N, STFT_HOP, "hann"), STFT_HOP, "hann")
    if entry == "welch_psd":
        return stream.welch_psd(x, STFT_N, STFT_HOP, "hann", SR)
    if entry == "am_demod":
        return ops.am_demod(x)
    if entry == "am_receive":
        return models.am_receive(x)
    if entry == "iir_one_pole":
        return ops.iir_one_pole(x, IIR_ALPHA)
    if entry == "deemphasis":
        return ops.deemphasis(x, SR)
    if entry == "decimate":
        return ops.decimate(x, 4)
    if entry == "interpolate":
        return ops.interpolate(x, 3)
    if entry == "resample_poly_cascade":
        return ops.resample_poly_cascade(x, CASCADE)
    return ops.pfb_channelize(x, PFB_CHANNELS)


def _assert_nan_inside(got: dict, ref: dict, tol: float, label: str):
    """The banded products' rule: the port's NaNs lie inside the JAX
    package's, and every number where the JAX package has none agrees."""
    assert got.keys() == ref.keys(), label
    for key in ref:
        g, r = got[key], ref[key]
        assert g.shape == r.shape, (label, key)
        assert not (np.isnan(g) & ~np.isnan(r)).any(), (label, key)
        keep = ~np.isnan(r)
        scale = max(1.0, float(np.nanmax(np.abs(r), initial=0.0)))
        np.testing.assert_allclose(g[keep], r[keep], rtol=0, atol=tol * scale,
                                   err_msg=f"{label} {key}")


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("entry", DSP_ENTRIES)
def test_dsp_entries_agree_with_jax(entry, kind):
    x = _signal(kind, DSP_N)
    label = f"{entry}({kind})"
    jx = x
    if (entry, kind) == INT_AS_F32:
        # The port computes int input in float32 (PORT.md), the JAX package
        # with x64 in float64; istft's edge samples divide by a window
        # energy near 0 and magnify float32 rounding, so the port is held
        # to the JAX result of the float32 signal it computes.
        jx = x.astype(np.float32)
        assert _dsp_call(pops, entry, torch.from_numpy(x)).dtype == torch.float32, label
    try:
        ref = _dsp_call(jops, entry, jnp.asarray(jx))
        jax.block_until_ready(jax.tree_util.tree_leaves(ref))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            _dsp_call(pops, entry, torch.from_numpy(x))
        return
    got = _dsp_call(pops, entry, torch.from_numpy(x))
    if (entry, kind) == NAN_FRAMES:
        got, ref = got.numpy(), np.asarray(ref)
        assert np.isnan(got).any() and not (np.isnan(got) & ~np.isnan(ref)).any(), label
        assert np.isnan(got).sum() < np.isnan(ref).sum(), label
        both = ~np.isnan(ref)
        np.testing.assert_allclose(got[both], ref[both], rtol=0, atol=AMP_TOL, err_msg=label)
        return
    tol = F64_TOL if kind == "f64" else AMP_TOL
    if kind == "nan" and entry in BANDED:
        assert np.isnan(_np(got)).any(), label
        _assert_nan_inside(_arrays(got), _arrays(ref), tol, label)
        return
    _assert_same(_arrays(got), _arrays(ref), tol, label)


# entry -> chunk length; the input is fed in whole chunks (or, shorter
# than one, as one chunk).
STREAM_ENTRIES = {"stft_step": 288, "fir_step": 128, "upfirdn_step": 128,
                  "resample_cascade_step": 160, "fm_discriminate_step": 128,
                  "pfb_channelize_step": 16, "fm_receiver_stream": 250}


def _stream(mod, entry: str, dtype):
    """(state, step) of ``entry`` in the package of ``mod``, from a cold
    start in ``dtype`` ("float32" or "float64")."""
    ops, stream, models = _packages(mod)
    dt = getattr(jnp if mod is jops else torch, dtype)
    if entry == "stft_step":
        return (stream.stft_stream_init(STEP_N, STEP_HOP, (), dt),
                lambda st, ch: stream.stft_step(st, ch, STEP_N, STEP_HOP, "hann"))
    if entry == "fir_step":
        return (ops.fir_stream_init(FIR_TAPS, (), dt),
                lambda st, ch: ops.fir_step(st, ch, FIR_TAPS))
    if entry == "upfirdn_step":
        return (ops.upfirdn_stream_init(FIR_TAPS, 3, 2, (), dt),
                lambda st, ch: ops.upfirdn_step(st, ch, FIR_TAPS, 3, 2))
    if entry == "resample_cascade_step":
        return (ops.resample_cascade_stream_init(CASCADE, batch_shape=(), dtype=dt),
                lambda st, ch: ops.resample_cascade_step(st, ch, CASCADE))
    if entry == "fm_discriminate_step":
        return (ops.fm_stream_init((), dt),
                lambda st, ch: ops.fm_discriminate_step(st, ch, sample_rate=SR))
    if entry == "pfb_channelize_step":
        return (ops.pfb_stream_init(PFB_CHANNELS, 8, (), dt),
                lambda st, ch: ops.pfb_channelize_step(st, ch, PFB_CHANNELS))
    rx = models.FmReceiver()
    return rx.stream_init((), dt), rx.stream_step


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("entry", STREAM_ENTRIES)
def test_stream_steps_agree_with_jax(entry, kind):
    x = _signal(kind, DSP_N)
    size = STREAM_ENTRIES[entry]
    chunks = [x[i:i + size] for i in range(0, x.size - size + 1, size)] or [x]
    dtype = "float64" if kind == "f64" else "float32"
    jst, jstep = _stream(jops, entry, dtype)
    pst, pstep = _stream(pops, entry, dtype)
    tol = F64_TOL if kind == "f64" else AMP_TOL
    nans = 0
    for i, ch in enumerate(chunks):
        label = f"{entry}({kind}) chunk {i}"
        try:
            jst, ref = jstep(jst, jnp.asarray(ch))
            jax.block_until_ready(jax.tree_util.tree_leaves(ref))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            with pytest.raises(type(e)):
                pstep(pst, torch.from_numpy(ch))
            return
        pst, got = pstep(pst, torch.from_numpy(ch))
        got, ref = _arrays(got), _arrays(ref)
        nans += sum(int(np.isnan(v).sum()) for v in got.values())
        if kind == "nan" and entry in BANDED:
            _assert_nan_inside(got, ref, tol, label)
        else:
            _assert_same(got, ref, tol, label)
    assert kind != "nan" or nans, f"{entry}(nan): no NaN came out"


LONG_IIR, LONG_IIR_BAD = 40000, 30000         # IIR block 234: carries' second group
LONG_IQ, LONG_IQ_BAD = 384000, 300000         # IF sample 30000 at 240 kHz
LONG_KINDS = {"nan": np.nan, "pos_inf": np.inf}


def _long_signal(kind: str, entry: str) -> np.ndarray:
    """A float32 noisy tone (an FM IQ row for the receiver) with one bad
    sample far into it."""
    rng = np.random.default_rng(2024)
    if entry == "fm_receiver":
        t = np.arange(LONG_IQ) / 2.4e6
        phase = 2 * np.pi * 75e3 * np.cumsum(0.7 * np.sin(2 * np.pi * 1000.0 * t)) / 2.4e6
        x = np.stack([np.cos(phase), np.sin(phase)]) + 0.01 * rng.standard_normal((2, LONG_IQ))
        x = x.astype(np.float32)
        x[0, LONG_IQ_BAD] = LONG_KINDS[kind]
        return x
    t = np.arange(LONG_IIR) / SR
    x = (0.5 * np.sin(2 * np.pi * 2300.0 * t)
         + 0.05 * rng.standard_normal(LONG_IIR)).astype(np.float32)
    x[LONG_IIR_BAD] = LONG_KINDS[kind]
    return x


@pytest.mark.parametrize("kind", LONG_KINDS)
@pytest.mark.parametrize("entry", ["iir_one_pole", "deemphasis", "fm_receiver"])
def test_long_bad_sample_agrees_with_jax(entry, kind):
    x = _long_signal(kind, entry)
    label = f"{entry}(long {kind})"
    if entry == "fm_receiver":
        ref = np.asarray(jmodels.FmReceiver()(jpd.core.ComplexArray(jnp.asarray(x[0]),
                                                                    jnp.asarray(x[1]))))
        got = pmodels.FmReceiver()(pt.core.ComplexArray(torch.from_numpy(x[0]),
                                                        torch.from_numpy(x[1]))).numpy()
        assert not np.isfinite(got).all(), label
        assert not (~np.isfinite(got) & np.isfinite(ref)).any(), label
        keep = np.isfinite(ref)
        np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=AMP_TOL * 100,
                                   err_msg=label)
        return
    ref = np.asarray(_dsp_call(jops, entry, jnp.asarray(x)))
    got = _dsp_call(pops, entry, torch.from_numpy(x)).numpy()
    first = LONG_IIR_BAD // 128 * 128
    assert np.isfinite(got[:first]).all() and not np.isfinite(got[first:]).any(), label
    _assert_same({"amplitude": got}, {"amplitude": ref}, AMP_TOL, label)


FFT_ENTRIES = ("rfft", "irfft_of_rfft", "fft_big", "fluent_chain")
BIG_N = 1 << 16
JAX_F32_BIG = ("fft_big", "f64")


def _pow2_prefix(x: np.ndarray) -> np.ndarray:
    return x[: 1 << (x.size.bit_length() - 1)]


def _fft_call(entry: str, x, ops, xform, fluent):
    if entry == "rfft":
        return ops.rfft(x)
    if entry == "irfft_of_rfft":
        return ops.irfft(ops.rfft(x))
    if entry == "fft_big":
        return ops.fft(x, impl="big")
    two = fluent.assert_non_zero(2.0)
    return xform.FluentFFT(x.shape[-1]).forward(x).scale(two).conj().inverse()


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("entry", FFT_ENTRIES)
def test_fft_entries_agree_with_jax(entry, kind):
    # 3n samples cut to a power of two: 512 (short: 128), or 2^16 (2^14).
    x = _pow2_prefix(_signal(kind, BIG_N // 2 if entry == "fft_big" else DSP_N))
    label = f"{entry}({kind})"
    try:
        ref = _fft_call(entry, jnp.asarray(x), jops, jpd.xform, jpd.fluent)
        jax.block_until_ready(jax.tree_util.tree_leaves(ref))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            _fft_call(entry, torch.from_numpy(x), pops, pt.xform, pt.fluent)
        return
    got = _fft_call(entry, torch.from_numpy(x), pops, pt.xform, pt.fluent)
    if (entry, kind) == JAX_F32_BIG:
        # The JAX kernels compute a float64 operand in float32; the port
        # runs the same decomposition in float64. Held apart, not enshrined:
        # the port against numpy at the float64 tolerance, the JAX result
        # only float32-close (and not float64-close: a fix there shows here).
        spec, jspec = _arrays(got)["spec"], _arrays(ref)["spec"]
        want = np.fft.fft(x)
        scale = float(np.abs(want).max())
        assert got.real.dtype == torch.float64, label
        np.testing.assert_allclose(spec, want, rtol=0, atol=F64_TOL * scale)
        np.testing.assert_allclose(jspec, want, rtol=0, atol=AMP_TOL * scale)
        assert np.abs(jspec - want).max() > F64_TOL * scale, label
        return
    _assert_same(_arrays(got), _arrays(ref), F64_TOL if kind == "f64" else AMP_TOL,
                 label)
