"""The port's stream.stft and stream.scan against the JAX package:
frame_signal, stft, istft, welch_psd, the streaming carry and the scan
loop in float64 to 1e-10; the fused spectrogram routes in float32; the
framed/frame route choice and its errors; and the chirp fixture end to end.

The JAX package's own STFT suite is all ``slow`` (tests/test_stft.py), so
these are the STFT tests the fast tier runs. Interpret-mode Pallas cases
stay small (n <= 512, few frames)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu.stream as jstream
from pragma_dsp_tpu.stream.stft import StftState as JStftState
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import dispatch
from pragma_dsp_tpu_torch.stream import (
    StftState, frame_signal, istft, jit_stream_step, scan_stream, spectrogram,
    spectrogram_amplitude, stft, stft_step, stft_stream_init, welch_psd)
from pragma_dsp_tpu_torch.utils import (result_to_numpy, stft_state_from_numpy,
                                        stft_state_to_numpy)
from pragma_dsp_tpu_torch import set_default_device

pstft = importlib.import_module("pragma_dsp_tpu_torch.stream.stft")

RNG = np.random.default_rng(31)
F64_TOL = 1e-10
AMP_TOL = 2e-6     # float32 fused routes against JAX (the K1 tests' tolerance)
PHASE_TOL = 1e-4   # rad, where amp > 1e-3


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cnp(z):
    """A ComplexArray of either package as a numpy complex array."""
    return np.asarray(z.real) + 1j * np.asarray(z.imag)


def _tc(z):
    return ComplexArray(_t(z.real), _t(z.imag))


def _wrapped(d):
    return np.abs(np.angle(np.exp(1j * d)))


# ── float64 parity ───────────────────────────────────────────────────


@pytest.mark.parametrize("length,n,hop", [(100, 16, 4), (1000, 64, 64),
                                          (777, 128, 96), (300, 32, 50),
                                          (64, 64, 8)])
def test_frame_signal_matches_jax(length, n, hop):
    x = RNG.standard_normal((2, length))
    got = frame_signal(_t(x), n, hop)
    ref = np.asarray(jstream.frame_signal(jnp.asarray(x), n, hop))
    assert got.shape == ref.shape == (2, 1 + (length - n) // hop, n)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("window", ["rect", "hann", "blackman"])
@pytest.mark.parametrize("n,hop", [(256, 64), (128, 128), (64, 48)])
def test_stft_matches_jax_f64(n, hop, window):
    x = RNG.standard_normal((2, 3, 1000))
    got = stft(_t(x), n, hop, window)
    ref = jstream.stft(jnp.asarray(x), n, hop, window)
    assert got.real.dtype == torch.float64
    np.testing.assert_allclose(_cnp(got), _cnp(ref), rtol=0, atol=F64_TOL)


def test_stft_complex_input_and_default_hop():
    z = RNG.standard_normal(1024) + 1j * RNG.standard_normal(1024)
    got = stft(_t(z), 256)
    ref = jstream.stft(jnp.asarray(z), 256)
    assert got.real.shape == (13, 256)
    np.testing.assert_allclose(_cnp(got), _cnp(ref), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("n,hop,length", [(256, 64, None), (256, 96, 1500),
                                          (128, 128, None)])
def test_istft_matches_jax_f64(n, hop, length):
    x = RNG.standard_normal((2, 2048))
    spec = jstream.stft(jnp.asarray(x), n, hop, "hann")
    ref = np.asarray(jstream.istft(spec, hop, "hann", length=length))
    got = istft(_tc(spec), hop, "hann", length=length)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    if hop == n:
        return  # no overlap: the Hann window's zero ends are not recoverable
    interior = slice(n, ref.shape[-1] - n)
    np.testing.assert_allclose(got.numpy()[..., interior], x[..., interior],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("hop,window,fs", [(None, "hann", 1.0),
                                           (64, "hann", 48e3),
                                           (32, "rect", 8.0)])
def test_welch_psd_matches_jax_real_and_iq(hop, window, fs):
    x = RNG.standard_normal((2, 1024))
    z = RNG.standard_normal(1024) + 1j * RNG.standard_normal(1024)
    for sig in (x, z):
        got = welch_psd(_t(sig), 128, hop, window, fs)
        ref = np.asarray(jstream.welch_psd(jnp.asarray(sig), 128, hop, window, fs))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)


def test_welch_psd_split_plane_input():
    z = RNG.standard_normal(512) + 1j * RNG.standard_normal(512)
    got = welch_psd(ComplexArray(_t(z.real), _t(z.imag)), 64, 32)
    np.testing.assert_array_equal(got.numpy(), welch_psd(_t(z), 64, 32).numpy())


def test_stft_step_matches_jax_chunk_by_chunk():
    n_fft, hop = 256, 64
    chunks = [RNG.standard_normal((2, 512)) for _ in range(4)]
    state = stft_stream_init(n_fft, hop, (2,), dtype=torch.float64)
    jstate = jstream.stft_stream_init(n_fft, hop, (2,), dtype=jnp.float64)
    for ch in chunks:
        state, spec = stft_step(state, _t(ch), n_fft, hop, "hann")
        jstate, jspec = jstream.stft_step(jstate, jnp.asarray(ch), n_fft, hop, "hann")
        np.testing.assert_allclose(_cnp(spec), _cnp(jspec), rtol=0, atol=F64_TOL)
        np.testing.assert_array_equal(stft_state_to_numpy(state).tail,
                                      stft_state_to_numpy(jstate).tail)
    full = np.concatenate([np.zeros((2, n_fft - hop))] + chunks, axis=-1)
    assert state.tail.shape == (2, n_fft - hop)
    np.testing.assert_array_equal(state.tail.numpy(), full[:, -(n_fft - hop):])


def test_stft_state_crosses_packages_as_numpy():
    """A carry started in the JAX package continues in the port and gives
    the JAX package's next frames."""
    n_fft, hop = 128, 32
    a, b = RNG.standard_normal(256), RNG.standard_normal(256)
    jstate, _ = jstream.stft_step(jstream.stft_stream_init(n_fft, hop, dtype=jnp.float64),
                                  jnp.asarray(a), n_fft, hop)
    state = stft_state_from_numpy(stft_state_to_numpy(jstate), dtype=torch.float64)
    assert isinstance(state, StftState) and state.tail.dtype == torch.float64
    _, spec = stft_step(state, _t(b), n_fft, hop)
    jback = JStftState(*stft_state_to_numpy(state))
    _, jspec = jstream.stft_step(jback, jnp.asarray(b), n_fft, hop)
    np.testing.assert_allclose(_cnp(spec), _cnp(jspec), rtol=0, atol=F64_TOL)


def _stft_scan_step(st, ch):
    st, spec = stft_step(st, ch, 128, 32, "hann")
    return st, spec


def test_scan_stream_equals_step_loop_and_jax():
    n_chunks, chunk = 6, 256
    x = RNG.standard_normal((n_chunks, chunk))
    state0 = stft_stream_init(128, 32, dtype=torch.float64)
    last, outs = scan_stream(_stft_scan_step, state0, _t(x))
    assert isinstance(outs, ComplexArray) and outs.real.shape == (n_chunks, 8, 128)
    st = state0
    for i in range(n_chunks):
        st, spec = _stft_scan_step(st, _t(x[i]))
        assert torch.equal(outs.real[i], spec.real) and torch.equal(outs.imag[i], spec.imag)
    assert torch.equal(last.tail, st.tail)

    def jstep(s, ch):
        s, spec = jstream.stft_step(s, ch, 128, 32, "hann")
        return s, (spec.real, spec.imag)

    jlast, (jre, jim) = jstream.scan_stream(
        jstep, jstream.stft_stream_init(128, 32, dtype=jnp.float64), jnp.asarray(x))
    np.testing.assert_allclose(outs.real.numpy(), np.asarray(jre), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(outs.imag.numpy(), np.asarray(jim), rtol=0, atol=F64_TOL)
    np.testing.assert_array_equal(last.tail.numpy(), np.asarray(jlast.tail))


def test_scan_stream_trees_and_static_kwargs():
    def step(st, ch, gain):
        s = st + ch["a"].sum()
        return s, (ch["a"] * gain, {"b": ch["b"] + s})

    chunks = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.ones(3, 1)}
    last, (ys, zs) = scan_stream(step, torch.tensor(0.0), chunks, gain=2.0)
    assert float(last) == 15.0
    assert torch.equal(ys, 2.0 * chunks["a"])
    assert zs["b"].flatten().tolist() == [2.0, 7.0, 16.0]
    with pytest.raises(ValueError, match="at least one chunk"):
        scan_stream(step, torch.tensor(0.0), {"a": torch.zeros(0, 2),
                                              "b": torch.zeros(0, 1)}, gain=1.0)


def test_jit_stream_step_donated_matches_undonated():
    x = RNG.standard_normal((4, 256))
    donated = jit_stream_step(stft_step, donate=True, n_fft=128, hop=32)
    plain = jit_stream_step(stft_step, donate=False, n_fft=128, hop=32)
    s1 = s2 = stft_stream_init(128, 32, dtype=torch.float64)
    for row in x:
        s1, o1 = donated(s1, _t(row))
        s2, o2 = plain(s2, _t(row))
        assert torch.equal(o1.real, o2.real) and torch.equal(o1.imag, o2.imag)
    assert jit_stream_step(_stft_scan_step) is _stft_scan_step


@pytest.mark.parametrize("sides", ["one", "two"])
def test_generic_spectrogram_matches_jax_f64(sides):
    t = np.arange(4096) / 48000.0
    x = np.sin(2 * np.pi * 3000.0 * t) + 0.1 * RNG.standard_normal((2, 4096))
    got = result_to_numpy(spectrogram(_t(x), 512, 256, "hann", 48000.0, sides))
    ref = jstream.spectrogram(jnp.asarray(x), 512, 256, "hann", 48000.0, sides)
    np.testing.assert_allclose(got.amplitude, np.asarray(ref.amplitude), rtol=0,
                               atol=F64_TOL)
    mask = np.asarray(ref.amplitude) > 1e-6
    assert _wrapped(got.phase[mask] - np.asarray(ref.phase)[mask]).max() < 1e-8
    np.testing.assert_array_equal(got.frequencies, np.asarray(ref.frequencies))
    if sides == "one":
        np.testing.assert_array_equal(got.peak.index, np.asarray(ref.peak.index))
    np.testing.assert_allclose(got.peak.amplitude, np.asarray(ref.peak.amplitude),
                               rtol=0, atol=F64_TOL)


# ── float32 fused routes ─────────────────────────────────────────────


@pytest.mark.parametrize("framed", [None, True, False])
def test_f32_spectrogram_fused_routes_match_jax(framed):
    """The port takes the fused route for f32 (K4 or K1, plain versions on
    the CPU); the JAX package off the TPU takes its stft route."""
    t = np.arange(2048) / 48000.0
    x = (0.6 * np.sin(2 * np.pi * 1700.0 * t)
         + 0.01 * RNG.standard_normal((2, 2048))).astype(np.float32)
    got = result_to_numpy(spectrogram(_t(x), 256, 128, "hann", 48000.0,
                                      framed=framed))
    ref = jstream.spectrogram(jnp.asarray(x), 256, 128, "hann", 48000.0)
    assert got.amplitude.dtype == np.float32 and got.amplitude.shape == (2, 15, 129)
    np.testing.assert_allclose(got.amplitude, np.asarray(ref.amplitude), rtol=0,
                               atol=AMP_TOL)
    mask = np.asarray(ref.amplitude) > 1e-3
    assert _wrapped(got.phase[mask] - np.asarray(ref.phase)[mask]).max() <= PHASE_TOL
    np.testing.assert_array_equal(got.peak.index, np.asarray(ref.peak.index))


@pytest.mark.parametrize("n,hop,sides", [(256, 128, "one"), (256, 64, "one"),
                                         (128, 32, "one"), (100, 25, "one"),
                                         (256, 128, "two")])
def test_f32_spectrogram_amplitude_matches_jax(n, hop, sides):
    x = RNG.standard_normal(n * 4).astype(np.float32)
    got = spectrogram_amplitude(_t(x), n, hop, "hann", sides)
    ref = np.asarray(jstream.spectrogram_amplitude(jnp.asarray(x), n, hop, "hann",
                                                   sides))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=AMP_TOL)


def test_frame_route_equals_framed_route_on_cpu():
    x = _t(RNG.standard_normal((2, 3000)).astype(np.float32))
    a = spectrogram_amplitude(x, 512, 128, "hann", framed=True)
    b = spectrogram_amplitude(x, 512, 128, "hann", framed=False)
    c = spectrogram_amplitude(x, 512, 128, "hann")
    assert torch.equal(a, b) and torch.equal(a, c)
    r1 = spectrogram(x, 512, 256, "hann", 48000.0, framed=True)
    r2 = spectrogram(x, 512, 256, "hann", 48000.0, framed=False)
    assert torch.equal(r1.amplitude, r2.amplitude) and torch.equal(r1.phase, r2.phase)
    assert torch.equal(r1.peak.index, r2.peak.index)


def test_framed_none_takes_k4_wherever_supported(monkeypatch):
    x = torch.zeros(4096)
    assert pstft._use_framed(4096, 1024, "one", None)
    assert pstft._use_framed(256, 128, "one", None)
    assert not pstft._use_framed(256, 128, "one", False)
    assert not pstft._use_framed(256, 64, "one", None)      # hop % 128
    assert not pstft._use_framed(256, 128, "two", None)
    calls = []
    monkeypatch.setattr(pstft, "framed_spectrum_amplitude_cuda",
                        lambda *a: calls.append(a) or torch.zeros(1))
    spectrogram_amplitude(x, 256, 128)
    assert len(calls) == 1


def test_float64_never_reaches_a_kernel_wrapper(monkeypatch):
    """The stated dtype rule: float64 goes stft -> |X| -> scaling through
    ops.dispatch (Stockham), whatever ``framed`` says, and raises the
    dispatch error for a non-power-of-two n_fft; float32 goes to the kernel
    wrappers."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel wrapper called")

    for name in ("framed_spectrum_amplitude_cuda", "spectrum_amplitude_cuda",
                 "framed_spectrum_amp_phase_cuda", "spectrum_amp_phase_cuda"):
        monkeypatch.setattr(pstft, name, refuse)
    x = RNG.standard_normal(1024)
    for n, hop, sides, framed in ((256, 128, "one", None), (256, 128, "one", True),
                                  (256, 64, "two", None), (128, 32, "one", None)):
        got = spectrogram_amplitude(_t(x), n, hop, "hann", sides, framed)
        assert got.dtype == torch.float64
        mags = pstft.magnitude(pstft.stft(_t(x), n, hop, "hann"))
        scale = (pstft.scale_amplitude_one_sided if sides == "one"
                 else pstft.scale_amplitude_two_sided)
        assert torch.equal(got, scale(mags, n))
        frames = np.lib.stride_tricks.sliding_window_view(x, n)[::hop]
        ref = np.abs(np.fft.fft(frames * pstft.window_values("hann", n), axis=-1)) / n
        if sides == "one":
            ref = ref[:, : n // 2 + 1] * np.where(
                np.isin(np.arange(n // 2 + 1), (0, n // 2)), 1.0, 2.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    with pytest.raises(ValueError, match="power of two"):
        spectrogram_amplitude(_t(x), 100, 25, "hann")
    assert spectrogram(_t(x), 256, 128, framed=True).amplitude.dtype == torch.float64
    with pytest.raises(AssertionError, match="kernel wrapper"):
        spectrogram_amplitude(_t(x.astype(np.float32)), 256, 128)


def test_pinned_stockham_takes_generic_spectrogram_route():
    x = _t(RNG.standard_normal(2048).astype(np.float32))
    fused = spectrogram(x, 512, 128, "hann")
    dispatch.set_fft_impl("stockham")
    try:
        plain = spectrogram(x, 512, 128, "hann")
    finally:
        dispatch.set_fft_impl("auto")
    torch.testing.assert_close(plain.amplitude, fused.amplitude, rtol=0, atol=AMP_TOL)


# ── error contracts: the same exception type in both packages ────────


def _raises_same(port_call, jax_call):
    with pytest.raises(Exception) as port_err:
        port_call()
    with pytest.raises(Exception) as jax_err:
        jax_call()
    assert type(port_err.value) is type(jax_err.value), (port_err.value, jax_err.value)


@pytest.mark.parametrize("case", ["framed_bad_hop", "framed_two_sided",
                                  "short_amplitude", "short_spectrogram",
                                  "short_stft", "misaligned_chunk",
                                  "non_pow2_large"])
def test_error_contracts_match_jax(case):
    x = RNG.standard_normal(2048).astype(np.float32)
    p, j = _t(x), jnp.asarray(x)
    calls = {
        "framed_bad_hop": (lambda m, a: m.spectrogram_amplitude(a, 512, 100, framed=True)),
        "framed_two_sided": (lambda m, a: m.spectrogram_amplitude(
            a, 512, 128, sides="two", framed=True)),
        "short_amplitude": (lambda m, a: m.spectrogram_amplitude(a[:300], 512, 128)),
        "short_spectrogram": (lambda m, a: m.spectrogram(a[:300], 512, 128,
                                                         framed=True)),
        "short_stft": (lambda m, a: m.stft(a[:300], 512)),
        "misaligned_chunk": (lambda m, a: m.stft_step(
            m.stft_stream_init(256, 64), a[:100], 256, 64)),
        "non_pow2_large": (lambda m, a: m.spectrogram_amplitude(a, 384, 128)),
    }
    port_mod = importlib.import_module("pragma_dsp_tpu_torch.stream")
    _raises_same(lambda: calls[case](port_mod, p), lambda: calls[case](jstream, j))


# ── the slice as a whole ─────────────────────────────────────────────


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chirp_fixture_spectrogram_peaks_match_jax(chirp_refs, dtype):
    for c in chirp_refs["cases"]:
        x = np.asarray(c["signal"], dtype)
        sr = c["sampleRate"]
        got = result_to_numpy(spectrogram(_t(x), 256, 128, "hann", sr))
        ref = jstream.spectrogram(jnp.asarray(x), 256, 128, "hann", sr)
        freqs = np.asarray(ref.peak.frequency)
        assert got.peak.frequency.shape == freqs.shape == (7,)
        np.testing.assert_array_equal(got.peak.frequency, freqs, err_msg=c["name"])
        assert np.all(np.diff(freqs) >= 0)      # a rising chirp
        tol = F64_TOL if dtype == np.float64 else AMP_TOL
        np.testing.assert_allclose(got.amplitude, np.asarray(ref.amplitude),
                                   rtol=0, atol=tol)


def test_public_names_match_jax():
    port_mod = importlib.import_module("pragma_dsp_tpu_torch.stream")
    assert sorted(port_mod.__all__) == sorted(jstream.__all__)
