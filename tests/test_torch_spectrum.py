"""The port's spectrum path against the JAX package: spectrum() on the
reallife fixtures in float64, the peak rule, batching, the input rules,
the FFT dispatch policy, the flagship step and the caching service."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import pragma_dsp_tpu as jpd
from pragma_dsp_tpu.public.spectrum import find_peak as jfind_peak
from pragma_dsp_tpu_torch import spectrum
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.entry import entry
from pragma_dsp_tpu_torch.ops import dispatch
from pragma_dsp_tpu_torch.public.spectrum import (
    _use_fused_one_sided, build_frame, find_peak)
from pragma_dsp_tpu_torch.stream import (
    FourierService, default_service, spectrum_fx, spectrum_stream)
from pragma_dsp_tpu_torch.utils import result_to_numpy
from pragma_dsp_tpu_torch import set_default_device


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _port(x, **kw):
    return result_to_numpy(spectrum(torch.from_numpy(np.asarray(x)), **kw))


def _jax(x, **kw):
    r = jpd.spectrum(jnp.asarray(x), **kw)
    return jax.tree_util.tree_map(np.asarray, r)


def _assert_same_spectrum(got, ref, tol, label=""):
    scale = max(1.0, float(np.max(np.abs(ref.amplitude))))
    np.testing.assert_allclose(got.amplitude, ref.amplitude, rtol=0,
                               atol=tol * scale, err_msg=label)
    np.testing.assert_array_equal(got.frequencies, ref.frequencies)
    sig = ref.amplitude > 1e-6 * scale
    d = np.abs(np.angle(np.exp(1j * (got.phase[sig] - ref.phase[sig]))))
    assert d.size == 0 or d.max() < 1e-6, label
    if got.amplitude.shape[-1] == got.frequencies.shape[-1] and not np.array_equal(
            got.peak.index, ref.peak.index):
        # Two-sided spectra of real signals tie bins k and N-k to ~1 ulp,
        # so the first argmax may land on either side of the tie.
        n = got.amplitude.shape[-1]
        np.testing.assert_array_equal(got.peak.index, (n - ref.peak.index) % n,
                                      err_msg=label)
    else:
        np.testing.assert_array_equal(got.peak.index, ref.peak.index, err_msg=label)
        np.testing.assert_array_equal(got.peak.frequency, ref.peak.frequency)
    np.testing.assert_allclose(got.peak.amplitude, ref.peak.amplitude, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("window", ["rect", "hann"])
@pytest.mark.parametrize("sides", ["one", "two"])
def test_spectrum_matches_jax_on_reallife_f64(all_signal_refs, sides, window):
    for c in all_signal_refs:
        x = np.asarray(c["signal"], np.float64)
        kw = dict(sample_rate=c["sampleRate"], sides=sides, window=window)
        _assert_same_spectrum(_port(x, **kw), _jax(x, **kw), 1e-10, c["name"])


def test_spectrum_scaling_laws_on_fixtures(pure_sine_refs, special_refs):
    for c in pure_sine_refs["cases"]:
        if c["kind"] != "pure_sine_bin_centered":
            continue
        r = _port(np.asarray(c["signal"]), sample_rate=c["sampleRate"])
        a = c["params"]["amplitude"]
        assert abs(float(r.peak.amplitude) - a) < 1e-9 * max(1.0, a), c["name"]
        assert int(r.peak.index) == c["params"]["bin_index"]
        assert abs(float(r.peak.frequency) - c["params"]["frequency_hz"]) < 1e-6
    cases = {c["kind"]: c for c in special_refs["cases"]}
    dc = _port(np.asarray(cases["dc"]["signal"]))
    assert abs(dc.amplitude[0] - 1.0) < 1e-9                  # DC not doubled
    nyq = cases["nyquist"]
    r = _port(np.asarray(nyq["signal"]))
    assert abs(r.amplitude[nyq["n"] // 2] - nyq["params"]["amplitude"]) < 1e-9
    ds = cases["dc_plus_sine"]
    r = _port(np.asarray(ds["signal"]))
    assert int(r.peak.index) == ds["params"]["sine_bin"]       # DC ignored


@pytest.mark.parametrize("amp,want", [
    ([0.0, 0.0, 0.0, 0.0], 0),          # all zero: global argmax -> DC
    ([0.0, 1.0, 3.0, 3.0, 1.0], 2),     # ties: first index wins
    ([-1.0, -2.0, -0.5, -3.0], 2),      # negative only: global argmax
    ([5.0, 1.0, 2.0], 2),               # DC largest, non-DC > 0: non-DC wins
    ([2.0, 0.0, 0.0, 0.0], 0),          # only DC > 0
])
def test_find_peak_rule_matches_jax(amp, want):
    a64 = np.asarray(amp, np.float64)
    freqs = np.arange(a64.size, dtype=np.float64) * 10.0
    got = find_peak(torch.from_numpy(a64), torch.from_numpy(freqs))
    ref = jfind_peak(jnp.asarray(a64), jnp.asarray(freqs))
    assert int(got.index) == int(ref.index) == want
    assert float(got.frequency) == float(ref.frequency) == 10.0 * want
    assert float(got.amplitude) == float(ref.amplitude) == amp[want]


def test_batched_spectrum_matches_loop_and_jax():
    rng = np.random.default_rng(3)
    t = np.arange(1000) / 8000.0
    x = np.stack([np.sin(2 * np.pi * 440.0 * t), rng.standard_normal(1000),
                  np.zeros(1000)]).reshape(3, 1, 1000)
    rb = _port(x, sample_rate=8000.0, window="hamming")
    assert rb.amplitude.shape == (3, 1, 513) and rb.peak.index.shape == (3, 1)
    for i in range(3):
        ri = _port(x[i, 0], sample_rate=8000.0, window="hamming")
        np.testing.assert_allclose(rb.amplitude[i, 0], ri.amplitude, rtol=0, atol=1e-12)
        assert int(rb.peak.index[i, 0]) == int(ri.peak.index)
    _assert_same_spectrum(rb, _jax(x, sample_rate=8000.0, window="hamming"), 1e-10)


@pytest.mark.parametrize("n", [256, 1024])
def test_f32_spectrum_takes_k1_route_and_matches_jax(n):
    rng = np.random.default_rng(21)
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t + 0.7)
         + 0.01 * rng.standard_normal((2, n))).astype(np.float32)
    assert _use_fused_one_sided(torch.from_numpy(x), n, "one")
    got = _port(x, sample_rate=48000.0, window="hann")
    ref = _jax(x, sample_rate=48000.0, window="hann")
    assert got.amplitude.dtype == np.float32
    np.testing.assert_allclose(got.amplitude, ref.amplitude, rtol=0, atol=2e-6)
    mask = ref.amplitude > 1e-3
    d = np.abs(np.angle(np.exp(1j * (got.phase[mask] - ref.phase[mask]))))
    assert d.max() <= 1e-4
    np.testing.assert_array_equal(got.peak.index, ref.peak.index)


def test_pinned_stockham_skips_k1_route():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(512).astype(np.float32))
    fused = spectrum(x, window="hann")
    dispatch.set_fft_impl("stockham")
    try:
        assert not _use_fused_one_sided(x, 512, "one")
        plain = spectrum(x, window="hann")
    finally:
        dispatch.set_fft_impl("auto")
    torch.testing.assert_close(plain.amplitude, fused.amplitude, rtol=0, atol=2e-6)
    assert not _use_fused_one_sided(x, 128, "one")
    assert not _use_fused_one_sided(x, 512, "two")
    assert not _use_fused_one_sided(x.double(), 512, "one")


def test_bf16_and_int_input_ride_f32_pipeline():
    rng = np.random.default_rng(12)
    x16 = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).bfloat16()
    r16 = spectrum(x16, sample_rate=48000.0, window="hann")
    r32 = spectrum(x16.float(), sample_rate=48000.0, window="hann")
    assert r16.amplitude.dtype == torch.float32
    assert torch.equal(r16.amplitude, r32.amplitude)
    assert torch.equal(r16.phase, r32.phase)
    ri = spectrum(torch.arange(256) % 7)
    rf = spectrum((torch.arange(256) % 7).float())
    assert ri.amplitude.dtype == torch.float32
    assert torch.equal(ri.amplitude, rf.amplitude)


def test_complex_input_rejected():
    z = np.ones(64) + 1j
    for x in (z, torch.from_numpy(z), torch.from_numpy(z.astype(np.complex64))):
        with pytest.raises(TypeError, match="real samples"):
            spectrum(x)


def test_padding_truncation_and_default_size():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(300)
    r = _port(x, fft_size=512)
    padded = np.zeros(512)
    padded[:300] = x
    k = np.arange(257)
    factor = np.where((k == 0) | (k == 256), 1 / 512, 2 / 512)
    np.testing.assert_allclose(r.amplitude, np.abs(np.fft.fft(padded))[:257] * factor,
                               atol=1e-12)
    r = _port(rng.standard_normal(1000), fft_size=256)
    assert r.amplitude.shape == (129,)
    assert _port(np.ones(100)).amplitude.shape == (65,)
    assert build_frame(torch.zeros(2, 3), 3).shape == (2, 3)


def test_dispatch_policy():
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    assert dispatch.choose_impl("cpu", f32, 1024) == "stockham"
    assert dispatch.choose_impl("cuda", f64, 1024) == "stockham"
    assert dispatch.choose_impl("cuda", f32, 1024) == "cuda"
    assert dispatch.choose_impl("cuda", bf16, 2) == "cuda"
    assert dispatch.choose_impl("cuda", f32, 16384) == "cuda"
    assert dispatch.choose_impl("cuda", f32, 1) == "cuda"
    assert dispatch.choose_impl("cuda", f32, 1000) == "stockham"
    # Above the row kernel: 2^15 rides fourstep (the JAX package's own
    # routing gap), 2^16..2^26 the two-kernel route, beyond it fourstep.
    assert dispatch.choose_impl("cuda", f32, 32768) == "fourstep"
    assert dispatch.choose_impl("cuda", bf16, 1 << 20) == "big"
    assert dispatch.choose_impl("cuda", f32, 1 << 27) == "fourstep"
    assert dispatch.get_fft_impl() == "auto"
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.set_fft_impl("pallas")
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.fft(torch.zeros(8), impl="pallas")
    four = dispatch.fft(torch.ones(8, dtype=torch.float64), impl="fourstep")
    np.testing.assert_allclose(four.real.numpy(), [8.0] + [0.0] * 7, atol=1e-14)


def test_dispatch_cpu_paths_agree():
    rng = np.random.default_rng(9)
    z = rng.standard_normal((2, 3, 256)) + 1j * rng.standard_normal((2, 3, 256))
    ca = ComplexArray(torch.from_numpy(z.real.astype(np.float32)),
                      torch.from_numpy(z.imag.astype(np.float32)))
    auto = dispatch.fft(ca)
    rows = dispatch.fft(ca, impl="cuda")               # K2's plain version on CPU
    assert torch.equal(auto.real, rows.real) and torch.equal(auto.imag, rows.imag)
    col = dispatch.fft(ComplexArray(ca.real.transpose(1, 2), ca.imag.transpose(1, 2)),
                       axis=1, impl="cuda")
    torch.testing.assert_close(col.real.transpose(1, 2), auto.real, rtol=0, atol=1e-4)
    back = dispatch.ifft(auto, impl="cuda")
    np.testing.assert_allclose(back.to_numpy_complex(), z, atol=1e-5)
    bf = dispatch.fft(ComplexArray(ca.real.bfloat16(), ca.imag.bfloat16()), impl="cuda")
    assert bf.real.dtype == torch.bfloat16
    z64 = ComplexArray(torch.from_numpy(z.real), torch.from_numpy(z.imag))
    np.testing.assert_allclose(dispatch.fft(z64).to_numpy_complex(),
                               np.fft.fft(z, axis=-1), rtol=0, atol=1e-9)


def test_flagship_step_matches_jax_entry():
    jfn, (jbatch,) = __graft_entry__.entry()
    jamp, jidx, jfreq, jpamp = (np.asarray(v) for v in jfn(jbatch))
    step, (batch,) = entry("cpu")
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    amp, idx, freq, pamp = (v.numpy() for v in step(batch))
    np.testing.assert_allclose(amp, jamp, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(freq, jfreq)
    np.testing.assert_allclose(pamp, jpamp, rtol=0, atol=2e-6)
    assert idx[0] == 32 and freq[0] == 1500.0 and idx[3] == 0


def test_spectrum_fx_parity_and_cache_identity(pure_sine_refs):
    svc = FourierService()
    for c in pure_sine_refs["cases"][:3]:
        x = torch.tensor(c["signal"], dtype=torch.float64)
        a = spectrum(x, sample_rate=c["sampleRate"], window="hann")
        b = spectrum_fx(x, service=svc, sample_rate=c["sampleRate"], window="hann")
        assert torch.equal(a.amplitude, b.amplitude) and torch.equal(a.phase, b.phase)
        assert int(a.peak.index) == int(b.peak.index)
    assert svc.fft(1024) is svc.fft(1024)
    assert svc.fft(1024) is not svc.fft(2048)
    assert svc.window("hann", 1024) is svc.window("hann", 1024)
    assert svc.window("hann", 256) is not svc.window("hamming", 256)
    assert default_service() is default_service()
    frames = [np.asarray(c["signal"], np.float32) for c in pure_sine_refs["cases"][:3]]
    results = list(spectrum_stream(iter(frames), sample_rate=48000.0))
    assert [int(r.peak.index) for r in results] == [
        c["params"]["bin_index"] for c in pure_sine_refs["cases"][:3]]
    assert list(spectrum_stream(iter([]))) == []
