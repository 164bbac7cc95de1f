"""The port's FIR path (ops.fir, ops.conv_cuda, ops.polyphase.design_lowpass)
against the JAX package on the same seeded numpy inputs.

* float64: fir_filter (direct, overlap_save, auto), overlap_save_filter at
  explicit blocks, complex and int input, fir_step chains, to 1e-10;
* design_lowpass bit-equal;
* the same exception type and message for the same bad call;
* the committed fixture tests/fixtures/dsp/fir.json.gz (>= 130 dB);
* float32: the plain version of K5a/K5b against the JAX Pallas kernels run
  in interpret mode, and fir_filter against the JAX float32 routes;
* the plain version of the kernel route's signal-in entry against
  overlap_save_filter and scipy's lfilter;
* the K5b pairing fault for a non-Hermitian H, shown in numpy.

The kernels themselves run only on a CUDA card (tests/test_torch_cuda.py,
chip_smoke.py phases 11-12).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.ops.conv_pallas import circular_convolve_pallas
from pragma_dsp_tpu.ops.fft_pallas import fft_pallas_permuted
from pragma_dsp_tpu.utils.fixtures import assert_snr, fixtures_dir, load_json
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (FirState, circular_convolve_cuda,
                                      design_lowpass, dispatch, fir_filter, fir_step,
                                      fir_stream_init, overlap_save_filter)
from pragma_dsp_tpu_torch.ops.conv_cuda import (circular_convolve_plain,
                                                overlap_save_cuda, overlap_save_plain)
from pragma_dsp_tpu_torch.utils import fir_state_from_numpy, fir_state_to_numpy
from pragma_dsp_tpu_torch import set_default_device

jfir = importlib.import_module("pragma_dsp_tpu.ops.fir")
jpoly = importlib.import_module("pragma_dsp_tpu.ops.polyphase")
pfir = importlib.import_module("pragma_dsp_tpu_torch.ops.fir")

F64_TOL = 1e-10
# float32 against float32, unit-scale signals: two FFT algorithms (or a
# convolution against an FFT route) each round to ~1e-7 per output.
F32_TOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _raises_like(jax_call, port_call):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(type(jerr.value)) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


# ── design_lowpass ───────────────────────────────────────────────────


@pytest.mark.parametrize("window", ["hamming", "hann", "blackman", "rect"])
@pytest.mark.parametrize("num_taps,cutoff", [(127, 0.2), (2048, 1 / 256),
                                             (9, 0.5), (64, 1.0)])
def test_design_lowpass_bit_equal(num_taps, cutoff, window):
    got = design_lowpass(num_taps, cutoff, window)
    ref = jpoly.design_lowpass(num_taps, cutoff, window)
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref)


def test_design_lowpass_unknown_window():
    _raises_like(lambda: jpoly.design_lowpass(9, 0.3, "kaiser"),
                 lambda: design_lowpass(9, 0.3, "kaiser"))


# ── float64 parity ───────────────────────────────────────────────────


@pytest.mark.parametrize("method", ["direct", "overlap_save", "auto"])
@pytest.mark.parametrize("k", [9, 31, 64, 127, 255])
def test_fir_filter_matches_jax_f64(k, method):
    rng = _rng(k)
    x = rng.standard_normal((3, 4, 1500))
    taps = sps.firwin(k, 0.2)
    got = fir_filter(_t(x), taps, method)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps), method))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.numpy()[1, 2], sps.lfilter(taps, 1.0, x[1, 2]),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("k,block,length", [(17, 64, 1000), (9, 16, 100),
                                            (127, 512, 3000), (129, 256, 2000),
                                            (1, 256, 700), (65, 1024, 300)])
def test_overlap_save_blocks_match_jax_f64(k, block, length):
    rng = _rng(100 + k)
    x = rng.standard_normal((2, length))
    taps = rng.standard_normal(k) / k
    got = overlap_save_filter(_t(x), _t(taps), block=block)
    ref = np.asarray(jfir.overlap_save_filter(jnp.asarray(x), jnp.asarray(taps),
                                              block=block))
    assert got.shape == ref.shape == (2, length)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("method", ["direct", "overlap_save"])
def test_fir_complex_input_matches_jax(method):
    rng = _rng(7)
    z = rng.standard_normal((2, 900)) + 1j * rng.standard_normal((2, 900))
    taps = sps.firwin(65, 0.3)
    ref = jfir.fir_filter(JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)),
                          jnp.asarray(taps), method)
    want = np.asarray(ref.real) + 1j * np.asarray(ref.imag)
    for x in (ComplexArray(_t(z.real), _t(z.imag)), _t(z)):
        got = fir_filter(x, taps, method)
        assert isinstance(got, ComplexArray)
        np.testing.assert_allclose(got.to_numpy_complex(), want, rtol=0,
                                   atol=F64_TOL)
    np.testing.assert_allclose(want, sps.lfilter(taps, 1.0, z, axis=-1), atol=1e-9)


def test_fir_int_input_is_coerced():
    """The JAX cases of tests/test_complex_input.py: int signals are
    filtered as floats, not with taps cast to int. The port coerces to
    float32 (torch's default) where the JAX package with x64 gives float64,
    so the comparison is at float32's tolerance, relative to the scale."""
    x = np.arange(64)
    taps = sps.firwin(9, 0.3)
    got = fir_filter(_t(x), taps)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL * 64)
    x2 = np.arange(2048)
    t127 = sps.firwin(127, 0.2)
    got = overlap_save_filter(_t(x2), _t(t127))
    ref = np.asarray(jfir.overlap_save_filter(jnp.asarray(x2), jnp.asarray(t127)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL * 2048)
    st, y = fir_step(fir_stream_init(taps), _t(np.arange(32)), taps)
    np.testing.assert_allclose(y.numpy(), sps.lfilter(taps, 1.0, np.arange(32.0)),
                               rtol=0, atol=F32_TOL * 32)


@pytest.mark.parametrize("k,chunk", [(9, 50), (65, 512), (127, 300)])
def test_fir_step_chain_matches_jax(k, chunk):
    rng = _rng(k + chunk)
    taps = sps.firwin(k, 0.15)
    chunks = [rng.standard_normal((2, chunk)) for _ in range(4)]
    st = fir_stream_init(taps, (2,), dtype=torch.float64)
    jst = jfir.fir_stream_init(taps, (2,), dtype=jnp.float64)
    outs = []
    for ch in chunks:
        st, y = fir_step(st, _t(ch), taps)
        jst, jy = jfir.fir_step(jst, jnp.asarray(ch), jnp.asarray(taps))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=F64_TOL)
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
        outs.append(y.numpy())
    full = np.concatenate(chunks, axis=-1)
    np.testing.assert_allclose(np.concatenate(outs, axis=-1),
                               fir_filter(_t(full), taps).numpy(), rtol=0, atol=1e-9)


def test_fir_state_roundtrip_through_numpy():
    """A carry made by the JAX package continues in the port and back."""
    rng = _rng(3)
    taps = sps.firwin(65, 0.15)
    a, b = rng.standard_normal(400), rng.standard_normal(400)
    jst, _ = jfir.fir_step(jfir.fir_stream_init(taps, dtype=jnp.float64),
                           jnp.asarray(a), jnp.asarray(taps))
    st = fir_state_from_numpy(fir_state_to_numpy(jst), dtype=torch.float64)
    assert isinstance(st, FirState) and st.tail.shape == (64,)
    st, y = fir_step(st, _t(b), taps)
    jst, jy = jfir.fir_step(jst, jnp.asarray(b), jnp.asarray(taps))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=F64_TOL)
    back = fir_state_to_numpy(st)
    np.testing.assert_array_equal(back.tail, np.asarray(jst.tail))


def test_fir_fixture_goldens():
    """tests/fixtures/dsp/fir.json.gz, as tests/test_dsp_fixtures.py runs it."""
    cases = load_json(os.path.join(fixtures_dir(), "dsp", "fir.json"))["cases"]
    assert cases
    for c in cases:
        y = fir_filter(torch.tensor(c["input"], dtype=torch.float64),
                       torch.tensor(c["taps"], dtype=torch.float64))
        assert_snr(c["output"], y.numpy(), 130, c["name"])


# ── errors ───────────────────────────────────────────────────────────


def _bad_calls():
    x = _rng(0).standard_normal(1024)
    yield "non-pow2 block", (lambda m: m.overlap_save_filter), (x, np.hamming(9)), {"block": 300}
    yield "tiny block", (lambda m: m.overlap_save_filter), (x, np.hamming(200)), {"block": 256}
    yield "unknown method", (lambda m: m.fir_filter), (x, np.hamming(9), "fast"), {}


@pytest.mark.parametrize("label", [c[0] for c in _bad_calls()])
def test_fir_errors_match_jax(label):
    _, fn, args, kw = next(c for c in _bad_calls() if c[0] == label)
    x, taps = args[:2]
    _raises_like(lambda: fn(jfir)(jnp.asarray(x), jnp.asarray(taps), *args[2:], **kw),
                 lambda: fn(pfir)(_t(x), _t(taps), *args[2:], **kw))


def test_circular_convolve_errors_match_jax():
    n = 256
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    jh = fft_pallas_permuted(JComplexArray(jnp.asarray(h), jnp.zeros(n, jnp.float32)),
                             interpret=True, precision="highest")
    ph = dispatch.fft(_t(h))
    x = np.zeros((2, n), np.float32)
    _raises_like(lambda: circular_convolve_pallas(jnp.asarray(x[:, :200]), jh, n,
                                                  interpret=True),
                 lambda: circular_convolve_cuda(_t(x[:, :200]), ph, n))
    _raises_like(lambda: circular_convolve_pallas(jnp.asarray(x[:, :128]), jh, 128,
                                                  interpret=True),
                 lambda: circular_convolve_cuda(_t(x[:, :128]), ph, 128))
    # Each entry rejects the other's layout of H.
    with pytest.raises(ValueError, match="digit-permuted"):
        circular_convolve_pallas(jnp.asarray(x), JComplexArray(
            jnp.asarray(ph.real.numpy()), jnp.asarray(ph.imag.numpy())), n,
            interpret=True)
    permuted = ComplexArray(_t(np.asarray(jh.real)), _t(np.asarray(jh.imag)))
    with pytest.raises(ValueError, match="natural-order"):
        circular_convolve_cuda(_t(x), permuted, n)


def test_overlap_save_route_rule():
    """The fused kernels take CUDA float32/bfloat16 blocks of n > 128 under
    impl "auto" or "cuda"; float64, the CPU and n <= 128 go through
    ops.dispatch."""
    rule = pfir._use_kernel
    assert rule("cuda", torch.float32, 256) and rule("cuda", torch.bfloat16, 1024)
    assert not rule("cuda", torch.float32, 128)
    assert not rule("cuda", torch.float64, 1024)
    assert not rule("cpu", torch.float32, 1024)
    dispatch.set_fft_impl("stockham")
    try:
        assert not rule("cuda", torch.float32, 1024)
    finally:
        dispatch.set_fft_impl("auto")
    dispatch.set_fft_impl("cuda")
    try:
        assert rule("cuda", torch.float32, 1024)
    finally:
        dispatch.set_fft_impl("auto")


# ── float32: the plain version of K5 against the Pallas kernels ──────


def _hamming127(n):
    h = np.zeros(n, np.float32)
    h[:127] = np.hamming(127) / np.hamming(127).sum()
    return h


@pytest.mark.parametrize("batch", [1, 3])
def test_circular_convolve_plain_matches_pallas_interpret(batch):
    """K5a (batch 1) and K5b (batch 3: an odd batch) at n = 256."""
    n = 256
    h = _hamming127(n)
    x = _rng(batch).standard_normal((batch, n)).astype(np.float32)
    jh = fft_pallas_permuted(JComplexArray(jnp.asarray(h), jnp.zeros(n, jnp.float32)),
                             interpret=True, precision="highest")
    ref = np.asarray(circular_convolve_pallas(jnp.asarray(x), jh, n, interpret=True,
                                              precision="highest"))
    got = circular_convolve_cuda(_t(x), dispatch.fft(_t(h)), n)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    oracle = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64)) * np.fft.fft(h)))
    assert_snr(oracle, got.numpy(), 125, "plain K5 vs float64")


def test_circular_convolve_plain_donate_and_shape():
    """On the CPU donate has no effect; leading batch axes are kept."""
    n = 512
    h = _hamming127(n)
    x = _t(_rng(9).standard_normal((2, 3, n)).astype(np.float32))
    hs = dispatch.fft(_t(h))
    a = circular_convolve_cuda(x, hs, n)
    b = circular_convolve_cuda(x.clone(), hs, n, donate=True)
    assert a.shape == (2, 3, n) and torch.equal(a, b)
    assert torch.equal(a, circular_convolve_plain(x, hs, n))


# (taps, block, signal length): a length that is no multiple of the hop, one
# that is, one block, and the smallest block
SIGNAL_IN_CASES = [(127, 1024, 3000), (127, 1024, 3 * 898), (127, 1024, 300),
                   (33, 256, 5000), (1, 256, 700)]


@pytest.mark.parametrize("k,n,length", SIGNAL_IN_CASES)
def test_overlap_save_on_the_signal_equals_the_filter_f64(k, n, length):
    """The plain version of the kernel route's signal-in entry (blocks read
    at their offset, only valid samples written) against
    overlap_save_filter's present result and scipy's lfilter."""
    rng = _rng(k + length)
    x = rng.standard_normal((2, length))
    taps = rng.standard_normal(k) / k
    h = torch.zeros(n, dtype=torch.float64)
    h[:k] = _t(taps)
    got = overlap_save_cuda(_t(x), dispatch.fft(h), n, k - 1)
    assert got.dtype == torch.float64 and got.shape == (2, length)
    assert torch.equal(got, overlap_save_plain(_t(x), dispatch.fft(h), n, k - 1))
    want = overlap_save_filter(_t(x), _t(taps), block=n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.numpy(), sps.lfilter(taps, 1.0, x, axis=-1),
                               rtol=0, atol=1e-9)


def test_overlap_save_on_the_signal_f32_and_shapes():
    """float32 under the FIR gate; leading axes kept; an overlap longer than
    the taps need drops valid samples only."""
    rng = _rng(17)
    x = rng.standard_normal((2, 3, 2500)).astype(np.float32)
    taps = sps.firwin(127, 0.2).astype(np.float32)
    h = torch.zeros(1024)
    h[:127] = _t(taps)
    hs = dispatch.fft(h)
    got = overlap_save_cuda(_t(x), hs, 1024, 126)
    ref = sps.lfilter(taps.astype(np.float64), 1.0, x.astype(np.float64), axis=-1)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 2500)
    assert_snr(ref, got.numpy(), 120, "signal-in overlap-save f32 vs lfilter")
    wider = overlap_save_cuda(_t(x), hs, 1024, 200)
    np.testing.assert_allclose(wider.numpy(), got.numpy(), rtol=0, atol=F32_TOL)


def test_overlap_save_on_the_signal_input_rules():
    x, hs = torch.zeros(2, 500), dispatch.fft(torch.zeros(256))
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        overlap_save_cuda(x, dispatch.fft(torch.zeros(128)), 128, 10)
    with pytest.raises(ValueError, match="power-of-two n > 128"):
        overlap_save_cuda(x, hs, 300, 10)
    for overlap in (-1, 256):
        with pytest.raises(ValueError, match="overlap must lie in 0..255"):
            overlap_save_cuda(x, hs, 256, overlap)
    assert overlap_save_cuda(torch.zeros(2, 0), hs, 256, 10).shape == (2, 0)


@pytest.mark.parametrize("method", ["direct", "overlap_save"])
def test_fir_filter_f32_matches_jax_f32(method):
    rng = _rng(11)
    x = rng.standard_normal((4, 3000)).astype(np.float32)
    taps = sps.firwin(127, 0.2).astype(np.float32)
    got = fir_filter(_t(x), _t(taps), method)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps), method))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)
    assert_snr(sps.lfilter(taps.astype(np.float64), 1.0, x.astype(np.float64)),
               got.numpy(), 120, f"{method} f32 vs lfilter")


# ── the K5b pairing fault of a non-Hermitian H ───────────────────────


def test_pairing_is_exact_only_for_a_hermitian_spectrum():
    """K5b convolves frames a, b as one complex signal a + ib and keeps the
    re plane as a's output. For the spectrum of a real filter that equals
    K5a's Re ifft(fft(a) H); for any other H it is Re(conv a) - Im(conv b).
    Both packages' kernels compute this, so batch 1 and batch >= 2 differ
    there; circular_convolve_cuda states that H must be Hermitian."""
    rng = _rng(21)
    n = 256
    a, b = rng.standard_normal(n), rng.standard_normal(n)

    def single(x, hs):
        return np.real(np.fft.ifft(np.fft.fft(x) * hs))

    def paired(hs):
        z = np.fft.ifft(np.fft.fft(a + 1j * b) * hs)
        return z.real, z.imag

    herm = np.fft.fft(rng.standard_normal(n))
    pa, pb = paired(herm)
    np.testing.assert_allclose(pa, single(a, herm), atol=1e-12)
    np.testing.assert_allclose(pb, single(b, herm), atol=1e-12)
    other = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    pa, _ = paired(other)
    conv_a = np.fft.ifft(np.fft.fft(a) * other)
    conv_b = np.fft.ifft(np.fft.fft(b) * other)
    np.testing.assert_allclose(pa, conv_a.real - conv_b.imag, atol=1e-12)
    assert np.abs(pa - single(a, other)).max() > 0.1
