"""The port's demodulators (ops.demod) and receivers (models) against the
JAX package on the same seeded numpy inputs.

* float64: am_demod, fm_discriminate and its streaming step,
  iir_one_pole (a scalar and a [..., 1] y0, a tensor alpha, lengths that
  take the carries through one, two and three levels of blocks),
  deemphasis, FmReceiver (batch, streaming, the stream-start fix with and
  without its mask), AmReceiver, wbfm_demod and am_receive, to 1e-10;
* float32: the receiver's stream against its batch prefix and the JAX
  float32 batch at tests/test_streaming_scan.py:111's bound (2e-4), and
  de-emphasis against float64 lfilter;
* the committed fixture tests/fixtures/dsp/fm_demod.json.gz (>= 130 dB);
* the same exception type and message for the same bad call;
* the interop round trip of FmDemodState and WbfmStreamState (nested);
* the receivers' buffers: a float32 call on their device builds and
  uploads no matrix.

The chains run on CUDA in chip_smoke.py phase 20 and
tests/test_torch_cuda.py.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import assert_snr, fixtures_dir, load_json, snr_db
from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.models import (AmReceiver, AmReceiverConfig, FmReceiver,
                                         FmReceiverConfig, am_receive, wbfm_demod)
from pragma_dsp_tpu_torch.models.fm_receiver import WbfmStreamState
from pragma_dsp_tpu_torch.ops import (FmDemodState, am_demod, deemphasis, fm_discriminate,
                                      fm_discriminate_step, fm_stream_init, iir_one_pole)
from pragma_dsp_tpu_torch.ops.polyphase import UpfirdnState
from pragma_dsp_tpu_torch.utils import (fm_demod_state_from_numpy, fm_demod_state_to_numpy,
                                        wbfm_stream_state_from_numpy,
                                        wbfm_stream_state_to_numpy)

jdemod = importlib.import_module("pragma_dsp_tpu.ops.demod")
jmodels = importlib.import_module("pragma_dsp_tpu.models")
ppoly = importlib.import_module("pragma_dsp_tpu_torch.ops.polyphase")

F64_TOL = 1e-10
RX_F32_TOL = 2e-4         # tests/test_streaming_scan.py:111
CHUNK, N_CHUNKS = 4800, 3


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pca(z):
    return ComplexArray(_t(z.real), _t(z.imag))


def _jca(z):
    return JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def _raises_like(jax_call, port_call):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(type(jerr.value)) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


def _fm_iq(batch=2, n=CHUNK * N_CHUNKS, fs=2.4e6, seed=5):
    """An FM-modulated tone pair plus a little noise, [batch, n] complex."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    msg = 0.7 * np.sin(2 * np.pi * 1000.0 * t) + 0.2 * np.sin(2 * np.pi * 4000.0 * t)
    iq = np.exp(1j * (0.5 + 2 * np.pi * 75e3 * np.cumsum(msg) / fs))
    return iq + 0.01 * (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n)))


def _am_iq(batch=2, n=19200, fs=960e3):
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    iq = (1.0 + msg) * np.exp(1j * 2 * np.pi * 5000.0 * t)
    return np.stack([iq * (1 + 0.1 * b) for b in range(batch)])


# ── demodulators ─────────────────────────────────────────────────────


@pytest.mark.parametrize("remove_dc", [True, False])
def test_am_demod_matches_jax_f64(remove_dc):
    z = _am_iq(n=4000)
    got = am_demod(_pca(z), remove_dc)
    ref = np.asarray(jdemod.am_demod(_jca(z), remove_dc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(am_demod(z, remove_dc).numpy(), ref, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("deviation", [None, 10000.0])
def test_fm_discriminate_matches_jax_f64(deviation):
    z = _fm_iq(n=5000, fs=100000.0)
    got = fm_discriminate(_pca(z), sample_rate=1e5, deviation=deviation)
    ref = np.asarray(jdemod.fm_discriminate(_jca(z), sample_rate=1e5, deviation=deviation))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    oracle = np.angle(z[..., 1:] * np.conj(z[..., :-1])) * 1e5 / (2 * np.pi)
    np.testing.assert_allclose(got.numpy()[..., 1:] * (deviation or 1.0), oracle, rtol=0,
                               atol=1e-6)


def test_fm_discriminate_step_matches_jax_and_batch():
    z = _fm_iq(n=4096, fs=48000.0)
    pst, jst = fm_stream_init((2,), torch.float64), jdemod.fm_stream_init((2,), jnp.float64)
    outs, jouts = [], []
    for i in range(4):
        ch = z[:, i * 1024:(i + 1) * 1024]
        pst, y = fm_discriminate_step(pst, _pca(ch), sample_rate=48000.0, deviation=5000.0)
        jst, jy = jdemod.fm_discriminate_step(jst, _jca(ch), sample_rate=48000.0,
                                              deviation=5000.0)
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
    got = np.concatenate(outs, -1)
    np.testing.assert_allclose(got, np.concatenate(jouts, -1), rtol=0, atol=F64_TOL)
    batch = fm_discriminate(_pca(z), sample_rate=48000.0, deviation=5000.0).numpy()
    np.testing.assert_allclose(got, batch, rtol=0, atol=1e-12)
    assert isinstance(pst, FmDemodState) and pst.last_re.shape == (2, 1)


def _loop_iir(x, alpha, y0):
    ref = np.empty_like(x)
    for b in range(x.shape[0]):
        acc = y0[b, 0] if np.ndim(y0) else y0
        for n in range(x.shape[1]):
            acc = (1 - alpha) * x[b, n] + alpha * acc
            ref[b, n] = acc
    return ref


@pytest.mark.parametrize("n", [1, 127, 128, 517, 20000])
def test_iir_one_pole_matches_jax_f64(n):
    """20000 samples take the carries through three levels of blocks."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n))
    alpha = 0.9
    y0 = np.array([[1.5], [-0.25]])
    got = iir_one_pole(_t(x), torch.tensor(alpha, dtype=torch.float64), y0=_t(y0))
    ref = np.asarray(jdemod.iir_one_pole(jnp.asarray(x), alpha, y0=jnp.asarray(y0)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    if n <= 517:
        np.testing.assert_allclose(got.numpy(), _loop_iir(x, alpha, y0), rtol=0, atol=F64_TOL)
    scalar = iir_one_pole(_t(x), alpha, y0=1.5).numpy()
    np.testing.assert_allclose(scalar, np.asarray(jdemod.iir_one_pole(jnp.asarray(x), alpha,
                                                                      y0=1.5)),
                               rtol=0, atol=F64_TOL)


def test_iir_one_pole_matches_lfilter_and_the_jax_scan():
    """tests/test_demod.py:78-106 on the port: the blocked form against
    lfilter and the JAX element scan (its traced-alpha route)."""
    import jax

    x = np.random.default_rng(30).standard_normal((2, 517))
    alpha, y0 = 0.9, 1.5
    got = iir_one_pole(_t(x), alpha, y0=y0).numpy()
    scanned = np.asarray(jax.jit(lambda v, a: jdemod.iir_one_pole(v, a, y0=y0))(
        jnp.asarray(x), jnp.asarray(alpha)))
    np.testing.assert_allclose(got, scanned, rtol=0, atol=F64_TOL)
    zi = sps.lfiltic([1 - alpha], [1, -alpha], [y0])
    np.testing.assert_allclose(got[0], sps.lfilter([1 - alpha], [1, -alpha], x[0], zi=zi)[0],
                               rtol=0, atol=F64_TOL)


def test_deemphasis_matches_jax_f64_and_is_lowpass():
    x = np.random.default_rng(31).standard_normal(8192)
    got = deemphasis(_t(x), 48000.0, tau=75e-6).numpy()
    ref = np.asarray(jdemod.deemphasis(jnp.asarray(x), 48000.0, tau=75e-6))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    xs, ys = np.abs(np.fft.rfft(x)), np.abs(np.fft.rfft(got))
    assert (ys[3500:4000] / xs[3500:4000]).mean() < 0.5 * (ys[1:100] / xs[1:100]).mean()


def test_deemphasis_f32_against_f64_lfilter():
    """The JAX package's slow audit (tests/test_fm_receiver.py:96-120) at
    2^18 samples: float32 blocks against float64 lfilter."""
    x = np.random.default_rng(7).standard_normal(1 << 18)
    alpha = float(np.exp(-1.0 / (240e3 * 75e-6)))
    ref = sps.lfilter([1 - alpha], [1, -alpha], x)
    got = deemphasis(torch.from_numpy(x.astype(np.float32)), 240e3)
    assert got.dtype == torch.float32
    assert snr_db(ref, got.double().numpy()) > 120.0


def test_fm_demod_fixture():
    """tests/test_dsp_fixtures.py:38-46 on the port."""
    c = load_json(os.path.join(fixtures_dir(), "dsp", "fm_demod.json"))["cases"][0]
    disc = fm_discriminate(ComplexArray(_t(c["iqRe"]), _t(c["iqIm"])),
                           sample_rate=c["sampleRate"], deviation=c["deviation"])
    assert_snr(c["discriminator"], disc.numpy()[1:], 130, c["name"])
    assert_snr(c["message"][1:], disc.numpy()[1:], 35, "msg recovery")


# ── receivers ────────────────────────────────────────────────────────


def test_fm_receiver_matches_jax_f64():
    z = _fm_iq()
    got = FmReceiver(device="cpu")(_pca(z))
    ref = np.asarray(jmodels.FmReceiver()(_jca(z)))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(wbfm_demod(_pca(z)).numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(wbfm_demod(z).numpy(), ref, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("mask", [None, [True, False]])
def test_fm_receiver_stream_start_fix_matches_jax(mask):
    z = _fm_iq()
    z[:, :300] = 0.0                         # a zero-fill warm-up halo
    kw = {"stream_start_if": 30}
    pk = dict(kw, stream_start_mask=None if mask is None else torch.tensor(mask))
    jk = dict(kw, stream_start_mask=None if mask is None else jnp.asarray(mask))
    got = FmReceiver(device="cpu")(_pca(z), **pk)
    ref = np.asarray(jmodels.FmReceiver()(_jca(z), **jk))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)


def _rx_stream(rx, z, dtype, conv, init):
    st = init(dtype)
    outs = []
    for i in range(N_CHUNKS):
        ch = z[:, i * CHUNK:(i + 1) * CHUNK]
        st, y = rx.stream_step(st, conv(ch))
        outs.append(np.asarray(y))
    return st, np.concatenate(outs, -1)


def test_fm_receiver_stream_matches_jax_f64():
    z = _fm_iq()
    rx, jrx = FmReceiver(device="cpu"), jmodels.FmReceiver()
    assert rx.chunk_quantum == jrx.chunk_quantum == 50
    pst, got = _rx_stream(rx, z, torch.float64, _pca,
                          lambda d: rx.stream_init((2,), d, device="cpu"))
    jst, ref = _rx_stream(jrx, z, jnp.float64, _jca, lambda d: jrx.stream_init((2,), d))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    batch = rx(_pca(z)).numpy()
    np.testing.assert_allclose(got, batch[:, :got.shape[-1]], rtol=0, atol=1e-9)
    assert isinstance(pst, WbfmStreamState) and isinstance(pst.audio, UpfirdnState)
    np.testing.assert_allclose(pst.deemph_y.numpy(), np.asarray(jst.deemph_y), rtol=0,
                               atol=F64_TOL)


def test_fm_receiver_stream_f32_matches_batch_prefix():
    """tests/test_streaming_scan.py:78-111 on the port, float32."""
    z = _fm_iq(batch=1)[0]
    rx = FmReceiver(device="cpu")
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    batch = rx(ComplexArray(_t(re), _t(im))).numpy()
    ref = np.asarray(jmodels.FmReceiver()(JComplexArray(jnp.asarray(re), jnp.asarray(im))))
    np.testing.assert_allclose(batch, ref, rtol=0, atol=RX_F32_TOL)
    st = rx.stream_init(device="cpu")
    outs = []
    for i in range(N_CHUNKS):
        st, y = rx.stream_step(st, ComplexArray(_t(re[i * CHUNK:(i + 1) * CHUNK]),
                                                _t(im[i * CHUNK:(i + 1) * CHUNK])))
        assert y.dtype == torch.float32
        outs.append(y.numpy())
    got = np.concatenate(outs)
    np.testing.assert_allclose(got, batch[:got.size], rtol=0, atol=RX_F32_TOL)


def test_am_receiver_matches_jax_f64():
    z = _am_iq()
    got = AmReceiver(device="cpu")(_pca(z))
    ref = np.asarray(jmodels.AmReceiver()(_jca(z)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(am_receive(_pca(z)).numpy(), ref, rtol=0, atol=F64_TOL)
    spec = np.abs(np.fft.rfft(got.numpy()[0, 300:-300]))
    freqs = np.fft.rfftfreq(got.shape[-1] - 600, 1 / 48000.0)
    assert abs(freqs[np.argmax(spec[1:]) + 1] - 1000.0) < 60.0


def test_receiver_configs_and_errors_match_jax():
    _raises_like(lambda: jmodels.FmReceiverConfig(iq_rate=1e6, if_rate=3e5),
                 lambda: FmReceiverConfig(iq_rate=1e6, if_rate=3e5))
    _raises_like(lambda: jmodels.AmReceiverConfig(iq_rate=1e6, if_rate=3e5),
                 lambda: AmReceiverConfig(iq_rate=1e6, if_rate=3e5))
    rx, jrx = FmReceiver(device="cpu"), jmodels.FmReceiver()
    z = _fm_iq(n=125)
    _raises_like(lambda: jrx.stream_step(jrx.stream_init((2,)), _jca(z)),
                 lambda: rx.stream_step(rx.stream_init((2,), device="cpu"), _pca(z)))
    for cfg, jcfg in ((FmReceiverConfig(audio_rate=44.1e3, channel_taps=63),
                       jmodels.FmReceiverConfig(audio_rate=44.1e3, channel_taps=63)),
                      (FmReceiverConfig(deemphasis_tau=None),
                       jmodels.FmReceiverConfig(deemphasis_tau=None))):
        p, j = FmReceiver(cfg, device="cpu"), jmodels.FmReceiver(jcfg)
        assert (p._up, p._down, p._decim1) == (j._up, j._down, j._decim1)
        assert np.array_equal(p._audio_taps, j._audio_taps)
        assert np.array_equal(p._chan_taps, j._chan_taps)


def test_receivers_are_modules_whose_buffers_serve_float32():
    rx, am = FmReceiver(device="cpu"), AmReceiver(device="cpu")
    assert isinstance(rx, torch.nn.Module)
    assert {n for n, _ in rx.named_buffers()} == {"chan_band", "audio_band"}
    assert rx.chan_band.dtype == torch.float32 and am.audio_band.device.type == "cpu"
    assert torch.equal(rx.chan_band, ppoly.band_tensor(rx._chan_taps, 1, 10, torch.float32,
                                                       "cpu"))
    z = _fm_iq(batch=1)[0].astype(np.complex64)
    before = ppoly._band_on.cache_info()
    rx(ComplexArray(_t(z.real), _t(z.imag)))
    am(ComplexArray(_t(z.real), _t(z.imag)))
    assert ppoly._band_on.cache_info().misses == before.misses
    assert ppoly._band_on.cache_info().hits == before.hits


# ── interop ──────────────────────────────────────────────────────────


def test_fm_demod_state_round_trip():
    jst = jdemod.fm_stream_init((3,), jnp.float64)
    st = fm_demod_state_from_numpy(fm_demod_state_to_numpy(jst), device="cpu")
    assert isinstance(st, FmDemodState) and st.last_re.dtype == torch.float64
    assert np.array_equal(st.last_re.numpy(), np.ones((3, 1)))
    back = fm_demod_state_to_numpy(st)
    assert isinstance(back, FmDemodState) and isinstance(back.last_im, np.ndarray)


def test_wbfm_stream_state_crosses_between_the_packages():
    """A JAX receiver stream stopped after one chunk continues in the port:
    the nested carry (three UpfirdnStates, an FmDemodState, the IIR output)
    converts field by field."""
    z = _fm_iq()
    rx, jrx = FmReceiver(device="cpu"), jmodels.FmReceiver()
    jst = jrx.stream_init((2,), jnp.float64)
    jst, _ = jrx.stream_step(jst, _jca(z[:, :CHUNK]))
    _, jy = jrx.stream_step(jst, _jca(z[:, CHUNK:2 * CHUNK]))
    npst = wbfm_stream_state_to_numpy(jst)
    assert isinstance(npst, WbfmStreamState)
    assert isinstance(npst.chan_re, UpfirdnState) and isinstance(npst.disc, FmDemodState)
    pst = wbfm_stream_state_from_numpy(npst, device="cpu")
    assert isinstance(pst.audio.tail, torch.Tensor) and pst.deemph_y.dtype == torch.float64
    _, y = rx.stream_step(pst, _pca(z[:, CHUNK:2 * CHUNK]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=F64_TOL)
