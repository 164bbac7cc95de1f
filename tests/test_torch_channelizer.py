"""The port's channelizer (ops.channelizer, ops.pfb_cuda) against the JAX
package on the same seeded numpy inputs.

* float64: pfb_channelize, pfb_channelize_frames and both streaming steps
  at C in {16, 128, 256}, batched, to 1e-10; pfb_taps bit-equal;
* the same exception type and message for the same bad call;
* the committed fixture tests/fixtures/dsp/channelizer.json.gz (>= 120 dB);
* float32: the plain version of K6 against the JAX Pallas kernel run in
  interpret mode and against the JAX float32 route;
* the streaming carries through utils.interop.

The kernel itself runs only on a CUDA card (tests/test_torch_cuda.py,
chip_smoke.py phase 13).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.ops.pfb_pallas import (pfb_channelize_frames_pallas,
                                           pfb_channelize_pallas)
from pragma_dsp_tpu.utils.fixtures import assert_snr, fixtures_dir, load_json
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (PfbFramesState, PfbState, dispatch,
                                      pfb_channelize, pfb_channelize_cuda,
                                      pfb_channelize_frames,
                                      pfb_channelize_frames_cuda,
                                      pfb_channelize_frames_step,
                                      pfb_channelize_step, pfb_frames_stream_init,
                                      pfb_stream_init, pfb_taps)
from pragma_dsp_tpu_torch.ops.pfb_cuda import pfb_channelize_plain, pfb_tap_table
from pragma_dsp_tpu_torch.utils import (pfb_frames_state_from_numpy,
                                        pfb_frames_state_to_numpy,
                                        pfb_state_from_numpy, pfb_state_to_numpy)
from pragma_dsp_tpu_torch import set_default_device

jch = importlib.import_module("pragma_dsp_tpu.ops.channelizer")
pch = importlib.import_module("pragma_dsp_tpu_torch.ops.channelizer")

F64_TOL = 1e-10
# float32 channel samples of unit-variance noise: |y| ~ sqrt(C) after the
# unnormalised DFT; two FFT algorithms each round to ~1e-7 of that.
F32_RTOL = 2e-6
CHANNELS = (16, 128, 256)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _iq(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _port(z, dtype=torch.float64):
    return ComplexArray(torch.tensor(z.real, dtype=dtype),
                        torch.tensor(z.imag, dtype=dtype))


def _jax(z, dtype=jnp.float64):
    return JComplexArray(jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype))


def _cnp(z):
    return np.asarray(z.real) + 1j * np.asarray(z.imag)


def _raises_like(jax_call, port_call):
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(type(jerr.value)) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("channels,tpb,scale", [(16, 8, 1.0), (256, 8, 1.0),
                                                (128, 4, 0.8), (4096, 8, 1.0)])
def test_pfb_taps_bit_equal(channels, tpb, scale):
    got = pfb_taps(channels, tpb, scale)
    assert np.array_equal(got, jch.pfb_taps(channels, tpb, scale))


# ── float64 parity ───────────────────────────────────────────────────


@pytest.mark.parametrize("c", CHANNELS)
def test_pfb_channelize_matches_jax_f64(c):
    z = _iq(c, (2, 24 * c))
    got = pfb_channelize(_port(z), c)
    ref = jch.pfb_channelize(_jax(z), c)
    assert got.real.shape == (2, 24, c) and got.real.dtype == torch.float64
    np.testing.assert_allclose(got.to_numpy_complex(), _cnp(ref), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("c", CHANNELS)
def test_pfb_frames_matches_jax_and_flat(c):
    z = _iq(c + 1, (3, 20 * c))
    taps = pfb_taps(c, 6)
    frames = z.reshape(3, 20, c)
    got = pfb_channelize_frames(_port(frames), c, taps)
    ref = jch.pfb_channelize_frames(_jax(frames), c, jnp.asarray(taps))
    np.testing.assert_allclose(got.to_numpy_complex(), _cnp(ref), rtol=0, atol=F64_TOL)
    flat = pfb_channelize(_port(z), c, taps)
    assert torch.equal(got.real, flat.real) and torch.equal(got.imag, flat.imag)


def test_pfb_complex_tensor_and_real_input():
    c = 16
    z = _iq(5, 40 * c)
    ref = _cnp(jch.pfb_channelize(_jax(z), c))
    got = pfb_channelize(torch.from_numpy(z), c)
    np.testing.assert_allclose(got.to_numpy_complex(), ref, rtol=0, atol=F64_TOL)
    real = pfb_channelize(torch.from_numpy(z.real), c)
    np.testing.assert_allclose(real.to_numpy_complex(),
                               _cnp(jch.pfb_channelize(jnp.asarray(z.real), c)),
                               rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("c", CHANNELS)
def test_pfb_steps_match_jax(c):
    chunks = [_iq(10 * c + i, (2, 5 * c)) for i in range(4)]
    taps = pfb_taps(c, 8)
    st = pfb_stream_init(c, 8, (2,), dtype=torch.float64)
    jst = jch.pfb_stream_init(c, 8, (2,), dtype=jnp.float64)
    sf = pfb_frames_stream_init(c, 8, (2,), dtype=torch.float64)
    jsf = jch.pfb_frames_stream_init(c, 8, (2,), dtype=jnp.float64)
    outs = []
    for ch in chunks:
        st, y = pfb_channelize_step(st, _port(ch), c, taps)
        jst, jy = jch.pfb_channelize_step(jst, _jax(ch), c, jnp.asarray(taps))
        np.testing.assert_allclose(y.to_numpy_complex(), _cnp(jy), rtol=0, atol=F64_TOL)
        np.testing.assert_array_equal(st.tail_re.numpy(), np.asarray(jst.tail_re))
        fr = ch.reshape(2, 5, c)
        sf, yf = pfb_channelize_frames_step(sf, _port(fr), c, taps)
        jsf, jyf = jch.pfb_channelize_frames_step(jsf, _jax(fr), c, jnp.asarray(taps))
        np.testing.assert_allclose(yf.to_numpy_complex(), _cnp(jyf), rtol=0,
                                   atol=F64_TOL)
        np.testing.assert_array_equal(sf.tail_im.numpy(), np.asarray(jsf.tail_im))
        assert torch.equal(yf.real, y.real) and torch.equal(yf.imag, y.imag)
        outs.append(y.to_numpy_complex())
    full = pfb_channelize(_port(np.concatenate(chunks, axis=-1)), c, taps)
    np.testing.assert_allclose(np.concatenate(outs, axis=-2), full.to_numpy_complex(),
                               rtol=0, atol=1e-9)


def test_pfb_states_roundtrip_through_numpy():
    """Carries made by the JAX package continue in the port."""
    c = 16
    taps = pfb_taps(c, 8)
    a, b = _iq(1, 8 * c), _iq(2, 8 * c)
    jst, _ = jch.pfb_channelize_step(jch.pfb_stream_init(c, dtype=jnp.float64),
                                     _jax(a), c, jnp.asarray(taps))
    st = pfb_state_from_numpy(pfb_state_to_numpy(jst), dtype=torch.float64)
    assert isinstance(st, PfbState) and st.tail_re.shape == (7 * c,)
    st, y = pfb_channelize_step(st, _port(b), c, taps)
    jst, jy = jch.pfb_channelize_step(jst, _jax(b), c, jnp.asarray(taps))
    np.testing.assert_allclose(y.to_numpy_complex(), _cnp(jy), rtol=0, atol=F64_TOL)
    np.testing.assert_array_equal(pfb_state_to_numpy(st).tail_im, np.asarray(jst.tail_im))

    jsf, _ = jch.pfb_channelize_frames_step(
        jch.pfb_frames_stream_init(c, dtype=jnp.float64), _jax(a.reshape(8, c)), c,
        jnp.asarray(taps))
    sf = pfb_frames_state_from_numpy(pfb_frames_state_to_numpy(jsf), dtype=torch.float64)
    assert isinstance(sf, PfbFramesState) and sf.tail_re.shape == (7, c)
    sf, yf = pfb_channelize_frames_step(sf, _port(b.reshape(8, c)), c, taps)
    jsf, jyf = jch.pfb_channelize_frames_step(jsf, _jax(b.reshape(8, c)), c,
                                              jnp.asarray(taps))
    np.testing.assert_allclose(yf.to_numpy_complex(), _cnp(jyf), rtol=0, atol=F64_TOL)


def test_tone_lands_in_its_channel():
    c, m = 128, 64
    for k in (0, 3, 77, 127):
        x = np.exp(2j * np.pi * (k / c) * np.arange(c * m))
        got = pfb_channelize(_port(x), c)
        power = np.abs(got.to_numpy_complex()) ** 2
        mean_power = power[8:].mean(axis=0)
        assert int(np.argmax(mean_power)) == k
        assert mean_power.sum() - mean_power[k] < 1e-3 * mean_power[k]


def test_channelizer_fixture_goldens():
    """tests/fixtures/dsp/channelizer.json.gz, as tests/test_dsp_fixtures.py
    runs it."""
    cases = load_json(os.path.join(fixtures_dir(), "dsp", "channelizer.json"))["cases"]
    assert cases
    for c in cases:
        iq = ComplexArray(torch.tensor(c["inputRe"], dtype=torch.float64),
                          torch.tensor(c["inputIm"], dtype=torch.float64))
        y = pfb_channelize(iq, c["channels"], np.asarray(c["taps"]), c["tapsPerBranch"])
        assert_snr(np.asarray(c["outputRe"]), y.real.numpy(), 120, c["name"] + " re")
        assert_snr(np.asarray(c["outputIm"]), y.imag.numpy(), 120, c["name"] + " im")


# ── errors and the route rule ────────────────────────────────────────


def test_pfb_errors_match_jax():
    bad_len = np.ones(100) + 0j
    _raises_like(lambda: jch.pfb_channelize(_jax(bad_len), 16),
                 lambda: pch.pfb_channelize(_port(bad_len), 16))
    for shape in ((8, 24), (64,)):
        z = np.ones(shape) + 0j
        _raises_like(lambda: jch.pfb_channelize_frames(_jax(z), 16),
                     lambda: pch.pfb_channelize_frames(_port(z), 16))
    chunk = np.ones((4, 24)) + 0j
    _raises_like(lambda: jch.pfb_channelize_frames_step(
                     jch.pfb_frames_stream_init(16), _jax(chunk), 16),
                 lambda: pch.pfb_channelize_frames_step(
                     pch.pfb_frames_stream_init(16), _port(chunk), 16))
    x = np.zeros(1024) + 0j
    for c, taps in ((64, np.ones(64)), (96, np.ones(96 * 3))):
        _raises_like(lambda: pfb_channelize_pallas(_jax(x, jnp.float32), jnp.asarray(taps),
                                                   c, interpret=True),
                     lambda: pfb_channelize_cuda(_port(x, torch.float32), taps, c))
    _raises_like(lambda: pfb_channelize_pallas(_jax(x[:1000], jnp.float32),
                                               jnp.ones(1024), 256, interpret=True),
                 lambda: pfb_channelize_cuda(_port(x[:1000], torch.float32),
                                             np.ones(1024), 256))


def test_pfb_route_rule():
    """K6 takes CUDA float32 streams with a power-of-two C in 128..16384
    under impl "auto" or "cuda"; everything else runs the branch filter and
    ops.dispatch."""
    rule = pch._use_kernel
    f32 = torch.float32
    assert rule("cuda", f32, 128) and rule("cuda", f32, 256) and rule("cuda", f32, 16384)
    assert not rule("cuda", f32, 64) and not rule("cuda", f32, 96)
    assert not rule("cuda", f32, 32768)
    assert not rule("cuda", torch.float64, 256) and not rule("cpu", f32, 256)
    dispatch.set_fft_impl("stockham")
    try:
        assert not rule("cuda", f32, 256)
    finally:
        dispatch.set_fft_impl("auto")


# ── float32: the plain version of K6 against the Pallas kernel ───────


def test_pfb_plain_matches_pallas_interpret():
    """pfb_channelize_frames_pallas in interpret mode at C = 128, M = 16,
    against the port's K6 wrapper on the CPU (its plain version)."""
    c, m = 128, 16
    z = _iq(128, (m, c)).astype(np.complex64)
    taps = pfb_taps(c, 8)
    ref = pfb_channelize_frames_pallas(_jax(z, jnp.float32),
                                       jnp.asarray(taps, jnp.float32), c,
                                       interpret=True, precision="highest")
    got = pfb_channelize_frames_cuda(_port(z, torch.float32), taps, c)
    assert got.real.dtype == torch.float32 and got.real.shape == (m, c)
    want = _cnp(ref)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.to_numpy_complex(), want, rtol=0,
                               atol=F32_RTOL * scale)


@pytest.mark.parametrize("c", [128, 256])
def test_pfb_plain_matches_jax_f32_route(c):
    z = _iq(c + 7, (2, 12 * c)).astype(np.complex64)
    taps = pfb_taps(c, 8)
    ref = _cnp(jch.pfb_channelize(_jax(z, jnp.float32), c))
    hp, _ = pfb_tap_table(taps, c)
    fr = _port(z.reshape(2, 12, c), torch.float32)
    re, im = pfb_channelize_plain(fr.real, fr.imag, hp.float())
    got = re.numpy() + 1j * im.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_RTOL * np.abs(ref).max())
    flat = pfb_channelize(_port(z, torch.float32), c)
    np.testing.assert_allclose(flat.to_numpy_complex(), ref, rtol=0,
                               atol=F32_RTOL * np.abs(ref).max())
