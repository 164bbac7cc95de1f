"""``ops.rfft`` / ``ops.irfft`` of the port against the JAX twins and numpy:
the same float64 inputs through both packages to 1e-10, the half-size
twiddles bit-equal, the routes through ``ops.dispatch`` (``impl=``), int
input, other axes, and the same errors."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import irfft, rfft
from pragma_dsp_tpu_torch import set_default_device

jrfft = importlib.import_module("pragma_dsp_tpu.ops.rfft")
prfft = importlib.import_module("pragma_dsp_tpu_torch.ops.rfft")

RNG = np.random.default_rng(60)
F64_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _cplx(c):
    return np.asarray(c.real) + 1j * np.asarray(c.imag)


@pytest.mark.parametrize("n", [2, 8, 64, 256, 1024, 1 << 15])
def test_rfft_matches_jax_and_numpy(n):
    x = RNG.standard_normal((3, n))
    got = _cplx(rfft(torch.from_numpy(x)))
    ref = np.fft.rfft(x, axis=-1)
    want = _cplx(jrfft.rfft(jnp.asarray(x)))
    scale = max(1.0, np.abs(ref).max())
    assert got.shape == ref.shape == (3, n // 2 + 1)
    assert np.abs(got - ref).max() < F64_TOL * scale
    assert np.abs(got - want).max() < F64_TOL * scale


@pytest.mark.parametrize("n", [2, 8, 256, 1024])
def test_irfft_roundtrip_and_jax(n):
    x = RNG.standard_normal((2, n))
    spec = rfft(torch.from_numpy(x))
    back = irfft(spec, n)
    assert back.shape == (2, n) and back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=F64_TOL)
    jback = np.asarray(jrfft.irfft(jrfft.rfft(jnp.asarray(x)), n))
    np.testing.assert_allclose(back.numpy(), jback, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(irfft(spec).numpy(), x, rtol=0, atol=F64_TOL)


def test_irfft_of_arbitrary_spectrum_matches_numpy():
    """DC and Nyquist imaginary parts are dropped, as numpy drops them."""
    X = RNG.standard_normal((2, 129)) + 1j * RNG.standard_normal((2, 129))
    got = irfft(ComplexArray(torch.from_numpy(X.real.copy()),
                             torch.from_numpy(X.imag.copy())), 256)
    np.testing.assert_allclose(got.numpy(), np.fft.irfft(X, 256, axis=-1),
                               rtol=0, atol=F64_TOL)
    want = np.asarray(jrfft.irfft(JComplexArray(jnp.asarray(X.real),
                                                jnp.asarray(X.imag)), 256))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_rfft_other_axes(axis):
    x = RNG.standard_normal((64, 32, 16))
    got = _cplx(rfft(torch.from_numpy(x), axis=axis))
    ref = np.fft.rfft(x, axis=axis)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    back = irfft(rfft(torch.from_numpy(x), axis=axis), axis=axis)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(
        got, _cplx(jrfft.rfft(jnp.asarray(x), axis=axis)), rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("impl", ["stockham", "cuda", "fourstep"])
def test_rfft_impl_routes_float32(impl):
    """float32 through each route's CPU version: >= 120 dB against numpy."""
    x = RNG.standard_normal((2, 1024)).astype(np.float32)
    got = rfft(torch.from_numpy(x), impl=impl)
    assert got.real.dtype == torch.float32
    ref = np.fft.rfft(x.astype(np.float64))
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real.numpy(), got.imag.numpy()])) > 120
    back = irfft(got, impl=impl)
    assert snr_db(x, back.numpy()) > 120


def test_rfft_through_the_big_route():
    """n = 2^17: the half-size transform is 2^16 points, the smallest the
    two-kernel route takes."""
    n = 1 << 17
    x = RNG.standard_normal(n).astype(np.float32)
    got = rfft(torch.from_numpy(x), impl="big")
    ref = np.fft.rfft(x.astype(np.float64))
    assert got.real.shape == (n // 2 + 1,)
    assert snr_db(np.stack([ref.real, ref.imag]),
                  np.stack([got.real.numpy(), got.imag.numpy()])) > 115
    assert snr_db(x, irfft(got, impl="big").numpy()) > 115
    with pytest.raises(ValueError, match="impl='big' supports"):
        rfft(torch.zeros(1024), impl="big")


def test_rfft_int_input_is_coerced():
    x = RNG.integers(-8, 8, size=(2, 64)).astype(np.int32)
    got = rfft(torch.from_numpy(x))
    assert got.real.dtype == torch.float32        # torch's default float
    np.testing.assert_allclose(_cplx(got), np.fft.rfft(x, axis=-1), rtol=0, atol=1e-4)
    want = _cplx(jrfft.rfft(jnp.asarray(x)))
    np.testing.assert_allclose(_cplx(got), want, rtol=0, atol=1e-4)


def test_rfft_leaves_its_input_alone():
    x = torch.from_numpy(RNG.standard_normal((2, 256)).astype(np.float32))
    keep = x.clone()
    spec = rfft(x)
    sr, si = spec.real.clone(), spec.imag.clone()
    irfft(spec)
    assert torch.equal(x, keep) and torch.equal(spec.real, sr) and torch.equal(spec.imag, si)


@pytest.mark.parametrize("n", [12, 1, 0])
def test_rfft_rejects_bad_sizes_like_jax(n):
    with pytest.raises(ValueError) as err:
        rfft(torch.zeros(3, n))
    with pytest.raises(ValueError) as jerr:
        jrfft.rfft(jnp.zeros((3, n)))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("n", [2, 256, 1 << 16])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_half_twiddles_bit_equal_to_jax(n, sign):
    for a, b in zip(prfft._half_twiddles(n, sign), jrfft._half_twiddles(n, sign)):
        assert a.dtype == np.float64 and a.shape == (n // 2 + 1,)
        np.testing.assert_array_equal(a, b)
