"""The port's core layer against the JAX package: split-complex contracts
(the round-5 input rules of tests/test_complex_input.py that apply to
this slice), the Stockham FFT in float64 and its twiddle tables, the
Radix2Fft plan, and numpy interop."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import complex as jcomplex
from pragma_dsp_tpu_torch import ops as tops
from pragma_dsp_tpu_torch.core import (
    ComplexArray, Radix2Fft, as_complex_array, create_complex_array,
    ensure_float, fft, fft_axis0, ifft, is_power_of_two, next_power_of_two)
from pragma_dsp_tpu_torch.utils import complex_from_numpy, to_numpy
from pragma_dsp_tpu_torch import set_default_device

# The packages export a function ``fft`` that shadows the submodule name.
jfft = importlib.import_module("pragma_dsp_tpu.core.fft")
tfft = importlib.import_module("pragma_dsp_tpu_torch.core.fft")

RNG = np.random.default_rng(77)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _complex_signal(shape, dtype=np.complex128):
    z = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
    return z.astype(dtype)


# ---------------------------------------------------------- ComplexArray


def test_complex_array_rejects_complex_planes():
    with pytest.raises(TypeError, match="complex dtype"):
        ComplexArray(torch.tensor([1 + 1j]), torch.zeros(1))
    with pytest.raises(TypeError, match="complex dtype"):
        ComplexArray(torch.zeros(1), torch.tensor([1j]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool])
def test_complex_array_rejects_int_and_bool_planes(dtype):
    with pytest.raises(TypeError, match="non-float"):
        ComplexArray(torch.zeros(4, dtype=dtype), torch.zeros(4))


def test_complex_array_rejects_mismatched_shapes():
    with pytest.raises(TypeError, match="shapes differ"):
        ComplexArray(torch.zeros(4), torch.zeros(8))


def test_complex_array_checks_only_tensors():
    # Non-tensor leaves (numpy integer scalars, placeholders) are not
    # checked: the reference's pytree-rebuild fault has no analogue here.
    ca = ComplexArray(np.int64(1), object())
    assert isinstance(ca, ComplexArray)


# ------------------------------------------------------ as_complex_array


@pytest.mark.parametrize("cdtype,rdtype", [(np.complex64, torch.float32),
                                           (np.complex128, torch.float64)])
def test_as_complex_array_splits_torch_complex(cdtype, rdtype):
    z = _complex_signal(16, cdtype)
    ca = as_complex_array(torch.from_numpy(z))
    ref = jcomplex.as_complex_array(jnp.asarray(z))
    assert ca.dtype == rdtype
    np.testing.assert_array_equal(ca.real.numpy(), np.asarray(ref.real))
    np.testing.assert_array_equal(ca.imag.numpy(), np.asarray(ref.imag))


def test_as_complex_array_dtype_override_on_complex():
    ca = as_complex_array(torch.from_numpy(_complex_signal(8)), dtype=torch.float32)
    assert ca.dtype == torch.float32


def test_as_complex_array_numpy_and_python_complex():
    z = _complex_signal(8)
    np.testing.assert_array_equal(as_complex_array(z).to_numpy_complex(), z)
    ca = as_complex_array([1 + 2j, 3 - 4j])
    ref = jcomplex.as_complex_array([1 + 2j, 3 - 4j])
    np.testing.assert_array_equal(ca.real.numpy(), np.asarray(ref.real))
    np.testing.assert_array_equal(ca.imag.numpy(), np.asarray(ref.imag))


def test_as_complex_array_coerces_int_and_bool():
    for x in (torch.arange(4), np.asarray([True, False]),
              (np.arange(4), np.arange(4))):
        ca = as_complex_array(x)
        assert ca.dtype.is_floating_point
        assert ca.imag.dtype.is_floating_point


def test_as_complex_array_tuple_complex_planes_raise():
    with pytest.raises(TypeError, match="complex dtype"):
        as_complex_array((np.array([1 + 2j]), np.array([3 + 4j])))


def test_as_complex_array_rejects_non_float_dtype_request():
    with pytest.raises(TypeError, match="must be floating"):
        as_complex_array(np.arange(4.0), dtype=torch.int32)


def test_ensure_float():
    assert ensure_float(torch.arange(3)).dtype == torch.get_default_dtype()
    assert ensure_float(np.asarray([True])).dtype == torch.get_default_dtype()
    assert ensure_float(torch.zeros(2, dtype=torch.float64)).dtype == torch.float64
    assert ensure_float(torch.zeros(2, dtype=torch.complex64)).dtype == torch.complex64


def test_power_of_two_helpers_match_jax():
    for n in range(0, 70):
        assert is_power_of_two(n) == jcomplex.is_power_of_two(n)
        assert next_power_of_two(n) == jcomplex.next_power_of_two(n)


def test_create_complex_array():
    ca = create_complex_array((2, 3), 1.5, dtype=torch.float64)
    assert ca.shape == (2, 3) and ca.dtype == torch.float64
    assert float(ca.real.sum()) == 9.0 and float(ca.imag.sum()) == 9.0
    assert ca.real.data_ptr() != ca.imag.data_ptr()
    assert len(create_complex_array(8)) == 8


# ------------------------------------------------------------- Stockham


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 8, 256, 1024])
def test_stockham_matches_jax_f64(n, inverse):
    z = _complex_signal((3, n))
    if inverse:
        got = ifft(complex_from_numpy(z)).to_numpy_complex()
        ref = jfft.ifft(jcomplex.as_complex_array(z)).to_numpy_complex()
        want = np.fft.ifft(z, axis=-1)
    else:
        got = fft(complex_from_numpy(z)).to_numpy_complex()
        ref = jfft.fft(jcomplex.as_complex_array(z)).to_numpy_complex()
        want = np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_stockham_over_axis0_matches_jax():
    z = _complex_signal((64, 3, 2))
    got = fft(complex_from_numpy(z), axis=0).to_numpy_complex()
    ref = jfft.fft(jcomplex.as_complex_array(z), axis=0).to_numpy_complex()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    re, im = fft_axis0(torch.from_numpy(z.real[:, 0]), torch.from_numpy(z.imag[:, 0]))
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), ref[:, 0],
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("n", [2, 64, 1024])
def test_twiddles_bit_equal_to_jax(n, sign):
    for tdt, ndt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        c, s = tfft._twiddles(n, sign, tdt)
        jc, js = jfft._twiddles(n, sign, ndt)
        np.testing.assert_array_equal(c.numpy(), jc)
        np.testing.assert_array_equal(s.numpy(), js)


def test_stockham_rejects_non_pow2():
    with pytest.raises(ValueError, match="power of two"):
        fft(torch.zeros(12))


def test_fft_torch_complex_matches_numpy():
    z = np.asarray([1 + 2j, 3 - 4j, 1j, 2 + 0j])
    got = fft(torch.from_numpy(z)).to_numpy_complex()
    np.testing.assert_allclose(got, np.fft.fft(z), atol=1e-12)


def test_fft_integer_input_matches_numpy():
    got = fft(torch.arange(8)).to_numpy_complex()
    np.testing.assert_allclose(got, np.fft.fft(np.arange(8)), atol=1e-5)


@pytest.mark.parametrize("n", [64, 1024])
def test_fft_ifft_complex128_roundtrip(n):
    z = _complex_signal(n)
    spec = tops.fft(torch.from_numpy(z))
    np.testing.assert_allclose(spec.to_numpy_complex(), np.fft.fft(z), atol=1e-9)
    rt = tops.ifft(spec).to_numpy_complex()
    np.testing.assert_allclose(rt, z, atol=1e-10)


# ------------------------------------------------------------ Radix2Fft


def test_radix2fft_plan_matches_jax():
    n = 256
    z = _complex_signal((2, n))
    plan = Radix2Fft(n)
    got = plan.forward_complex(complex_from_numpy(z)).to_numpy_complex()
    ref = jfft.Radix2Fft(n).forward_complex(
        jcomplex.as_complex_array(z)).to_numpy_complex()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    real = plan.forward(torch.from_numpy(z.real)).to_numpy_complex()
    np.testing.assert_allclose(real, np.fft.fft(z.real, axis=-1), atol=1e-10)
    back = plan.inverse(plan.forward(complex_from_numpy(z))).to_numpy_complex()
    np.testing.assert_allclose(back, z, atol=1e-12)
    with pytest.raises(ValueError, match="!= size"):
        plan.forward(torch.zeros(128))
    with pytest.raises(ValueError, match="power of two"):
        Radix2Fft(100)


# -------------------------------------------------------------- interop


def test_interop_roundtrip():
    z = _complex_signal((2, 5))
    ca = complex_from_numpy(z, dtype=torch.float64)
    np.testing.assert_array_equal(to_numpy(ca), z)
    np.testing.assert_array_equal(to_numpy(ca.real), z.real)
    bf = ComplexArray(torch.ones(3, dtype=torch.bfloat16),
                      torch.zeros(3, dtype=torch.bfloat16))
    np.testing.assert_array_equal(to_numpy(bf), np.ones(3))
