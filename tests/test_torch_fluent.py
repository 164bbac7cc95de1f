"""``math``, ``fluent`` and ``xform.FluentFFT`` of the port against the JAX
twins: the same float64 inputs through both to 1e-10, the same typestate
after every op, the same error types, tags and messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu.fluent as jfluent
import pragma_dsp_tpu.math as jmath
import pragma_dsp_tpu_torch.fluent as pfluent
import pragma_dsp_tpu_torch.math as pmath
from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.xform import FluentFFT as JFluentFFT
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.fluent import (NonZero, NotInvertibleError, as_non_zero,
                                         assert_non_zero, chain)
from pragma_dsp_tpu_torch.xform import FluentFFT
from pragma_dsp_tpu_torch import set_default_device

RNG = np.random.default_rng(3)
TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _z(shape=(2, 16)):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


def _p(z):
    return ComplexArray(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()))


def _j(z):
    return JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def _cplx(c):
    return np.asarray(c.real) + 1j * np.asarray(c.imag)


# ── math ─────────────────────────────────────────────────────────────


BINARY = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "mul": lambda a, b: a * b, "div": lambda a, b: a / b}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_math_binary_ops_match_jax_and_numpy(name):
    a, b = _z(), _z()
    got = _cplx(getattr(pmath, name)(_p(a), _p(b)))
    want = _cplx(getattr(jmath, name)(_j(a), _j(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, BINARY[name](a, b), rtol=0, atol=TOL)


@pytest.mark.parametrize("name,args,oracle", [
    ("scale", (2.5,), lambda a: 2.5 * a),
    ("mul_scalar", (0.5, -1.5), lambda a: a * (0.5 - 1.5j)),
    ("div_scalar", (0.5, -1.5), lambda a: a / (0.5 - 1.5j)),
    ("conj", (), np.conj)])
def test_math_scalar_ops_match_jax_and_numpy(name, args, oracle):
    a = _z()
    got = _cplx(getattr(pmath, name)(_p(a), *args))
    want = _cplx(getattr(jmath, name)(_j(a), *args))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, oracle(a), rtol=0, atol=TOL)


def test_math_projections_copy_zero():
    a = _z((3, 8))
    np.testing.assert_allclose(pmath.mag(_p(a)).numpy(), np.asarray(jmath.mag(_j(a))),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(pmath.mag(_p(a)).numpy(), np.abs(a), rtol=0, atol=TOL)
    np.testing.assert_allclose(pmath.arg(_p(a)).numpy(), np.asarray(jmath.arg(_j(a))),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(pmath.arg(_p(a)).numpy(), np.angle(a), rtol=0, atol=TOL)
    src = _p(a)
    dup = pmath.copy(src)
    dup.real[0, 0] = 99.0                       # tensors are mutable: a real copy
    assert float(src.real[0, 0]) == a.real[0, 0]
    z = pmath.zero(src)
    assert z.real.shape == (3, 8) and z.real.dtype == torch.float64
    assert not z.real.any() and not z.imag.any()
    assert z.real.data_ptr() != z.imag.data_ptr()
    assert sorted(pmath.__all__) == sorted(jmath.__all__)


def test_math_keeps_dtype_and_broadcasts():
    a = _z((2, 3, 8)).astype(np.complex64)
    b = _z((8,)).astype(np.complex64)
    out = pmath.mul(_p(a), _p(b))
    assert out.real.dtype == torch.float32 and out.real.shape == (2, 3, 8)
    np.testing.assert_allclose(_cplx(out), a * b, rtol=0, atol=1e-5)


# ── NonZero and the typestate ────────────────────────────────────────


def test_non_zero_brand():
    s = assert_non_zero(2.0)
    assert isinstance(s, NonZero) and float(s) == 2.0
    with pytest.raises(ValueError) as err:
        assert_non_zero(0.0)
    with pytest.raises(ValueError) as jerr:
        jfluent.assert_non_zero(0.0)
    assert str(err.value) == str(jerr.value)
    assert as_non_zero(0.0) is None
    assert float(as_non_zero(-3.0)) == -3.0
    assert sorted(pfluent.__all__) == sorted(jfluent.__all__)


OPS = [("scale_nz", lambda c, m, o: c.scale(m.assert_non_zero(2.0))),
       ("scale", lambda c, m, o: c.scale(3.0)),
       ("mul", lambda c, m, o: c.mul(o)),
       ("mul_scalar_nz", lambda c, m, o: c.mul_scalar(m.assert_non_zero(2.0), 0.0)),
       ("mul_scalar", lambda c, m, o: c.mul_scalar(2.0, 1.0)),
       ("div", lambda c, m, o: c.div(o)),
       ("div_scalar_nz", lambda c, m, o: c.div_scalar(0.0, m.assert_non_zero(4.0))),
       ("div_scalar", lambda c, m, o: c.div_scalar(2.0, 1.0)),
       ("conj", lambda c, m, o: c.conj()),
       ("add", lambda c, m, o: c.add(o)),
       ("sub", lambda c, m, o: c.sub(o)),
       ("clone", lambda c, m, o: c.clone())]


@pytest.mark.parametrize("name,op", OPS, ids=[n for n, _ in OPS])
def test_chain_op_matches_jax_state_and_data(name, op):
    x = RNG.standard_normal(64)
    other = _z((64,))
    pc = op(FluentFFT(64).forward(torch.from_numpy(x)), pfluent, _p(other))
    jc = op(JFluentFFT(64).forward(jnp.asarray(x)), jfluent, _j(other))
    assert (pc.state.kind, pc.state.has_fft, pc.state.invert, pc.state.length) == (
        jc.state.kind, jc.state.has_fft, jc.state.invert, jc.state.length)
    assert len(pc) == pc.length == 64
    np.testing.assert_allclose(_cplx(pc.unwrap()), _cplx(jc.unwrap()), rtol=0,
                               atol=TOL * 64)
    pres, jres = pc.inverse_checked(), jc.inverse_checked()
    assert pres.ok and jres.ok
    np.testing.assert_allclose(_cplx(pres.value), _cplx(jres.value), rtol=0, atol=TOL)
    if jc.state.invert == "yes":
        np.testing.assert_allclose(_cplx(pc.inverse()), _cplx(jc.inverse()), rtol=0,
                                   atol=TOL)
    else:
        with pytest.raises(NotInvertibleError) as err:
            pc.inverse()
        with pytest.raises(jfluent.NotInvertibleError) as jerr:
            jc.inverse()
        assert str(err.value) == str(jerr.value)
        assert err.value.error.tag == jerr.value.error.tag == "NotInvertible"


def test_forward_scale_inverse_roundtrip():
    x = RNG.standard_normal(64)
    f = FluentFFT(64)
    out = (f.forward(torch.from_numpy(x)).scale(assert_non_zero(2.0))
           .scale(assert_non_zero(0.5)).inverse())
    np.testing.assert_allclose(out.real.numpy(), x, rtol=0, atol=TOL)
    np.testing.assert_allclose(out.imag.numpy(), 0, rtol=0, atol=TOL)
    c = f.forward(torch.from_numpy(x)).conj().conj()
    assert c.state.invert == "yes"
    np.testing.assert_allclose(c.inverse().real.numpy(), x, rtol=0, atol=TOL)


def test_no_is_sticky_and_clone_is_independent():
    x = torch.from_numpy(RNG.standard_normal(16))
    c = FluentFFT(16).forward(x)
    c2 = c.clone().scale(5.0)
    assert c.state.invert == "yes" and c2.state.invert == "maybe"
    c2.data.real[0] = 123.0
    assert float(c.data.real[0]) != 123.0
    no = pfluent.ComplexChain(c.data, c._inverse_fn,
                              pfluent.ChainState(has_fft=True, invert="no"))
    assert no.scale(2.0).state.invert == "no"
    assert no.conj().state.invert == "no"


def test_chain_without_fft_has_no_inverse():
    z = _z((8,))
    pc, jc = chain(_p(z)), jfluent.chain(_j(z))
    with pytest.raises(NotInvertibleError) as err:
        pc.inverse()
    with pytest.raises(jfluent.NotInvertibleError) as jerr:
        jc.inverse()
    assert str(err.value) == str(jerr.value)
    res = pc.inverse_checked()
    assert not res.ok and res.error.tag == "NoFftContext"
    assert res.error == pfluent.InverseError(jc.inverse_checked().error.tag,
                                             jc.inverse_checked().error.reason)
    np.testing.assert_allclose(pc.mag().numpy(), np.abs(z), rtol=1e-12)
    np.testing.assert_allclose(pc.arg().numpy(), np.angle(z), rtol=1e-12)


@pytest.mark.parametrize("state,tag", [
    (dict(has_fft=True, kind="real"), "NotInvertible"),
    (dict(has_fft=True, length="changed"), "LengthMismatch"),
    (dict(has_fft=False), "NoFftContext")])
def test_inverse_errors_match_jax(state, tag):
    z = _z((8,))
    pc = pfluent.ComplexChain(_p(z), lambda d: d, pfluent.ChainState(**state))
    jc = jfluent.ComplexChain(_j(z), lambda d: d, jfluent.ChainState(**state))
    with pytest.raises(NotInvertibleError) as err:
        pc.inverse()
    with pytest.raises(jfluent.NotInvertibleError) as jerr:
        jc.inverse()
    assert err.value.error.tag == jerr.value.error.tag == tag
    assert str(err.value) == str(jerr.value)


def test_inverse_checked_wraps_a_failing_inverse():
    def boom(_):
        raise RuntimeError("no inverse today")

    pc = pfluent.ComplexChain(_p(_z((8,))), boom, pfluent.ChainState(has_fft=True))
    res = pc.inverse_checked()
    assert not res.ok and res.error.tag == "NotInvertible"
    assert res.error.reason == "no inverse today"


# ── FluentFFT ────────────────────────────────────────────────────────


def test_freq_domain_convolution():
    n = 32
    x, h = RNG.standard_normal(n), RNG.standard_normal(n)
    f = FluentFFT(n)
    H = f.forward(torch.from_numpy(h)).unwrap()
    out = f.forward(torch.from_numpy(x)).mul(H).inverse_checked()
    assert out.ok
    ref = np.real(np.fft.ifft(np.fft.fft(x) * np.fft.fft(h)))
    np.testing.assert_allclose(out.value.real.numpy(), ref, rtol=0, atol=1e-9)


def test_fluent_fft_forward_complex_and_size_rule():
    z = _z((64,))
    f = FluentFFT(64)
    assert f.size == 64
    c = f.forward_complex(_p(z))
    np.testing.assert_allclose(_cplx(c.unwrap()), np.fft.fft(z), rtol=0, atol=TOL * 64)
    np.testing.assert_allclose(_cplx(c.inverse()), z, rtol=0, atol=TOL)
    jc = JFluentFFT(64).forward_complex(_j(z))
    np.testing.assert_allclose(_cplx(c.unwrap()), _cplx(jc.unwrap()), rtol=0,
                               atol=TOL * 64)
    with pytest.raises(ValueError) as err:
        FluentFFT(48)
    with pytest.raises(ValueError) as jerr:
        JFluentFFT(48)
    assert str(err.value) == str(jerr.value)


def test_fluent_chain_at_a_large_size():
    """2^16 points in float64: the size from which a CUDA float32 chain
    rides the two-kernel route; on the CPU the same chain, Stockham."""
    n = 1 << 16
    x = RNG.standard_normal(n)
    out = (FluentFFT(n).forward(torch.from_numpy(x)).scale(assert_non_zero(4.0))
           .conj().conj().scale(assert_non_zero(0.25)).inverse())
    np.testing.assert_allclose(out.real.numpy(), x, rtol=0, atol=1e-9)
