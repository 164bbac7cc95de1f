"""The port's polyphase resampler (ops.polyphase) against the JAX package
on the same seeded numpy inputs.

* float64: upfirdn at tests/test_resampler.py's ratios (and up = down = 1,
  the convolution route), complex input in every form, taps given as a
  tensor, resample_poly, decimate, interpolate, the cascade, and the
  streaming steps of upfirdn and of the cascade, to 1e-10;
* the banded matrix built in numpy against the JAX package's loop, at
  every grouping, and every product of the banded form on operands that
  BLAS reads in place (no frame copied);
* float32 against the JAX float32 results at tests/test_streaming_scan.py's
  bound (1e-6);
* the committed fixture tests/fixtures/dsp/resampler.json.gz (>= 130 dB);
* the same exception type and message for the same bad call;
* the upfirdn_step guard: where len(taps) <= up - down the port raises and
  the JAX stream is misaligned against scipy; everywhere else both equal
  scipy's batch prefix;
* the interop round trip of UpfirdnState and CascadeState;
* the two packages' ``ops.__all__``.

The products run on CUDA in chip_smoke.py phase 19 and
tests/test_torch_cuda.py.
"""

import importlib
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import assert_snr, fixtures_dir, load_json
from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (CascadeState, UpfirdnState, cascade_chunk_quantum,
                                      decimate, interpolate, resample_cascade_step,
                                      resample_cascade_stream_init, resample_poly,
                                      resample_poly_cascade, resampler_taps, upfirdn,
                                      upfirdn_step, upfirdn_stream_init)
from pragma_dsp_tpu_torch.utils import (cascade_state_from_numpy, cascade_state_to_numpy,
                                        upfirdn_state_from_numpy, upfirdn_state_to_numpy)

jpoly = importlib.import_module("pragma_dsp_tpu.ops.polyphase")
ppoly = importlib.import_module("pragma_dsp_tpu_torch.ops.polyphase")
jops = importlib.import_module("pragma_dsp_tpu.ops")
pops = importlib.import_module("pragma_dsp_tpu_torch.ops")

F64_TOL = 1e-10
F32_TOL = 1e-6           # tests/test_streaming_scan.py:51
RATIOS = [(1, 4), (4, 1), (3, 2), (147, 160)]    # tests/test_resampler.py:26
CASCADE = [(3, 4), (7, 8), (7, 5)]


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _raises_like(jax_call, port_call):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as jerr:
        jax_call()
    with pytest.raises(type(jerr.value)) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


def _jax_band_matrix(hh, up, down, cyc):
    """The JAX package's loop (``ops/polyphase.py:126-133``) verbatim."""
    k = hh.shape[0]
    q_taps = -(-k // up)
    halo = q_taps - 1
    upc = up * cyc
    mat = np.zeros((down * cyc + halo, upc))
    for r in range(upc):
        p = (r * down) % up
        c = (r * down) // up
        for q in range(q_taps):
            tap = p + up * q
            if tap < k:
                mat[c - q + halo, r] = hh[tap]
    return mat


# ── constants ────────────────────────────────────────────────────────


@pytest.mark.parametrize("up,down,num_taps", [(147, 160, 127), (3, 2, 127),
                                              (1, 5, 31), (7, 8, 65)])
def test_resampler_taps_bit_equal(up, down, num_taps):
    got = resampler_taps(up, down, num_taps)
    assert got.dtype == np.float64
    assert np.array_equal(got, jpoly.resampler_taps(up, down, num_taps))


@pytest.mark.parametrize("up,down,k", [(1, 10, 127), (147, 160, 127), (147, 160, 1177),
                                       (3, 2, 127), (5, 2, 3), (4, 1, 9), (1, 1, 5)])
@pytest.mark.parametrize("cyc", [1, 3, 128])
def test_band_matrix_bit_equal_to_the_jax_loop(up, down, k, cyc):
    hh = np.random.default_rng(k).standard_normal(k)
    assert np.array_equal(ppoly.band_matrix(hh, up, down, cyc),
                          _jax_band_matrix(hh, up, down, cyc))


def test_grouping_rule():
    assert ppoly.cycles(147) == 1
    assert ppoly.cycles(1) == -(-ppoly.CYCLE_OUTPUTS // 1)
    for up in (1, 2, 3, 7, 147, 300):
        assert up * ppoly.cycles(up) >= min(ppoly.CYCLE_OUTPUTS, up)
    for up in (1, 2, 3, 4, 5, 6, 7, 9, 31, 32, 147, 300):
        # The frames tile one frame of the JAX grouping, ceil(128/up) cycles,
        # so each lies inside one of its frames.
        tiles = ppoly.subframes(up)
        assert [f for f, _ in tiles] == [sum(c for _, c in tiles[:i]) for i in range(len(tiles))]
        assert sum(c for _, c in tiles) == (-(-128 // up) if len(tiles) > 1 else tiles[0][1])
        assert (-(-128 // up)) % tiles[0][1] == 0 or len(tiles) > 1
        assert max(c for _, c in tiles) == ppoly.cycles(up)
    assert ppoly.subframes(3) == [(0, 11), (11, 11), (22, 11), (33, 10)]
    assert ppoly.subframes(1) == [(0, 32)] and ppoly.subframes(147) == [(0, 1)]


@pytest.mark.parametrize("up,down", [(3, 1), (7, 1), (3, 2), (3, 4), (1, 10), (147, 160)])
def test_banded_products_read_their_operands_in_place(up, down, monkeypatch):
    """Every product of the banded form multiplies a strided view whose
    row stride is at least its width, and writes or adds into such a view
    of the output, so BLAS copies no frame: a window wider than the frame
    stride (interpolation by 3 tiles 53 samples at 43) is split into
    row-shifted terms. The result is scipy's."""
    seen = []

    def held(a, b, out):
        for t in (a, out):
            assert t.stride(1) == 1 and t.stride(0) >= t.shape[1], (t.shape, t.stride())
        seen.append(a.shape[1])

    mm, addmm_ = torch.mm, torch.Tensor.addmm_
    monkeypatch.setattr(torch, "mm", lambda a, b, out: (held(a, b, out), mm(a, b, out=out))[1])
    monkeypatch.setattr(torch.Tensor, "addmm_",
                        lambda self, a, b: (held(a, b, self), addmm_(self, a, b))[1])
    x = np.random.default_rng(up * 1000 + down).standard_normal((2, 700))
    hh = resampler_taps(up, down)
    got = upfirdn(torch.from_numpy(x), hh, up, down).numpy()
    np.testing.assert_allclose(got, np.stack([sps.upfirdn(hh, r, up, down) for r in x]),
                               rtol=0, atol=F64_TOL)
    assert len(seen) >= len(ppoly.subframes(up))


# ── float64 parity ───────────────────────────────────────────────────


@pytest.mark.parametrize("up,down", RATIOS + [(1, 1), (2, 3), (1, 10)])
def test_upfirdn_matches_jax_f64(up, down):
    rng = np.random.default_rng(20 + up + down)
    x = rng.standard_normal((2, 3, 2000))
    h = sps.firwin(127, min(1.0 / up, 1.0 / down) * 0.9)
    got = upfirdn(_t(x), h, up, down)
    ref = np.asarray(jpoly.upfirdn(jnp.asarray(x), jnp.asarray(h), up, down))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.numpy()[1, 2], sps.upfirdn(h, x[1, 2], up, down),
                               rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("form", ["ComplexArray", "numpy", "torch"])
def test_upfirdn_complex_matches_jax_f64(form):
    rng = np.random.default_rng(21)
    z = rng.standard_normal((2, 1000)) + 1j * rng.standard_normal((2, 1000))
    h = sps.firwin(63, 0.2)
    ref = jpoly.upfirdn(JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)), h, 2, 3)
    x = {"ComplexArray": ComplexArray(_t(z.real), _t(z.imag)), "numpy": z,
         "torch": torch.from_numpy(z)}[form]
    got = upfirdn(x, h, 2, 3)
    assert isinstance(got, ComplexArray) and got.real.dtype == torch.float64
    np.testing.assert_allclose(got.real.numpy(), np.asarray(ref.real), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(ref.imag), rtol=0, atol=F64_TOL)


def test_taps_as_a_tensor_and_precision_are_accepted():
    rng = np.random.default_rng(22)
    x = _t(rng.standard_normal((3, 700)))
    h = sps.firwin(63, 0.3)
    want = upfirdn(x, h, 3, 2)
    assert torch.equal(upfirdn(x, torch.from_numpy(h), 3, 2), want)
    assert torch.equal(upfirdn(x, torch.from_numpy(h).float(), 3, 2),
                       upfirdn(x, h.astype(np.float32), 3, 2))
    assert torch.equal(upfirdn(x, list(h), 3, 2, precision="bf16x3"), want)
    assert torch.equal(upfirdn(x, h, 3, 2, precision="highest"), want)


def test_int_input_is_coerced():
    x = np.arange(-50, 50, dtype=np.int32)
    got = upfirdn(x, np.ones(4) / 4, 1, 2)
    assert got.dtype == torch.get_default_dtype()
    np.testing.assert_allclose(got.numpy(), sps.upfirdn(np.ones(4) / 4, x, 1, 2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["resample_poly", "resample_poly_taps", "decimate",
                                   "interpolate", "cascade"])
def test_resamplers_match_jax_f64(entry):
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 4800))
    calls = {
        "resample_poly": lambda m, v: m.resample_poly(v, 147, 160),
        "resample_poly_taps": lambda m, v: m.resample_poly(
            v, 294, 320, taps=m.resampler_taps(147, 160, 8 * 147 + 1)),
        "decimate": lambda m, v: m.decimate(v, 4),
        "interpolate": lambda m, v: m.interpolate(v[..., :500], 4),
        "cascade": lambda m, v: m.resample_poly_cascade(v, CASCADE),
    }
    got = calls[entry](ppoly, _t(x))
    ref = np.asarray(calls[entry](jpoly, jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)


def test_cascade_matches_scipy_chain():
    x = np.random.default_rng(9).standard_normal(4800)
    ref = x
    for up, down in CASCADE:
        ref = sps.upfirdn(resampler_taps(up, down, 8 * max(up, down) + 1), ref, up, down)
    got = resample_poly_cascade(_t(x), CASCADE)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F64_TOL)


def test_cascade_quantum():
    for factors in (CASCADE, [(1, 4)], [(147, 160)], [(2, 3), (5, 4)], [(6, 4)]):
        assert cascade_chunk_quantum(factors) == jpoly.cascade_chunk_quantum(factors)
    assert cascade_chunk_quantum(CASCADE) == 160


# ── streaming ────────────────────────────────────────────────────────


def _stream(mod, x, h, up, down, chunk, dtype, conv, init_kw):
    state = mod.upfirdn_stream_init(h, up, down, x.shape[:-1], dtype, **init_kw)
    outs = []
    for i in range(x.shape[-1] // chunk):
        state, y = mod.upfirdn_step(state, conv(x[..., i * chunk:(i + 1) * chunk]),
                                    h, up, down)
        outs.append(_np(y))
    return state, np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("up,down", [(1, 5), (147, 160), (3, 2), (4, 1), (1, 1)])
def test_upfirdn_step_matches_jax_and_batch_prefix_f64(up, down):
    rng = np.random.default_rng(3)
    h = resampler_taps(up, down, 127)
    x = rng.standard_normal((2, 3200))
    chunk = (down // math.gcd(up, down)) * max(1, 640 // (down // math.gcd(up, down)))
    pst, got = _stream(ppoly, x, h, up, down, chunk, torch.float64, _t, {})
    jst, ref = _stream(jpoly, x, h, up, down, chunk, jnp.float64, jnp.asarray, {})
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(pst.tail.numpy(), np.asarray(jst.tail), rtol=0, atol=0)
    batch = sps.upfirdn(h, x[1], up, down)
    np.testing.assert_allclose(got[1], batch[:got.shape[-1]], rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("up,down", [(1, 5), (147, 160), (3, 2)])
def test_upfirdn_step_f32_matches_jax_batch(up, down):
    """tests/test_streaming_scan.py:35-51 on the port: float32 steps
    against the port's float32 batch prefix, and the batch against the JAX
    float32 batch, at its 1e-6 of the output's scale (|y| reaches 4 at
    up = 3: a step's frames group the products in another order than the
    batch's, as the two packages' products do, each within a few ulp)."""
    rng = np.random.default_rng(3)
    h = resampler_taps(up, down, 127)
    x = rng.standard_normal((2, 3200)).astype(np.float32)
    ref = np.asarray(jpoly.upfirdn(jnp.asarray(x), h, up, down))
    batch = upfirdn(_t(x), h, up, down).numpy()
    chunk = (down // math.gcd(up, down)) * max(1, 640 // (down // math.gcd(up, down)))
    _, got = _stream(ppoly, x, h, up, down, chunk, torch.float32, _t, {})
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, batch[:, :got.shape[-1]], rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(batch, ref, rtol=0, atol=F32_TOL * scale)


def test_cascade_step_matches_jax_f64():
    q = cascade_chunk_quantum(CASCADE)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(q * 4 * 5)
    pst = resample_cascade_stream_init(CASCADE, dtype=torch.float64)
    jst = jpoly.resample_cascade_stream_init(CASCADE, dtype=jnp.float64)
    got, ref = [], []
    for i in range(5):
        ch = x[i * 4 * q:(i + 1) * 4 * q]
        pst, y = resample_cascade_step(pst, _t(ch), CASCADE)
        jst, jy = jpoly.resample_cascade_step(jst, jnp.asarray(ch), CASCADE)
        got.append(y.numpy())
        ref.append(np.asarray(jy))
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert got.shape[0] == len(x) * 147 // 160
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    batch = resample_poly_cascade(_t(x), CASCADE).numpy()
    np.testing.assert_allclose(got, batch[:got.shape[0]], rtol=0, atol=1e-9)
    assert isinstance(pst, CascadeState) and len(pst.stages) == 3


def test_stream_init_device_and_dtype():
    st = upfirdn_stream_init(np.ones(127), 1, 5, (2, 3), torch.float64, device="cpu")
    assert st.tail.shape == (2, 3, 130) and st.tail.dtype == torch.float64
    assert st.tail.shape[-1] == jpoly.upfirdn_stream_init(np.ones(127), 1, 5).tail.shape[-1]
    cs = resample_cascade_stream_init(CASCADE, batch_shape=(2,))
    assert all(s.tail.device.type == "cpu" for s in cs.stages)


# ── the upfirdn_step guard (a decided divergence) ────────────────────


def _guard_cases():
    for up in (1, 2, 5):
        for down in (1, 2, 5):
            for k in (1, 2, 3, 4, 6):
                yield up, down, k


@pytest.mark.parametrize("up,down,k", list(_guard_cases()))
def test_upfirdn_step_guard(up, down, k):
    """Chunks of 4*down/gcd over 240 samples. Where len(taps) <= up - down
    the port raises ValueError and the JAX stream is misaligned against
    scipy's batch prefix; everywhere else both match it."""
    rng = np.random.default_rng(100 * up + 10 * down + k)
    h = rng.standard_normal(k)
    x = rng.standard_normal(240)
    chunk = 4 * down // math.gcd(up, down)
    batch = sps.upfirdn(h, x, up, down)
    _, ref = _stream(jpoly, x, h, up, down, chunk, jnp.float64, jnp.asarray, {})
    n = min(ref.shape[-1], batch.shape[-1])
    jax_err = float(np.abs(ref[:n] - batch[:n]).max())
    if k <= up - down:
        assert jax_err > 0.1, (up, down, k, jax_err)
        with pytest.raises(ValueError, match="len\\(taps\\) > up - down"):
            _stream(ppoly, x, h, up, down, chunk, torch.float64, _t, {})
        return
    assert jax_err < 1e-9
    _, got = _stream(ppoly, x, h, up, down, chunk, torch.float64, _t, {})
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)


# ── errors ───────────────────────────────────────────────────────────


def test_errors_match_jax():
    h = resampler_taps(3, 2, 31)
    jst = jpoly.upfirdn_stream_init(h, 3, 2, (), jnp.float64)
    pst = upfirdn_stream_init(h, 3, 2, (), torch.float64)
    _raises_like(lambda: jpoly.upfirdn_step(jst, jnp.zeros(5), h, 3, 2),
                 lambda: upfirdn_step(pst, torch.zeros(5, dtype=torch.float64), h, 3, 2))
    z = np.ones(8) + 1j
    _raises_like(lambda: jpoly.upfirdn_step(jst, jnp.asarray(z), h, 3, 2),
                 lambda: upfirdn_step(pst, torch.from_numpy(z), h, 3, 2))
    _raises_like(lambda: jpoly.upfirdn_step(jst, JComplexArray(jnp.ones(8), jnp.ones(8)),
                                            h, 3, 2),
                 lambda: upfirdn_step(pst, ComplexArray(torch.ones(8), torch.ones(8)),
                                      h, 3, 2))
    _raises_like(lambda: jpoly.resample_poly_cascade(jnp.zeros(100), CASCADE[:2],
                                                     taps=[np.ones(5)]),
                 lambda: resample_poly_cascade(torch.zeros(100), CASCADE[:2],
                                               taps=[np.ones(5)]))
    jcs = jpoly.resample_cascade_stream_init(CASCADE)
    pcs = resample_cascade_stream_init(CASCADE)
    _raises_like(lambda: jpoly.resample_cascade_step(jcs, jnp.zeros(100), CASCADE),
                 lambda: resample_cascade_step(pcs, torch.zeros(100), CASCADE))


# ── fixture ──────────────────────────────────────────────────────────


def test_resampler_fixture():
    """tests/test_dsp_fixtures.py:29-35 on the port (the cases bench.py's
    config-3 gate reads), float64 and float32."""
    fx = load_json(os.path.join(fixtures_dir(), "dsp", "resampler.json"))
    for c in fx["cases"]:
        got = upfirdn(_t(c["input"]), _t(c["taps"]), c["up"], c["down"])
        assert got.shape[0] == len(c["output"]), c["name"]
        assert_snr(c["output"], got.numpy(), 130, c["name"])
        got32 = upfirdn(torch.tensor(c["input"], dtype=torch.float32), np.asarray(c["taps"]),
                        c["up"], c["down"])
        assert_snr(c["output"], got32.numpy(), 120, c["name"] + " f32")


# ── interop ──────────────────────────────────────────────────────────


def test_upfirdn_state_crosses_between_the_packages():
    """A JAX stream stopped half way continues in the port (and back)."""
    rng = np.random.default_rng(31)
    h = resampler_taps(3, 2, 63)
    x = rng.standard_normal((2, 1200))
    jst = jpoly.upfirdn_stream_init(h, 3, 2, (2,), jnp.float64)
    jst, _ = jpoly.upfirdn_step(jst, jnp.asarray(x[:, :600]), h, 3, 2)
    _, jy = jpoly.upfirdn_step(jst, jnp.asarray(x[:, 600:]), h, 3, 2)
    pst = upfirdn_state_from_numpy(upfirdn_state_to_numpy(jst), device="cpu")
    assert isinstance(pst, UpfirdnState) and pst.tail.dtype == torch.float64
    pst, py = upfirdn_step(pst, _t(x[:, 600:]), h, 3, 2)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=F64_TOL)
    back = upfirdn_state_to_numpy(pst)
    assert isinstance(back, UpfirdnState) and isinstance(back.tail, np.ndarray)


def test_cascade_state_round_trip_is_nested():
    jcs = jpoly.resample_cascade_stream_init(CASCADE, batch_shape=(2,), dtype=jnp.float64)
    jcs, _ = jpoly.resample_cascade_step(jcs, jnp.asarray(
        np.random.default_rng(32).standard_normal((2, 320))), CASCADE)
    npcs = cascade_state_to_numpy(jcs)
    assert isinstance(npcs, CascadeState) and isinstance(npcs.stages, tuple)
    assert all(isinstance(s, UpfirdnState) for s in npcs.stages)
    pcs = cascade_state_from_numpy(npcs, device="cpu")
    for got, ref in zip(pcs.stages, jcs.stages):
        assert isinstance(got.tail, torch.Tensor)
        assert np.array_equal(got.tail.numpy(), np.asarray(ref.tail))
    again = cascade_state_to_numpy(pcs)
    for got, ref in zip(again.stages, npcs.stages):
        assert np.array_equal(got.tail, ref.tail)


# ── exports ──────────────────────────────────────────────────────────

# The JAX kernel entries, which the port names *_cuda, and the JAX
# permuted-order kernel entries, which the port does not have (PORT.md);
# the port's kernel wrappers and counters.
JAX_ONLY = {n for n in jops.__all__ if "_pallas" in n}
PORT_ONLY = {"LAUNCHES", "fft_rows_cuda", "fft_cols_cuda", "resolve_precision",
             "spectrum_amp_phase_cuda", "spectrum_amplitude_cuda",
             "framed_spectrum_amplitude_cuda", "framed_spectrum_amp_phase_cuda",
             "circular_convolve_cuda", "pfb_channelize_cuda", "pfb_channelize_frames_cuda"}


def test_ops_all_matches_jax():
    jax_names = set(jops.__all__) - JAX_ONLY
    port_names = set(pops.__all__) - PORT_ONLY
    assert jax_names == port_names, (jax_names - port_names, port_names - jax_names)
    assert {"fft_big_permuted", "ifft_big_from_permuted"} <= set(pops.__all__)
    assert len(pops.__all__) == len(set(pops.__all__))
    for name in pops.__all__:
        assert hasattr(pops, name), name
