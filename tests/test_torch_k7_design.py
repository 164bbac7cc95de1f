"""K7's design (csrc/fft_cols.cu: a tile of whole columns held by a
cluster of blocks, the twiddle generated from its exact integer phase) on
the CPU: its step-by-step version ``fft_cols_steps`` against the plain
version, float64 numpy and the JAX package's column kernel
(``_fft_pallas_cols_3d`` in interpret mode) at every n it takes, forward
and inverse, with and without the twiddle, on a ragged m; and the
generated twiddle (``cols_twiddle_steps``) against the float64 grid of
``ops.fft_big``, a rank's columns of it and the JAX package's grid, its
worst error stated in units of 2^-24. The kernel itself runs only on a
card: chip_smoke.py holds it against these same versions there."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.ops import fft_cuda
from pragma_dsp_tpu_torch.ops.fft_big import _interstage_grids64

jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")
jbig = importlib.import_module("pragma_dsp_tpu.ops.fft_big")

SIZES = [256, 512, 1024, 2048, 4096]
M = 20                      # ragged against both tile widths, 16 and 32
COLS_N1 = 1024              # the twiddle's N = n * 1024 ...
OFFSET = 5                  # ... on columns 5..24 of it, a rank's block
STEPS_DB = 125.0            # float64: steps against plain and numpy
PALLAS_DB = 110.0           # tests/test_pallas_fft.py:313, float32 against float64
# The generated twiddle's worst error against the float64 grid, in units of
# 2^-24 (a float32 ulp of values in [0.5, 1)): A and B_q each rounded once
# (1/2 each), their product's two roundings and its sum's (measured 2.04
# on the grids below). The JAX package's grid is the float64 grid rounded
# once, 1/2 from it.
TWIDDLE_UNITS = 3.0
JAX_GRID_UNITS = TWIDDLE_UNITS + 0.5
LANES = 128


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The step-by-step versions run many small tensor operations; with the
    suite's parallel workers each on every core they wait on each other's
    threads (the K7 tests here took 176 s with six workers, 21 s with one
    thread a worker)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _iq(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _planes(z, dtype=torch.float64):
    return (torch.tensor(np.ascontiguousarray(z.real), dtype=dtype),
            torch.tensor(np.ascontiguousarray(z.imag), dtype=dtype))


def _cnp(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _stack(z):
    return np.stack([z.real, z.imag])


def _twiddle(n, inverse):
    return fft_cuda.Twiddle(n * COLS_N1, OFFSET, 1.0 if inverse else -1.0)


def _row_perm(n):
    """Natural row k2 held by row p of the JAX column kernel's output."""
    p = np.arange(n)
    return p // LANES + (n // LANES) * (p % LANES)


@pytest.mark.parametrize("twiddle", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_steps_match_plain_and_numpy_f64(n, inverse, twiddle):
    """n's own tile and cluster, batch 2, the last tile ragged: the
    step-by-step version (the cluster's exchange, the later passes on each
    block's share, the generated twiddle) against the plain version (the
    float64 grid) and numpy."""
    z = _iq(n + inverse, (2, n, M))
    fold = _twiddle(n, inverse) if twiddle else None
    re, im = _planes(z)
    got = _cnp(fft_cuda.fft_cols_steps(re, im, inverse, fold))
    plain = _cnp(fft_cuda.fft_cols_plain(re, im, inverse, fold))
    mul = 1.0
    if twiddle:
        c, s = fold.grids(n, M)
        mul = c + 1j * s
    want = np.fft.ifft(z * mul, axis=-2) if inverse else np.fft.fft(z, axis=-2) * mul
    assert got.shape == (2, n, M)
    assert snr_db(_stack(plain), _stack(got)) >= STEPS_DB
    assert snr_db(_stack(want), _stack(got)) >= STEPS_DB


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_steps_and_plain_match_pallas(n, inverse):
    """float32 with the twiddle of a rank's columns, against the JAX column
    kernel in interpret mode fed the same grid (its rows permuted as its
    kernel lists them): its forward output and its inverse input are
    sublane-permuted, undone here."""
    z = _iq(7 * n + inverse, (1, n, M)).astype(np.complex64)
    fold = _twiddle(n, inverse)
    gc, gs = (g.astype(np.float32) for g in fold.grids(n, M))
    k2 = _row_perm(n)
    re, im = _planes(z, torch.float32)
    if inverse:
        perm = JComplexArray(jpallas.natural_to_cols_permuted(jnp.asarray(z.real[0]), n),
                             jpallas.natural_to_cols_permuted(jnp.asarray(z.imag[0]), n))
        r = jpallas.ifft_pallas_cols_from_permuted(perm, interpret=True, precision="highest",
                                                   fold_grids=(gc[k2], gs[k2]))
        ref = np.stack([np.asarray(r.real), np.asarray(r.imag)])[:, None]
        exact = np.fft.ifft(z.astype(np.complex128) * (fold.grids(n, M)[0]
                                                       + 1j * fold.grids(n, M)[1]), axis=-2)
    else:
        p = jpallas.fft_pallas_cols_permuted(
            JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag)), interpret=True,
            precision="highest", fold_grids=(gc[k2], gs[k2]))
        ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(p.real, n)),
                        np.asarray(jpallas.cols_permuted_to_natural(p.imag, n))])
        exact = np.fft.fft(z.astype(np.complex128), axis=-2) * (fold.grids(n, M)[0]
                                                               + 1j * fold.grids(n, M)[1])
    assert snr_db(_stack(exact), ref) >= PALLAS_DB
    for version in (fft_cuda.fft_cols_steps, fft_cuda.fft_cols_plain):
        got = version(re, im, inverse, fold)
        assert got[0].dtype == torch.float32
        got = np.stack([got[0].numpy(), got[1].numpy()])
        assert snr_db(ref.astype(np.float64), got) >= PALLAS_DB, version.__name__
        assert snr_db(_stack(exact), got) >= PALLAS_DB, version.__name__


@pytest.mark.parametrize("n2,n1,off,width,sign", [(1024, 1024, 0, 1024, -1.0),
                                                  (1024, 1024, 256, 256, 1.0),
                                                  (4096, 4096, 4000, 96, -1.0),
                                                  (256, 512, 0, 512, 1.0)])
def test_generated_twiddle_against_the_grids(n2, n1, off, width, sign):
    """The twiddle K7 forms (A * B_q, each factor from its phase reduced
    mod N in integers), for the (n2, width) block of columns off.. of an
    (n2, n1) transform: within TWIDDLE_UNITS of 2^-24 of the float64 grid
    of ops.fft_big (whose columns are Twiddle.grids' bit for bit), within
    JAX_GRID_UNITS of the JAX package's float32 grid, and in float64
    within 1e-15 of the float64 grid."""
    fold = fft_cuda.Twiddle(n2 * n1, off, sign)
    c64, s64 = fold.grids(n2, width)
    gc, gs = _interstage_grids64(n2, n1, sign)
    np.testing.assert_array_equal(c64, gc[:, off:off + width])
    np.testing.assert_array_equal(s64, gs[:, off:off + width])
    wc, ws = (t.numpy().astype(np.float64)
              for t in fft_cuda.cols_twiddle_steps(fold, n2, width, torch.float32))
    worst = max(np.abs(wc - c64).max(), np.abs(ws - s64).max()) * 2.0 ** 24
    assert worst <= TWIDDLE_UNITS, worst
    jc, js = (np.asarray(g, np.float64)[np.argsort(_row_perm(n2))][:, off:off + width]
              for g in jbig._interstage_grids(n2, n1, sign))
    worst_jax = max(np.abs(wc - jc).max(), np.abs(ws - js).max()) * 2.0 ** 24
    assert worst_jax <= JAX_GRID_UNITS, worst_jax
    dc, ds = fft_cuda.cols_twiddle_steps(fold, n2, width, torch.float64)
    assert max(np.abs(dc.numpy() - c64).max(), np.abs(ds.numpy() - s64).max()) <= 1e-15


def test_twiddle_checks_and_the_plain_grid():
    """A twiddle's size is a power of two from 4 to 2^31, its sign +1 or -1
    and its offset >= 0; the plain version multiplies by its grid rounded
    to the planes' dtype, the same bits as the explicit grid."""
    z = _iq(3, (2, 256, 8)).astype(np.complex64)
    re, im = _planes(z, torch.float32)
    for bad in (fft_cuda.Twiddle(3 * 256), fft_cuda.Twiddle(2), fft_cuda.Twiddle(1 << 32),
                fft_cuda.Twiddle(1 << 16, -1), fft_cuda.Twiddle(1 << 16, 0, 0.5)):
        with pytest.raises(ValueError, match="a twiddle takes"):
            fft_cuda.fft_cols_cuda(re, im, fold=bad)
    fold = fft_cuda.Twiddle(1 << 16, 40)
    grid = tuple(torch.from_numpy(g).float() for g in fold.grids(256, 8))
    for inverse in (False, True):
        a = fft_cuda.fft_cols_cuda(re, im, inverse, fold)
        b = fft_cuda.fft_cols_cuda(re, im, inverse, grid)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
