"""The large-FFT path of the port on the CPU: K7's plain version against
the JAX column kernel run in interpret mode, ``ops.fft_big`` against the
JAX module after each side's ``big_permuted_to_natural``, the natural-order
route through K2's turned instances against the permuted route and its
transpose (bit for bit), the turned instances' addressing, the split, the
inter-stage grids, the dispatch policy table, the four-step FFT, and the
entries that route through them above 16384 points.

K7 itself runs only on a CUDA card: tests/test_torch_cuda.py checks it
there, and chip_smoke.py is its evidence; tests/test_torch_cols_pfb_regs.py
holds its step-by-step version."""

import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pragma_dsp_tpu.core import ComplexArray as JComplexArray
from pragma_dsp_tpu.utils.fixtures import snr_db
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import (dispatch, fft_cuda, overlap_save_filter,
                                      pfb_channelize, pfb_taps)
from pragma_dsp_tpu_torch import set_default_device

# The packages export functions that shadow these submodule names.
jpallas = importlib.import_module("pragma_dsp_tpu.ops.fft_pallas")
jbig = importlib.import_module("pragma_dsp_tpu.ops.fft_big")
jfour = importlib.import_module("pragma_dsp_tpu.ops.fft_fourstep")
jdispatch = importlib.import_module("pragma_dsp_tpu.ops.dispatch")
pbig = importlib.import_module("pragma_dsp_tpu_torch.ops.fft_big")
pfour = importlib.import_module("pragma_dsp_tpu_torch.ops.fft_fourstep")
pfir = importlib.import_module("pragma_dsp_tpu_torch.ops.fir")

RNG = np.random.default_rng(77)
LANES = 128


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


def _cx(shape, dtype=np.complex64):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(dtype)


def _jca(z):
    return JComplexArray(jnp.asarray(z.real), jnp.asarray(z.imag))


def _pca(z):
    return ComplexArray(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()))


def _planes(c):
    """Either package's ComplexArray as one stacked float64 numpy array."""
    return np.stack([np.asarray(c.real, np.float64), np.asarray(c.imag, np.float64)])


def _row_perm(n):
    """Natural row k2 held by row p of the JAX column kernel's output."""
    p = np.arange(n)
    return p // LANES + (n // LANES) * (p % LANES)


# ── K7's plain version against the JAX column kernel ─────────────────


@pytest.mark.parametrize("n,m", [(256, 128), (512, 100), (256, 256)])
def test_k7_plain_matches_pallas_forward(n, m):
    """float32 on both sides; atol 2e-4 as tests/test_pallas_fft.py's fold
    test holds the JAX kernel to (|X| reaches ~60 here)."""
    z = _cx((2, n, m))
    p = jpallas.fft_pallas_cols_permuted(_jca(z), interpret=True, precision="highest")
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(p.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(p.imag, n))])
    got = fft_cuda.fft_cols_cuda(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()))
    assert got[0].dtype == torch.float32 and got[0].shape == (2, n, m)
    np.testing.assert_allclose(np.stack([got[0].numpy(), got[1].numpy()]), ref,
                               rtol=0, atol=2e-4)
    want = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert snr_db(np.stack([want.real, want.imag]),
                  np.stack([got[0].numpy(), got[1].numpy()])) > 110


@pytest.mark.parametrize("n,m", [(256, 128), (512, 100)])
def test_k7_plain_matches_pallas_inverse(n, m):
    """The JAX inverse consumes sublane-permuted rows; the port natural
    ones. Same input after the permutation, natural time order out."""
    z = _cx((n, m))
    perm = JComplexArray(jpallas.natural_to_cols_permuted(jnp.asarray(z.real), n),
                         jpallas.natural_to_cols_permuted(jnp.asarray(z.imag), n))
    ref = jpallas.ifft_pallas_cols_from_permuted(perm, interpret=True,
                                                 precision="highest")
    got = fft_cuda.fft_cols_cuda(torch.from_numpy(z.real.copy()),
                                 torch.from_numpy(z.imag.copy()), inverse=True)
    np.testing.assert_allclose(np.stack([got[0].numpy(), got[1].numpy()]),
                               _planes(ref), rtol=0, atol=2e-6)
    back = fft_cuda.fft_cols_cuda(*fft_cuda.fft_cols_cuda(
        torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())), inverse=True)
    assert snr_db(np.stack([z.real, z.imag]),
                  np.stack([back[0].numpy(), back[1].numpy()])) > 120


def test_k7_plain_fold_matches_pallas():
    """The fold grid rides the natural rows in the port and the permuted
    rows in the JAX kernel: row k2 of one is row p of the other."""
    n, m = 256, 128
    z = _cx((n, m))
    gc = RNG.standard_normal((n, m)).astype(np.float32)
    gs = RNG.standard_normal((n, m)).astype(np.float32)
    k2 = _row_perm(n)
    pf = jpallas.fft_pallas_cols_permuted(_jca(z), interpret=True, precision="highest",
                                          fold_grids=(gc[k2], gs[k2]))
    ref = np.stack([np.asarray(jpallas.cols_permuted_to_natural(pf.real, n)),
                    np.asarray(jpallas.cols_permuted_to_natural(pf.imag, n))])
    re, im = torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())
    fre, fim = fft_cuda.fft_cols_cuda(re, im, fold=(gc, gs))
    np.testing.assert_allclose(np.stack([fre.numpy(), fim.numpy()]), ref,
                               rtol=0, atol=2e-4)
    # forward: an explicit multiply after; inverse: an explicit multiply before
    pre, pim = fft_cuda.fft_cols_cuda(re, im)
    np.testing.assert_allclose(fre.numpy(), pre.numpy() * gc - pim.numpy() * gs,
                               rtol=0, atol=2e-4)
    vi = fft_cuda.fft_cols_cuda(fre, fim, inverse=True, fold=(gc, gs))
    ve = fft_cuda.fft_cols_cuda(fre * torch.from_numpy(gc) - fim * torch.from_numpy(gs),
                                fre * torch.from_numpy(gs) + fim * torch.from_numpy(gc),
                                inverse=True)
    np.testing.assert_allclose(vi[0].numpy(), ve[0].numpy(), rtol=0, atol=2e-4)
    jvi = jpallas.ifft_pallas_cols_from_permuted(
        JComplexArray(pf.real, pf.imag), interpret=True, precision="highest",
        fold_grids=(gc[k2], gs[k2]))
    np.testing.assert_allclose(np.stack([vi[0].numpy(), vi[1].numpy()]), _planes(jvi),
                               rtol=0, atol=2e-4)


def test_k7_float64_and_batch_axes_against_numpy():
    z = _cx((2, 3, 256, 5), np.complex128)
    got = fft_cuda.fft_cols_plain(torch.from_numpy(z.real.copy()),
                                  torch.from_numpy(z.imag.copy()))
    ref = np.fft.fft(z, axis=-2)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), ref,
                               rtol=0, atol=1e-11)
    inv = fft_cuda.fft_cols_cuda(*got, inverse=True)
    np.testing.assert_allclose(inv[0].numpy() + 1j * inv[1].numpy(), z,
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", [128, 384, 64])
def test_k7_size_contract_matches_jax(n):
    z = np.zeros((n, 128), np.float32)
    with pytest.raises(ValueError) as port_err:
        fft_cuda.fft_cols_cuda(torch.from_numpy(z), torch.from_numpy(z))
    with pytest.raises(ValueError) as jax_err:
        jpallas.fft_pallas_cols_permuted(JComplexArray(jnp.asarray(z), jnp.asarray(z)),
                                         interpret=True)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value) == (
        f"column FFT size must be a power of two > 128, got {n}")


def test_k7_input_rules():
    z = torch.zeros(256, 4)
    assert fft_cuda.MAX_COLS_N == jpallas.MAX_COLS_N == 4096
    assert fft_cuda.MAX_ROWS_N == jpallas.MAX_ROWS_N == 16384
    with pytest.raises(ValueError, match=r"covers n <= 4096"):
        fft_cuda.fft_cols_cuda(torch.zeros(8192, 1), torch.zeros(8192, 1))
    with pytest.raises(ValueError, match=r"\[\.\.\., n, m\]"):
        fft_cuda.fft_cols_cuda(z, torch.zeros(256, 5))
    with pytest.raises(ValueError, match=r"\[\.\.\., n, m\]"):
        fft_cuda.fft_cols_cuda(torch.zeros(256), torch.zeros(256))
    with pytest.raises(ValueError, match="fold grids"):
        fft_cuda.fft_cols_cuda(z, z, fold=(np.zeros((256, 3)), np.zeros((256, 3))))
    out = fft_cuda.fft_cols_cuda(z, z, donate=True)      # donate: no effect on CPU
    assert out[0].shape == (256, 4)


@pytest.mark.parametrize("n,m,want", [(256, 4096, (32, 1)), (1024, 1024, (16, 1)),
                                      (4096, 128, (16, 4)), (512, 100, (16, 1)),
                                      (256, 3, (32, 1)), (2048, 1, (32, 8))])
def test_k7_tile_fits_shared_memory(n, m, want):
    """A tile of whole 64- or 128-byte row segments whatever m (a ragged
    tile is masked), in a cluster of blocks of 512 or 1024 threads; shared
    memory holds a block's padded [row][column] exchange of both planes and
    its twiddle tables (B_q of its columns, A of each thread), for the
    blocks an SM holds."""
    tile, cluster = fft_cuda.cols_config(n)
    assert (tile, cluster) == want and -(-m // tile) >= 1
    threads = n // 16 * tile // cluster
    assert threads in (512, 1024)
    pad = fft_cuda.cols_pad_shift(tile, cluster)
    words = fft_cuda.exchange_at(n // cluster, 0, pad) * tile
    assert words == (n // cluster + (n // cluster >> pad)) * tile
    assert (1024 // threads) * (8 * words + 8 * 16 * tile + 8 * threads + 1024) <= 228 * 1024


# ── ops.fft_big ──────────────────────────────────────────────────────


@pytest.mark.parametrize("bits", range(10, 28))
def test_big_split_matches_jax(bits):
    n = 1 << bits
    try:
        want = jbig.big_split(n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pbig.big_split(n)
        assert str(err.value) == str(e)
        return
    assert pbig.big_split(n) == want
    assert want[0] * want[1] == n
    assert want[0] <= pbig.MAX_COLS_N and want[1] <= pbig.MAX_ROWS_N


def test_big_split_rejects_non_power_like_jax():
    assert pbig.MIN_BIG_N == jbig.MIN_BIG_N == 1 << 16
    for n in ((1 << 16) + 1, 3 << 15, 0):
        with pytest.raises(ValueError) as err:
            pbig.big_split(n)
        with pytest.raises(ValueError) as jerr:
            jbig.big_split(n)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("n2b,n1b", [(256, 256), (256, 512), (1024, 1024)])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_interstage_grids_bit_equal_under_row_permutation(n2b, n1b, sign):
    c, s = pbig._interstage_grids(n2b, n1b, sign)
    jc, js = jbig._interstage_grids(n2b, n1b, sign)
    k2 = _row_perm(n2b)
    assert c.dtype == s.dtype == np.float32 and c.shape == (n2b, n1b)
    np.testing.assert_array_equal(c[k2], jc)
    np.testing.assert_array_equal(s[k2], js)


def test_fft_big_matches_jax_and_numpy():
    """2^16 points through both packages, each un-permuted by its own
    big_permuted_to_natural: >= 115 dB against numpy, atol 1e-3 between
    the packages (tests/test_pallas_fft.py's bounds; |X| reaches ~1000)."""
    n = 1 << 16
    z = _cx((n,))
    ref = np.fft.fft(z.astype(np.complex128))
    p = pbig.fft_big_permuted(_pca(z))
    assert p.real.shape == (256, 256) and p.real.dtype == torch.float32
    got = np.stack([pbig.big_permuted_to_natural(p.real, 256, 256).numpy(),
                    pbig.big_permuted_to_natural(p.imag, 256, 256).numpy()])
    assert snr_db(np.stack([ref.real, ref.imag]), got) > 115
    jp = jbig.fft_big_permuted(_jca(z), interpret=True, precision="highest")
    jgot = np.stack([np.asarray(jbig.big_permuted_to_natural(jp.real, 256, 256)),
                     np.asarray(jbig.big_permuted_to_natural(jp.imag, 256, 256))])
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-3)
    # the layout: element [k2, k1] holds X[k2 + n2b*k1]
    np.testing.assert_array_equal(p.real.numpy()[3, 5], got[0][3 + 256 * 5])
    nat = pbig.fft_big(_pca(z))
    np.testing.assert_array_equal(_planes(nat), got.astype(np.float64))
    back = pbig.natural_to_big_permuted(nat.real, 256, 256)
    assert back.is_contiguous() and torch.equal(back, p.real)


def test_ifft_big_roundtrip_and_jax():
    n = 1 << 16
    z = _cx((2, n))
    p = pbig.fft_big_permuted(_pca(z))
    rt = pbig.ifft_big_from_permuted(p)
    assert rt.real.shape == (2, n)
    assert snr_db(np.stack([z.real, z.imag]), _planes(rt)) > 115
    spec = _cx((n,))
    got = pbig.ifft_big(_pca(spec))
    ref = np.fft.ifft(spec.astype(np.complex128))
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(got)) > 115
    jgot = jbig.ifft_big(_jca(spec), interpret=True, precision="highest")
    np.testing.assert_allclose(_planes(got), _planes(jgot), rtol=0, atol=1e-6)


def test_fft_big_float64_and_bfloat16():
    n = 1 << 16
    z = _cx((n,), np.complex128)
    got = pbig.fft_big(_pca(z))
    assert got.real.dtype == torch.float64
    np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), np.fft.fft(z),
                               rtol=0, atol=1e-9)
    back = pbig.ifft_big(got)
    np.testing.assert_allclose(back.real.numpy() + 1j * back.imag.numpy(), z,
                               rtol=0, atol=1e-12)
    zb = _pca(z.astype(np.complex64))
    bf = pbig.fft_big_permuted(ComplexArray(zb.real.bfloat16(), zb.imag.bfloat16()))
    f32 = pbig.fft_big_permuted(ComplexArray(zb.real.bfloat16().float(),
                                             zb.imag.bfloat16().float()))
    assert bf.real.dtype == torch.bfloat16
    assert torch.equal(bf.real, f32.real.bfloat16())


def test_fft_big_does_not_write_its_input_unless_donated():
    z = _pca(_cx((1 << 16,)))
    keep = z.real.clone()
    pbig.fft_big_permuted(z)
    pbig.ifft_big(z)
    assert torch.equal(z.real, keep)
    with pytest.raises(ValueError, match="unknown precision"):
        pbig.fft_big(z, precision="fp8")


# ── natural order through K2's turned instances ─────────────────────


def _natural_by_transpose(p):
    """The permuted route's result, transposed to natural order."""
    n2b, n1b = p.real.shape[-2:]
    return (pbig.big_permuted_to_natural(p.real, n2b, n1b),
            pbig.big_permuted_to_natural(p.imag, n2b, n1b))


@pytest.mark.parametrize("bits", [16, 17])       # (n2b, n1b) = (256, 256), (256, 512)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_natural_order_equals_the_permuted_route_and_its_transpose(bits, dtype):
    """fft_big is bit for bit fft_big_permuted then big_permuted_to_natural,
    and ifft_big natural_to_big_permuted then ifft_big_from_permuted; the
    split (256, 512) is not square, so a swapped index map would fail."""
    n = 1 << bits
    n2b, n1b = pbig.big_split(n)
    z = _pca(_cx((2, n), np.complex128))
    z = ComplexArray(z.real.to(dtype), z.imag.to(dtype))
    keep = z.real.clone()
    want = _natural_by_transpose(pbig.fft_big_permuted(z))
    got = pbig.fft_big(z)
    assert got.real.shape == (2, n) and got.real.dtype == dtype
    assert torch.equal(got.real, want[0]) and torch.equal(got.imag, want[1])
    old = pbig.ifft_big_from_permuted(
        ComplexArray(pbig.natural_to_big_permuted(z.real, n2b, n1b),
                     pbig.natural_to_big_permuted(z.imag, n2b, n1b)), donate=True)
    back = pbig.ifft_big(z)
    assert back.real.shape == (2, n)
    assert torch.equal(back.real, old.real) and torch.equal(back.imag, old.imag)
    assert torch.equal(z.real, keep)
    one = pbig.fft_big(ComplexArray(z.real[1], z.imag[1]))      # one row, no batch axis
    assert one.real.shape == (n,) and torch.equal(one.real, want[0][1])


@pytest.mark.parametrize("shape,load", [((2, 24, 256), False), ((2, 256, 24), True),
                                        ((1, 8, 4096), False), ((3, 512, 16), True)])
def test_turned_rows_plain_is_the_row_fft_and_a_transpose(shape, load):
    """On a CPU tensor the turned wrapper is its plain version: the row FFT
    then the transpose (the turned store), or the transpose then the row
    FFT (the turned load), forward and inverse."""
    z = _cx(shape)
    re, im = torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy())
    for inverse in (False, True):
        got = fft_cuda.fft_rows_turned_cuda(re, im, inverse, load)
        assert all(g.is_contiguous() for g in got)
        src = (re.transpose(1, 2), im.transpose(1, 2)) if load else (re, im)
        n = src[0].shape[-1]
        rows = fft_cuda.fft_rows_plain(src[0].reshape(-1, n), src[1].reshape(-1, n), inverse)
        rows = tuple(r.reshape(src[0].shape) for r in rows)
        want = rows if load else tuple(r.transpose(1, 2) for r in rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        oracle = np.fft.ifft if inverse else np.fft.fft
        ref = oracle(z.astype(np.complex128), axis=1 if load else 2).transpose(0, 2, 1)
        assert snr_db(np.stack([ref.real, ref.imag]), _planes(ComplexArray(*got))) > 115


def test_turned_rows_input_rules():
    with pytest.raises(ValueError, match="fft_rows_turned takes"):
        fft_cuda.fft_rows_turned_cuda(torch.zeros(8, 256), torch.zeros(8, 256))
    with pytest.raises(ValueError, match="fft_rows_turned takes"):
        fft_cuda.fft_rows_turned_cuda(torch.zeros(1, 8, 256), torch.zeros(1, 8, 128))
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.fft_rows_turned_cuda(torch.zeros(1, 8, 384), torch.zeros(1, 8, 384))
    with pytest.raises(ValueError, match="power of two"):
        fft_cuda.fft_rows_turned_cuda(torch.zeros(1, 384, 8), torch.zeros(1, 384, 8),
                                      load=True)


_spec = importlib.util.spec_from_file_location(
    "k2_k1_split", Path(__file__).resolve().parent.parent / "scripts" / "k2_k1_split.py")
_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_split)


def _run_rows(n, cluster):
    """Rows of one run of a turned launch of n in ``cluster`` blocks: a
    block of 8 rows that stages its own (as many as 1024 threads hold), or
    the cluster's row-instance blocks."""
    if cluster == 1:
        threads = n // fft_cuda.points_per_thread(n)
        return 8 if threads * 8 <= 1024 else 1024 // threads
    return fft_cuda.rows_per_block(n) * cluster


def _turned_accesses(n, cluster):
    """K2's turned side as csrc/fft_rows.cu addresses it, for one run of
    _run_rows(n, cluster) rows at j0 = 0 of an item of cols = 2 * RR
    columns, held by ``cluster`` blocks: for each block (rank) and q, the
    turned side's (thread, staging word, device word), and for each block
    and register q the row side's (thread, block whose staging holds the
    point, staging word, row, point)."""
    rr = _run_rows(n, cluster)
    regs = fft_cuda.points_per_thread(n)
    t = n // regs
    rows = rr // cluster                      # rows a block
    threads = rows * t
    share = n // cluster                      # points a block turns
    stride = share + 32 // rr
    cols = 2 * rr
    i = np.arange(threads)
    r, kk = i % rr, i // rr
    kstep = threads // rr
    turned = [(rank, [(i, r * stride + kk + q * kstep,
                       (rank * share + kk + q * kstep) * cols + r) for q in range(regs)])
              for rank in range(cluster)]
    local, tid = i // t, i % t
    per = regs // cluster                     # registers a block turns
    row_side = [(rank, [(i, np.full(threads, q // per),
                         (rank * rows + local) * stride + tid + (q % per) * t,
                         rank * rows + local, tid + t * q) for q in range(regs)])
                for rank in range(cluster)]
    return turned, row_side, rr, stride, cols


# Every cluster K2's turned kernel is built in at each n: the shipped one
# of each direction and those of scripts/k2_k1_split.py's turned designs.
_TURNED = sorted({(n, c) for n in (256, 512, 1024, 2048, 4096)
                  for c in fft_cuda.TURN_CLUSTER[n]}
                 | {(n, c[0]) for log2cs in _split.K2_TURN_DESIGNS.values()
                    for n, c in _split.turn_host_table(log2cs).items()})


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
def test_turned_side_is_conflict_free_and_sector_whole(n):
    """The instances each n launches turn runs of at least 8 rows: every
    32-byte sector of their turned side whole (the addressing as below)."""
    for load in (False, True):
        assert fft_cuda.turn_rows(n, load) >= 8
        _check_turned_side(n, fft_cuda.TURN_CLUSTER[n][load])


@pytest.mark.parametrize("n,cluster", _TURNED)
def test_every_turned_instance_is_conflict_free_and_runs_whole(n, cluster):
    _check_turned_side(n, cluster)


def _check_turned_side(n, cluster):
    """The turned side of a run: each warp's 32 staging words lie in 32
    banks; in device memory it touches runs of RR consecutive words that
    start at a multiple of RR (RR = 8: a 32-byte sector, 16: 64 bytes);
    over the blocks and their q every point of every row is touched once,
    and the staging fits the exchange of the block's rows."""
    turned, _, rr, stride, cols = _turned_accesses(n, cluster)
    rows_a_block = rr // cluster
    exchange = rows_a_block * (n + n // 32 + (n // 16 if n // 16 < 32 else 0))
    assert rr * stride <= exchange
    touched = []
    for _, accesses in turned:
        for i, word, at in accesses:
            for w in range(0, len(i), 32):
                assert len(set(word[w:w + 32] % 32)) == 32
                runs = np.sort(at[w:w + 32]).reshape(-1, rr)
                assert (runs[:, 0] % rr == 0).all()
                assert (np.diff(runs, axis=1) == 1).all()
            touched.append(at)
    touched = np.concatenate(touched)
    assert len(set(touched)) == rr * n
    assert sorted(touched % cols) == sorted(np.repeat(np.arange(rr), n))


@pytest.mark.parametrize("n,cluster", _TURNED)
def test_turned_row_side_meets_the_turned_side(n, cluster):
    """The row side of a run: register q of a thread (point tid + T*q of
    its row) lies in the staging of block q / (16 / cluster) at the word
    the turned side of that block reads or writes for that row and point;
    a warp's accesses are consecutive words of one block (a row of at least
    32 threads) and every (block, word) of the staging is touched once from
    each side."""
    turned, row_side, rr, stride, _ = _turned_accesses(n, cluster)
    t = n // fft_cuda.points_per_thread(n)
    share = n // cluster
    seen_turned, seen_rows = set(), set()
    for rank, accesses in turned:
        for _, word, at in accesses:
            row = word // stride
            point = rank * share + word % stride
            seen_turned.update(zip([rank] * len(word), word, row, point))
    for _, accesses in row_side:
        for i, owner, word, row, point in accesses:
            assert (point // share == owner).all()
            if t >= 32:
                for w in range(0, len(i), 32):
                    assert len(set(owner[w:w + 32])) == 1
                    assert (np.diff(word[w:w + 32]) == 1).all()
            seen_rows.update(zip(owner, word, row, point))
    assert seen_rows == seen_turned
    assert len(seen_rows) == rr * n


def test_turned_instances_match_the_host_rules():
    """csrc/fft_rows.cu instantiates one turned store and one turned load
    for each n = 2^8 to 2^12, in the host's cluster, and the host's run of
    rows is the kernel's; fft_big turns its row stage up to the widest of
    them and keeps the transpose above, with a width each takes."""
    text = (fft_cuda._build.CSRC / "fft_rows.cu").read_text()
    assert "kTurnMinLog2N = 8, kTurnMaxLog2N = 12" in text
    assert fft_cuda.MIN_TURNED_N == 1 << 8 and fft_cuda.MAX_TURNED_N == 1 << 12
    assert "return threads * 8 <= 1024 ? 8 : 1024 / threads;" in text

    def table(name):
        found = re.findall(r"constexpr int " + name + r"\[\] = \{([^}]*)\};", text)
        assert len(found) == 1
        return [1 << int(v) for v in found[0].split(",")]

    sizes = [1 << b for b in range(8, 13)]
    assert table("kLog2TurnStoreCluster") == [fft_cuda.TURN_CLUSTER[n][0] for n in sizes]
    assert table("kLog2TurnLoadCluster") == [fft_cuda.TURN_CLUSTER[n][1] for n in sizes]
    for n in sizes:
        for load in (False, True):
            assert fft_cuda.turn_rows(n, load) == _run_rows(n, fft_cuda.TURN_CLUSTER[n][load])
    assert [_run_rows(n, 1) for n in sizes] == [8, 8, 8, 8, 4]
    assert [fft_cuda.rows_per_block(n) for n in sizes] == [8, 4, 2, 1, 1]
    for bits in range(16, 27):
        n2b, n1b = pbig.big_split(1 << bits)
        if n1b <= fft_cuda.MAX_TURNED_N:
            assert n2b % fft_cuda.turn_rows(n1b) == 0
            assert n2b % fft_cuda.turn_rows(n1b, load=True) == 0


# ── dispatch ─────────────────────────────────────────────────────────


def _policy_row(bits):
    if bits <= 14:
        return "cuda"
    if bits == 15 or bits > 26:
        return "fourstep"
    return "big"


@pytest.mark.parametrize("bits", range(1, 28))
def test_dispatch_policy_table(bits):
    n = 1 << bits
    want = _policy_row(bits)
    for dtype in (torch.float32, torch.bfloat16):
        assert dispatch.choose_impl("cuda", dtype, n) == want, (dtype, n)
    assert dispatch.choose_impl("cuda", torch.float64, n) == "stockham"
    assert dispatch.choose_impl("cpu", torch.float32, n) == "stockham"
    assert dispatch.choose_impl("cuda", torch.float32, n + 1 if n > 2 else 3) == "stockham"
    assert dispatch._big_supports(n) == (want == "big")


@pytest.mark.parametrize("shape,axis,want", [
    ((8, 1024, 128), -2, True), ((8, 1024, 128), 1, True), ((1024, 128), 0, True),
    ((8, 1024, 127), -2, False), ((8, 128, 512), -2, False),
    ((8, 8192, 128), -2, False), ((8, 4096, 128), -2, True),
    ((8, 1024, 128), -1, False), ((8, 1024, 128), 0, False), ((1024,), 0, False),
    ((4, 384, 256), -2, False), ((2, 3, 256, 128), 2, True)])
def test_dispatch_axis_minus_2_rule(shape, axis, want):
    """The column kernel takes axis -2 of an operand with ndim >= 2, a
    power-of-two 128 < n <= 4096 and a last dimension >= 128."""
    assert dispatch._use_cols(shape, axis) is want


def test_dispatch_cuda_impl_axis_minus_2_on_cpu():
    z = _cx((3, 256, 192))
    out = dispatch.fft(_pca(z), axis=-2, impl="cuda")
    ref = np.fft.fft(z.astype(np.complex128), axis=-2)
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(out)) > 110
    rt = dispatch.ifft(out, axis=1, impl="cuda")
    assert np.abs(rt.real.numpy() + 1j * rt.imag.numpy() - z).max() < 1e-4


@pytest.mark.parametrize("impl", ["big", "fourstep"])
def test_dispatch_impl_on_cpu(impl):
    n = 1 << 16
    z = _cx((n,))
    out = dispatch.fft(_pca(z), impl=impl)
    ref = np.fft.fft(z.astype(np.complex128))
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(out)) > 115
    rt = dispatch.ifft(out, impl=impl)
    assert np.abs(rt.real.numpy() + 1j * rt.imag.numpy() - z).max() < 2e-3


def test_dispatch_big_over_another_axis():
    z = _cx((1 << 16, 2), np.complex128)
    out = dispatch.fft(_pca(z), axis=0, impl="big")
    assert out.real.shape == z.shape
    np.testing.assert_allclose(out.real.numpy() + 1j * out.imag.numpy(),
                               np.fft.fft(z, axis=0), rtol=0, atol=1e-9)
    rt = dispatch.ifft(out, axis=0, impl="big")
    np.testing.assert_allclose(rt.real.numpy() + 1j * rt.imag.numpy(), z, atol=1e-12)


def test_dispatch_big_range_message_matches_jax():
    z = np.zeros(1024, np.float32)
    for f, jf in ((dispatch.fft, jdispatch.fft), (dispatch.ifft, jdispatch.ifft)):
        with pytest.raises(ValueError) as err:
            f(torch.from_numpy(z), impl="big")
        with pytest.raises(ValueError) as jerr:
            jf(jnp.asarray(z), impl="big")
        assert str(err.value) == str(jerr.value)
    assert dispatch.MAX_BIG_N == 1 << 26


def test_pinned_big_falls_back_for_other_sizes():
    z = _cx((4, 256))
    ref = dispatch.fft(_pca(z))
    dispatch.set_fft_impl("big")
    try:
        assert dispatch.get_fft_impl() == "big"
        out = dispatch.fft(_pca(z))                      # 256 is outside big's range
        assert torch.equal(out.real, ref.real)
        big = dispatch.fft(_pca(_cx((1 << 16,))))        # inside: the pinned impl
        assert big.real.shape == (1 << 16,)
    finally:
        dispatch.set_fft_impl("auto")
    for name in ("fourstep", "big", "cuda", "stockham", "auto"):
        dispatch.set_fft_impl(name)
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.set_fft_impl("pallas")
    with pytest.raises(ValueError, match="unknown fft impl"):
        dispatch.fft(torch.zeros(8), impl="pallas")


# ── ops.fft_fourstep ─────────────────────────────────────────────────


@pytest.mark.parametrize("n", [1, 2, 64, 128, 256, 4096, 1 << 15])
def test_fourstep_matches_jax_float64(n):
    z = _cx((3, n), np.complex128)
    for f, jf, ref in ((pfour.fft_fourstep, jfour.fft_fourstep, np.fft.fft(z)),
                       (pfour.ifft_fourstep, jfour.ifft_fourstep, np.fft.ifft(z))):
        got = f(_pca(z))
        want = jf(_jca(z))
        assert got.real.dtype == torch.float64
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(_planes(got), _planes(want), rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), ref,
                                   rtol=0, atol=1e-10 * scale)


def test_fourstep_axis_float32_and_errors():
    z = _cx((512, 3))
    got = pfour.fft_fourstep(_pca(z), axis=0)
    ref = np.fft.fft(z.astype(np.complex128), axis=0)
    assert got.real.dtype == torch.float32 and got.real.shape == (512, 3)
    assert snr_db(np.stack([ref.real, ref.imag]), _planes(got)) > 120
    for f, jf in ((pfour.fft_fourstep, jfour.fft_fourstep),
                  (pfour.ifft_fourstep, jfour.ifft_fourstep)):
        with pytest.raises(ValueError) as err:
            f(torch.zeros(12))
        with pytest.raises(ValueError) as jerr:
            jf(jnp.zeros(12))
        assert str(err.value) == str(jerr.value)
    assert pfour.FOURSTEP_RADIX == jfour.FOURSTEP_RADIX == 128


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_fourstep_tables_bit_equal_to_jax(sign):
    for a, b in zip(pfour._dft_matrix(128, sign), jfour._dft_matrix(128, sign)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pfour._twiddle_grid(1 << 15, 256, 128, sign),
                    jfour._twiddle_grid(1 << 15, 256, 128, sign)):
        np.testing.assert_array_equal(a, b)


def test_full_float32_restores_process_settings():
    """On a CPU tensor nothing is touched; the context is re-entrant from
    one thread only through separate calls, and always restores."""
    from pragma_dsp_tpu_torch.ops._tf32 import full_float32

    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    with full_float32(torch.zeros(1)):
        assert (torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()) == before
    assert (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before


# ── the entries that route through dispatch above 16384 ──────────────


def test_long_frame_glue_matches_k1_plain():
    """Above 16384 points a CUDA frame goes window -> dispatch.fft -> the
    one-sided scaling of ``_onesided_from_bins``; the same glue on the CPU
    must give K1's plain version (float32, amplitude atol 2e-6, phase
    1e-4 rad where the amplitude exceeds 1e-3)."""
    n = 1 << 15
    t = np.arange(n) / 48000.0
    x = (0.8 * np.sin(2 * np.pi * 1500.0 * t)
         + 0.01 * RNG.standard_normal((2, n))).astype(np.float32)
    xt = torch.from_numpy(x)
    win = torch.from_numpy(fft_cuda.onesided_window(n, "hann")[0])
    spec = dispatch.fft(xt * win, impl="fourstep")
    amp, ph = fft_cuda._onesided_from_bins(spec.real, spec.imag, n, True)
    pamp, pph = fft_cuda.spectrum_amp_phase_plain(xt, n, "hann")
    assert amp.shape == (2, n // 2 + 1)
    np.testing.assert_allclose(amp.numpy(), pamp.numpy(), rtol=0, atol=2e-6)
    mask = pamp.numpy() > 1e-3
    d = np.abs(np.angle(np.exp(1j * (ph.numpy()[mask] - pph.numpy()[mask]))))
    assert mask.any() and d.max() <= 1e-4
    assert float(ph[0, 0]) in (0.0, float(np.float32(np.pi)))
    assert float(ph[0, -1]) in (0.0, float(np.float32(np.pi)))
    assert int(amp[0].argmax()) == 1024                  # 1500 Hz at 48 kHz / 2^15


def test_long_overlap_save_block_takes_the_dispatch_route():
    """A 4000-tap filter needs a 32768-point block: no fused kernel holds
    it, so on every device it runs fft x H -> ifft through dispatch."""
    assert pfir._use_kernel("cuda", torch.float32, 16384)
    assert not pfir._use_kernel("cuda", torch.float32, 32768)
    assert not pfir._use_kernel("cpu", torch.float32, 1024)
    taps = RNG.standard_normal(4000) / 4000
    x = RNG.standard_normal(40000)
    got = overlap_save_filter(torch.from_numpy(x), taps)
    ref = np.convolve(x, taps)[:x.size]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_channelizer_above_16384_channels_answers():
    c, frames = 1 << 15, 3
    z = _cx((frames * c,), np.complex128)
    taps = pfb_taps(c, 2)
    got = pfb_channelize(_pca(z), c, taps)
    hp = np.zeros(2 * c)
    hp[:taps.size] = taps
    zp = np.concatenate([np.zeros(c), z]).reshape(frames + 1, c)
    v = hp[:c] * zp[1:] + hp[c:] * zp[:-1]
    ref = np.fft.fft(v, axis=-1)
    assert got.real.shape == (frames, c)
    np.testing.assert_allclose(got.real.numpy() + 1j * got.imag.numpy(), ref,
                               rtol=0, atol=1e-10)
