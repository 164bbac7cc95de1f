"""Hand-written CUDA kernels of the spectrum, spectrogram and FFT paths,
each beside its plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/fft_pallas.py``:

* K1 ``spectrum_onesided`` (``csrc/spectrum_onesided.cu``) replaces
  ``_spectrum_onesided_kernel`` + ``_onesided_body``: window -> FFT ->
  one-sided scaled amplitude, optionally phase, natural bin order. The
  real frame is packed into n/2 complex points and untangled
  (``csrc/onesided.cuh``). Its peak instance (:func:`spectrum_peak_cuda`)
  also writes each frame's peak by ``find_peak``'s rule and the frequency
  axis: ``spectrum()`` in one launch.
* K2 ``fft_rows`` (``csrc/fft_rows.cu``) replaces ``_fft2d_kernel``: a
  batched complex FFT over the last axis, natural order in and out, by the
  register-resident mixed-radix core (``csrc/fft_regs.cuh``) that K1, K3,
  K4 and K5 share; :func:`radix_plan` is its plan. Its turned instances
  (:func:`fft_rows_turned_cuda`) read or write the rows as the columns of
  a [B, n, m] array, the large FFT's natural order; its pieced instances
  (:func:`fft_rows_pieces_cuda`) read or write them in the pieces of the
  distributed FFT's all-to-all (:func:`to_pieces`).
* K3 ``spectrum_twosided`` (``csrc/spectrum_twosided.cu``) replaces
  ``_spectrum_kernel``: window -> DFT -> |X|/n over all n bins, for any
  n <= 128 and power-of-two n above; it serves ``sides="two"`` and the
  one-sided n <= 128 spectra of :func:`spectrum_amplitude_cuda`. Above 128
  points it is K1's packed real transform with a two-sided store (each
  magnitude written at k and n - k); up to 128, the complex core on a zero
  imaginary plane, or a direct DFT off the powers of two.
* K4 ``stft_onesided`` (``csrc/stft_onesided.cu``) replaces
  ``_stft_onesided_kernel``: K1 read straight from a signal at a hop, so a
  spectrogram never materialises its overlapping frames.
* K7 ``fft_cols`` (``csrc/fft_cols.cu``) replaces ``_fftcols_kernel``: a
  batched complex FFT over axis -2 of [B, n, m], natural row order in and
  out, with an optional twiddle folded into the output (forward) or the
  input (inverse), generated in the kernel (:class:`Twiddle`) or read
  from an (n, m) grid: a tile of whole columns held by a cluster of
  blocks, the register core's passes after the first on each block's
  share, the lanes of a warp across the columns. It is stage 1 of the
  large FFT (``ops/fft_big.py``) and the axis -2 route of ``ops.dispatch``.
  Its pieced instances (:func:`fft_cols_pieces_cuda`) store or load the
  rows in the pieces of the distributed FFT's all-to-all.

K1, K3 and K4 hold a whole frame in one block, which ends at n = 16384. A longer CUDA frame takes the route the JAX package takes in
effect: window -> ``ops.dispatch.fft`` (the large FFT, K7 then K2) -> |X|,
phase and scaling in PyTorch, with DC and Nyquist made real as K1 makes
them.

``fft_rows_steps``, ``spectrum_amp_phase_steps``,
``spectrum_twosided_steps`` and ``fft_cols_steps`` repeat the register
core's arithmetic step by step in PyTorch (thread, register and
shared-memory address included), ``spectrum_peak_steps`` K1's peak
reduction, and ``phase_steps`` and ``magnitude_steps`` the phase and the
magnitude K1, K3 and K4 compute without atan2f and sqrtf: the tests hold
them against the JAX package and float64 here and the kernels against
them on the card.

Each wrapper takes its plain version only because the tensor it was given
lies on the CPU. For a CUDA tensor it launches its kernel or raises; there
is no fallback. ``LAUNCHES`` counts kernel launches, one per launch and
nowhere else; it also holds the counts of K5a/K5b (``ops/conv_cuda.py``)
and K6 (``ops/pfb_cuda.py``).

Precision: "auto" and None (with the global policy at "auto") resolve to
"highest". "bf16x3" is accepted for API parity with the JAX package but
runs the same f32 kernels here; a tensor-core mode is later work.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.complex import is_power_of_two
from ..core.device import to_tensor
from ..core.fft import fft_axis0
from ..xform.fourier import bin_frequencies, bin_step, create_window, window_values
from . import _build

__all__ = [
    "LAUNCHES",
    "MAX_ROWS_N",
    "MAX_COLS_N",
    "MAX_DFT_N",
    "FRAMED_HOP_QUANTUM",
    "resolve_precision",
    "spectrum_amplitude_cuda",
    "spectrum_amplitude_plain",
    "spectrum_amp_phase_cuda",
    "spectrum_amp_phase_plain",
    "spectrum_peak_cuda",
    "spectrum_peak_plain",
    "spectrum_peak_steps",
    "spectrum_twosided_plain",
    "framed_spectrum_supported",
    "framed_spectrum_amplitude_cuda",
    "framed_spectrum_amp_phase_cuda",
    "framed_spectrum_amp_phase_plain",
    "fft_rows_cuda",
    "fft_rows_plain",
    "fft_rows_turned_cuda",
    "fft_rows_turned_plain",
    "turn_rows",
    "rows_per_block",
    "TURN_CLUSTER",
    "MIN_TURNED_N",
    "MAX_TURNED_N",
    "fft_rows_steps",
    "radix_plan",
    "points_per_thread",
    "pass_twiddles",
    "exchange_pad",
    "frame_exchange_at",
    "spectrum_amp_phase_steps",
    "phase_steps",
    "magnitude_steps",
    "PHASE_POLY",
    "spectrum_twosided_steps",
    "framed_spectrum_amp_phase_steps",
    "fft_cols_cuda",
    "fft_cols_plain",
    "fft_cols_steps",
    "cols_config",
    "cols_twiddle_steps",
    "Twiddle",
    "to_pieces",
    "from_pieces",
    "fft_cols_pieces_cuda",
    "fft_cols_pieces_plain",
    "fft_rows_pieces_cuda",
    "fft_rows_pieces_plain",
]

# A row of complex f32 must fit one block's shared memory (8*n bytes).
MAX_ROWS_N = 16384
# The sizes K2's turned and pieced instances take (kTurnMinLog2N,
# kTurnMaxLog2N in csrc/fft_rows.cu): 8 rows a block to n = 2048, 4 at 4096.
MIN_TURNED_N, MAX_TURNED_N = 256, 4096
# The column kernel's largest transform, the JAX package's bound
# (fft_pallas.py:791), kept as the contract: ops.fft_big splits by it.
MAX_COLS_N = 4096
# K7's tiles (columns a cluster holds: 64- or 128-byte row segments) and its
# blocks' threads (512: two blocks an SM; 1024: one).
COLS_TILES = (16, 32)
COLS_MIN_THREADS, COLS_MAX_THREADS = 512, 1024
# The (tile, cluster) K7 launches at each n (kLog2Tile, kLog2Cluster of
# csrc/fft_cols.cu): the fastest instance at [B, n, 2^20/n] with the twiddle
# on an H100 (PERF.md, PR 17).
COLS_CONFIG = {256: (32, 1), 512: (16, 1), 1024: (16, 1), 2048: (32, 8), 4096: (16, 4)}
# K3 takes any n up to this through a direct DFT, as the JAX package's
# dense-DFT route does (fft_pallas.py:1638-1641); above it, n must be a
# power of two, and one-sided spectra go to K1.
MAX_DFT_N = 128
# The widest butterfly a thread of the register core does in one pass.
MAX_RADIX = 16
# The framed kernel's hop contract, kept exactly as the JAX predicate
# (fft_pallas.py:1404-1409). It comes from the TPU's 128-lane tile; K4
# could take any hop, but the port does not widen the public contract.
FRAMED_HOP_QUANTUM = 128

LAUNCHES = {"spectrum_onesided": 0, "fft_rows": 0, "spectrum_twosided": 0,
            "stft_onesided": 0, "osconv": 0, "osconv_pair": 0, "pfb": 0,
            "fft_cols": 0}

_PRECISIONS = ("highest", "bf16x3")


def resolve_precision(precision: Optional[str]) -> str:
    """None -> the global policy (``ops.dispatch.set_fft_precision``);
    "auto" -> "highest". "bf16x3" runs the f32 kernels in this port."""
    if precision is None:
        from .dispatch import get_fft_precision

        precision = get_fft_precision()
    if precision == "auto":
        return "highest"
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return precision


# ── constant tables (numpy float64, rounded once to f32) ─────────────


def onesided_window(n: int, window: str) -> np.ndarray:
    """The f32 window row K1 multiplies in: bit-equal to the one the JAX
    plan ``_onesided_plan`` builds."""
    return window_values(window, n).reshape(1, n).astype(np.float32)


def _dft64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of -2*pi*m/n, m < n, in float64 (the Stockham twiddles'
    formula, extended to a whole turn)."""
    ang = -1.0 * 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.cos(ang), np.sin(ang)


def dft_table(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The n-entry table every kernel's twiddles come from, rounded once to
    f32. K3's direct DFT indexes all of it by (k*j) mod n; K1, K4 and K3
    read W_n^k, k < n/2, in the untangle; :func:`pass_twiddles` gathers the
    register core's passes from it."""
    c, s = _dft64(n)
    return c.astype(np.float32), s.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_tables(n: int, window: str, device: torch.device):
    """(cos, sin, window) on ``device``: :func:`dft_table` and the f32
    window row."""
    tabs = dft_table(n) + (onesided_window(n, window)[0],)
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


@functools.lru_cache(maxsize=32)
def _dft_matrices(n: int, dtype: torch.dtype, device: torch.device):
    """Dense [n, n] DFT matrices C[j, k], S[j, k] = (cos, sin)(-2*pi*jk/n),
    from the float64 table indexed by (j*k) mod n."""
    idx = np.outer(np.arange(n), np.arange(n)) % n
    return tuple(torch.from_numpy(t[idx]).to(device=device, dtype=dtype)
                 for t in _dft64(n))


# ── the register core: plan, pass tables, and its steps in PyTorch ───


def radix_plan(n: int) -> Tuple[int, ...]:
    """The radices of the self-sorting passes of an n-point transform
    (``csrc/fft_regs.cuh``), first pass first; their product is n, and
    none is wider than :func:`points_per_thread`. Passes of that width as
    long as it divides what is left, then the remainder: 1024 is
    (16, 16, 4), 4096 (16, 16, 16), 16384 (16, 16, 16, 4). The first pass
    multiplies by no twiddles, so it is a wide one; but below 512 points,
    where several rows share a warp and the exchange is not conflict-free
    either way, the remainder goes first (128 is (8, 16), which read faster
    on an H100 than (16, 8)). n < 16 is one pass of radix n; n = 1 has
    none."""
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    width, left, plan = points_per_thread(n), n, []
    while left > 1:
        plan.append(min(left, width))
        left //= plan[-1]
    return tuple(plan[::-1] if n < 512 else plan)


def points_per_thread(n: int) -> int:
    """Complex points a thread of the register core holds, which is also
    its widest radix: 16 (64 registers, so that even the 1024 threads of a
    16384-point row fit an SM); 4 from 16 to 64 points, so that a row
    still has 4 to 16 threads; the whole row below that. ``RowShape`` in
    csrc/fft_regs.cuh has the same rule."""
    return n if n < 16 else (4 if n < 128 else MAX_RADIX)


def plan_code(plan: Tuple[int, ...]) -> int:
    """The plan as the C launchers take it: log2 of pass p's radix in
    nibble p. The kernels are instantiated per size with these same codes
    (``FFT_PLANS`` in csrc/fft_regs.cuh) and refuse another."""
    return sum((r.bit_length() - 1) << (4 * p) for p, r in enumerate(plan))


@functools.lru_cache(maxsize=32)
def _plan_code_of(n: int) -> int:
    return plan_code(radix_plan(n))


def pass_twiddles(n: int, dtype=np.float32) -> np.ndarray:
    """The twiddles of :func:`radix_plan`'s passes, laid out as the kernel
    reads them: for each pass after the first (radix r, Ns = the product of
    the radices before it), (r - 1) * Ns pairs (cos, sin) of W_n^(t * k *
    n / (Ns * r)) at [(t - 1) * Ns + k], t = 1..r-1, k < Ns, so that the
    lanes of a warp (consecutive k) read consecutive pairs. The values are
    entries of the one float64 table of :func:`dft_table`, rounded once.
    Shape [L, 2], L >= 1 (a one-pass plan reads none)."""
    c, s = _dft64(n)
    rows = [np.zeros((1, 2))] if len(radix_plan(n)) < 2 else []
    ns = 1
    for r in radix_plan(n):
        if ns > 1:
            idx = (np.arange(1, r)[:, None] * np.arange(ns)[None, :]
                   * (n // (ns * r))).reshape(-1)
            rows.append(np.stack([c[idx], s[idx]], axis=-1))
        ns *= r
    return np.concatenate(rows).astype(dtype)


@functools.lru_cache(maxsize=32)
def _device_pass_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pass_twiddles(n)).to(device)


def exchange_pad(a):
    """Where word ``a`` of a row lies in the shared-memory exchange: one
    spare word after every 32. A pass's loads (consecutive words) and the
    first pass's stores (stride 16) touch 32 different banks; the second
    pass's stores (two runs of 16 words) are a 2-way conflict."""
    return exchange_at(a)


def exchange_at(a, log2w: int = 0, padshift: int = 5):
    """``exchange_at`` of csrc/fft_regs.cuh: where point ``a`` of a
    transform lies in its exchange, in words from its point 0, when points
    are ``2**log2w`` words apart with one spare point after every
    ``2**padshift``. The row kernels are (0, 5), :func:`exchange_pad`; K7's
    [row][column] tile is (log2 of its columns, :func:`cols_pad_shift`)."""
    return (a + (a >> padshift)) << log2w


# The one-sided body's exchange (csrc/onesided.cuh, the register core's
# PAIR layout): a frame's points as (re, im) pairs, one spare pair after
# every 16 points.
FRAME_PAD_SHIFT = 4


def frame_exchange_at(a):
    """``frame_at`` of csrc/onesided.cuh: where point ``a`` of a frame's
    n/2 points lies in its exchange, in 8-byte (re, im) pairs from its point
    0. An 8-byte warp access is served in two phases of 16 lanes, and 16
    consecutive points from a multiple of 16 (every reload), or 16 points
    16 apart (the first pass's store), fall on 16 different bank pairs."""
    return exchange_at(a, 0, FRAME_PAD_SHIFT)


def _w16(e: int, dtype: torch.dtype) -> Tuple[float, float]:
    """(cos, sin) of -2*pi*e/16, rounded once from float64 to ``dtype``."""
    w = np.exp(-2j * np.pi * e / 16)
    cast = np.float32 if dtype == torch.float32 else np.float64
    return float(cast(w.real)), float(cast(w.imag))


def _bit_reverse(t: int, bits: int) -> int:
    return int(format(t, f"0{bits}b")[::-1], 2) if bits else 0


def _butterflies_steps(xr: list, xi: list, radix: int) -> None:
    """R/radix in-register DFTs of ``radix`` points, on registers
    u + t*M (M = R/radix): decimation-in-frequency radix-2 stages with the
    constants W_16^e, then the bit-reversed positions renamed to natural
    order, as ``butterflies`` of fft_regs.cuh does."""
    m = len(xr) // radix
    bits = radix.bit_length() - 1
    dtype = xr[0].dtype
    for u in range(m):
        for stage in range(bits):
            h = (radix // 2) >> stage
            for t in range(radix):
                if t & h:
                    continue
                a, b = u + t * m, u + (t + h) * m
                dr, di = xr[a] - xr[b], xi[a] - xi[b]
                xr[a], xi[a] = xr[a] + xr[b], xi[a] + xi[b]
                e = (t & (h - 1)) * (8 // h)
                if e == 0:
                    xr[b], xi[b] = dr, di
                elif e == 4:                       # times -i
                    xr[b], xi[b] = di, -dr
                else:
                    c, s = _w16(e, dtype)
                    xr[b], xi[b] = dr * c - di * s, dr * s + di * c
        nat = [(xr[u + _bit_reverse(t, bits) * m], xi[u + _bit_reverse(t, bits) * m])
               for t in range(radix)]
        for t in range(radix):
            xr[u + t * m], xi[u + t * m] = nat[t]


def _fft_regs_steps(xr: list, xi: list, n: int, tw: torch.Tensor, at=exchange_pad) -> None:
    """The register core on R = len(xr) registers of [B, T] lanes
    (T = n/R threads a row; register q of thread tid holds point
    tid + T*q, before and after): the passes of :func:`radix_plan`, each a
    twiddle multiply, the in-register butterflies and, but for the last,
    one exchange through a padded row of shared memory, point a at
    ``at(a)``: :func:`exchange_pad` in the planes of the row kernels,
    :func:`frame_exchange_at` in the pairs of the one-sided body."""
    regs = len(xr)
    lanes = n // regs
    dev = xr[0].device
    tid = torch.arange(lanes, device=dev)
    lead, words = xr[0].shape[:-1], at(n)
    plan = radix_plan(n)
    ns, off = 1, 0
    for p, r in enumerate(plan):
        m = regs // r
        if ns > 1:
            for u in range(m):
                k = (tid + u * lanes) & (ns - 1)
                for t in range(1, r):
                    c, s = tw[off + (t - 1) * ns + k].unbind(-1)
                    q = u + t * m
                    xr[q], xi[q] = xr[q] * c - xi[q] * s, xr[q] * s + xi[q] * c
            off += (r - 1) * ns
        _butterflies_steps(xr, xi, r)
        if p + 1 < len(plan):
            sre = torch.empty(lead + (words,), dtype=xr[0].dtype, device=dev)
            sim = torch.empty_like(sre)
            for u in range(m):
                j = tid + u * lanes
                base = (j // ns) * ns * r + (j & (ns - 1))
                for t in range(r):
                    a = at(base + t * ns)
                    sre[..., a], sim[..., a] = xr[u + t * m], xi[u + t * m]
            for q in range(regs):
                a = at(tid + lanes * q)
                xr[q], xi[q] = sre[..., a], sim[..., a]
        ns *= r


def fft_rows_steps(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's arithmetic step by step in PyTorch, for the tests: what
    ``csrc/fft_rows.cu`` does to [B, n] planes, thread index, register
    number and shared-memory address included. The inverse is the forward
    transform of the swapped planes, swapped back and scaled by 1/n."""
    n = re.shape[-1]
    if n == 1:
        return re.clone(), im.clone()
    if inverse:
        re, im = im, re
    regs = points_per_thread(n)
    lanes = n // regs
    tid = torch.arange(lanes, device=re.device)
    xr = [re[..., tid + lanes * q] for q in range(regs)]
    xi = [im[..., tid + lanes * q] for q in range(regs)]
    tw = torch.from_numpy(pass_twiddles(
        n, np.float32 if re.dtype == torch.float32 else np.float64)).to(re)
    _fft_regs_steps(xr, xi, n, tw)
    scale = 1.0 / n if inverse else 1.0
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    for q in range(regs):
        ore[..., tid + lanes * q] = xr[q] * scale
        oim[..., tid + lanes * q] = xi[q] * scale
    return (oim, ore) if inverse else (ore, oim)


def _packed_real_bins_steps(x: torch.Tensor, n: int, window: str):
    """The per-frame body of ``csrc/onesided.cuh`` up to its stores, step by
    step: the windowed real frame [B, n] packed as z[j] = xw[2j] +
    i*xw[2j+1], the register core at n/2 points (its exchange in pairs),
    then the untangle of the bins in pairs (k, n/2 - k), 0 < k < n/4: thread
    tid's registers q >= R/2 (Z[n/4 ..]) go to the exchange at k - n/4, and
    thread tid takes k = tid + T*q, q < R/2, with Z[n/2 - k] from there:
    (sr + a, si - b) at k and (sr - a, -si - b) at n/2 - k, with sr, si, dr,
    di = Z[k] +- conj Z[n/2-k] and a = c*di + s*dr, b = c*dr - s*di,
    W_n^k = (c, s); bin n/4 (Z[n/4] its own partner) by the one-bin formula.
    The exchange holds Z[k'] at n/2 - k', where bin k reads it at k.
    Returns (re, im) over bins 0..n/2 as the kernel holds them: 2*X[k]
    between the edges; DC = Re Z[0] + Im Z[0] and Nyquist = Re Z[0] -
    Im Z[0], unscaled, with imaginary part +0.0."""
    half = n // 2
    quarter = half // 2
    regs = points_per_thread(half)
    up = regs // 2
    lanes = half // regs
    tid = torch.arange(lanes, device=x.device)
    xw = x * create_window(window, n, dtype=x.dtype, device=x.device)
    xr = [xw[..., 2 * (tid + lanes * q)] for q in range(regs)]
    xi = [xw[..., 2 * (tid + lanes * q) + 1] for q in range(regs)]
    cast = np.float32 if x.dtype == torch.float32 else np.float64
    _fft_regs_steps(xr, xi, half, torch.from_numpy(pass_twiddles(half, cast)).to(x),
                    at=frame_exchange_at)
    zr = torch.empty(x.shape[:-1] + (frame_exchange_at(quarter) + 1,), dtype=x.dtype,
                     device=x.device)
    zi = torch.empty_like(zr)
    for q in range(up, regs):
        a = frame_exchange_at(half - (tid + lanes * q))
        zr[..., a], zi[..., a] = xr[q], xi[q]
    wc, ws = (torch.from_numpy(t.astype(cast)).to(x.device) for t in _dft64(n))
    re2 = torch.empty(x.shape[:-1] + (half + 1,), dtype=x.dtype, device=x.device)
    im2 = torch.empty_like(re2)
    for q in range(up):
        k = tid + lanes * q
        a = frame_exchange_at(k)                              # k = 0 reads nothing
        pr, pi = zr[..., a], zi[..., a]
        sr, si = xr[q] + pr, xi[q] - pi
        dr, di = xr[q] - pr, xi[q] + pi
        c, s = wc[k], ws[k]
        pa, pb = c * di + s * dr, c * dr - s * di
        re2[..., k], im2[..., k] = sr + pa, si - pb
        re2[..., half - k], im2[..., half - k] = sr - pa, -si - pb
    zr0, zi0 = xr[up][..., 0], xi[up][..., 0]      # Z[n/4], thread 0's register R/2
    c, s = wc[quarter], ws[quarter]
    sr, si, dr, di = zr0 + zr0, zi0 - zi0, zr0 - zr0, zi0 + zi0
    re2[..., quarter] = sr + (c * di + s * dr)
    im2[..., quarter] = si - (c * dr - s * di)
    # k = 0 pairs Z[0] with itself: both edge bins are exactly real
    re2[..., 0] = xr[0][..., 0] + xi[0][..., 0]
    re2[..., half] = xr[0][..., 0] - xi[0][..., 0]
    im2[..., 0] = 0.0
    im2[..., half] = 0.0
    return re2, im2


# phase_of's polynomial in csrc/onesided.cuh, highest power first: atan(a)
# = a*P(a^2) on [0, 1], the minimax fit of degree 8 (relative error 1.7e-8).
PHASE_POLY = (0.002903554, -0.016283017, 0.043039385, -0.07533678, 0.10654679,
              -0.14207134, 0.19993055, -0.33333093, 1.0)


def phase_steps(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``phase_of`` of csrc/onesided.cuh (the phase K1, K4 write) step by
    step in float32: the ratio of the smaller to the larger magnitude (both
    scaled by 2^64 below 2^-64, its reciprocal rounded once, where the
    card's rcp.approx is within 1 ulp), :data:`PHASE_POLY` by fused
    multiply-adds (each rounded once, from float64), the octant's
    reflections, y's sign; a NaN in gives a NaN."""
    y, x = y.float(), x.float()
    ax, ay = x.abs(), y.abs()
    up = torch.where(torch.fmax(ax, ay) < 2.0 ** -64, 2.0 ** 64, 1.0).float()
    big, small = torch.fmax(ax, ay) * up, torch.fmin(ax, ay) * up
    a = torch.where(small == big, 1.0, small * (1.0 / big))
    a = torch.where(big == 0.0, 0.0, a)
    s = (a * a).double()
    p = torch.full_like(a, PHASE_POLY[0])
    for c in PHASE_POLY[1:]:
        p = (p.double() * s + c).float()
    r = a * p
    r = torch.where(ay > ax, np.float32(np.pi / 2) - r, r)
    r = torch.where(torch.signbit(x), np.float32(np.pi) - r, r)
    r = torch.copysign(r, y)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, r)


def magnitude_steps(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``magnitude`` of csrc/onesided.cuh (the amplitude K1, K3, K4 write,
    before their scale) step by step in float32: v = re^2 + im^2 with one
    fused multiply-add, the reciprocal square root rounded once (the card's
    rsqrt.approx is within about 1 ulp of it), then one Newton step on the
    root, q + (v - q^2)*r/2, each fused multiply-add rounded once (from
    float64); 0 and infinity as they are, a NaN stays a NaN."""
    re, im = re.float(), im.float()
    v = (re.double() * re.double() + (im * im).double()).float()
    r = torch.rsqrt(v.double()).float()
    q = v * r
    e = (-(q.double() * q.double()) + v.double()).float()
    root = (e.double() * (0.5 * r).double() + q.double()).float()
    return torch.where((v == 0.0) | torch.isinf(v), v, root)


def spectrum_amp_phase_steps(x: torch.Tensor, n: int, window: str,
                             with_phase: bool = True, parts: bool = False):
    """K1's and K4's per-frame arithmetic step by step in PyTorch, for the
    tests (``csrc/onesided.cuh`` with its one-sided store): the packed real
    transform of :func:`_packed_real_bins_steps`, every bin scaled by 1/n
    (the untangle gives 2*X between the edges), the magnitude and the phase
    by the kernels' formulas (:func:`magnitude_steps`, :func:`phase_steps`)
    in float32 and, in float64, where those float32 formulas would be the
    whole error, by sqrt and atan2. ``parts=True`` returns the unscaled
    bins (re, im) of X instead of (amplitude, phase)."""
    half = n // 2
    re2, im2 = _packed_real_bins_steps(x, n, window)
    if parts:
        re2[..., 1:half] *= 0.5
        im2[..., 1:half] *= 0.5
        return re2, im2
    mag = (magnitude_steps(re2, im2) if re2.dtype == torch.float32
           else torch.sqrt(re2 * re2 + im2 * im2))
    amp = mag * (1.0 / n)
    amp[..., 0] = re2[..., 0].abs() * (1.0 / n)
    amp[..., half] = re2[..., half].abs() * (1.0 / n)
    if not with_phase:
        return amp, None
    if re2.dtype == torch.float32:
        return amp, phase_steps(im2, re2)
    return amp, torch.atan2(im2, re2)


def spectrum_twosided_steps(x: torch.Tensor, n: int, window: str) -> torch.Tensor:
    """K3's arithmetic step by step in PyTorch, for the tests
    (``csrc/spectrum_twosided.cu``), [B, n] -> [B, n]. A power-of-two n
    above 128: the packed real transform of K1 with the two-sided store,
    |X|/n at the edges, (0.5/n)*|2X| between them, written at k and at
    n - k. A power-of-two n up to 128: the register core on the windowed
    row with a zero imaginary plane, then |X|/n. Any other n: the direct
    DFT, which :func:`spectrum_twosided_plain` already is."""
    if not is_power_of_two(n):
        return spectrum_twosided_plain(x, n, window)
    if n <= MAX_DFT_N:
        xw = x * create_window(window, n, dtype=x.dtype, device=x.device)
        re, im = fft_rows_steps(xw, torch.zeros_like(xw))
        return torch.sqrt(re * re + im * im) * (1.0 / n)
    half = n // 2
    re2, im2 = _packed_real_bins_steps(x, n, window)
    amp = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    mag = (magnitude_steps(re2, im2) if re2.dtype == torch.float32
           else torch.sqrt(re2 * re2 + im2 * im2))
    inner = mag[..., 1:half] * (0.5 / n)
    amp[..., 1:half] = inner
    amp[..., half + 1:] = inner.flip(-1)
    amp[..., 0] = re2[..., 0].abs() * (1.0 / n)
    amp[..., half] = re2[..., half].abs() * (1.0 / n)
    return amp


def framed_spectrum_amp_phase_steps(x: torch.Tensor, n: int, hop: int,
                                    window: str, with_phase: bool = True):
    """K4's arithmetic step by step: frames at f*hop of a [B, L] signal,
    then :func:`spectrum_amp_phase_steps`."""
    frames = x.unfold(-1, n, hop)
    amp, ph = spectrum_amp_phase_steps(frames.reshape(-1, n), n, window,
                                       with_phase)
    out_shape = frames.shape[:-1] + (n // 2 + 1,)
    return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)


# ── K1: one-sided spectrum ───────────────────────────────────────────


def spectrum_amp_phase_plain(x: torch.Tensor, n: int, window: str,
                             with_phase: bool = True):
    """K1's plain version: window -> Stockham FFT -> hypot -> one-sided
    scaling (DC and Nyquist /n, others 2/n) -> atan2, on [B, n] frames.
    DC and Nyquist are made exactly real, as the kernel makes them."""
    xw = (x * create_window(window, n, dtype=x.dtype, device=x.device)).T
    re, im = fft_axis0(xw, torch.zeros_like(xw))
    return _onesided_from_bins(re.T, im.T, n, with_phase)


def _onesided_from_bins(re: torch.Tensor, im: torch.Tensor, n: int,
                        with_phase: bool):
    """Bins [..., n] of a real frame's FFT -> (one-sided scaled amplitude,
    phase or None), DC and Nyquist made exactly real."""
    bins = n // 2 + 1
    re = re[..., :bins]
    im = im[..., :bins].clone()
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    amp = torch.hypot(re, im) * (2.0 / n)
    amp[..., 0] *= 0.5  # exact: DC and Nyquist are scaled by 1/n
    amp[..., -1] *= 0.5
    return (amp, torch.atan2(im, re)) if with_phase else (amp, None)


def _long_frame_fft(x: torch.Tensor, n: int, window: str):
    """The FFT of windowed CUDA float32 frames [B, n] too long for one
    block (n > MAX_ROWS_N), through ``ops.dispatch``. The windowed copy is
    dead after the transform, so it is donated."""
    from .dispatch import fft as _fft

    if x.dtype != torch.float32:
        raise TypeError(f"the spectrum kernels take float32, got {x.dtype}")
    return _fft(x * _device_tables(n, window, x.device)[2], donate=True)


def _launch_spectrum_onesided(x: torch.Tensor, n: int, window: str,
                              with_phase: bool):
    if n > MAX_ROWS_N:
        spec = _long_frame_fft(x, n, window)
        return _onesided_from_bins(spec.real, spec.imag, n, with_phase)
    if x.dtype != torch.float32:
        raise TypeError(f"the one-sided spectrum kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    batch = x.shape[0]
    amp = torch.empty((batch, n // 2 + 1), dtype=torch.float32, device=x.device)
    ph = torch.empty_like(amp) if with_phase else None
    if batch == 0:
        return amp, ph
    lib = _build.library()
    twc, tws, win = _device_tables(n, window, x.device)
    tw = _device_pass_twiddles(n // 2, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.spectrum_onesided_f32(
            x.data_ptr(), win.data_ptr(), amp.data_ptr(),
            ph.data_ptr() if with_phase else None,
            twc.data_ptr(), tws.data_ptr(), tw.data_ptr(),
            _plan_code_of(n // 2), batch, n, stream)
    _build.check(lib, code, "spectrum_onesided")
    LAUNCHES["spectrum_onesided"] += 1
    return amp, ph


def _onesided(x: torch.Tensor, n: int, window: str, with_phase: bool):
    shape = x.shape
    frames = x.reshape(-1, n)
    if frames.is_cuda:
        amp, ph = _launch_spectrum_onesided(frames, n, window, with_phase)
    else:
        amp, ph = spectrum_amp_phase_plain(frames, n, window, with_phase)
    out_shape = shape[:-1] + (n // 2 + 1,)
    return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)


def _frames_of(x, n: int, precision: Optional[str]) -> torch.Tensor:
    resolve_precision(precision)
    x = to_tensor(x)
    if x.shape[-1] != n:
        raise ValueError(f"frame length {x.shape[-1]} != n {n}")
    return x


def _amplitude_frames(x, n: int, precision: Optional[str]) -> torch.Tensor:
    x = _frames_of(x, n, precision)
    if n > MAX_DFT_N and not is_power_of_two(n):
        # Above the direct-DFT bound only power-of-two sizes are covered.
        raise ValueError(f"spectrum size must be a power of two, got {n}")
    return x


def _fold_one_sided(amp: torch.Tensor, n: int) -> torch.Tensor:
    """K3's all-bin |X|/n -> bins 0..n//2, every bin but DC and (even n)
    Nyquist doubled (fft_pallas.py:1646-1661)."""
    bins = n // 2 + 1
    double = torch.full((bins,), 2.0, dtype=amp.dtype, device=amp.device)
    double[0] = 1.0
    if n % 2 == 0:
        double[n // 2] = 1.0
    return amp[..., :bins] * double


def spectrum_amplitude_cuda(x, n: int, window: str = "rect",
                            sides: str = "one",
                            precision: Optional[str] = None) -> torch.Tensor:
    """Fused amplitude spectrum of real frames [batch..., n]: [..., n//2+1]
    one-sided (DC and, for even n, Nyquist /n; other bins 2/n), or
    [..., n] two-sided (all bins /n) for ``sides="two"``
    (reference src/public/spectrum.ts:45-72).

    The routes of spectrum_amplitude_pallas: one-sided power-of-two n > 128
    runs K1; sides="two" and any n <= 128 (power of two or not) run K3.
    Above 128, n must be a power of two (ValueError otherwise); on CUDA,
    float32 only, and n > 16384 runs window -> ``ops.dispatch.fft`` -> |X|
    -> the same scaling. A CPU tensor runs :func:`spectrum_amplitude_plain`.
    """
    x = _amplitude_frames(x, n, precision)
    if not x.is_cuda:
        return spectrum_amplitude_plain(x, n, window, sides)
    if sides == "one" and n > MAX_DFT_N:
        return _onesided(x, n, window, False)[0]
    amp = _launch_spectrum_twosided(x.reshape(-1, n), n, window).reshape(x.shape)
    return amp if sides == "two" else _fold_one_sided(amp, n)


def spectrum_amplitude_plain(x, n: int, window: str = "rect",
                             sides: str = "one") -> torch.Tensor:
    """:func:`spectrum_amplitude_cuda`'s routes on the plain versions of K1
    and K3, in the input's dtype: the CPU path and the card's checks."""
    x = _amplitude_frames(x, n, None)
    if sides == "one" and n > MAX_DFT_N:
        amp = spectrum_amp_phase_plain(x.reshape(-1, n), n, window, False)[0]
        return amp.reshape(x.shape[:-1] + (n // 2 + 1,))
    amp = spectrum_twosided_plain(x.reshape(-1, n), n, window).reshape(x.shape)
    return amp if sides == "two" else _fold_one_sided(amp, n)


def spectrum_amp_phase_cuda(x, n: int, window: str = "rect",
                            precision: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused one-sided amplitude and phase of real frames [batch..., n] in
    one kernel: (amplitude, phase), both [..., n//2+1], natural bin order.
    Phase is atan2(im, re) of the unnormalised FFT; DC and Nyquist phase is
    exactly 0 or +pi. Needs a power-of-two n > 128 (ValueError otherwise,
    as in the JAX package)."""
    x = _frames_of(x, n, precision)
    if n <= MAX_DFT_N or not is_power_of_two(n):
        raise ValueError(
            f"fused amp+phase needs a power-of-two n > {MAX_DFT_N}, got {n}")
    return _onesided(x, n, window, with_phase=True)


# ── K1's peak instance: spectrum() in one launch ─────────────────────


def _with_peak(amp: torch.Tensor, ph: torch.Tensor, n: int, sample_rate: float):
    """The frequency axis and ``find_peak``'s fields of one-sided bins
    [B, n//2+1] in their dtype: (frequencies, amp, ph, index, frequency,
    peak amplitude, peak phase)."""
    from ..public.spectrum import find_peak

    freqs = bin_frequencies(n, sample_rate, "one", dtype=amp.dtype, device=amp.device)
    peak = find_peak(amp, freqs)
    peak_ph = torch.take_along_dim(ph, peak.index[..., None], dim=-1)[..., 0]
    return freqs, amp, ph, peak.index, peak.frequency, peak.amplitude, peak_ph


def spectrum_peak_plain(x: torch.Tensor, n: int, window: str, sample_rate: float):
    """The peak instance's plain version on [B, n] frames, in the input's
    dtype: :func:`spectrum_amp_phase_plain`, then ``find_peak`` over its
    amplitude, ``bin_frequencies`` and the phase at the peak. The CPU path
    and the card's checks."""
    amp, ph = spectrum_amp_phase_plain(x, n, window)
    return _with_peak(amp, ph, n, sample_rate)


def _peak_beats(av, ak, bv, bk):
    """``peak_beats`` of csrc/onesided.cuh on tensors: (isnan, value,
    -index) of a greater than b's."""
    an, bn = torch.isnan(av), torch.isnan(bv)
    return torch.where(an != bn, an, torch.where(~an & (av != bv), av > bv, ak < bk))


def spectrum_peak_steps(amplitude: torch.Tensor, phase: torch.Tensor, n: int,
                        sample_rate: float):
    """K1's peak reduction step by step in PyTorch, for the tests: the
    amplitudes [B, n//2+1] as the kernel's threads hold them (T = n/32 a
    frame; thread t holds bins k = t + T*q, q < 8, and n/2 - k, the
    untangle's pairs, thread 0 also n/4; thread 0 hands Nyquist over first
    and keeps DC apart). Each thread's runs in its order: a strict > from
    -inf over its bins below n/4 (increasing) and a >= over its bins from
    n/4 up (decreasing) keep their first largest bin, the high run's
    winner taking the low one's only where larger; a sum flags a NaN, and a
    thread whose sum is NaN takes its first NaN (Nyquist last); then the
    xor tree over the lanes of a warp (the frame's T lanes where T < 32),
    the warps of a frame in order, and DC against the non-DC winner, all by
    ``peak_beats``. Any values, negative ones too. Returns (index,
    frequency, amplitude, phase) at the peak, as the kernel writes them."""
    half = n // 2
    quarter = half // 2
    regs = points_per_thread(half)
    up = regs // 2
    lanes = half // regs
    lead = amplitude.shape[:-1]
    dev = amplitude.device
    tid = torch.arange(lanes, device=dev)
    first = tid == 0
    sentinel = torch.full(lead + (lanes,), 2 ** 31 - 1, device=dev)
    m = torch.full(lead + (lanes,), -float("inf"), dtype=amplitude.dtype, device=dev)
    k, hm, hk = sentinel.clone(), m.clone(), sentinel.clone()
    nyq = torch.where(first, amplitude[..., half:half + 1], m)
    total = torch.where(first, nyq, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    for q in range(up):
        low = tid + lanes * q
        high = half - low
        cv, hv = amplitude[..., low], amplitude[..., high]
        take, htake = cv > m, hv >= hm
        if q == 0:                       # thread 0's DC is kept apart, Nyquist too
            take, htake = take & ~first, htake & ~first
            cv, hv = torch.where(first, zero, cv), torch.where(first, zero, hv)
        total = total + cv + hv
        m, k = torch.where(take, cv, m), torch.where(take, low, k)
        hm, hk = torch.where(htake, hv, hm), torch.where(htake, high, hk)
    qv = torch.where(first, amplitude[..., quarter:quarter + 1], zero)    # thread 0's n/4
    total = total + qv
    htake = first & (qv >= hm)
    hm, hk = torch.where(htake, qv, hm), torch.where(htake, quarter, hk)
    later = hm > m
    v, k = torch.where(later, hm, m), torch.where(later, hk, k)
    pos = torch.fmax(v, nyq) > 0
    later = nyq > v
    v, k = torch.where(later, nyq, v), torch.where(later, half, k)
    # a thread whose sum is NaN: its first NaN bin, Nyquist last
    nan_first = torch.where(torch.isnan(nyq), half, sentinel)
    for q in range(up):
        bins = half - tid - lanes * q
        hit = torch.isnan(amplitude[..., bins]) & (bins != half)
        nan_first = torch.where(hit, bins, nan_first)
    hit = first & torch.isnan(amplitude[..., quarter:quarter + 1])
    nan_first = torch.where(hit, quarter, nan_first)
    for q in reversed(range(up)):
        bins = tid + lanes * q
        hit = torch.isnan(amplitude[..., bins]) & (bins != 0)
        nan_first = torch.where(hit, bins, nan_first)
    rescan = torch.isnan(total) & (nan_first != sentinel)
    k = torch.where(rescan, nan_first, k)
    v = torch.where(rescan, torch.take_along_dim(
        amplitude, nan_first.clamp(max=half), dim=-1), v)
    width = min(lanes, 32)
    o = width // 2
    while o:
        partner = tid ^ o
        ov, ok, opos = v[..., partner], k[..., partner], pos[..., partner]
        win = _peak_beats(ov, ok, v, k)
        v, k, pos = torch.where(win, ov, v), torch.where(win, ok, k), pos | opos
        o //= 2
    rv, rk, rpos = v[..., 0], k[..., 0], pos[..., 0]
    for w in range(1, lanes // width):   # a frame's warps through shared memory
        wv, wk = v[..., w * width], k[..., w * width]
        win = _peak_beats(wv, wk, rv, rk)
        rv, rk, rpos = torch.where(win, wv, rv), torch.where(win, wk, rk), rpos | pos[..., w * width]
    dc = amplitude[..., 0]
    non_dc = rpos | _peak_beats(rv, rk, dc, torch.zeros_like(rk))
    index = torch.where(non_dc, rk, torch.zeros_like(rk))
    freq = (index.to(torch.float64) * bin_step(n, sample_rate)).to(amplitude.dtype)
    peak_ph = torch.take_along_dim(phase, index[..., None], dim=-1)[..., 0]
    return index, freq, torch.where(non_dc, rv, dc), peak_ph


def _launch_spectrum_peak(x: torch.Tensor, n: int, window: str, sample_rate: float):
    """One launch of K1's peak instance on [B, n] frames. At bench.py's
    [16384, 1024] the host's work a call is as long as the kernel on an
    H100, so the float outputs are views of one allocation, and the device
    is switched only where the frames lie on another than the current one."""
    step = bin_step(n, sample_rate)
    if x.dtype != torch.float32:
        raise TypeError(f"the one-sided spectrum kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    batch, bins = x.shape[0], n // 2 + 1
    if batch == 0:
        amp = x.new_empty((0, bins))
        return _with_peak(amp, torch.empty_like(amp), n, sample_rate)
    amp, ph, freqs, peak_freq, peak_amp, peak_ph = torch.empty(
        2 * batch * bins + bins + 3 * batch, dtype=torch.float32, device=x.device,
    ).split((batch * bins, batch * bins, bins, batch, batch, batch))
    amp, ph = amp.view(batch, bins), ph.view(batch, bins)
    index = torch.empty(batch, dtype=torch.int64, device=x.device)
    lib = _build.library()
    twc, tws, win = _device_tables(n, window, x.device)
    tw = _device_pass_twiddles(n // 2, x.device)
    with _on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.spectrum_onesided_peak_f32(
            x.data_ptr(), win.data_ptr(), amp.data_ptr(), ph.data_ptr(),
            freqs.data_ptr(), index.data_ptr(), peak_freq.data_ptr(),
            peak_amp.data_ptr(), peak_ph.data_ptr(), twc.data_ptr(), tws.data_ptr(),
            tw.data_ptr(), _plan_code_of(n // 2), batch, n, step, stream)
    _build.check(lib, code, "spectrum_onesided")
    LAUNCHES["spectrum_onesided"] += 1
    return freqs, amp, ph, index, peak_freq, peak_amp, peak_ph


def spectrum_peak_cuda(x, n: int, window: str = "rect", sample_rate: float = 1.0,
                       precision: Optional[str] = None):
    """``spectrum()``'s one-sided result of real frames [batch..., n]:
    (frequencies [n//2+1], amplitude and phase [..., n//2+1], and the peak's
    index (int64), frequency, amplitude and phase [...]), by the rules of
    :func:`spectrum_amp_phase_cuda`, ``find_peak`` and ``bin_frequencies``.
    On CUDA, float32 with n = 256 .. 16384 is one launch of K1's peak
    instance; a longer frame takes K1's long-frame route and ``find_peak``;
    a CPU tensor runs :func:`spectrum_peak_plain`. Needs a power-of-two
    n > 128 (ValueError otherwise)."""
    x = _frames_of(x, n, precision)
    if n <= MAX_DFT_N or not is_power_of_two(n):
        raise ValueError(
            f"the fused peak spectrum needs a power-of-two n > {MAX_DFT_N}, got {n}")
    lead = x.shape[:-1]
    frames = x.reshape(-1, n)
    if not frames.is_cuda:
        out = spectrum_peak_plain(frames, n, window, sample_rate)
    elif n > MAX_ROWS_N:
        out = _with_peak(*_launch_spectrum_onesided(frames, n, window, True), n,
                         sample_rate)
    else:
        out = _launch_spectrum_peak(frames, n, window, sample_rate)
    if x.dim() == 2:
        return out
    freqs, amp, ph, *peak = out
    bins = lead + (n // 2 + 1,)
    return (freqs, amp.reshape(bins), ph.reshape(bins),
            *(p.reshape(lead) for p in peak))


# ── K3: two-sided amplitude ──────────────────────────────────────────


def spectrum_twosided_plain(x: torch.Tensor, n: int, window: str) -> torch.Tensor:
    """K3's plain version: window -> Stockham FFT (power-of-two n) or a
    dense DFT matmul (other n) -> hypot -> /n, all n bins of [B, n]."""
    xw = x * create_window(window, n, dtype=x.dtype, device=x.device)
    if is_power_of_two(n):
        re, im = fft_axis0(xw.T, torch.zeros_like(xw.T))
        re, im = re.T, im.T
    else:
        c, s = _dft_matrices(n, x.dtype, x.device)
        re, im = xw @ c, xw @ s
    return torch.hypot(re, im) * (1.0 / n)


def _launch_spectrum_twosided(x: torch.Tensor, n: int, window: str):
    if n > MAX_ROWS_N:
        spec = _long_frame_fft(x, n, window)
        return torch.hypot(spec.real, spec.imag) * (1.0 / n)
    if x.dtype != torch.float32:
        raise TypeError(f"the two-sided spectrum kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    batch = x.shape[0]
    amp = torch.empty((batch, n), dtype=torch.float32, device=x.device)
    if batch == 0:
        return amp
    lib = _build.library()
    cos, sin, win = _device_tables(n, window, x.device)
    # A power-of-two n runs the register core: at n/2 points on the packed
    # frame above 128 points, at n points up to it.
    points = None if not is_power_of_two(n) else (n // 2 if n > MAX_DFT_N else n)
    tw = None if points is None else _device_pass_twiddles(points, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.spectrum_twosided_f32(
            x.data_ptr(), win.data_ptr(), amp.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), None if tw is None else tw.data_ptr(),
            0 if points is None else _plan_code_of(points), batch, n, stream)
    _build.check(lib, code, "spectrum_twosided")
    LAUNCHES["spectrum_twosided"] += 1
    return amp


# ── K4: framed one-sided spectrogram ─────────────────────────────────


def framed_spectrum_supported(n: int, hop: int, sides: str = "one") -> bool:
    """True when the framed (signal-in) kernel covers this (n, hop, sides):
    one-sided, power-of-two n > 128, hop a multiple of 128 that divides n.
    The same predicate as the JAX package's."""
    return (sides == "one" and n > MAX_DFT_N and is_power_of_two(n)
            and hop % FRAMED_HOP_QUANTUM == 0 and hop <= n and n % hop == 0)


def framed_spectrum_amp_phase_plain(x: torch.Tensor, n: int, hop: int,
                                    window: str, with_phase: bool = True):
    """K4's plain version: frames ``x.unfold`` of a [B, L] signal, then
    K1's plain version; ([B, F, n//2+1], phase or None)."""
    frames = x.unfold(-1, n, hop)
    amp, ph = spectrum_amp_phase_plain(frames.reshape(-1, n), n, window,
                                       with_phase)
    out_shape = frames.shape[:-1] + (n // 2 + 1,)
    return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)


def _launch_stft_onesided(x: torch.Tensor, n: int, hop: int, window: str,
                          with_phase: bool):
    if n > MAX_ROWS_N:
        # No block holds such a frame: materialise the frames and take the
        # long-frame route of K1.
        frames = x.unfold(-1, n, hop)
        amp, ph = _launch_spectrum_onesided(frames.reshape(-1, n), n, window,
                                            with_phase)
        out_shape = frames.shape[:-1] + (n // 2 + 1,)
        return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)
    if x.dtype != torch.float32:
        raise TypeError(f"the framed spectrum kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    batch, length = x.shape
    frames = 1 + (length - n) // hop
    amp = torch.empty((batch, frames, n // 2 + 1), dtype=torch.float32,
                      device=x.device)
    ph = torch.empty_like(amp) if with_phase else None
    if batch == 0:
        return amp, ph
    lib = _build.library()
    twc, tws, win = _device_tables(n, window, x.device)
    tw = _device_pass_twiddles(n // 2, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.stft_onesided_f32(
            x.data_ptr(), win.data_ptr(), amp.data_ptr(),
            ph.data_ptr() if with_phase else None,
            twc.data_ptr(), tws.data_ptr(), tw.data_ptr(),
            _plan_code_of(n // 2), batch, length, n, hop, stream)
    _build.check(lib, code, "stft_onesided")
    LAUNCHES["stft_onesided"] += 1
    return amp, ph


def _framed(x, n: int, hop: int, window: str, precision: Optional[str],
            with_phase: bool):
    resolve_precision(precision)
    if not framed_spectrum_supported(n, hop):
        raise ValueError(
            f"framed spectrum needs one-sided pow-2 n > {MAX_DFT_N} with "
            f"hop % {FRAMED_HOP_QUANTUM} == 0 dividing n; got n={n}, hop={hop}")
    x = to_tensor(x)
    shape = x.shape
    signals = x.reshape(-1, shape[-1])
    if shape[-1] < n:
        raise ValueError(f"signal length {shape[-1]} < frame size {n}")
    if signals.is_cuda:
        amp, ph = _launch_stft_onesided(signals, n, hop, window, with_phase)
    else:
        amp, ph = framed_spectrum_amp_phase_plain(signals, n, hop, window,
                                                  with_phase)
    out_shape = shape[:-1] + amp.shape[-2:]
    return amp.reshape(out_shape), (ph.reshape(out_shape) if with_phase else None)


def framed_spectrum_amplitude_cuda(x, n: int, hop: int, window: str = "rect",
                                   precision: Optional[str] = None
                                   ) -> torch.Tensor:
    """Framed one-sided amplitude spectrogram of a real signal
    [batch..., L] -> [batch..., F, n//2+1], F = 1 + (L - n)//hop, trailing
    samples dropped. Equal to framing followed by
    :func:`spectrum_amplitude_cuda`, but K4 reads the signal directly and
    never materialises the frames (on CUDA up to n = 16384; longer frames
    are materialised and go through ``ops.dispatch.fft``). Requires
    :func:`framed_spectrum_supported` (n, hop) (ValueError otherwise)."""
    return _framed(x, n, hop, window, precision, with_phase=False)[0]


def framed_spectrum_amp_phase_cuda(x, n: int, hop: int, window: str = "rect",
                                   precision: Optional[str] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Framed one-sided amplitude AND phase spectrogram:
    [batch..., L] -> ([batch..., F, n//2+1], [batch..., F, n//2+1]); the
    amp+phase analogue of :func:`framed_spectrum_amplitude_cuda`."""
    return _framed(x, n, hop, window, precision, with_phase=True)


# ── K2: row FFT ──────────────────────────────────────────────────────


def fft_rows_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: the Stockham FFT over the last axis of [B, n]."""
    ore, oim = fft_axis0(re.T, im.T, inverse)
    return ore.T.contiguous(), oim.T.contiguous()


def _check_rows_planes(re: torch.Tensor, im: torch.Tensor, n: int) -> None:
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the row FFT kernel takes float32 planes, got "
                        f"{re.dtype}/{im.dtype}")
    if not (re.is_cuda and im.is_cuda and re.device == im.device):
        raise ValueError("the row FFT kernel needs both planes on one CUDA device")
    if n > MAX_ROWS_N:
        raise ValueError(
            f"the row FFT kernel covers n <= {MAX_ROWS_N}, got {n}: "
            "ops.dispatch.fft routes larger transforms (ops.fft_big)")


def _on_device(device: torch.device):
    """The context a launch on ``device`` runs in: none where it is the
    current device (switching costs the host a few microseconds a launch,
    as long as a short kernel at one row), else a switch to it."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch_rows_kernel(re, im, ore, oim, rows: int, n: int, cols: int,
                        turn: int, inverse: bool, pieces: int = 1) -> None:
    """One launch of K2 on contiguous float32 planes (``turn``: 0 rows in
    and out, 1 stored turned, 2 loaded turned, 3 loaded in pieces, 4 stored
    in pieces; ``cols`` the turned width or the rows a chunk of pieces;
    ``pieces`` their number, or the blocks a cluster of a turned launch)."""
    lib = _build.library()
    tw = _device_pass_twiddles(n, re.device)
    with _on_device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = lib.fft_rows_f32(re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                                oim.data_ptr(), tw.data_ptr(), _plan_code_of(n),
                                rows, n, cols, turn, int(inverse), pieces, stream)
    _build.check(lib, code, "fft_rows")
    LAUNCHES["fft_rows"] += 1


def _launch_fft_rows(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                     donate: bool):
    n = re.shape[-1]
    _check_rows_planes(re, im, n)
    if donate and not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("donate=True needs contiguous input planes")
    re, im = re.contiguous(), im.contiguous()
    ore, oim = (re, im) if donate else (torch.empty_like(re), torch.empty_like(im))
    batch = re.shape[0]
    if batch == 0:
        return ore, oim
    _launch_rows_kernel(re, im, ore, oim, batch, n, 0, 0, inverse)
    return ore, oim


def fft_rows_cuda(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                  donate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over the last axis of split planes [B, n],
    natural order in and out. The forward transform is unnormalised; the
    inverse scales by 1/n. Power-of-two n up to 16384 on CUDA.

    donate=True lets the kernel write the result into ``re``/``im``
    (which must be contiguous): each block reads all of its rows before
    its first store, so in place is safe. The inputs must be dead after
    the call. On the CPU, donate has no effect.
    """
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"fft_rows takes two [B, n] planes, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    n = re.shape[-1]
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    if re.is_cuda or im.is_cuda:
        return _launch_fft_rows(re, im, inverse, donate)
    return fft_rows_plain(re, im, inverse)


def rows_per_block(n: int) -> int:
    """Rows a block of K2's row instance holds (``RowShape::kRows`` in
    csrc/fft_regs.cuh): one, or as many as fill 128 threads of n/16."""
    return max(1, 128 // (n // points_per_thread(n)))


# Blocks a cluster of K2's turned instance at each n, (turned store, turned
# load): the faster of one block that stages its own rows (1) and clusters
# of 8, 16 or 32 rows on an "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md;
# scripts/k2_k1_split.py times the others). csrc/fft_rows.cu instantiates
# these (kLog2TurnStoreCluster, kLog2TurnLoadCluster) and refuses another.
TURN_CLUSTER = {256: (2, 2), 512: (1, 1), 1024: (1, 1), 2048: (1, 16), 4096: (8, 16)}


def turn_rows(n: int, load: bool = False) -> int:
    """Rows of one item a turned launch of K2 runs over on its turned side,
    so that its accesses there cover that many consecutive words: a block
    of 8 rows (or as many as 1024 threads hold) where it stages its own,
    else its cluster of blocks (:data:`TURN_CLUSTER`, by direction) times
    the row instance's rows a block. The turned width must be a
    multiple."""
    cluster = TURN_CLUSTER[n][int(load)]
    if cluster == 1:
        threads = n // points_per_thread(n)
        return 8 if threads * 8 <= 1024 else 1024 // threads
    return rows_per_block(n) * cluster


def fft_rows_turned_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                          load: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's turned instances' plain version: :func:`fft_rows_plain` over
    the rows, then the transpose of the last two axes (``load=False``: rows
    [..., m, n] in, [..., n, m] out), or the transpose first (``load=True``:
    [..., n, m] in, the transforms of its columns as rows [..., m, n] out).
    Contiguous output."""
    if load:
        re, im = re.transpose(-2, -1), im.transpose(-2, -1)
    shape = re.shape
    n = shape[-1]
    ore, oim = fft_rows_plain(re.reshape(-1, n), im.reshape(-1, n), inverse)
    ore, oim = ore.reshape(shape), oim.reshape(shape)
    if not load:
        ore, oim = ore.transpose(-2, -1).contiguous(), oim.transpose(-2, -1).contiguous()
    return ore, oim


def fft_rows_turned_cuda(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                         load: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 with one side turned, so that no transpose runs around it.

    ``load=False`` (the turned store): rows [B, m, n] in; out [B, n, m]
    with out[b, k, j] = FFT(row j of item b)[k]. ``load=True`` (the turned
    load): [B, n, m] in; row j of item b of the output [B, m, n] is the FFT
    of column j of item b. The same bits as :func:`fft_rows_cuda` followed,
    or preceded, by the transpose; the forward transform is unnormalised,
    the inverse scales by 1/n. On CUDA: power-of-two n from 256 to 4096
    (:data:`MIN_TURNED_N`, :data:`MAX_TURNED_N`), m a multiple of
    :func:`turn_rows`, a new output (never in place). A CPU tensor runs
    :func:`fft_rows_turned_plain`.
    """
    if re.ndim != 3 or re.shape != im.shape:
        raise ValueError(f"fft_rows_turned takes two [B, m, n] or [B, n, m] planes, "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    batch, a, b = re.shape
    n, m = (a, b) if load else (b, a)
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    if not (re.is_cuda or im.is_cuda):
        return fft_rows_turned_plain(re, im, inverse, load)
    _check_rows_planes(re, im, n)
    if not MIN_TURNED_N <= n <= MAX_TURNED_N:
        raise ValueError(f"the turned row FFT kernel takes n in {MIN_TURNED_N}.."
                         f"{MAX_TURNED_N}, got n = {n}")
    if m % turn_rows(n, load) != 0:
        raise ValueError(f"the turned row FFT kernel takes a width that is a multiple of "
                         f"{turn_rows(n, load)} at n = {n}, got {m}")
    re, im = re.contiguous(), im.contiguous()
    out = (batch, m, n) if load else (batch, n, m)
    ore, oim = re.new_empty(out), im.new_empty(out)
    if batch * m:
        _launch_rows_kernel(re, im, ore, oim, batch * m, n, m, 2 if load else 1, inverse,
                            TURN_CLUSTER[n][int(load)])
    return ore, oim


# ── the distributed FFT's pieces (K2 and K7) ─────────────────────────


def to_pieces(t: torch.Tensor, d: int, bc: int, axis: int) -> torch.Tensor:
    """The layout of the distributed FFT's all-to-all: [B, a, b] planes
    with ``axis`` (-2 or -1) cut into ``d`` pieces and the items in chunks
    of ``bc``, as [B/bc, d, bc, a/d, b] (axis -2) or [B/bc, d, bc, a, b/d]
    (axis -1), contiguous: chunk c's [d, bc, ...] is one send buffer, piece
    j bound for position j of the axis."""
    b, rows, cols = t.shape
    if axis % 3 == 1:
        v = t.reshape(b // bc, bc, d, rows // d, cols).transpose(1, 2)
    else:
        v = t.reshape(b // bc, bc, rows, d, cols // d).permute(0, 3, 1, 2, 4)
    return v.contiguous()


def from_pieces(p: torch.Tensor, axis: int) -> torch.Tensor:
    """The inverse of :func:`to_pieces`: [C, d, bc, a', b'] pieces back to
    natural [C*bc, a, b] planes, ``axis`` (-2 or -1) the one they cut."""
    c, d, bc, rows, cols = p.shape
    if axis % 3 == 1:
        return p.transpose(1, 2).reshape(c * bc, d * rows, cols)
    return p.permute(0, 2, 3, 1, 4).reshape(c * bc, rows, d * cols)


def _check_pieces(re: torch.Tensor, im: torch.Tensor, pieces, n: int, load: bool,
                  what: str) -> Tuple[int, int]:
    """(d, bc) of a pieced wrapper's call, checked: d divides the
    transform's n, bc the items; a loaded buffer is [C, d, bc, ...] and
    contiguous (a copy would be the very re-layout the kernels spare)."""
    d, bc = (int(v) for v in pieces)
    if re.shape != im.shape:
        raise ValueError(f"{what} takes two planes of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if d < 1 or n % d != 0:
        raise ValueError(f"{what}: {d} pieces do not divide n = {n}")
    if load:
        if re.ndim != 5 or tuple(re.shape[1:3]) != (d, bc):
            raise ValueError(f"{what} loads [chunks, {d}, {bc}, ...] pieces, got "
                             f"{tuple(re.shape)}")
        if not (re.is_contiguous() and im.is_contiguous()):
            raise ValueError(f"{what} loads contiguous pieces")
    elif bc < 1 or re.ndim != 3 or re.shape[0] % bc != 0:
        raise ValueError(f"{what}: chunks of {bc} items do not divide the batch of "
                         f"{tuple(re.shape)}")
    return d, bc


def _pieces_out(out, shape, like: torch.Tensor, what: str):
    """The caller's output planes, checked, or two new ones."""
    if out is None:
        return like.new_empty(shape), like.new_empty(shape)
    ore, oim = out
    for o in (ore, oim):
        if (tuple(o.shape) != tuple(shape) or not o.is_contiguous()
                or o.dtype != like.dtype or o.device != like.device):
            raise ValueError(f"{what}: out must be two contiguous {tuple(shape)} "
                             f"{like.dtype} planes on {like.device}, got "
                             f"{tuple(o.shape)} {o.dtype} on {o.device}")
    return ore, oim


def _plain_into(planes, out, what: str):
    """A plain version's result, or written into the caller's ``out``."""
    if out is None:
        return planes
    dst = _pieces_out(out, planes[0].shape, planes[0], what)
    for o, t in zip(dst, planes):
        o.copy_(t)
    return dst


def fft_rows_pieces_plain(re: torch.Tensor, im: torch.Tensor, pieces, inverse: bool = False,
                          load: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's pieced instances' plain version: :func:`fft_rows_plain` over
    the rows of natural [B, h, n] planes, preceded by :func:`from_pieces`
    (``load``) or followed by :func:`to_pieces` (the store), axis -1."""
    d, bc = pieces
    if load:
        re, im = from_pieces(re, -1), from_pieces(im, -1)
    shape = re.shape
    ore, oim = fft_rows_plain(re.reshape(-1, shape[-1]), im.reshape(-1, shape[-1]), inverse)
    ore, oim = ore.reshape(shape), oim.reshape(shape)
    if load:
        return ore, oim
    return to_pieces(ore, d, bc, -1), to_pieces(oim, d, bc, -1)


def fft_rows_pieces_cuda(re: torch.Tensor, im: torch.Tensor, pieces, inverse: bool = False,
                         load: bool = False, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 with one side in the distributed FFT's pieces, so that no copy
    runs around its all-to-all. ``pieces`` = (d, bc).

    The pieced store (``load=False``): natural rows [B, h, n] in; out
    [B/bc, d, bc, h, n/d] (:func:`to_pieces` over axis -1), one launch. The
    pieced load (``load=True``): [C, d, bc, h, loc] in, contiguous; out the
    natural rows [C*bc, h, d*loc]. The same bits as :func:`fft_rows_cuda`
    preceded, or followed, by the re-layout; the forward transform is
    unnormalised, the inverse scales by 1/n. ``out``: two contiguous planes
    of the result's shape to write into (a chunk's rows of a larger output).
    On CUDA: power-of-two n from 256 to 4096, never in place. A CPU tensor
    runs :func:`fft_rows_pieces_plain`.
    """
    what = "fft_rows_pieces"
    n = re.shape[-1] * (pieces[0] if load else 1)
    if not is_power_of_two(n):
        raise ValueError(f"FFT size must be power of two, got {n}")
    d, bc = _check_pieces(re, im, pieces, n, load, what)
    if load:
        chunks, _, _, h, loc = re.shape
        shape = (chunks * bc, h, n)
    else:
        batch, h, _ = re.shape
        shape = (batch // bc, d, bc, h, n // d)
    if not (re.is_cuda or im.is_cuda):
        return _plain_into(fft_rows_pieces_plain(re, im, (d, bc), inverse, load), out, what)
    _check_rows_planes(re, im, n)
    if not MIN_TURNED_N <= n <= MAX_TURNED_N:
        raise ValueError(f"the pieced row FFT kernel takes n in {MIN_TURNED_N}.."
                         f"{MAX_TURNED_N}, got n = {n}")
    re, im = re.contiguous(), im.contiguous()
    ore, oim = _pieces_out(out, shape, re, what)
    rows = re.numel() // n
    if rows:
        _launch_rows_kernel(re, im, ore, oim, rows, n, bc * h, 3 if load else 4, inverse, d)
    return ore, oim




# ── K7: column FFT with a folded twiddle ─────────────────────────────


class Twiddle(NamedTuple):
    """The inter-stage twiddle of a large FFT of ``size`` = N points, as
    K7 folds it into an (n, m) block: W_N^(sign*k2*(offset + c)) at row k2
    and column c (``offset``: a rank's first column in ``dist_fft``).

    K7 generates it on the card from the phase k2*(offset + c) reduced mod
    N exactly in integers (:func:`cols_twiddle_steps` repeats it); the
    plain versions multiply by :meth:`grids`, the float64 grid of that same
    phase rounded once, as ``ops.fft_big``'s grids are formed."""
    size: int
    offset: int = 0
    sign: float = -1.0

    def grids(self, n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
        """(cos, sin) of the (n, m) block, float64."""
        return _twiddle_grids64(int(self.size), int(self.offset), float(self.sign), n, m)


@functools.lru_cache(maxsize=8)
def _twiddle_grids64(size: int, offset: int, sign: float, n: int, m: int):
    k2 = np.arange(n, dtype=np.int64)
    c = np.arange(offset, offset + m, dtype=np.int64)
    phase = (k2[:, None] * c[None, :]) % size
    ang = sign * 2.0 * np.pi * phase.astype(np.float64) / size
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def _twiddle_planes(fold: Twiddle, n: int, m: int, dtype: torch.dtype,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:meth:`Twiddle.grids` on ``device`` in ``dtype`` (8 bytes a point in
    float32), kept for the last eight in use."""
    return tuple(torch.from_numpy(g).to(device=device, dtype=dtype) for g in fold.grids(n, m))


def _check_fold(fold, n: int, m: int):
    """A fold argument, checked: None, a :class:`Twiddle` (N a power of two
    from 4 to 2^31, sign +1 or -1, offset >= 0), or two (n, m) grids."""
    if fold is None:
        return None
    if isinstance(fold, Twiddle):
        if not (is_power_of_two(fold.size) and 4 <= fold.size <= 1 << 31
                and fold.sign in (1, -1) and fold.offset >= 0):
            raise ValueError(f"a twiddle takes a power-of-two size in 4..2^31, sign +1 "
                             f"or -1 and an offset >= 0, got {fold}")
        return fold
    if len(fold) != 2 or any(tuple(g.shape) != (n, m) for g in fold):
        raise ValueError(f"fold grids must be two ({n}, {m}) arrays, got "
                         f"{[tuple(g.shape) for g in fold]}")
    return fold


def _fold_mul(re: torch.Tensor, im: torch.Tensor, fold):
    if isinstance(fold, Twiddle):
        gc, gs = _twiddle_planes(fold, re.shape[-2], re.shape[-1], re.dtype, re.device)
    else:
        gc, gs = (torch.as_tensor(g).to(device=re.device, dtype=re.dtype) for g in fold)
    return re * gc - im * gs, re * gs + im * gc


def fft_cols_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                   fold=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: the Stockham FFT over axis -2 of [..., n, m], and
    the twiddle multiply (after a forward transform, before an inverse
    one): a :class:`Twiddle`'s float64 grid rounded to the planes' dtype,
    or the grids given."""
    if fold is not None and inverse:
        re, im = _fold_mul(re, im, fold)
    n = re.shape[-2]
    moved = torch.movedim(re, -2, 0).shape
    ore, oim = fft_axis0(torch.movedim(re, -2, 0).reshape(n, -1),
                         torch.movedim(im, -2, 0).reshape(n, -1), inverse)
    ore = torch.movedim(ore.reshape(moved), 0, -2)
    oim = torch.movedim(oim.reshape(moved), 0, -2)
    if fold is not None and not inverse:
        ore, oim = _fold_mul(ore, oim, fold)
    return ore.contiguous(), oim.contiguous()


def cols_config(n: int) -> Tuple[int, int]:
    """(columns a tile, blocks a cluster) of K7 at n: ``COLS_CONFIG``, the
    kLog2Tile and kLog2Cluster tables of csrc/fft_cols.cu. A cluster holds
    a tile of whole columns; its blocks have n*tile/(16*cluster) threads."""
    if n not in COLS_CONFIG:
        raise ValueError(f"the column FFT covers power-of-two n in "
                         f"{min(COLS_CONFIG)}..{max(COLS_CONFIG)}, got {n}")
    return COLS_CONFIG[n]


def cols_instances(n: int) -> Tuple[Tuple[int, int], ...]:
    """Every (tile, cluster) K7 is built for at n: a tile of 16 or 32
    columns, up to 8 blocks a cluster, 512 or 1024 threads a block. The
    natural layout has each; the pieced ones :func:`cols_config` only."""
    return tuple((tile, cluster) for tile in COLS_TILES for cluster in (1, 2, 4, 8)
                 if COLS_MIN_THREADS <= n * tile // (MAX_RADIX * cluster) <= COLS_MAX_THREADS)


def _check_cols_config(n: int, config) -> Tuple[int, int]:
    config = cols_config(n) if config is None else tuple(int(v) for v in config)
    if config not in cols_instances(n):
        raise ValueError(
            f"the column FFT kernel takes a tile of {COLS_TILES} columns in clusters of "
            f"1..8 blocks of {COLS_MIN_THREADS} or {COLS_MAX_THREADS} threads "
            f"(n * tile / (16 * cluster)), got (tile, cluster) = {config} at n = {n}")
    return config


def cols_pad_shift(tile: int, cluster: int) -> int:
    """log2 of the rows between two spare rows of K7's exchange (kPadShift):
    G = 16/cluster where a warp spans two rows (16 columns), none (30, a
    shift no row index reaches) at 32 columns."""
    return 30 if tile >= 32 else 4 - (cluster.bit_length() - 1)


def cols_twiddle_steps(fold: Twiddle, n: int, m: int, dtype=torch.float64,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twiddle K7 generates for an (n, m) block, step by step: at row
    k2 = r0 + (n/16)*q, A * B_q with A = W^(r0*c) and B_q = W^((n/16)*q*c)
    (c the column plus the offset), each from its phase reduced mod N in
    integers, rounded to ``dtype`` from float64 (the kernel's cospi/sinpi
    are within an ulp of it), and the product rounded in ``dtype`` without
    fused multiply-adds, as the kernel forms it."""
    lanes = n // MAX_RADIX
    c = torch.arange(fold.offset, fold.offset + m, dtype=torch.int64)
    k2 = torch.arange(n, dtype=torch.int64)

    def unit(phase):
        ang = fold.sign * 2.0 * np.pi * (phase % fold.size).double() / fold.size
        return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)

    ar, ai = unit((k2 % lanes)[:, None] * c[None, :])
    br, bi = unit((k2 // lanes * lanes)[:, None] * c[None, :])
    out = ar * br - ai * bi, ar * bi + ai * br
    return tuple(t.to(device) for t in out) if device is not None else out


def fft_cols_steps(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                   fold=None, config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's arithmetic step by step in PyTorch, for the tests: what
    ``csrc/fft_cols.cu`` does to [..., n, m] planes, block, thread,
    register and shared-memory address included.

    A cluster of ``cluster`` blocks owns ``tile`` adjacent columns
    (default :func:`cols_config`); a last tile that m does not fill loads
    zeros for its missing columns and stores nothing there. Row-thread
    r = rank*(T/cluster) + i (T = n/16) holds rows r + T*q in register q
    and runs pass 1 (radix 16); its output t goes to block t/G (G =
    16/cluster), local row r*G + t%G of that block's [row][column]
    exchange. Every later pass is the register core's on the block's own
    n/cluster points (local index i, stride Ns/cluster, spare rows by
    :func:`cols_pad_shift`), with the twiddles of the true butterfly index
    j = 16*(i/G) + rank*G + i%G; register q then holds row j + T*q. A
    :class:`Twiddle` multiplies the registers by :func:`cols_twiddle_steps`
    after the load (inverse) or before the store (forward), grids by their
    values. The inverse is the forward transform of the swapped planes, on
    which the twiddle enters conjugated, swapped back and scaled by 1/n."""
    n, m = re.shape[-2:]
    tl, cs = _check_cols_config(n, config)
    fold = _check_fold(fold, n, m)
    shape, dev, dtype = re.shape, re.device, re.dtype
    tiles = -(-m // tl)
    lanes = n // MAX_RADIX                      # T
    loc = lanes // cs                           # T/CS, row-threads a block
    g_out = MAX_RADIX // cs                     # G
    pad = cols_pad_shift(tl, cs)
    col = torch.arange(tl, device=dev)

    def tiled(plane):
        """[..., n, m] -> [B, tiles, n, tl], zeros in the masked columns."""
        plane = torch.nn.functional.pad(plane.reshape(-1, n, m), (0, tiles * tl - m))
        return plane.reshape(-1, n, tiles, tl).transpose(1, 2)

    def words(rows):
        """Word of (local row, column) in a block's exchange plane."""
        return exchange_at(rows, 0, pad)[..., None] * tl + col

    if inverse:
        re, im = im, re
    pr, pi = tiled(re), tiled(im)
    gsign = -1.0 if inverse else 1.0
    if fold is not None:
        if isinstance(fold, Twiddle):
            gc, gs = cols_twiddle_steps(fold, n, m, dtype, dev)
        else:
            gc, gs = (torch.as_tensor(g).to(device=dev, dtype=dtype) for g in fold)
        gc, gs = (tiled(g)[0] for g in (gc, gs))           # [tiles, n, tl]

    def fold_in(xr, xi, rows):
        for q in range(MAX_RADIX):
            c, s = gc[:, rows + lanes * q, :], gsign * gs[:, rows + lanes * q, :]
            xr[q], xi[q] = xr[q] * c - xi[q] * s, xr[q] * s + xi[q] * c

    # pass 1: row-thread r (all ranks in order) holds rows r + T*q
    r = torch.arange(lanes, device=dev)
    xr = [pr[:, :, r + lanes * q, :] for q in range(MAX_RADIX)]
    xi = [pi[:, :, r + lanes * q, :] for q in range(MAX_RADIX)]
    if fold is not None and inverse:
        fold_in(xr, xi, r)
    _butterflies_steps(xr, xi, MAX_RADIX)
    plane = int(exchange_at(n // cs, 0, pad)) * tl
    sre = torch.zeros(pr.shape[:2] + (cs, plane), dtype=dtype, device=dev)
    sim = torch.zeros_like(sre)
    for t in range(MAX_RADIX):
        at = words(r * g_out + t % g_out)                  # [T, tl] in block t // G
        sre[:, :, t // g_out, at], sim[:, :, t // g_out, at] = xr[t], xi[t]
    # the later passes, block by block: [B, tiles, cs, T/cs, tl] registers
    rank = torch.arange(cs, device=dev)[:, None]
    i = torch.arange(loc, device=dev)[None, :]
    j = (i // g_out) * MAX_RADIX + rank * g_out + i % g_out          # [cs, loc]
    rank = rank[..., None]                                            # by (i, column)
    xr = [sre[:, :, rank, words(i + loc * q)] for q in range(MAX_RADIX)]
    xi = [sim[:, :, rank, words(i + loc * q)] for q in range(MAX_RADIX)]
    tw = torch.from_numpy(pass_twiddles(
        n, np.float32 if dtype == torch.float32 else np.float64)).to(dev)
    plan = radix_plan(n)
    ns, off = MAX_RADIX, 0
    for p, radix in enumerate(plan[1:], 1):
        mm = MAX_RADIX // radix
        for u in range(mm):
            k = (j + u * lanes) & (ns - 1)
            for t in range(1, radix):
                c, s = (w[..., None] for w in tw[off + (t - 1) * ns + k].unbind(-1))
                q = u + t * mm
                xr[q], xi[q] = xr[q] * c - xi[q] * s, xr[q] * s + xi[q] * c
        off += (radix - 1) * ns
        _butterflies_steps(xr, xi, radix)
        if p + 1 < len(plan):
            nsl = ns // cs
            for u in range(mm):
                jl = i + u * loc
                base = (jl // nsl) * nsl * radix + jl % nsl
                for t in range(radix):
                    at = words(base + t * nsl)
                    sre[:, :, rank, at], sim[:, :, rank, at] = xr[u + t * mm], xi[u + t * mm]
            xr = [sre[:, :, rank, words(i + loc * q)] for q in range(MAX_RADIX)]
            xi = [sim[:, :, rank, words(i + loc * q)] for q in range(MAX_RADIX)]
        ns *= radix
    if fold is not None and not inverse:
        fold_in(xr, xi, j)
    scale = 1.0 / n if inverse else 1.0
    ore, oim = torch.empty_like(pr), torch.empty_like(pi)
    for q in range(MAX_RADIX):
        ore[:, :, j + lanes * q, :] = xr[q] * scale
        oim[:, :, j + lanes * q, :] = xi[q] * scale
    ore, oim = (p.transpose(1, 2).reshape(-1, n, tiles * tl)[..., :m].reshape(shape)
                for p in (ore, oim))
    return (oim, ore) if inverse else (ore, oim)


def fft_cols_pieces_plain(re: torch.Tensor, im: torch.Tensor, pieces, inverse: bool = False,
                          fold=None, load: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's pieced instances' plain version: :func:`fft_cols_plain` of
    natural [B, n, m] planes, preceded by :func:`from_pieces` (``load``) or
    followed by :func:`to_pieces` (the store), axis -2."""
    d, bc = pieces
    if load:
        return fft_cols_plain(from_pieces(re, -2), from_pieces(im, -2), inverse, fold)
    ore, oim = fft_cols_plain(re, im, inverse, fold)
    return to_pieces(ore, d, bc, -2), to_pieces(oim, d, bc, -2)


def fft_cols_pieces_cuda(re: torch.Tensor, im: torch.Tensor, pieces, inverse: bool = False,
                         fold=None, load: bool = False, out=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 with one side in the distributed FFT's pieces, so that no copy
    runs around its all-to-all. ``pieces`` = (d, bc).

    The blocked store (``load=False``): natural [B, n, m] in; out
    [B/bc, d, bc, n/d, m] (:func:`to_pieces` over axis -2), one launch. The
    blocked load (``load=True``): [C, d, bc, n/d, m] in, contiguous; out
    natural [C*bc, n, m]. ``fold``: a :class:`Twiddle` or two (n, m) grids
    in natural row order, multiplied into the forward's output or the
    inverse's input as :func:`fft_cols_cuda` does. The same bits as
    :func:`fft_cols_cuda` followed, or preceded, by the re-layout. ``out``:
    two contiguous planes of the result's shape to write into. On CUDA:
    power-of-two n from 256 to 4096, any m, n's own tile and cluster, never
    in place. A CPU tensor runs :func:`fft_cols_pieces_plain`.
    """
    what = "fft_cols_pieces"
    if load:
        if re.ndim != 5:
            raise ValueError(f"{what} loads [chunks, d, bc, n/d, m] pieces, got "
                             f"{tuple(re.shape)}")
        n, m = re.shape[1] * re.shape[3], re.shape[4]
    else:
        n, m = re.shape[-2:]
    if not is_power_of_two(n) or not MAX_DFT_N < n <= MAX_COLS_N:
        raise ValueError(f"the pieced column FFT takes a power-of-two n in "
                         f"{2 * MAX_DFT_N}..{MAX_COLS_N}, got {n}")
    d, bc = _check_pieces(re, im, pieces, n, load, what)
    fold = _check_fold(fold, n, m)
    shape = ((re.shape[0] * bc, n, m) if load
             else (re.shape[0] // bc, d, bc, n // d, m))
    if not (re.is_cuda or im.is_cuda):
        return _plain_into(fft_cols_pieces_plain(re, im, (d, bc), inverse, fold, load), out,
                           what)
    _check_cols_planes(re, im)
    re, im = re.contiguous(), im.contiguous()
    ore, oim = _pieces_out(out, shape, re, what)
    batch = re.numel() // (n * m)
    if batch:
        _launch_cols_kernel(re, im, ore, oim, batch, n, m, cols_config(n), fold,
                            inverse, 2 if load else 1, d, bc)
    return ore, oim


def _check_cols_planes(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the column FFT kernel takes float32 planes, got "
                        f"{re.dtype}/{im.dtype}")
    if not (re.is_cuda and im.is_cuda and re.device == im.device):
        raise ValueError("the column FFT kernel needs both planes on one CUDA device")


def _launch_cols_kernel(re, im, ore, oim, batch: int, n: int, m: int, config, fold,
                        inverse: bool, layout: int = 0, pieces: int = 1,
                        items: int = 1) -> None:
    """One launch of K7 on contiguous float32 planes (``config``: (tile,
    cluster); ``layout``: 0 natural, 1 stored in pieces, 2 loaded in
    pieces; ``pieces`` their number, ``items`` the items a chunk)."""
    gc = gs = None
    log2big = offset = sign = 0
    if isinstance(fold, Twiddle):
        log2big, offset, sign = fold.size.bit_length() - 1, fold.offset, int(fold.sign)
    elif fold is not None:
        gc, gs = (torch.as_tensor(g).to(device=re.device, dtype=torch.float32)
                  .contiguous() for g in fold)
    lib = _build.library()
    tw = _device_pass_twiddles(n, re.device)
    with _on_device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = lib.fft_cols_f32(
            re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
            None if gc is None else gc.data_ptr(),
            None if gs is None else gs.data_ptr(), tw.data_ptr(),
            _plan_code_of(n), batch, n, m, *config, int(inverse), layout, pieces, items,
            log2big, offset, sign, stream)
    _build.check(lib, code, "fft_cols")
    LAUNCHES["fft_cols"] += 1


def _launch_fft_cols(re: torch.Tensor, im: torch.Tensor, inverse: bool, fold,
                     donate: bool, config=None):
    """Launch K7 on [B, n, m] planes. ``config`` = (tile, cluster)
    overrides :func:`cols_config`: the card's measurement of the instances
    uses it, no path does."""
    _check_cols_planes(re, im)
    re, im = re.contiguous(), im.contiguous()
    ore, oim = (re, im) if donate else (torch.empty_like(re), torch.empty_like(im))
    batch, n, m = re.shape
    config = _check_cols_config(n, config)
    if batch * m == 0:
        return ore, oim
    _launch_cols_kernel(re, im, ore, oim, batch, n, m, config, _check_fold(fold, n, m),
                        inverse)
    return ore, oim


def fft_cols_cuda(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                  fold=None, donate: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over axis -2 of split planes [..., n, m], natural
    row order in and out; the forward transform is unnormalised, the
    inverse scales by 1/n. Power-of-two n in 256..4096, any m.

    ``fold``: the forward result is multiplied by it, the inverse's input
    before the transform (the inter-stage twiddle of :mod:`ops.fft_big`
    rides the kernel and costs no pass of its own). A :class:`Twiddle` is
    generated in the kernel; (cos, sin), two (n, m) grids in natural row
    order, are read.

    donate=True lets the kernel write the result into ``re``/``im`` (which
    must be contiguous and dead after the call): a barrier lies between a
    tile's last load and its first store, and tiles are disjoint, so in
    place is safe. A CPU tensor runs :func:`fft_cols_plain`; donate has no
    effect there.
    """
    if re.ndim < 2 or re.shape != im.shape:
        raise ValueError(f"fft_cols takes two [..., n, m] planes, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    n, m = re.shape[-2:]
    if not is_power_of_two(n) or n <= MAX_DFT_N:
        raise ValueError(
            f"column FFT size must be a power of two > {MAX_DFT_N}, got {n}")
    if n > MAX_COLS_N:
        raise ValueError(f"the column FFT covers n <= {MAX_COLS_N}, got {n}")
    fold = _check_fold(fold, n, m)
    if not (re.is_cuda or im.is_cuda):
        return fft_cols_plain(re, im, inverse, fold)
    if donate and not (re.is_contiguous() and im.is_contiguous()):
        # a reshape of anything else would be a copy, and not in place
        raise ValueError("donate=True needs contiguous input planes")
    shape = re.shape
    ore, oim = _launch_fft_cols(re.reshape(-1, n, m), im.reshape(-1, n, m),
                                inverse, fold, donate)
    return ore.reshape(shape), oim.reshape(shape)
