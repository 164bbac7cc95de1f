"""Hand-written CUDA kernels of the spectrum, spectrogram and FFT paths,
each beside its plain PyTorch version.

Counterpart of ``pragma_dsp_tpu/ops/fft_pallas.py``:

* K1 ``spectrum_onesided`` (``csrc/spectrum_onesided.cu``) replaces
  ``_spectrum_onesided_kernel`` + ``_onesided_body``: window -> FFT ->
  one-sided scaled amplitude, optionally phase, natural bin order. The
  real frame is packed into n/2 complex points and untangled
  (``csrc/onesided.cuh``).
* K2 ``fft_rows`` (``csrc/fft_rows.cu``) replaces ``_fft2d_kernel``: a
  batched complex FFT over the last axis, natural order in and out, by the
  register-resident mixed-radix core (``csrc/fft_regs.cuh``) that K1, K3,
  K4 and K5 share; :func:`radix_plan` is its plan.
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
  out, with an optional (n, m) twiddle grid folded into the output
  (forward) or the input (inverse): the register core run down the columns
  of a tile, the lanes of a warp across its columns. It is stage 1 of the
  large FFT (``ops/fft_big.py``) and the axis -2 route of ``ops.dispatch``.

K1, K3 and K4 hold a whole frame in one block, which ends at n = 16384. A longer CUDA frame takes the route the JAX package takes in
effect: window -> ``ops.dispatch.fft`` (the large FFT, K7 then K2) -> |X|,
phase and scaling in PyTorch, with DC and Nyquist made real as K1 makes
them.

``fft_rows_steps``, ``spectrum_amp_phase_steps``,
``spectrum_twosided_steps`` and ``fft_cols_steps`` repeat the register
core's arithmetic step by step in PyTorch (thread, register and
shared-memory address included): the tests hold them against the JAX
package here and the kernels against them on the card.

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

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.complex import is_power_of_two, next_power_of_two
from ..core.device import to_tensor
from ..core.fft import fft_axis0
from ..xform.fourier import create_window, window_values
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
    "spectrum_twosided_plain",
    "framed_spectrum_supported",
    "framed_spectrum_amplitude_cuda",
    "framed_spectrum_amp_phase_cuda",
    "framed_spectrum_amp_phase_plain",
    "fft_rows_cuda",
    "fft_rows_plain",
    "fft_rows_steps",
    "radix_plan",
    "points_per_thread",
    "pass_twiddles",
    "exchange_pad",
    "spectrum_amp_phase_steps",
    "spectrum_twosided_steps",
    "framed_spectrum_amp_phase_steps",
    "fft_cols_cuda",
    "fft_cols_plain",
    "fft_cols_steps",
]

# A row of complex f32 must fit one block's shared memory (8*n bytes).
MAX_ROWS_N = 16384
# The column kernel's largest transform, the JAX package's bound
# (fft_pallas.py:791), kept as the contract: ops.fft_big splits by it. Four
# columns of 4096 points are the 1024 threads of one block.
MAX_COLS_N = 4096
# The tile widths K7 is instantiated for (narrower only where the threads
# of a block hold no wider one: 4 columns at n = 4096), and that limit.
COLS_TILES = (8, 16, 32)
COLS_MAX_THREADS = 1024
# K7's exchange tile has one spare row after every 2**COLS_PAD_SHIFT rows.
COLS_PAD_SHIFT = 4
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
    [row][column] tile of ``2**log2w`` columns is (log2w, COLS_PAD_SHIFT):
    the 32 / 2**log2w rows a warp touches at once, consecutive on a reload
    and 16 apart on the first pass's store, lie in different banks."""
    return (a + (a >> padshift)) << log2w


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


def _fft_regs_steps(xr: list, xi: list, n: int, tw: torch.Tensor,
                    log2w: Optional[int] = None) -> None:
    """The register core on R = len(xr) registers of [B, T] lanes
    (T = n/R threads a row; register q of thread tid holds point
    tid + T*q, before and after): the passes of :func:`radix_plan`, each a
    twiddle multiply, the in-register butterflies and, but for the last,
    one exchange through a padded row of shared memory.

    ``log2w`` set: the core down the columns of a tile, as K7 runs it.
    Registers are [..., T, W] (W = 2**log2w columns, the lanes of a warp
    across them first), the exchange is the [row][column] tile of
    :func:`exchange_at` (log2w, COLS_PAD_SHIFT), and a row's lanes share
    its twiddle."""
    regs = len(xr)
    lanes = n // regs
    dev = xr[0].device
    tid = torch.arange(lanes, device=dev)
    if log2w is None:
        lead, words = xr[0].shape[:-1], exchange_pad(n)
        at, wide = exchange_pad, (lambda v: v)
    else:
        col = torch.arange(1 << log2w, device=dev)
        lead, words = xr[0].shape[:-2], exchange_at(n, log2w, COLS_PAD_SHIFT)
        at = lambda a: exchange_at(a, log2w, COLS_PAD_SHIFT)[:, None] + col  # noqa: E731
        wide = lambda v: v[:, None]  # noqa: E731
    plan = radix_plan(n)
    ns, off = 1, 0
    for p, r in enumerate(plan):
        m = regs // r
        if ns > 1:
            for u in range(m):
                k = (tid + u * lanes) & (ns - 1)
                for t in range(1, r):
                    c, s = (wide(w) for w in tw[off + (t - 1) * ns + k].unbind(-1))
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
    i*xw[2j+1], the register core at n/2 points, then the untangle. Returns
    (re, im) over bins 0..n/2 as the kernel holds them: 2*X[k] between the
    edges, by (Z[k] + conj Z[n/2-k]) - i*W_n^k*(Z[k] - conj Z[n/2-k]);
    DC = Re Z[0] + Im Z[0] and Nyquist = Re Z[0] - Im Z[0], unscaled, with
    imaginary part +0.0."""
    half = n // 2
    regs = points_per_thread(half)
    lanes = half // regs
    tid = torch.arange(lanes, device=x.device)
    xw = x * create_window(window, n, dtype=x.dtype, device=x.device)
    xr = [xw[..., 2 * (tid + lanes * q)] for q in range(regs)]
    xi = [xw[..., 2 * (tid + lanes * q) + 1] for q in range(regs)]
    cast = np.float32 if x.dtype == torch.float32 else np.float64
    _fft_regs_steps(xr, xi, half, torch.from_numpy(pass_twiddles(half, cast)).to(x))
    zr = torch.empty(x.shape[:-1] + (exchange_pad(half),), dtype=x.dtype,
                     device=x.device)
    zi = torch.empty_like(zr)
    for q in range(regs):
        a = exchange_pad(tid + lanes * q)
        zr[..., a], zi[..., a] = xr[q], xi[q]
    wc, ws = (torch.from_numpy(t.astype(cast)).to(x.device) for t in _dft64(n))
    re2 = torch.empty(x.shape[:-1] + (half + 1,), dtype=x.dtype, device=x.device)
    im2 = torch.empty_like(re2)
    for q in range(regs):
        k = tid + lanes * q
        a = exchange_pad((half - k) & (half - 1))
        pr, pi = zr[..., a], zi[..., a]
        sr, si = xr[q] + pr, xi[q] - pi
        dr, di = xr[q] - pr, xi[q] + pi
        c, s = wc[k], ws[k]
        re2[..., k] = sr + (c * di + s * dr)
        im2[..., k] = si - (c * dr - s * di)
    # k = 0 pairs Z[0] with itself: both edge bins are exactly real
    re2[..., 0] = xr[0][..., 0] + xi[0][..., 0]
    re2[..., half] = xr[0][..., 0] - xi[0][..., 0]
    im2[..., 0] = 0.0
    im2[..., half] = 0.0
    return re2, im2


def spectrum_amp_phase_steps(x: torch.Tensor, n: int, window: str,
                             with_phase: bool = True, parts: bool = False):
    """K1's and K4's per-frame arithmetic step by step in PyTorch, for the
    tests (``csrc/onesided.cuh`` with its one-sided store): the packed real
    transform of :func:`_packed_real_bins_steps`, every bin scaled by 1/n
    (the untangle gives 2*X between the edges). ``parts=True`` returns the
    unscaled bins (re, im) of X instead of (amplitude, phase)."""
    half = n // 2
    re2, im2 = _packed_real_bins_steps(x, n, window)
    if parts:
        re2[..., 1:half] *= 0.5
        im2[..., 1:half] *= 0.5
        return re2, im2
    amp = torch.sqrt(re2 * re2 + im2 * im2) * (1.0 / n)
    amp[..., 0] = re2[..., 0].abs() * (1.0 / n)
    amp[..., half] = re2[..., half].abs() * (1.0 / n)
    return (amp, torch.atan2(im2, re2)) if with_phase else (amp, None)


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
    inner = torch.sqrt(re2 * re2 + im2 * im2)[..., 1:half] * (0.5 / n)
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


def _launch_fft_rows(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                     donate: bool):
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the row FFT kernel takes float32 planes, got "
                        f"{re.dtype}/{im.dtype}")
    if not (re.is_cuda and im.is_cuda and re.device == im.device):
        raise ValueError("the row FFT kernel needs both planes on one CUDA device")
    n = re.shape[-1]
    if n > MAX_ROWS_N:
        raise ValueError(
            f"the row FFT kernel covers n <= {MAX_ROWS_N}, got {n}: "
            "ops.dispatch.fft routes larger transforms (ops.fft_big)")
    if donate and not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("donate=True needs contiguous input planes")
    re, im = re.contiguous(), im.contiguous()
    ore, oim = (re, im) if donate else (torch.empty_like(re), torch.empty_like(im))
    batch = re.shape[0]
    if batch == 0:
        return ore, oim
    lib = _build.library()
    tw = _device_pass_twiddles(n, re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = lib.fft_rows_f32(re.data_ptr(), im.data_ptr(), ore.data_ptr(),
                                oim.data_ptr(), tw.data_ptr(),
                                _plan_code_of(n), batch, n, int(inverse),
                                stream)
    _build.check(lib, code, "fft_rows")
    LAUNCHES["fft_rows"] += 1
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


# ── K7: column FFT with a folded twiddle grid ────────────────────────


def _fold_mul(re: torch.Tensor, im: torch.Tensor, fold):
    gc, gs = (torch.as_tensor(g).to(device=re.device, dtype=re.dtype) for g in fold)
    return re * gc - im * gs, re * gs + im * gc


def fft_cols_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                   fold=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: the Stockham FFT over axis -2 of [..., n, m], and
    the grid multiply (after a forward transform, before an inverse one)."""
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


def cols_tile(n: int, m: int) -> int:
    """Columns per block of K7: as many as the n/16 * tile threads of a
    block allow, up to a warp: 32 to n = 512, 16 at 1024, 8 at 2048, 4 at
    4096; down to 8 where m rounded up to a power of two is narrower (the
    one tile's missing columns are masked). The exchange tile takes
    8.5 * n * tile bytes of shared memory. Width is what the time follows
    (a warp's load touches 32/tile lines): on an H100 with the fold,
    [64, 1024, 1024] read 0.54 ms at 16 columns and 0.68 at 8,
    [64, 256, 4096] 0.46 at 32, 0.49 at 16 and 0.67 at 8, and
    [16, 4096, 1024], the same bytes with 4 columns, 1.62 ms."""
    widest = min(COLS_TILES[-1], COLS_MAX_THREADS * MAX_RADIX // n)
    return min(widest, max(COLS_TILES[0], next_power_of_two(m)))


def _check_cols_tile(n: int, tile: int) -> int:
    threads = n // MAX_RADIX * tile
    if not (is_power_of_two(tile) and tile <= COLS_TILES[-1]
            and threads <= COLS_MAX_THREADS
            and (tile >= COLS_TILES[0] or threads == COLS_MAX_THREADS)):
        raise ValueError(
            f"the column FFT kernel takes a tile of {COLS_TILES} columns with "
            f"n/16 * tile <= {COLS_MAX_THREADS} threads, or the widest that "
            f"fits, got {tile} at n = {n}")
    return tile


def fft_cols_steps(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                   fold=None, tile: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's arithmetic step by step in PyTorch, for the tests: what
    ``csrc/fft_cols.cu`` does to [..., n, m] planes. A block owns ``tile``
    adjacent columns (default :func:`cols_tile`); thread (column, r) holds
    rows r + (n/16)*q of its column in register q; a last tile that m does
    not fill loads zeros for its missing columns and stores nothing there;
    the passes are the register core's down the column with the padded
    [row][column] exchange. The grid multiplies the registers after the
    load (inverse) or before the store (forward). The inverse is the
    forward transform of the swapped planes, on which the grid enters
    conjugated, swapped back and scaled by 1/n."""
    n, m = re.shape[-2:]
    tl = _check_cols_tile(n, cols_tile(n, m) if tile is None else tile)
    shape = re.shape
    tiles = -(-m // tl)

    def tiled(plane):
        """[..., n, m] -> [B, tiles, n, tl], zeros in the masked columns."""
        plane = torch.nn.functional.pad(plane.reshape(-1, n, m), (0, tiles * tl - m))
        return plane.reshape(-1, n, tiles, tl).transpose(1, 2)

    if inverse:
        re, im = im, re
    pr, pi = tiled(re), tiled(im)
    lanes = n // MAX_RADIX
    r = torch.arange(lanes, device=re.device)
    xr = [pr[:, :, r + lanes * q, :] for q in range(MAX_RADIX)]
    xi = [pi[:, :, r + lanes * q, :] for q in range(MAX_RADIX)]
    if fold is not None:
        gc, gs = (tiled(torch.as_tensor(g).to(device=re.device, dtype=re.dtype))[0]
                  for g in fold)
        gsign = -1.0 if inverse else 1.0

        def grid_multiply():
            for q in range(MAX_RADIX):
                c, s = gc[:, r + lanes * q, :], gsign * gs[:, r + lanes * q, :]
                xr[q], xi[q] = xr[q] * c - xi[q] * s, xr[q] * s + xi[q] * c

    if fold is not None and inverse:
        grid_multiply()
    tw = torch.from_numpy(pass_twiddles(
        n, np.float32 if re.dtype == torch.float32 else np.float64)).to(re.device)
    _fft_regs_steps(xr, xi, n, tw, log2w=tl.bit_length() - 1)
    if fold is not None and not inverse:
        grid_multiply()
    scale = 1.0 / n if inverse else 1.0
    ore, oim = torch.empty_like(pr), torch.empty_like(pi)
    for q in range(MAX_RADIX):
        ore[:, :, r + lanes * q, :] = xr[q] * scale
        oim[:, :, r + lanes * q, :] = xi[q] * scale
    ore, oim = (p.transpose(1, 2).reshape(-1, n, tiles * tl)[..., :m].reshape(shape)
                for p in (ore, oim))
    return (oim, ore) if inverse else (ore, oim)


def _launch_fft_cols(re: torch.Tensor, im: torch.Tensor, inverse: bool, fold,
                     donate: bool, tile: Optional[int] = None):
    """Launch K7 on [B, n, m] planes. ``tile`` overrides :func:`cols_tile`:
    the card's measurement of the tile widths uses it, no path does."""
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"the column FFT kernel takes float32 planes, got "
                        f"{re.dtype}/{im.dtype}")
    if not (re.is_cuda and im.is_cuda and re.device == im.device):
        raise ValueError("the column FFT kernel needs both planes on one CUDA device")
    re, im = re.contiguous(), im.contiguous()
    ore, oim = (re, im) if donate else (torch.empty_like(re), torch.empty_like(im))
    batch, n, m = re.shape
    tile = _check_cols_tile(n, cols_tile(n, m) if tile is None else tile)
    if batch * m == 0:
        return ore, oim
    gc = gs = None
    if fold is not None:
        gc, gs = (torch.as_tensor(g).to(device=re.device, dtype=torch.float32)
                  .contiguous() for g in fold)
    lib = _build.library()
    tw = _device_pass_twiddles(n, re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        code = lib.fft_cols_f32(
            re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
            None if gc is None else gc.data_ptr(),
            None if gs is None else gs.data_ptr(), tw.data_ptr(),
            _plan_code_of(n), batch, n, m, tile, int(inverse), stream)
    _build.check(lib, code, "fft_cols")
    LAUNCHES["fft_cols"] += 1
    return ore, oim


def fft_cols_cuda(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                  fold=None, donate: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over axis -2 of split planes [..., n, m], natural
    row order in and out; the forward transform is unnormalised, the
    inverse scales by 1/n. Power-of-two n in 256..4096, any m.

    ``fold`` = (cos, sin), two (n, m) grids in natural row order: the
    forward result is multiplied by cos + i*sin, the inverse's input is
    multiplied by it before the transform (the inter-stage twiddle of
    :mod:`ops.fft_big` rides the kernel and costs no pass of its own).

    donate=True lets the kernel write the result into ``re``/``im`` (which
    must be contiguous and dead after the call): each block reads its whole
    tile of columns into registers before it writes (a barrier lies
    between), and tiles are disjoint, so in place is safe. A CPU tensor runs :func:`fft_cols_plain`;
    donate has no effect there.
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
    if fold is not None and any(tuple(g.shape) != (n, m) for g in fold):
        raise ValueError(f"fold grids must be two ({n}, {m}) arrays, got "
                         f"{[tuple(g.shape) for g in fold]}")
    if not (re.is_cuda or im.is_cuda):
        return fft_cols_plain(re, im, inverse, fold)
    if donate and not (re.is_contiguous() and im.is_contiguous()):
        # a reshape of anything else would be a copy, and not in place
        raise ValueError("donate=True needs contiguous input planes")
    shape = re.shape
    ore, oim = _launch_fft_cols(re.reshape(-1, n, m), im.reshape(-1, n, m),
                                inverse, fold, donate)
    return ore.reshape(shape), oim.reshape(shape)
