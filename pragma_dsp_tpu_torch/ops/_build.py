"""Build and load the hand-written CUDA kernels (``csrc/``).

The kernels have a plain C interface. Each source is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library, loaded with ``ctypes``. The build happens at first use into
``pragma_dsp_tpu_torch/_build/`` and is keyed by a hash of the sources and
flags, so an edited source rebuilds. Nothing here runs at import time: the
CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: it would swap sqrtf/atan2f for approximations.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # in_re, in_im, out_re, out_im, pass table, plan, batch, n, cols, turn,
    # inverse, pieces, stream
    "fft_rows_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, win, amp, ph (nullable), twc, tws, pass table, plan, batch, n, stream
    "spectrum_onesided_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, win, amp, ph, axis, index, freq, peak amp, peak ph, twc, tws, pass
    # table, plan, batch, n, sample_rate / n, stream
    "spectrum_onesided_peak_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, ctypes.c_double, _P],
    # x, win, amp, cos, sin, pass table (nullable), plan, batch, n, stream
    "spectrum_twosided_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, win, amp, ph (nullable), twc, tws, pass table, plan, batch, length,
    # n, hop, stream
    "stft_onesided_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, hre, him, pass table, plan, batch, n, stream
    "osconv_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # in, out, hre, him, pass table, plan, rows, length, n, overlap, stream
    "osconv_signal_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xre, xim, ore, oim, hp, pass table, plan, frames, m_frames, c, t_taps,
    # blocks, skip, out_frames, out_first, stream
    "pfb_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # in_re, in_im, out_re, out_im, gc, gs (both nullable), pass table, plan,
    # batch, n, m, tile, cluster, inverse, layout, pieces, items a chunk, log2
    # of the generated twiddle's N (0: none), its column offset and sign, stream
    "fft_cols_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    """The kernel sources: every ``.cu`` under ``csrc/`` (headers hashed too)."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _run_all(cmds) -> None:
    """Run the commands as concurrent processes; wait for every one, then
    raise with the output of those that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` unless this exact build exists."""
    target = BUILD_DIR / f"libpragma_dsp_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, target.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
