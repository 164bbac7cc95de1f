"""The port's parallel/ against the JAX package's, rank by rank.

Four gloo ranks of the port run once for the module, in processes of their
own (this file run as a script, ``python tests/test_torch_parallel.py
--rank R --world 4 --dir D``, rendezvous through a file in D). Each rank
takes its block of the same seeded inputs, runs every case on a 1-D mesh
``("x",)`` and on a 2x2 ``("host", "chip")`` mesh with the joint axis, and
writes its blocks of the results, and the messages of the errors it was
meant to raise, to D. The tests gather the blocks in the joint axis' order
and hold them against the JAX package's global result on a 4-device
sub-mesh of conftest's 8 virtual devices: float64 to 1e-10, float32 to the
bound each case states, the same ``ValueError`` messages.

The ranks also run ``entry.dryrun_multichip()`` and a barrier whose fourth
rank never arrives. This module imports torch, numpy and the port only at
its top, so a rank never imports JAX; the JAX package is imported inside
the reference helpers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch import parallel as pp
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import dispatch
from pragma_dsp_tpu_torch.ops.channelizer import pfb_taps
from pragma_dsp_tpu_torch.ops.polyphase import design_lowpass, resampler_taps

WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-10
RANK_TIMEOUT_S = 240
BARRIER_TIMEOUT_S = 1.0


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


# ── the cases ────────────────────────────────────────────────────────
#
# entry: which sharded entry; mesh: "1d" (axis "x") or "2d" (the joint
# axis ("host", "chip"), or "chip" with the batch over "host" for the
# batched FFT); x: the global input's shape, its dtype and whether it is
# complex; tol: "f64" (1e-10) or a float32 bound in dB against the JAX
# result; err: the case must raise ValueError on both sides.

def _case(entry, mesh="1d", shape=(4 * 96,), dtype="f64", cplx=False, tol="f64",
          err=False, **kw):
    return dict(entry=entry, mesh=mesh, shape=shape, dtype=dtype, cplx=cplx,
                tol=tol, err=err, **kw)


CASES = {
    # sharded_fir_filter
    "fir_f64_direct_1d": _case("fir", shape=(2, 4 * 96), taps=31, method="direct"),
    "fir_f64_direct_2d": _case("fir", mesh="2d", shape=(2, 4 * 96), taps=31, method="direct"),
    "fir_f64_complex_1d": _case("fir", cplx=True, taps=63, method="direct"),
    "fir_f32_auto_1d": _case("fir", shape=(2, 4 * 512), dtype="f32", tol=110.0, taps=127,
                             method="auto"),
    # sharded_spectrogram
    "spec_f64_1d": _case("spec", shape=(2, 4 * 256), n_fft=64, hop=16, pad_tail=False),
    "spec_f64_pad_tail_1d": _case("spec", shape=(2, 4 * 256), n_fft=64, hop=16, pad_tail=True),
    "spec_f64_2d": _case("spec", mesh="2d", shape=(4 * 256,), n_fft=64, hop=16,
                         pad_tail=False),
    "spec_f64_short_1d": _case("spec", shape=(4 * 48,), n_fft=64, hop=16, pad_tail=False),
    "spec_f64_two_sided_1d": _case("spec", shape=(4 * 256,), n_fft=64, hop=32, pad_tail=False,
                                   sides="two"),
    "spec_f32_1d": _case("spec", shape=(2, 4 * 512), dtype="f32", tol=100.0, n_fft=256,
                         hop=128, pad_tail=False),
    # sharded_pfb_channelize
    "pfb_f64_turn_1d": _case("pfb", shape=(4 * 64,), cplx=True, c=8, tpb=4, turn=True),
    "pfb_f64_frames_out_1d": _case("pfb", shape=(4 * 64,), cplx=True, c=8, tpb=4, turn=False),
    "pfb_f64_turn_2d": _case("pfb", mesh="2d", shape=(4 * 64,), cplx=True, c=8, tpb=4,
                             turn=True),
    "pfb_f64_batch_turn_1d": _case("pfb", shape=(2, 4 * 64), cplx=True, c=8, tpb=4, turn=True),
    "pfb_f64_taps_1d": _case("pfb", shape=(4 * 64,), cplx=True, c=8, tpb=4, turn=True,
                             taps=20),
    "pfb_f32_turn_1d": _case("pfb", shape=(4 * 256,), dtype="f32", cplx=True, tol=110.0,
                             c=16, tpb=8, turn=True),
    # sharded_pfb_channelize_frames
    "pfbf_f64_turn_1d": _case("pfbf", shape=(4 * 8, 8), cplx=True, c=8, tpb=4, turn=True),
    "pfbf_f64_frames_out_1d": _case("pfbf", shape=(4 * 8, 8), cplx=True, c=8, tpb=4,
                                    turn=False),
    "pfbf_f64_turn_2d": _case("pfbf", mesh="2d", shape=(4 * 8, 8), cplx=True, c=8, tpb=4,
                              turn=True),
    "pfbf_f64_batch_frames_out_2d": _case("pfbf", mesh="2d", shape=(2, 4 * 8, 8), cplx=True,
                                          c=8, tpb=4, turn=False),
    # sharded_channel_power
    "pow_f64_1d": _case("pow", shape=(4 * 8, 8), cplx=True, c=8, tpb=4, n_fft=4,
                        window="hann"),
    "pow_f64_2d": _case("pow", mesh="2d", shape=(4 * 8, 8), cplx=True, c=8, tpb=4, n_fft=4,
                        window="hann"),
    "pow_f64_rect_1d": _case("pow", shape=(4 * 16, 8), cplx=True, c=8, tpb=4, n_fft=8,
                             window="rect"),
    # sharded_upfirdn, sharded_resample_poly
    "up_f64_3_4_1d": _case("up", shape=(4 * 64,), up=3, down=4, taps=25),
    "up_f64_1_4_1d": _case("up", shape=(2, 4 * 64), up=1, down=4, taps=31),
    "up_f64_complex_2_1_1d": _case("up", shape=(4 * 64,), cplx=True, up=2, down=1, taps=17),
    "up_f64_3_4_2d": _case("up", mesh="2d", shape=(4 * 64,), up=3, down=4, taps=25),
    "rs_f64_147_160_1d": _case("rs", shape=(4 * 320,), up=147, down=160),
    "rs_f64_complex_6_8_2d": _case("rs", mesh="2d", shape=(4 * 64,), cplx=True, up=6, down=8,
                                   num_taps=25),
    # sharded_wbfm_demod
    "wbfm_f64_1d": _case("wbfm", shape=(4 * 16800,), cplx=True),
    "wbfm_f64_2d": _case("wbfm", mesh="2d", shape=(4 * 16800,), cplx=True),
    "wbfm_f64_halo_1d": _case("wbfm", shape=(4 * 1000,), cplx=True, halo=400),
    # dist_fft / dist_ifft: forward (permuted rows) and the roundtrip
    "fft_f64_c1_1d": _case("fft", n=4096, chunks=1),
    "fft_f64_c2_1d": _case("fft", n=4096, chunks=2),
    "fft_f64_c4_1d": _case("fft", n=4096, chunks=4),
    "fft_f64_auto_1d": _case("fft", n=4096, chunks=None),
    "fft_f64_batch_axis_2d": _case("fft", mesh="batch", n=4096, chunks=1, batch=2),
    "fft_f64_batch_1d": _case("fft", n=4096, chunks=2, batch=3),
    "fft_f64_batch_chunks_1d": _case("fft", n=4096, chunks=2, batch=4),
    "fft_f64_batch_c4_1d": _case("fft", n=4096, chunks=4, batch=4),
    "fft_f64_batch_axis_c2_2d": _case("fft", mesh="batch", n=4096, chunks=2, batch=4),
    "fft_f32_1d": _case("fft", dtype="f32", tol=110.0, n=4096, chunks=2),
    "fft_f32_batch_chunks_1d": _case("fft", dtype="f32", tol=110.0, n=4096, chunks=2, batch=2),
    "fft_f32_cols_fold_1d": _case("fft", dtype="f32", tol=110.0, n=1 << 16, chunks=1,
                                  fold=True),
    # the halo-coverage guards and the other ValueErrors
    "err_fir_history": _case("fir", shape=(4 * 64,), taps=127, method="auto", err=True),
    "err_spec_overlap": _case("spec", shape=(4 * 64,), n_fft=128, hop=32, pad_tail=False,
                              err=True),
    "err_spec_hop": _case("spec", shape=(4 * 100,), n_fft=64, hop=32, pad_tail=False,
                          err=True),
    "err_pfb_multiple": _case("pfb", shape=(4 * 36,), cplx=True, c=8, tpb=4, turn=True,
                              err=True),
    "err_pfb_history": _case("pfb", shape=(4 * 16,), cplx=True, c=8, tpb=4, turn=True,
                             err=True),
    "err_pfbf_shape": _case("pfbf", shape=(4 * 4, 7), cplx=True, c=8, tpb=4, turn=True,
                            err=True),
    "err_pfbf_history": _case("pfbf", shape=(4 * 2, 8), cplx=True, c=8, tpb=4, turn=True,
                              err=True),
    "err_pow_history": _case("pow", shape=(4 * 2, 8), cplx=True, c=8, tpb=4, n_fft=2,
                             window="hann", err=True),
    "err_pow_multiple": _case("pow", shape=(4 * 12, 8), cplx=True, c=8, tpb=4, n_fft=8,
                              window="hann", err=True),
    "err_up_block": _case("up", shape=(4 * 100,), up=147, down=160, taps=9, err=True),
    "err_up_history": _case("up", shape=(4 * 64,), up=1, down=4, taps=1177, err=True),
    "err_wbfm_quantum": _case("wbfm", shape=(4 * 16801,), cplx=True, err=True),
    "err_wbfm_halo": _case("wbfm", shape=(4 * 400,), cplx=True, err=True),
    "err_fft_divide": _case("fft", shape=(6, 16), err=True, chunks=1),
    "err_fft_chunks": _case("fft", n=4096, chunks=3, err=True),
    "err_fft_batch_axis_name": _case("fft", n=4096, chunks=1, batch_axis="nope", err=True),
    "err_fft_batch_dim": _case("fft", mesh="batch", n=4096, chunks=1, err=True),
}

# The sharded upfirdn where len(taps) <= up - down: the port raises (as its
# upfirdn_step does); the JAX result is short and misaligned there.
GUARD_CASES = [(up, down, k) for up in (1, 2, 5) for down in (1, 2, 5)
               for k in (1, 2, 3, 4, 6) if k <= up - down]
for _up, _down, _k in GUARD_CASES:
    CASES[f"guard_{_up}_{_down}_{_k}"] = _case("up", shape=(4 * 40 * _down,), up=_up,
                                               down=_down, taps=("random", _k), err=True)


# ── inputs and layouts, shared by the ranks and the reference ────────

def _taps(spec):
    """The case's taps (float64; float32 for a float32 FIR), or None."""
    t = spec.get("taps")
    if t is None:
        return None
    if spec["entry"] == "fir":
        return design_lowpass(t, 0.2).astype(np.float32 if spec["dtype"] == "f32"
                                             else np.float64)
    if isinstance(t, tuple):                        # ("random", k)
        return np.random.default_rng(zlib.crc32(repr(t).encode())).standard_normal(t[1])
    if spec["entry"] == "pfb":                      # a truncated prototype
        return pfb_taps(spec["c"], spec["tpb"])[:t]
    if spec["entry"] == "up" and "up" in spec and spec["up"] != 1:
        return resampler_taps(spec["up"], spec["down"], t)
    return design_lowpass(t, 0.2)


def _input(name, spec):
    """The case's global input, seeded by its name: float64 or float32,
    real or complex."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if spec["entry"] == "fft" and "n" in spec:
        n2, n1 = pp.dist_fft_shape(spec["n"], _fft_devices(spec))
        shape = ((spec["batch"],) if "batch" in spec else ()) + (n2, n1)
        cplx = True
    else:
        shape = spec["shape"]
        cplx = spec["cplx"] or spec["entry"] == "fft"
    if spec["entry"] == "wbfm":
        t = np.arange(shape[-1]) / 2.4e6
        msg = 0.7 * np.sin(2 * np.pi * 1000.0 * t) + 0.2 * np.sin(2 * np.pi * 4000.0 * t)
        x = np.exp(1j * (1.0 + 2 * np.pi * 75e3 * np.cumsum(msg) / 2.4e6))
        x = x + 0.001 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    else:
        x = rng.standard_normal(shape)
        if cplx:
            x = x + 1j * rng.standard_normal(shape)
    if spec["dtype"] == "f32":
        x = x.astype(np.complex64 if cplx else np.float32)
    return x


def _fft_devices(spec):
    return 2 if spec["mesh"] == "batch" else WORLD


def _in_axis(spec):
    """The axis the input is split along over the (joint) mesh axis."""
    if spec["entry"] in ("pfbf", "pow"):
        return -2
    return -1


def _out_layout(spec, field):
    """How a field's rank blocks form the global result: ("cat", axis) in
    the joint axis' order, or ("same",) for a replicated result."""
    e = spec["entry"]
    if e == "spec":
        if field == "frequencies":
            return ("same",)
        return ("cat", -2) if field in ("amplitude", "phase") else ("cat", -1)
    if e in ("pfb", "pfbf"):
        return ("cat", -1) if spec["turn"] else ("cat", -2)
    if e == "pow":
        return ("same",)
    if e == "fft":
        return ("cat", -2) if field == "p" else ("cat", -1)
    return ("cat", -1)


def _coords(spec, rank):
    """(position along the sharded axis, batch shard or None) of a rank."""
    if spec["mesh"] == "batch":
        return rank % 2, rank // 2
    return rank, None


def _local(spec, x, rank, axis):
    pos, bshard = _coords(spec, rank)
    d = _fft_devices(spec) if spec["entry"] == "fft" else WORLD
    if bshard is not None and x.ndim >= 3:
        x = np.split(x, 2, axis=0)[bshard]
    return np.split(x, d, axis=axis)[pos]


def _gather(spec, field, blocks):
    layout = _out_layout(spec, field)
    if layout[0] == "same":
        return blocks[0]
    if spec["mesh"] == "batch":
        rows = [np.concatenate([blocks[2 * h + c] for c in range(2)], axis=layout[1])
                for h in range(2)]
        return np.concatenate(rows, axis=0)
    return np.concatenate(blocks, axis=layout[1])


# ── the port, on one rank ────────────────────────────────────────────

def _t(a):
    a = np.ascontiguousarray(a)
    if np.iscomplexobj(a):
        return ComplexArray(torch.from_numpy(a.real.copy()), torch.from_numpy(a.imag.copy()))
    return torch.from_numpy(a)


def _np(v):
    if isinstance(v, ComplexArray):
        return v.real.numpy() + 1j * v.imag.numpy()
    return v.numpy()


def _port_case(spec, x, mesh, axis):
    e = spec["entry"]
    taps = _taps(spec)
    if e == "fir":
        return {"y": pp.sharded_fir_filter(x, taps, mesh, axis, spec["method"])}
    if e == "spec":
        r = pp.sharded_spectrogram(x, spec["n_fft"], spec["hop"], "hann", 48000.0,
                                   spec.get("sides", "one"), mesh=mesh, axis=axis,
                                   pad_tail=spec["pad_tail"])
        return {"frequencies": r.frequencies, "amplitude": r.amplitude, "phase": r.phase,
                **{f"peak_{k}": v for k, v in r.peak._asdict().items()}}
    if e in ("pfb", "pfbf"):
        fn = pp.sharded_pfb_channelize if e == "pfb" else pp.sharded_pfb_channelize_frames
        return {"y": fn(x, spec["c"], taps, spec["tpb"], mesh=mesh, axis=axis,
                        channels_sharded_out=spec["turn"])}
    if e == "pow":
        return {"p": pp.sharded_channel_power(x, spec["c"], taps, spec["tpb"], mesh=mesh,
                                              axis=axis, n_fft=spec["n_fft"],
                                              window=spec["window"])}
    if e == "up":
        return {"y": pp.sharded_upfirdn(x, taps, spec["up"], spec["down"], mesh=mesh,
                                        axis=axis)}
    if e == "rs":
        return {"y": pp.sharded_resample_poly(x, spec["up"], spec["down"],
                                              num_taps=spec.get("num_taps", 127),
                                              mesh=mesh, axis=axis)}
    if e == "wbfm":
        return {"y": pp.sharded_wbfm_demod(x, mesh, axis, halo=spec.get("halo", 8192))}
    if e == "fft":
        kw = dict(chunks=spec["chunks"])
        if spec["mesh"] == "batch" or "batch_axis" in spec:
            kw["batch_axis"] = spec.get("batch_axis", "host")
        p = pp.dist_fft(x, mesh, axis, **kw)
        return {"p": p, "rt": pp.dist_ifft(p, mesh, axis, **kw)}
    raise ValueError(e)


def _rank_main(rank: int, world: int, folder: str) -> None:
    """One rank of the module's port run: every case, the dry run, the
    barrier that times out."""
    torch.set_num_threads(1)
    set_default_device("cpu")
    pp.init_multihost(f"file://{os.path.join(folder, 'rendezvous')}", world, rank,
                      timeout_s=RANK_TIMEOUT_S, backend="gloo")
    meshes = {"1d": (pp.data_mesh(device_type="cpu"), "x"),
              "2d": (pp.make_mesh((2, 2), ("host", "chip"), device_type="cpu"),
                     ("host", "chip"))}
    meshes["batch"] = (meshes["2d"][0], "chip")
    arrays, report = {}, {"errors": {}, "times": {}}
    for name, spec in CASES.items():
        mesh, axis = meshes[spec["mesh"]]
        x = _t(_local(spec, _input(name, spec), rank, _in_axis(spec)))
        if spec.get("fold"):
            dispatch.set_fft_impl("cuda")       # K7's plain version on the CPU
        t0 = time.perf_counter()
        try:
            out = _port_case(spec, x, mesh, axis)
        except ValueError as exc:
            report["errors"][name] = str(exc)
            continue
        finally:
            dispatch.set_fft_impl("auto")
        report["times"][name] = time.perf_counter() - t0
        for field, v in out.items():
            arrays[f"{name}|{field}"] = _np(v)
    from pragma_dsp_tpu_torch.entry import dryrun_multichip

    report["dryrun"] = {k: list(v) for k, v in dryrun_multichip().items()}
    groups = len(pp.mesh._JOINT_GROUPS)
    dryrun_multichip()                  # new meshes over the same ranks
    report["joint_groups"] = [groups, len(pp.mesh._JOINT_GROUPS)]
    report["health"] = pp.health_check()
    report["jax_modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "jaxlib")) or m == "pragma_dsp_tpu" or m.startswith("pragma_dsp_tpu."))
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **arrays)
    # The last act: ranks 1..3 wait at a barrier that rank 0 never joins.
    if rank > 0:
        try:
            pp.barrier(timeout_s=BARRIER_TIMEOUT_S)
            report["barrier"] = "returned"
        except pp.BarrierTimeout as exc:
            report["barrier"] = f"{type(exc).__name__}: {exc}"
    with open(os.path.join(folder, f"rank{rank}.json.tmp"), "w") as f:
        json.dump(report, f)
    os.replace(os.path.join(folder, f"rank{rank}.json.tmp"),
               os.path.join(folder, f"rank{rank}.json"))
    if rank == 0:
        # stay in the group until the others have given up on the barrier
        deadline = time.time() + RANK_TIMEOUT_S
        while time.time() < deadline and not all(
                os.path.exists(os.path.join(folder, f"rank{r}.json")) for r in range(world)):
            time.sleep(0.05)
    sys.stdout.flush()
    os._exit(0)       # the timed-out barrier's thread still waits in gloo


# ── the run, once for the module ─────────────────────────────────────

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks; the first test that needs them waits."""
    folder = str(tmp_path_factory.mktemp("ranks"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(WORLD), "--dir", folder],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    state = {}

    def results():
        if not state:
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
            finally:
                for p in procs:
                    p.kill()
            for r, (p, (out, err)) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}\n{err}"
            state["arrays"] = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
                               for r in range(WORLD)]
            state["reports"] = []
            for r in range(WORLD):
                with open(os.path.join(folder, f"rank{r}.json")) as f:
                    state["reports"].append(json.load(f))
            state["stdout"] = [o for o, _ in outs]
        return state

    yield results
    for p in procs:
        p.kill()


def _port_global(ranks, name, field):
    spec = CASES[name]
    blocks = [ranks()["arrays"][r][f"{name}|{field}"] for r in range(WORLD)]
    if _out_layout(spec, field)[0] == "same":
        for b in blocks[1:]:
            np.testing.assert_array_equal(b, blocks[0])
    return _gather(spec, field, blocks)


# ── the JAX package's global results ─────────────────────────────────

def _jax_meshes():
    from pragma_dsp_tpu.parallel import make_mesh

    return {"1d": (make_mesh((4,), ("x",)), "x"),
            "2d": (make_mesh((2, 2), ("host", "chip")), ("host", "chip"))}


def _jax_case(name):
    """The JAX package's global result of a case: {field: numpy}, or the
    ValueError's message."""
    import jax.numpy as jnp

    from pragma_dsp_tpu import parallel as jp
    from pragma_dsp_tpu.core import ComplexArray as JComplex
    from pragma_dsp_tpu.ops import set_fft_impl

    spec = CASES[name]
    meshes = _jax_meshes()
    meshes["batch"] = (meshes["2d"][0], "chip")
    mesh, axis = meshes[spec["mesh"]]
    x = _input(name, spec)
    xj = JComplex(jnp.asarray(x.real), jnp.asarray(x.imag)) if np.iscomplexobj(x) \
        else jnp.asarray(x)
    taps = _taps(spec)
    e = spec["entry"]
    cnp = lambda z: np.asarray(z.real) + 1j * np.asarray(z.imag)  # noqa: E731
    try:
        if e == "fir":
            y = jp.sharded_fir_filter(xj, jnp.asarray(taps), mesh, axis, spec["method"])
            return {"y": cnp(y) if spec["cplx"] else np.asarray(y)}
        if e == "spec":
            r = jp.sharded_spectrogram(xj, spec["n_fft"], spec["hop"], "hann", 48000.0,
                                       spec.get("sides", "one"), mesh=mesh, axis=axis,
                                       pad_tail=spec["pad_tail"])
            return {"frequencies": np.asarray(r.frequencies),
                    "amplitude": np.asarray(r.amplitude), "phase": np.asarray(r.phase),
                    **{f"peak_{k}": np.asarray(v) for k, v in r.peak._asdict().items()}}
        if e in ("pfb", "pfbf"):
            fn = jp.sharded_pfb_channelize if e == "pfb" else jp.sharded_pfb_channelize_frames
            return {"y": cnp(fn(xj, spec["c"], taps, spec["tpb"], mesh=mesh, axis=axis,
                                channels_sharded_out=spec["turn"]))}
        if e == "pow":
            return {"p": np.asarray(jp.sharded_channel_power(
                xj, spec["c"], taps, spec["tpb"], mesh=mesh, axis=axis,
                n_fft=spec["n_fft"], window=spec["window"]))}
        if e in ("up", "rs"):
            if e == "up":
                y = jp.sharded_upfirdn(xj, taps, spec["up"], spec["down"], mesh=mesh,
                                       axis=axis)
            else:
                y = jp.sharded_resample_poly(xj, spec["up"], spec["down"],
                                             num_taps=spec.get("num_taps", 127),
                                             mesh=mesh, axis=axis)
            return {"y": cnp(y) if spec["cplx"] else np.asarray(y)}
        if e == "wbfm":
            return {"y": np.asarray(jp.sharded_wbfm_demod(xj, mesh, axis,
                                                          halo=spec.get("halo", 8192)))}
        if e == "fft":
            kw = dict(chunks=spec["chunks"])
            if spec["mesh"] == "batch" or "batch_axis" in spec:
                kw["batch_axis"] = spec.get("batch_axis", "host")
            if spec.get("fold"):
                set_fft_impl("pallas")         # the column kernel in interpret mode
            try:
                p = jp.dist_fft(xj, mesh, axis, **kw)
                rt = jp.dist_ifft(p, mesh, axis, **kw)
            finally:
                set_fft_impl("auto")
            return {"p": cnp(p), "rt": cnp(rt)}
    except ValueError as exc:
        return str(exc)
    raise ValueError(e)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = float(np.sum(np.abs(np.asarray(got, np.complex128) - ref) ** 2))
    return np.inf if err == 0 else 10 * np.log10(float(np.sum(np.abs(ref) ** 2)) / err)


def _wrapped(d):
    return np.abs(np.angle(np.exp(1j * d)))


VALUE_CASES = [n for n, s in CASES.items() if not s["err"]]
ERROR_CASES = [n for n, s in CASES.items() if s["err"] and not n.startswith("guard_")]


@pytest.mark.parametrize("name", VALUE_CASES)
def test_sharded_entry_matches_jax(ranks, name):
    spec = CASES[name]
    ref = _jax_case(name)
    assert isinstance(ref, dict), ref
    assert name not in ranks()["reports"][0]["errors"], ranks()["reports"][0]["errors"][name]
    for field, want in ref.items():
        got = _port_global(ranks, name, field)
        assert got.shape == want.shape, (field, got.shape, want.shape)
        if spec.get("sides") == "two" and field in ("peak_index", "peak_frequency",
                                                    "peak_phase"):
            # bins k and n - k of a real frame tie: either may be the peak
            if field == "peak_index":
                assert np.all((got == want) | (got == spec["n_fft"] - want))
            continue
        if field == "phase" or field == "peak_phase":
            amp = ref["amplitude"] if field == "phase" else ref["peak_amplitude"]
            mask = amp > (1e-6 if spec["tol"] == "f64" else 1e-3)
            bound = 1e-8 if spec["tol"] == "f64" else 1e-4
            assert _wrapped(got[mask] - want[mask]).max() <= bound, field
        elif field in ("peak_index", "frequencies"):
            np.testing.assert_array_equal(got, want)
        elif field == "peak_frequency":
            np.testing.assert_array_equal(got, want)
        elif spec["tol"] == "f64":
            np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL, err_msg=field)
        else:
            assert got.dtype in (np.float32, np.complex64, np.int32, np.int64), got.dtype
            assert _snr_db(want, got) >= spec["tol"], (field, _snr_db(want, got))


@pytest.mark.parametrize("name", ERROR_CASES)
def test_guards_raise_the_jax_messages(ranks, name):
    ref = _jax_case(name)
    assert isinstance(ref, str), f"the JAX package did not raise: {ref}"
    for r in range(WORLD):
        assert ranks()["reports"][r]["errors"].get(name) == ref, (r, ref)


@pytest.mark.parametrize("up,down,k", GUARD_CASES)
def test_upfirdn_guard_decision(ranks, up, down, k):
    """Where len(taps) <= up - down the JAX sharded upfirdn is short and
    misaligned against scipy's batch prefix, and the port raises as its
    upfirdn_step does."""
    from scipy import signal as sps

    name = f"guard_{up}_{down}_{k}"
    spec = CASES[name]
    ref = _jax_case(name)
    x = _input(name, spec)
    batch = sps.upfirdn(_taps(spec), x, up, down)
    want = x.shape[-1] * up // down
    n = min(want, ref["y"].shape[-1])
    assert ref["y"].shape[-1] < want or np.abs(ref["y"][:n] - batch[:n]).max() > 0.1
    msg = ranks()["reports"][0]["errors"][name]
    assert "needs len(taps) > up - down" in msg


def test_sharded_entries_agree_with_single_device_port(ranks):
    """The gathered blocks against the port's own unsharded entries."""
    from pragma_dsp_tpu_torch.ops import fir_filter, pfb_channelize, upfirdn
    from pragma_dsp_tpu_torch.stream import spectrogram

    x = _input("fir_f64_direct_1d", CASES["fir_f64_direct_1d"])
    np.testing.assert_allclose(_port_global(ranks, "fir_f64_direct_1d", "y"),
                               fir_filter(_t(x), design_lowpass(31, 0.2), "direct").numpy(),
                               rtol=0, atol=F64_TOL)
    x = _input("spec_f64_1d", CASES["spec_f64_1d"])
    np.testing.assert_allclose(_port_global(ranks, "spec_f64_1d", "amplitude"),
                               spectrogram(_t(x), 64, 16, "hann", 48000.0).amplitude.numpy(),
                               rtol=0, atol=F64_TOL)
    x = _input("pfb_f64_frames_out_1d", CASES["pfb_f64_frames_out_1d"])
    np.testing.assert_allclose(_port_global(ranks, "pfb_f64_frames_out_1d", "y"),
                               _np(pfb_channelize(_t(x), 8, taps_per_branch=4)),
                               rtol=0, atol=F64_TOL)
    spec = CASES["up_f64_3_4_1d"]
    x = _input("up_f64_3_4_1d", spec)
    got = _port_global(ranks, "up_f64_3_4_1d", "y")
    np.testing.assert_allclose(got, upfirdn(_t(x), _taps(spec), 3, 4).numpy()[:got.shape[-1]],
                               rtol=0, atol=F64_TOL)


def test_dist_fft_matches_numpy(ranks):
    """The gathered permuted spectrum is numpy's FFT, and the roundtrip the
    input, at every chunk depth."""
    for name in ("fft_f64_c1_1d", "fft_f64_c2_1d", "fft_f64_c4_1d", "fft_f64_auto_1d"):
        x = _input(name, CASES[name])
        p = _port_global(ranks, name, "p")
        got = pp.permuted_to_natural_host(ComplexArray(torch.from_numpy(p.real.copy()),
                                                       torch.from_numpy(p.imag.copy())))
        np.testing.assert_allclose(got, np.fft.fft(x.reshape(-1)), rtol=0, atol=1e-9)
        np.testing.assert_allclose(_port_global(ranks, name, "rt"), x, rtol=0, atol=F64_TOL)


def test_barrier_whose_peer_never_arrives_times_out(ranks):
    for r in range(1, WORLD):
        got = ranks()["reports"][r]["barrier"]
        assert got == (f"BarrierTimeout: barrier did not complete within "
                       f"{BARRIER_TIMEOUT_S:.1f}s across {WORLD} process(es) / {WORLD} "
                       "device(s) — a peer host is likely dead or unreachable"), got


def test_dryrun_multichip_at_four_ranks(ranks):
    """Every rank ran the dry run, 2-D steps included; the gathered shapes
    are the JAX dry run's global shapes."""
    shapes = [ranks()["reports"][r]["dryrun"] for r in range(WORLD)]
    d = WORLD
    frames = sum(s["spectrogram"][0] for s in shapes)
    assert frames == 1 + (d * 8 * 32 - 128) // 32
    n2, n1 = pp.dist_fft_shape(max(4096, d * d * 64), d)
    for r, s in enumerate(shapes):
        assert s["fir"] == [8 * 32] and s["dist_fft"] == [n2 // d, n1]
        assert s["roundtrip"] == [n2, n1 // d] and s["pfb"] == [4 * d, 4]
        assert s["pfb_frames"] == [8, 4 * d] and s["power"] == [8, 4 * d]
        assert s["resample"] == [240] and s["wbfm"] == [16]
        assert s["pfb2d"] == [4 * d, 4] and s["power2d"] == [8, 4 * d]
        assert s["fir2d"] == [4 * d * 4] and s["fft2d"] == [1, 32, 64]
    assert all("dryrun_multichip(4)" in out for out in ranks()["stdout"])


def test_joint_axis_groups_are_made_once_per_rank_layout(ranks):
    """A second dry run builds its meshes anew over the same ranks and
    makes no more process groups."""
    for r in range(WORLD):
        made, after = ranks()["reports"][r]["joint_groups"]
        assert made == 1 and after == made, (r, made, after)


def test_health_check_on_gloo_ranks(ranks):
    for r in range(WORLD):
        h = ranks()["reports"][r]["health"]
        assert h["process_index"] == r and h["process_count"] == WORLD
        assert h["platform"] == "cpu" and h["devices"] == []
        assert set(h) == {"process_index", "process_count", "local_devices",
                          "global_devices", "platform", "devices"}


def test_jax_health_check_has_the_same_keys():
    from pragma_dsp_tpu.parallel import health_check

    assert set(health_check()) == set(pp.health_check())


# ── what needs no process group ──────────────────────────────────────

@pytest.mark.parametrize("n,d", [(4096, 1), (4096, 4), (4096, 8), (1 << 16, 4),
                                 (1 << 20, 8), (64, 8), (100, 2)])
def test_dist_fft_shape_matches_jax(n, d):
    from pragma_dsp_tpu.parallel import dist_fft_shape as jshape

    try:
        want = jshape(n, d)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            pp.dist_fft_shape(n, d)
        return
    assert pp.dist_fft_shape(n, d) == want


@pytest.mark.parametrize("n2,n1,d,inverse", [(1024, 1024, 1, False), (128, 128, 2, False),
                                             (1024, 1024, 4, False), (4096, 2048, 8, True),
                                             (8192, 8192, 8, False), (256, 64, 4, True)])
def test_optimal_chunks_matches_jax_with_the_same_constants(n2, n1, d, inverse):
    from pragma_dsp_tpu.parallel import optimal_chunks as jchunks

    for consts in ((1e11, 4.5e10, 2.2e-6), (450e9, 1.8e11, 3e-5), (1e9, 1e12, 1e-7)):
        kw = dict(a2a_bw=consts[0], fft_rate=consts[1], overhead_s=consts[2])
        assert pp.optimal_chunks(n2, n1, d, inverse, **kw) == jchunks(n2, n1, d, inverse, **kw)
    c = pp.optimal_chunks(n2, n1, d, inverse)
    assert 1 <= c <= 8 and ((n1 if inverse else n2) // d) % c == 0


def test_permuted_to_natural_host_matches_jax():
    import jax.numpy as jnp

    from pragma_dsp_tpu.core import ComplexArray as JComplex
    from pragma_dsp_tpu.parallel import permuted_to_natural_host as jp2n

    z = np.random.default_rng(3).standard_normal((2, 8, 16, 2)).view(np.complex128)[..., 0]
    got = pp.permuted_to_natural_host(_t(z))
    np.testing.assert_array_equal(got, jp2n(JComplex(jnp.asarray(z.real), jnp.asarray(z.imag))))


def test_parallel_all_is_the_jax_list_less_p_and_named_sharding():
    import pragma_dsp_tpu.parallel as jpar

    assert pp.__all__ == [n for n in jpar.__all__ if n not in ("P", "NamedSharding")]
    for n in pp.__all__:
        assert hasattr(pp, n), n


def test_no_process_group_needed_for_a_lone_barrier():
    pp.barrier(timeout_s=1.0)
    assert not pp.is_multihost()


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        pp.init_multihost("127.0.0.1:1", 1, 0)


def test_ranks_import_no_jax(ranks):
    """A rank imported this module's top level, ran every case and the dry
    run: no module of JAX or of the JAX package was loaded."""
    for r in range(WORLD):
        assert ranks()["reports"][r]["jax_modules"] == [], r


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--rank", type=int, required=True)
    args.add_argument("--world", type=int, required=True)
    args.add_argument("--dir", required=True)
    a = args.parse_args()
    _rank_main(a.rank, a.world, a.dir)
