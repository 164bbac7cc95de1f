"""The port's utils/ against the JAX package's: the fixture and SNR
helpers and the checksum equal on the same inputs, checkpoints of every
streaming carry crossing both ways, the profiling helpers on the CPU
(``timed``'s keys, a Chrome trace, ``device_idle_share`` on a synthetic
trace), the debug helpers, the bench harness, and the two ``__all__``
lists."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pragma_dsp_tpu.models as jmodels
import pragma_dsp_tpu.ops as jops
import pragma_dsp_tpu.stream as jstream
import pragma_dsp_tpu.utils as jutils
import pragma_dsp_tpu.utils.checkpoint as jckpt
import pragma_dsp_tpu_torch.models as pmodels
import pragma_dsp_tpu_torch.ops as pops
import pragma_dsp_tpu_torch.stream as pstream
import pragma_dsp_tpu_torch.utils as putils
from pragma_dsp_tpu_torch import set_default_device
from pragma_dsp_tpu_torch.core import ComplexArray
from pragma_dsp_tpu_torch.ops import fft_cuda, fir_filter, pfb_channelize
from pragma_dsp_tpu_torch.utils import benchharness, checkpoint, debug, profiling

RNG = np.random.default_rng(91)


@pytest.fixture(scope="module", autouse=True)
def _cpu_is_the_default_device():
    """These tests run on the CPU and say so: host input (numpy arrays,
    lists, ``device=None``) would otherwise go to the card."""
    previous = set_default_device("cpu")
    yield
    set_default_device(previous)


# ── fixtures.py and checksum: copies, equal on the same inputs ───────

PAIRS = [
    (RNG.standard_normal(64), RNG.standard_normal(64)),
    (np.zeros(8), np.zeros(8)),
    (np.zeros(8), np.ones(8)),
    (RNG.standard_normal((3, 5)), RNG.standard_normal((3, 5))),
    (np.ones(4), np.ones(4)),
    (np.array([]), np.array([])),
]


@pytest.mark.parametrize("fn", ["max_abs_error", "rms_error", "snr_db"])
@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_error_measures_match_jax(fn, i):
    ref, test = PAIRS[i]
    want = getattr(jutils, fn)(ref, test)
    got = getattr(putils, fn)(ref, test)
    assert got == want or (np.isnan(got) and np.isnan(want))
    # tensors on the CPU give the same number
    assert getattr(putils, fn)(torch.from_numpy(ref), torch.from_numpy(test)) == got \
        or np.isnan(got)


def test_fixtures_dir_and_load_json_match_jax():
    assert putils.fixtures_dir() == jutils.fixtures_dir()
    path = os.path.join(putils.fixtures_dir(), "unit_fixtures.json")
    assert putils.load_json(path) == jutils.load_json(path)


@pytest.mark.parametrize("abs_tol,rel_tol", [(1e-3, 0.0), (0.0, 1e-2), (1e-9, 1e-9)])
def test_assert_close_matches_jax(abs_tol, rel_tol):
    ref = RNG.standard_normal(32)
    test = ref + 1e-4 * RNG.standard_normal(32)
    outcomes = []
    for pkg in (jutils, putils):
        try:
            pkg.assert_close(ref, test, abs_tol, rel_tol, label="case")
            outcomes.append(None)
        except AssertionError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("min_db", [60.0, 90.0])
def test_assert_snr_matches_jax(min_db):
    ref = RNG.standard_normal(256)
    test = ref + 1e-4 * RNG.standard_normal(256)
    outcomes = []
    for pkg in (jutils, putils):
        try:
            pkg.assert_snr(ref, test, min_db, label="case")
            outcomes.append(None)
        except AssertionError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("arrays", [
    (RNG.standard_normal(1000),),
    (RNG.standard_normal((7, 33)), RNG.standard_normal(5)),
    (np.arange(10, dtype=np.float32), np.array([]), np.ones(3)),
])
def test_checksum_equals_jax(arrays):
    want = jutils.checksum(*arrays)
    assert putils.checksum(*arrays) == want
    assert putils.checksum(*(torch.from_numpy(np.asarray(a)) for a in arrays)) == want


# ── checkpoint.py: every carry, both ways ────────────────────────────

CARRIES = {
    "StftState": lambda stream, ops, models, dt: stream.stft_stream_init(64, 16, (2,), dt),
    "FirState": lambda stream, ops, models, dt: ops.fir_stream_init(np.ones(9), (2,), dt),
    "PfbState": lambda stream, ops, models, dt: ops.pfb_stream_init(8, 4, (2,), dt),
    "PfbFramesState": lambda stream, ops, models, dt: ops.pfb_frames_stream_init(8, 4, (2,),
                                                                                 dt),
    "UpfirdnState": lambda stream, ops, models, dt: ops.upfirdn_stream_init(
        np.ones(25), 3, 4, (2,), dt),
    "CascadeState": lambda stream, ops, models, dt: ops.resample_cascade_stream_init(
        ((3, 4), (7, 8)), None, 8, (2,), dt),
    "FmDemodState": lambda stream, ops, models, dt: ops.fm_stream_init((2,), dt),
    "WbfmStreamState": lambda stream, ops, models, dt: models.FmReceiver().stream_init(
        (2,), dt),
}


def _port_carry(name):
    like = CARRIES[name](pstream, pops, pmodels, torch.float64)
    leaves = iter(torch.from_numpy(RNG.standard_normal(tuple(t.shape)))
                  for t in checkpoint.tree_leaves(like))
    return checkpoint._rebuild(like, leaves)


@pytest.mark.parametrize("name", list(CARRIES))
def test_port_checkpoint_restores_in_jax(name, tmp_path):
    state = _port_carry(name)
    path = putils.save_state(str(tmp_path / "carry"), state)
    assert path.endswith(".npz")
    jlike = CARRIES[name](jstream, jops, jmodels, jnp.float64)
    back = jckpt.restore_state(path, jlike)
    assert type(back).__name__ == name
    got = jax.tree_util.tree_leaves(back)
    want = checkpoint.tree_leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("name", list(CARRIES))
def test_jax_checkpoint_restores_in_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_try_orbax", lambda: None)   # its npz route
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(RNG.standard_normal(a.shape)),
        CARRIES[name](jstream, jops, jmodels, jnp.float64))
    path = jckpt.save_state(str(tmp_path / "carry"), jstate)
    like = CARRIES[name](pstream, pops, pmodels, torch.float64)
    back = putils.restore_state(path, like)
    assert type(back) is type(like)
    got = checkpoint.tree_leaves(back)
    for g, w, l in zip(got, jax.tree_util.tree_leaves(jstate), checkpoint.tree_leaves(like)):
        assert isinstance(g, torch.Tensor) and g.device == l.device
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_restored_carry_streams_on(tmp_path):
    """A PFB stream checkpointed mid-way and resumed gives the batch result."""
    x = RNG.standard_normal(8 * 40) + 1j * RNG.standard_normal(8 * 40)
    xc = ComplexArray(torch.from_numpy(x.real), torch.from_numpy(x.imag))
    state = pops.pfb_stream_init(8, 4, dtype=torch.float64)
    state, a = pops.pfb_channelize_step(state, ComplexArray(xc.real[:160], xc.imag[:160]), 8,
                                        taps_per_branch=4)
    path = putils.save_state(str(tmp_path / "pfb_resume"), state)
    resumed = putils.restore_state(path, pops.pfb_stream_init(8, 4, dtype=torch.float64))
    _, b = pops.pfb_channelize_step(resumed, ComplexArray(xc.real[160:], xc.imag[160:]), 8,
                                    taps_per_branch=4)
    ref = pfb_channelize(xc, 8, taps_per_branch=4)
    np.testing.assert_allclose(torch.cat([a.real, b.real]).numpy(), ref.real.numpy(),
                               rtol=0, atol=1e-12)


def test_restore_rejects_a_checkpoint_of_another_state(tmp_path):
    path = putils.save_state(str(tmp_path / "fir"), _port_carry("FirState"))
    with pytest.raises(ValueError, match="holds 1 arrays"):
        putils.restore_state(path, _port_carry("PfbState"))


def test_tree_leaves_follow_jax_order():
    tree = {"b": (1.0, None, [2.0, 3.0]), "a": {"z": 4.0, "y": 5.0}}
    assert checkpoint.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)


# ── profiling.py ─────────────────────────────────────────────────────

def test_timed_keys_match_jax():
    got = putils.timed(lambda a: a * 2, torch.ones(8), warmup=1, iters=3)
    want = jutils.timed(lambda a: a * 2, jnp.ones(8), warmup=1, iters=3)
    assert set(got) == set(want) and got["iters"] == 3
    assert 0 < got["min_s"] <= got["avg_s"] <= got["max_s"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.from_numpy(RNG.standard_normal((4, 1024)))
    with putils.trace(str(tmp_path)) as log_dir:
        with putils.annotate("pragma-fir"):
            fir_filter(x, np.ones(31) / 31, "direct")
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pragma-fir" for e in events)
    # no card: no kernel in the window, the device idles all of it
    assert putils.device_idle_share(log_dir) == 1.0


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


@pytest.mark.parametrize("kernels,want", [
    ([], 1.0),
    ([(0, 100)], 0.0),
    ([(10, 20), (50, 10)], 0.7),
    ([(10, 20), (20, 20), (35, 5)], 0.7),       # overlapping kernels count once
    ([(0, 50), (10, 10)], 0.5),                 # one inside another
])
def test_device_idle_share_of_a_synthetic_trace(kernels, want):
    events = [{"ph": "X", "cat": "cpu_op", "name": "op", "ts": 0, "dur": 100},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
              # the profiler's own session and start-up: not the window
              {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": -50, "dur": 400},
              {"ph": "X", "cat": "overhead", "name": "buffers", "ts": -40, "dur": 10}]
    events += [_kernel(a, b) for a, b in kernels]
    assert putils.device_idle_share({"traceEvents": events}) == pytest.approx(want)


def test_device_idle_share_reads_a_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_kernel(0, 30), {
        "ph": "X", "cat": "cpu_op", "name": "op", "ts": 0, "dur": 120}]}))
    assert putils.device_idle_share(str(path)) == pytest.approx(0.75)
    with pytest.raises(ValueError, match="no timed events"):
        putils.device_idle_share({"traceEvents": []})


# ── debug.py ─────────────────────────────────────────────────────────

def test_check_finite_raises_the_jax_message():
    putils.check_finite("ok", torch.ones(3), np.zeros(2))
    for bad in (np.array([1.0, np.nan]), np.array([np.inf])):
        with pytest.raises(ValueError) as got:
            putils.check_finite("stage", torch.ones(2), torch.from_numpy(bad))
        with pytest.raises(ValueError) as want:
            jutils.check_finite("stage", jnp.ones(2), jnp.asarray(bad))
        assert str(got.value) == "check_finite failed at 'stage' (array 1)"
        assert str(want.value).startswith(str(got.value))


def test_checked_keeps_the_contract():
    def stage(x):
        putils.check_finite("stage", x)
        return x * 2

    f = debug.checked(stage)
    assert f.__name__ == "stage"
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="check_finite failed at 'stage'"):
        f(torch.tensor([float("nan")]))


def test_debug_nans_raises_on_a_nan_result():
    x = torch.tensor([-1.0, 4.0])
    assert torch.isnan(torch.sqrt(x)).any()           # outside: no check
    with putils.debug_nans():
        assert torch.equal(torch.sqrt(torch.tensor([4.0])), torch.tensor([2.0]))
        with pytest.raises(FloatingPointError, match="nan"):
            torch.sqrt(x)
        with putils.debug_nans(False):
            torch.sqrt(x)                             # switched off inside
        with pytest.raises(FloatingPointError):
            x.log()
    torch.sqrt(x)


def test_sanitizer_mode_checks_nans_and_not_allocations():
    with putils.sanitizer_mode():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([-1.0]))
        torch.empty(64).fill_(0.0)                    # memory a kernel fills
        torch.empty_like(torch.ones(64)).zero_()
    torch.log(torch.tensor([-1.0]))                   # off again outside
    assert {torch.empty, torch.empty_like, torch.empty_strided} <= debug._UNINITIALISED


def test_sanitizer_mode_results_equal_outside_on_the_cpu():
    x = torch.from_numpy(RNG.standard_normal((3, 2048)).astype(np.float32))
    before = dict(fft_cuda.LAUNCHES)
    with putils.sanitizer_mode():
        a = fir_filter(x, np.hanning(127), "overlap_save")
    assert torch.equal(a, fir_filter(x, np.hanning(127), "overlap_save"))
    assert fft_cuda.LAUNCHES == before


# ── benchharness.py ──────────────────────────────────────────────────

def test_bench_context_on_the_cpu():
    ctx = putils.BenchContext(warmup=1, iters=3)
    x = torch.from_numpy(RNG.standard_normal((4, 256)))
    res = ctx.time("fir", lambda: fir_filter(x, np.ones(9), "direct"),
                   samples_per_call=x.numel(), hbm_bytes_per_call=16 * x.numel(),
                   flops_per_call=18 * x.numel())
    assert res.device == "cpu" and res.iters == 3
    assert 0 < res.min_s <= res.avg_s <= res.max_s
    assert res.checksum == putils.checksum(fir_filter(x, np.ones(9), "direct"))
    assert res.roofline(putils.device_specs()) == {}  # no published peak
    assert set(res.roofline({"hbm_bytes_per_s": 1e9, "f32_flops": 1e9})) == {
        "hbm_fraction", "f32_fraction"}
    report = ctx.report()
    assert report.splitlines()[0] == "device: cpu" and "on cpu" in report
    assert "%" not in report                            # no roofline share


def test_device_specs_and_memory_snapshot_on_the_cpu():
    specs = putils.device_specs()
    assert specs["kind"] == "cpu" and specs["power_limit"] is None
    assert all(specs[k] is None for k in ("hbm_bytes_per_s", "f32_flops", "bf16_flops"))
    snap = benchharness.memory_snapshot()
    assert set(snap) == set(jutils.benchharness.memory_snapshot())
    assert snap["hbm_in_use_bytes"] == 0 and snap["host_rss_bytes"] > 0


def test_h100_specs_are_the_published_rates(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(benchharness, "_power_limit", lambda: "700.00 W")
    specs = putils.device_specs()
    assert (specs["hbm_bytes_per_s"], specs["f32_flops"], specs["bf16_flops"]) == (
        3.35e12, 67e12, 989e12)
    assert specs["power_limit"] == "700.00 W"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 PCIe")
    specs = putils.device_specs()
    assert specs["kind"] == "NVIDIA H100 PCIe" and specs["hbm_bytes_per_s"] is None


def test_utils_all_holds_the_jax_list():
    assert set(jutils.__all__) <= set(putils.__all__)
    for n in putils.__all__:
        assert hasattr(putils, n), n
    assert debug.__all__ == jutils.debug.__all__
