"""The port's bench (``live_video_magnification_tpu_torch/bench.py``, ``cli.py
bench``) on the CPU at tiny sizes, against the reference package's root
``bench.py``: the same JSON keys and metric names in the same order, the same
frames, the kernel flags reaching the step, failures reported, not hidden.
"""

import importlib.util
import json
import os
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch import bench as tbench
from live_video_magnification_tpu_torch import cli as tcli
from live_video_magnification_tpu_torch.models import color as tcolor
from live_video_magnification_tpu_torch.models import motion as tmotion
from live_video_magnification_tpu_torch.models import riesz as triesz

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--res", "32x48", "--levels", "2", "--steps", "2"]
FAST = {"LVMT_MXU_DTYPE": "bf16", "LVMT_TAIL": "mxu", "LVMT_TAIL_IO": "bf16",
        "LVMT_PYR_IO": "bf16"}
FLAG_VARS = ("LVMT_TAIL", "LVMT_PHASE_FUSED", "LVMT_BUILD", "LVMT_MXU_DTYPE",
             "LVMT_PYR_IO", "LVMT_TAIL_IO", "LVMT_NATIVE")
MODELS = {"phase": triesz, "laplace": tmotion, "color": tcolor}


@pytest.fixture(scope="module")
def jbench():
    """The reference package's root bench.py as a module."""
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_flags(monkeypatch):
    """No kernel flag in the environment; whatever was there restored after."""
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _reference_main(jbench, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    assert jbench.main() == 0


@pytest.mark.parametrize("mode", ["phase", "laplace", "color"])
def test_json_line_has_the_references_keys(mode, jbench, monkeypatch, capsys, clean_flags):
    argv = [*TINY, "--mode", mode]
    _reference_main(jbench, monkeypatch, argv)
    (ref,) = _json_lines(capsys.readouterr().out)
    before = list(sys.argv)
    assert tcli.main(["bench", *argv, "--device", "cpu"]) == 0
    assert sys.argv == before
    captured = capsys.readouterr()
    (got,) = _json_lines(captured.out)
    assert list(got) == list(ref)
    assert got["metric"] == ref["metric"] == f"{mode}_32x48_fps_per_chip"
    assert got["unit"] == "fps" and got["value"] > 0
    # both rounded from the unrounded fps: value to 0.01, vs_baseline to 0.001
    assert abs(got["vs_baseline"] - got["value"] / 60.0) <= 0.0006
    assert "device=cpu levels=2" in captured.err and "checksums=(" in captured.err


@pytest.mark.parametrize("mode", ["phase", "laplace", "color"])
def test_parameters_equal_the_references(mode, jbench):
    """_mode_setup's per-frame parameters, value for value in f32."""
    _, jdyn, _, _ = jbench._mode_setup(mode, 32, 48, 2, 30.0)
    _, dyn, _, _ = tbench._mode_setup(mode, 32, 48, 2, 30.0, torch.device("cpu"))
    assert len(dyn) == len(jdyn)
    for got, want in zip(dyn, jdyn):
        np.testing.assert_array_equal(np.asarray(got, np.float32).ravel(),
                                      np.asarray(want).astype(np.float32).ravel())


def test_frames_equal_the_references_dynamic_slice():
    h, w = 24, 40
    rng = np.random.default_rng(0)
    jbase = jnp.asarray(rng.integers(0, 255, (3, h, w + 64), dtype=np.uint8))
    base = tbench.frame_base(h, w, "cpu")
    for t in (0, 1, 5, 63, 64, 65, 130):
        want = np.asarray(jax.lax.dynamic_slice_in_dim(jbase, t % 64, w, axis=2))
        got = tbench.frame_at(base, t, w)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (3, h, w)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["phase", "laplace", "color"])
def test_warm_checksum_equals_a_plain_step_loop(mode, clean_flags):
    h, w, levels, steps = 32, 48, 2, 3
    got = tbench.bench_mode_scan(mode, h, w, levels, steps, device="cpu")
    base = np.random.default_rng(0).integers(0, 255, (3, h, w + 64), dtype=np.uint8)
    state, dyn, _, _ = tbench._mode_setup(mode, h, w, levels, 30.0, torch.device("cpu"))
    m = MODELS[mode]
    kw = {"framerate": 30.0} if mode == "color" else {}
    total = 0
    for t in range(steps):
        frame = torch.from_numpy(np.ascontiguousarray(base[:, :, t % 64:t % 64 + w]))
        state, out = m.step(state, frame, dyn, levels=levels, **kw)
        total += int(out.numpy()[:, ::64, ::64].astype(np.int64).sum())
    assert got["checksums"][0] == total
    assert set(got) == {"fps", "compile_s", "ms_per_frame", "checksums"}


def _recording_step(monkeypatch, calls):
    real = triesz.step

    def step(state, frame, dyn, **kw):
        calls.append(dict(kw, band_dtype=state.old[0].lowpass.dtype))
        return real(state, frame, dyn, **kw)

    monkeypatch.setattr(triesz, "step", step)


def test_fast_flags_reach_the_step_and_the_environment_is_restored(monkeypatch, clean_flags):
    """The step reads no environment, so the bench must pass the flags: the
    fast run's step gets the four of --fast (and its state bf16 band
    levels); a flag set by the caller reaches the default run; every
    variable is as it was after."""
    calls = []
    _recording_step(monkeypatch, calls)
    monkeypatch.setenv("LVMT_TAIL", "level")
    tbench.bench_fast_mode("phase", 32, 48, 2, 2, device="cpu")
    assert len(calls) == 8  # the warm run and three timed runs of 2 steps
    for kw in calls:
        assert (kw["mxu_dtype"], kw["tail"], kw["tail_io"], kw["pyr_io"]) == (
            "bf16", "mxu", "bf16", "bf16")
        assert kw["band_dtype"] == torch.bfloat16
        assert kw["build"] == "auto" and kw["phase_fused"] is False
    assert os.environ["LVMT_TAIL"] == "level"
    assert not [v for v in FLAG_VARS if v != "LVMT_TAIL" and v in os.environ]
    calls.clear()
    tbench.bench_mode_scan("phase", 32, 48, 2, 2, device="cpu")
    assert {kw["tail"] for kw in calls} == {"level"}
    assert {kw["mxu_dtype"] for kw in calls} == {"f32"}
    monkeypatch.setenv("LVMT_TAIL", "bogus")
    with pytest.raises(ValueError, match="unknown tail"):
        tbench.bench_mode_scan("phase", 32, 48, 2, 2, device="cpu")


def _scan_stub(seen):
    def scan(mode, h, w, levels, steps, fps_cfg=30.0, device=None):
        seen.append((mode, h, w, {v: os.environ.get(v) for v in FAST}))
        return {"fps": 42.0, "compile_s": 0.0, "rtt_s": 0.0, "ms_per_frame": 23.8,
                "checksums": (1, 2)}
    return scan


def test_headline_runs_the_fast_pairing_with_the_references_keys(jbench, monkeypatch, capsys,
                                                                 clean_flags):
    """The 4K headline (stubbed scan: no 4K run here) adds ``fast_mode_fps``
    from a run under the four flags, as the reference's does, and leaves
    the environment as it was; a failure of that run is raised."""
    jseen, seen = [], []
    monkeypatch.setattr(jbench, "bench_mode_scan", _scan_stub(jseen))
    _reference_main(jbench, monkeypatch, ["--steps", "2"])
    (ref,) = _json_lines(capsys.readouterr().out)
    monkeypatch.setattr(tbench, "bench_mode_scan", _scan_stub(seen))
    assert tbench.main(["--steps", "2", "--device", "cpu"]) == 0
    (got,) = _json_lines(capsys.readouterr().out)
    assert list(got) == list(ref) and "fast_mode_fps" in got
    assert got["metric"] == "phase_4k_fps_per_chip" and got["fast_mode_fps"] == 42.0
    assert [s[:3] for s in seen] == [("phase", 2160, 3840)] * 2
    assert seen[0][3] == dict.fromkeys(FAST) and seen[1][3] == FAST
    assert not [v for v in FLAG_VARS if v in os.environ]
    assert "TPU" not in got["note"] and "dB" not in got["note"]

    def broken(*a, **k):
        raise RuntimeError("fast run failed")

    monkeypatch.setattr(tbench, "bench_fast_mode", broken)
    with pytest.raises(RuntimeError, match="fast run failed"):
        tbench.main(["--steps", "2", "--device", "cpu"])


def _stub_port(monkeypatch, fail=None, gl=None):
    fps = lambda *a, **k: {"fps": 30.0, "ms_per_frame": 33.3}
    stubs = {
        "bench_mode_scan": fps, "bench_fast_mode": fps, "bench_time_parallel": fps,
        "bench_sharded_step": fps,
        "bench_streaming": lambda **k: {"fps": 60.0, "latency_ms_p95": 20.0},
        "bench_display_present": lambda: {"fps": 100.0, "present_ms": 10.0,
                                          "idle_poll_us": 1.0},
        "bench_display_present_gl": lambda: {"fps": 100.0, "present_ms": 10.0,
                                             "idle_ms": 1.0, "uploads": 60},
        "_gl_unavailable": lambda: gl,
    }
    if fail is not None:
        def broken(*a, **k):
            raise RuntimeError("out of memory")
        stubs[fail] = broken
    for name, fn in stubs.items():
        monkeypatch.setattr(tbench, name, fn)


def test_matrix_emits_the_references_metrics_in_order(jbench, monkeypatch, capsys):
    fps = lambda *a, **k: {"fps": 30.0, "ms_per_frame": 33.3}
    for name in ("bench_mode_scan", "bench_time_parallel", "bench_sharded_step"):
        monkeypatch.setattr(jbench, name, fps)
    monkeypatch.setattr(jbench, "bench_display_present",
                        lambda: {"fps": 100.0, "present_ms": 10.0, "idle_poll_us": 1.0})
    monkeypatch.setattr(jbench, "bench_display_present_gl",
                        lambda: {"fps": 100.0, "present_ms": 10.0, "idle_ms": 1.0,
                                 "uploads": 60})
    streamed = json.dumps({"fps": 60.0, "latency_ms_p95": 20.0})
    import subprocess

    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=streamed + "\n"))
    ref = jbench.run_matrix(2)
    _stub_port(monkeypatch)
    got = tbench.run_matrix(2, "cpu")
    assert [e["metric"] for e in got] == [e["metric"] for e in ref]
    assert len(got) == 13
    lines = _json_lines(capsys.readouterr().out)
    assert lines[-len(got):] == got  # one JSON line an entry
    for g, r in zip(got, ref):
        assert "error" not in g and "error" not in r
        assert g.get("target") == r.get("target") and g["unit"] == r["unit"]
        assert set(g) == set(r), g["metric"]
        assert g["device"] == "cpu" or g["metric"].startswith("display")
        assert "TPU" not in g.get("note", "") and "relay" not in g.get("note", "")


@pytest.mark.parametrize("fail,gl,rc", [
    (None, None, 0),
    ("bench_time_parallel", None, 1),
    ("bench_streaming", None, 1),
    (None, "ModuleNotFoundError: No module named 'OpenGL'", 0),
])
def test_main_returns_1_when_an_entry_failed(fail, gl, rc, monkeypatch, capsys, tmp_path):
    """One failing entry is written as {"metric", "error"}, the others still
    run, and main returns 1; the GL entry is "skipped" (rc 0) only where no
    GL context can be made."""
    _stub_port(monkeypatch, fail=fail, gl=gl)
    out = tmp_path / "matrix.json"
    assert tbench.main(["--matrix", "--steps", "2", "--out", str(out), "--device", "cpu"]) == rc
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and len(doc["results"]) == 13
    errors = [e for e in doc["results"] if "error" in e]
    assert len(errors) == (0 if fail is None else
                           1 if fail == "bench_time_parallel" else 3)
    assert all("out of memory" in e["error"] for e in errors)
    gl_entry = doc["results"][-1]
    assert gl_entry["metric"] == "display_present_gl_1080p"
    assert ("skipped" in gl_entry) == (gl is not None) and ("value" in gl_entry) == (gl is None)
    if rc:
        assert "# failed: " in capsys.readouterr().err


def test_streaming_and_present_return_the_references_keys(jbench, monkeypatch, clean_flags):
    got = tbench.bench_streaming(h=64, w=96, duration=1.0, device="cpu")
    assert "LVMT_NATIVE" not in os.environ  # restored, not leaked
    ref = jbench.bench_streaming(h=64, w=96, duration=1.0)
    assert set(got) == set(ref)
    assert got["processed"] > 0 and got["fps"] >= 0 and got["target_fps"] == 60.0
    got = tbench.bench_display_present(h=64, w=96, n=8)
    ref = jbench.bench_display_present(h=64, w=96, n=8)
    assert set(got) == set(ref) and got["present_ms"] > 0


def test_bench_subcommand_forwards_to_the_ports_bench(capsys):
    """``cli bench ...`` hands its tail to bench.py's parser, an optional
    leading ``--`` dropped; ``--help`` returns 0 instead of raising
    SystemExit, and sys.argv is left alone."""
    before = list(sys.argv)
    for form in (["bench", "--help"], ["bench", "--", "--help"]):
        assert tcli.main(form) == 0
        out = capsys.readouterr().out
        assert "--matrix" in out and "--device" in out
    assert tcli.main(["bench", "--mode", "bogus"]) == 2  # argparse's usage error
    assert sys.argv == before


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(TINY)
