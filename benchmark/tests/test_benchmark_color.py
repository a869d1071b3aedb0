"""The colour configuration: its plain reference against the program on the
CPU at small sizes (through the window's fill, its first full frame and its
steady shift), the packed-spectrum gains, the bf16 control, the cell
``color_vga_live30`` at a CPU size, its span readers on fixed spans, and on
the card the reference against the program at 270x480."""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import program, readers
from benchmark.harness.cell import load_reader
from benchmark.harness.clip import make_clip
from benchmark.reference.color import ColorReference, ideal_bandpass, packed_gains, window_rows
from benchmark.run import run_cell
from live_video_magnification_tpu_torch.engine import profiling
from live_video_magnification_tpu_torch.engine.profiling import Span
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.models import color as color_mode
from live_video_magnification_tpu_torch.ops.temporal import ideal_bandpass_apply
from test_benchmark_harness import SEED, _run, _small_copy

ROOT = Path(__file__).resolve().parents[2]
COLOR = json.loads((ROOT / "benchmark" / "configs" / "color_vga_l4.json").read_text())
CLIP = {"frames": 40, "waves": 8, "min_wavelength_px": 6.0, "shift_px": 0.5, "pulse": 0.02}
# 8 fps: a window of 16 rows, so 40 frames hold its fill, its first full frame and 24 shifts
SMALL = dict(COLOR, levels=3, capture_fps=8.0)


def _frames(cfg, h, w, frames=40, seed=3, device=torch.device("cpu")):
    cfg = dict(cfg, height=h, width=w)
    clip = make_clip(dict(CLIP, frames=frames), h, w, cfg["capture_fps"],
                     (cfg["low_hz"], cfg["high_hz"]), seed, device)
    proc = ClipProcessor(program.processor_config(cfg), h, w, 3, device=device)
    got, _ = proc.process_chunk(clip)
    return cfg, clip, got


def _reference(cfg, clip, device="cpu", dtype=torch.float32):
    ref = ColorReference(cfg, device, dtype)
    return np.stack([ref.step(torch.from_numpy(f).to(device)).cpu().numpy() for f in clip])


@pytest.mark.parametrize("h,w", [(48, 64), (45, 77)])
def test_reference_follows_the_program(h, w):
    """The reference's FFT and the program's circulant operator round
    differently: u8 frames agree within 1 LSB, and on all but a few pixels
    exactly, through the fill, the first full window and the steady shift."""
    cfg, clip, got = _frames(SMALL, h, w)
    want = _reference(cfg, clip)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 0.002
    for part in (d[:15], d[15:17], d[17:]):  # filling, the first full windows, shifting
        assert (part > 0).mean() < 0.002
    assert np.array_equal(want[0], clip[0]) and np.array_equal(got[0], clip[0])
    # the frames moved: magnification changed them, on both sides alike
    assert np.abs(want[1:].astype(np.int16) - clip[1:]).max() > 3


def test_parameters_match_the_program():
    p = program.processor_config(COLOR).magnification
    ref = ColorReference(COLOR, "cpu")
    assert (np.float32(p.amplification), p.co_low, p.co_high, p.framerate, p.levels) == (
        ref.amplification, ref.lo, ref.hi, ref.fps, ref.levels)
    assert window_rows(COLOR["capture_fps"]) == color_mode.window_size(p.framerate) == 64
    assert window_rows(8.0) == 16 and window_rows(60.0) == 128
    state = color_mode.init_state(480, 640, 3, 4, 30.0, device="cpu")
    assert tuple(state.window.shape) == (64, 3, 30, 40)


def test_a_bin_keeps_its_real_part_and_loses_its_imaginary_one():
    """At L = 64, 30 fps, 0.8-1.2 Hz the packed band [3.41, 5.12] holds index
    4 (bin 2's imaginary part) and 5 (bin 3's real part): bin 2 is scaled by
    i and bin 3 by 1, as mulSpectrums scales a CCS spectrum by the packed
    mask. The FFT form follows the program's circulant operator there, and
    departs from a mask of whole bins."""
    real, imag = packed_gains(64, 0.8, 1.2, 30.0)
    assert np.flatnonzero(real).tolist() == [3] and np.flatnonzero(imag).tolist() == [2]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((64, 37)).astype(np.float32))
    got = ideal_bandpass(x, 0.8, 1.2, 30.0)
    want = ideal_bandpass_apply(x, 64, 0.8, 1.2, 30.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    # float64 by a DFT of its own: bin k times its complex gain, Hermitian, 1/L^2
    spec = np.fft.fft(x.numpy().astype(np.float64), axis=0)
    gain = np.zeros(64, complex)
    gain[2], gain[3] = 1j, 1.0
    gain[-2], gain[-3] = -1j, 1.0
    exact = np.fft.ifft(spec * gain[:, None], axis=0).real / 64
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=2e-6)
    whole = np.zeros(64)
    whole[[2, 3, -2, -3]] = 1.0
    plain = np.fft.ifft(spec * whole[:, None], axis=0).real / 64
    assert np.abs(plain - exact).max() > 0.5 * np.abs(exact).max()
    # an odd length, a band with DC, and an even length's Nyquist bin
    for length, lo, hi in ((7, 0.0, 30.0), (10, 0.1, 14.9), (64, 0.0, 0.2)):
        y = x[:length]
        np.testing.assert_allclose(ideal_bandpass(y, lo, hi, 30.0).numpy(),
                                   ideal_bandpass_apply(y, length, lo, hi, 30.0).numpy(),
                                   rtol=0, atol=2e-6)


def test_bf16_reference_departs():
    """The control: the same reference in bfloat16 lands more than 2 LSB away."""
    cfg = dict(SMALL, height=48, width=64)
    clip = make_clip(CLIP, 48, 64, 8.0, (0.8, 1.2), 4, torch.device("cpu"))
    f32 = _reference(cfg, clip)
    bf16 = _reference(cfg, clip, dtype=torch.bfloat16)
    assert np.abs(f32.astype(np.int16) - bf16.astype(np.int16)).max() > 2


def _small_cell(tmp_path):
    bench = _small_copy(tmp_path)
    path = bench / "configs" / "color_vga_l4.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), height=96, width=128)))
    return tmp_path, bench


def test_the_cell_runs_and_agrees_on_the_cpu(tmp_path):
    root, bench = _small_cell(tmp_path)
    r = _run(root, bench, "color_vga_live30", seconds=1.0)
    assert r["correct"] and r["notes"]["frames_compared"] >= 2, (r["checks"], r["notes"])
    assert set(r["metrics"]) == {"live_fps", "setup_s"}
    t = _run(root, bench, "color_vga_live30", trace=True, seconds=1.0)
    assert t["correct"]
    # every operator was built in the warm-up; no card, so no CUDA events
    assert t["metrics"]["color_operator_builds.live"]["value"] == 0.0
    assert t["metrics"]["step_issue_ms.live"]["value"] > 0
    assert not {"color_pyramid_device_ms.live", "color_bandpass_device_ms.live",
                "color_reconstruct_device_ms.live"} & set(t["metrics"])
    c = _run(root, bench, "color_vga_live30", seconds=0.5, control="bf16_reference")
    assert not c["correct"], c["checks"]


def _alter(out):
    out = out.clone()
    out[:, 8:24, 8:24] = out[:, 8:24, 8:24] // 2 + 3
    return out


@pytest.mark.parametrize("fault", ["tile", "stuck"])
def test_a_wrong_colour_step_is_not_correct(tmp_path, monkeypatch, fault):
    """A wrong 16x16 tile once the window holds two frames, or a window that
    never fills (each frame passes through)."""
    root, bench = _small_cell(tmp_path)
    step = color_mode.step

    def wrong(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        if fault == "stuck":
            return state, out
        return new_state, (_alter(out) if state.count > 2 else out)

    monkeypatch.setattr(color_mode, "step", wrong)
    r = _run(root, bench, "color_vga_live30", seconds=0.5)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["over1_ppm"]["value"] > r["checks"]["over1_ppm"]["limit"]


US = 1_000
SLICE_NS = 1_000_000  # the profiled slice: ctx.span = (1 ms, 2 ms)


def _color_spans(at=0, build=False):
    held = []
    for seq, ms in enumerate([0.1, 0.2, 0.3]):
        t = at + seq * 30 * US
        step = Span("consumer.step", seq, t, t + 20 * US, thread=1)
        bandpass = Span("color.bandpass", seq, t + 5 * US, t + 10 * US, 1, step, device_ms=2 * ms)
        held += [step, Span("color.pyramid", seq, t, t + 5 * US, 1, step, device_ms=ms),
                 bandpass,
                 Span("color.reconstruct", seq, t + 10 * US, t + 20 * US, 1, step,
                      device_ms=None if seq == 2 else 3 * ms)]
        if build:
            held.append(Span("color.operator", seq, t + 6 * US, t + 7 * US, 1, bandpass))
    return held


def _ctx(monkeypatch, held):
    monkeypatch.setattr(profiling, "spans", lambda t0, t1: [
        s for s in held if s.start_ns <= t1 * 1e9 and s.end_ns >= t0 * 1e9])
    window = types.SimpleNamespace(setup_end=0.0)
    return readers.Context(window, None, (SLICE_NS * 1e-9, 2 * SLICE_NS * 1e-9), COLOR)


def _read(name, ctx):
    return load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")(ctx)


def test_the_colour_readers(monkeypatch):
    # the frames inside the profiled slice (slower, and building) are left out
    ctx = _ctx(monkeypatch, _color_spans() + _color_spans(at=SLICE_NS, build=True))
    assert _read("color_pyramid_device_ms.live", ctx) == pytest.approx(0.2)
    assert _read("color_bandpass_device_ms.live", ctx) == pytest.approx(0.4)
    # the frame whose events were not read is left out
    assert _read("color_reconstruct_device_ms.live", ctx) == pytest.approx(0.45)
    assert _read("color_operator_builds.live", ctx) == 0.0
    ctx = _ctx(monkeypatch, _color_spans(build=True))
    assert _read("color_operator_builds.live", ctx) == 3.0
    # a program without the colour spans (the parent of this configuration) reads nothing
    ctx = _ctx(monkeypatch, [s for s in _color_spans() if s.name == "consumer.step"])
    for part in ("pyramid", "bandpass", "reconstruct"):
        assert _read(f"color_{part}_device_ms.live", ctx) is None
    assert _read("color_operator_builds.live", ctx) is None


@pytest.mark.cuda
def test_reference_follows_the_program_on_the_card(cuda_device):
    cfg, clip, got = _frames(dict(COLOR, capture_fps=30.0), 270, 480, frames=80, seed=5,
                             device=cuda_device)
    want = _reference(cfg, clip, cuda_device)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d > 1).mean() < 1e-3 and (d > 0).mean() < 0.01, ((d > 1).mean(), (d > 0).mean())


@pytest.mark.cuda
def test_a_traced_colour_run_on_the_card_reads_every_colour_metric(cuda_device):
    r = run_cell(ROOT, "color_vga_live30", SEED, 4.0, True, device=cuda_device)
    assert r["correct"]
    for part in ("pyramid", "bandpass", "reconstruct"):
        assert r["metrics"][f"color_{part}_device_ms.live"]["value"] > 0, r["metrics"]
    assert r["metrics"]["color_operator_builds.live"]["value"] == 0.0


@pytest.mark.cuda
def test_a_wrong_tile_at_the_cells_size_is_not_correct(cuda_device, monkeypatch):
    """One 16x16 tile of every frame wrong once the window holds two frames,
    at the cell's own size: 833 pixels a million, over ``over1_ppm``'s limit."""
    step = color_mode.step

    def altered(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        if state.count > 2:
            out = out.clone()
            out[..., 200:216, 300:316] = out[..., 200:216, 300:316] // 2 + 3
        return new_state, out

    monkeypatch.setattr(color_mode, "step", altered)
    r = run_cell(ROOT, "color_vga_live30", SEED, 3.0, False, device=cuda_device)
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert r["checks"]["over1_ppm"]["value"] > r["checks"]["over1_ppm"]["limit"]
