"""The plain reference against the program, on the CPU at small sizes.

Several frames each, so the carried state (prior pyramid and DF-II
registers; the EMAs) is compared too. The reference correlates through
conv2d while the program adds its taps one by one, so the two round
differently: u8 frames agree to within 1 LSB on all but a few pixels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import program
from benchmark.harness.clip import make_clip
from benchmark.reference.laplace import MotionReference, ladder, motion_params
from benchmark.reference.phase import PhaseReference, phase_params
from live_video_magnification_tpu_torch.export.batch import ClipProcessor

PHASE = dict(mode="phase", levels=4, amplification=50, wavelength=50, low_hz=1.0, high_hz=5.0,
             chroma=0, capture_fps=30.0)
MOTION = dict(mode="laplace", levels=3, amplification=20, wavelength=50, low_hz=1.0,
              high_hz=5.0, chroma=30, capture_fps=30.0)
CLIP = {"frames": 12, "waves": 8, "min_wavelength_px": 6.0, "shift_px": 0.5, "pulse": 0.02}
REFS = {"phase": PhaseReference, "laplace": MotionReference}


def _run(cfg, h, w, frames=12, seed=3):
    cfg = dict(cfg, height=h, width=w)
    clip = make_clip(dict(CLIP, frames=frames), h, w, 30.0, (1.0, 5.0), seed,
                     torch.device("cpu"))
    proc = ClipProcessor(program.processor_config(cfg), h, w, 3, device="cpu")
    got, _ = proc.process_chunk(clip)
    ref = REFS[cfg["mode"]](cfg, "cpu")
    want = np.stack([ref.step(torch.from_numpy(f)).numpy() for f in clip])
    return clip, got, want


@pytest.mark.parametrize("mode,h,w", [("phase", 135, 240), ("phase", 137, 243),
                                      ("laplace", 48, 80), ("laplace", 45, 77)])
def test_reference_follows_the_program(mode, h, w):
    """Sizes whose coarsest phase level is at least 9x15: on a smaller one
    the 13x13 blur spans the level, and where the quaternion's cos rounds
    past 1 the app's arcCos gives 1 rad, so the two sides part at a few
    pixels a thousand (a pixel in 130 at 67x101)."""
    clip, got, want = _run(PHASE if mode == "phase" else MOTION, h, w)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 0.002
    # the frames moved: magnification changed them, on both sides alike
    assert np.abs(want[1:].astype(np.int16) - clip[1:]).max() > 3


def test_phase_first_frame_passes_through():
    clip, got, want = _run(PHASE, 48, 64, frames=2)
    assert np.array_equal(want[0], clip[0]) and np.array_equal(got[0], clip[0])


def test_parameters_match_the_program():
    cfg = program.processor_config(dict(PHASE, height=64, width=96)).magnification
    p = phase_params(PHASE)
    assert np.float32(cfg.amplification) == p.amplification
    assert np.isclose((cfg.co_wavelength * np.pi / 100.0), p.threshold)
    m = program.processor_config(dict(MOTION, height=48, width=80)).magnification
    q = motion_params(MOTION)
    assert (np.float32(m.co_low), np.float32(m.co_high), np.float32(m.chrom_attenuation)) == (
        q.blend_lo, q.blend_hi, q.chroma)
    assert np.float32(m.co_wavelength) == q.wavelength
    gains = ladder(q, 720, 1280, 5)
    assert gains[0] == 0.0 and gains[-1] == 0.0 and max(gains) <= 20.0


def test_bf16_reference_departs():
    """The control: the same reference in bfloat16 lands many LSB away."""
    cfg = dict(MOTION, height=48, width=80)
    clip = make_clip(CLIP, 48, 80, 30.0, (1.0, 5.0), 4, torch.device("cpu"))
    f32, bf16 = MotionReference(cfg, "cpu"), MotionReference(cfg, "cpu", torch.bfloat16)
    d = max(int((f32.step(torch.from_numpy(f)).to(torch.int16)
                 - bf16.step(torch.from_numpy(f)).to(torch.int16)).abs().max()) for f in clip)
    assert d > 2


@pytest.mark.cuda
def test_reference_follows_the_program_on_the_card(cuda_device):
    cfg = dict(PHASE, height=270, width=480, levels=5)
    clip = make_clip(CLIP, 270, 480, 30.0, (1.0, 5.0), 5, cuda_device)
    proc = ClipProcessor(program.processor_config(cfg), 270, 480, 3, device=cuda_device)
    got, _ = proc.process_chunk(clip)
    ref = PhaseReference(cfg, cuda_device)
    want = np.stack([ref.step(torch.from_numpy(f).to(cuda_device)).cpu().numpy() for f in clip])
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d > 1).mean() < 1e-3
