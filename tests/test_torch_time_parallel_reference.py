"""The time-parallel phase export against the benchmark's plain reference, on
the CPU at small sizes, and its stage spans.

``ClipProcessor(time_parallel=True)`` as the configuration
``benchmark/configs/phase_4k_l6_tp.json`` builds it (its values at a CPU
size) exports two chunks of 6 frames, so the carried state (the prior
pyramid, the accumulated phase and the DF-II registers) crosses a chunk
boundary; ``benchmark/reference/phase.py::PhaseReference`` replays the same
frames one at a time. The two sides compute the same semantics in different
orders (an associative scan over T against a recurrence; conv2d against the
program's taps), so u8 frames agree to within 1 LSB on all but a few pixels:
the bar of ``benchmark/tests/test_benchmark_reference.py``.

With the recorder on, one chunk opens ``phase_tp.build`` and
``phase_tp.collapse`` once and ``phase_tp.difference`` / ``.scan`` /
``.amplify`` once a band level, inside its ``export.step`` and with its id;
the frames are those of the recorder off, bit for bit. The benchmark's
readers of those spans find nothing where the program opened none, and the
scan's least bytes are counted by hand.
"""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import program, readers, time_parallel  # noqa: E402
from benchmark.harness.cell import load_reader  # noqa: E402
from benchmark.harness.clip import make_clip  # noqa: E402
from benchmark.reference.phase import PhaseReference  # noqa: E402
from live_video_magnification_tpu_torch.engine import profiling  # noqa: E402
from live_video_magnification_tpu_torch.engine.profiling import Span  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "phase_4k_l6_tp.json").read_text())
CLIP = {"frames": 12, "waves": 8, "min_wavelength_px": 6.0, "shift_px": 0.5, "pulse": 0.02}
CHUNK = 6
STAGES = ("build", "difference", "scan", "amplify", "collapse")
READERS = [f"tp_{s}_device_ms.export" for s in STAGES] + ["tp_scan_roofline"]


def _small(h, w, levels=4):
    return dict(CONFIG, height=h, width=w, levels=levels)


def _export(cfg, clip):
    """The clip through the configuration's processor, a chunk at a time."""
    proc = program.clip_processor(cfg, "cpu")
    assert proc.time_parallel
    parts = [proc.process_chunk(clip[i:i + CHUNK]) for i in range(0, len(clip), CHUNK)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


@pytest.mark.parametrize("h,w", [(135, 240), (137, 243)])
def test_the_time_parallel_export_follows_the_reference(h, w):
    torch.set_num_threads(2)
    cfg = _small(h, w)
    clip = make_clip(CLIP, h, w, cfg["capture_fps"], (cfg["low_hz"], cfg["high_hz"]), 3,
                     torch.device("cpu"))
    got, original = _export(cfg, clip)
    ref = PhaseReference(cfg, "cpu")
    want = np.stack([ref.step(torch.from_numpy(f)).numpy() for f in clip])
    assert np.array_equal(original, clip)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 0.002
    # the first frame passes through; later ones moved, on both sides alike,
    # the second chunk's too (its state carried across the boundary)
    assert np.array_equal(got[0], clip[0]) and np.array_equal(want[0], clip[0])
    moved = np.abs(want.astype(np.int16) - clip.astype(np.int16)).reshape(len(clip), -1).max(1)
    assert (moved[1:] > 3).all(), moved


def test_a_chunk_opens_its_stage_spans_and_keeps_its_frames():
    torch.set_num_threads(2)
    cfg = _small(64, 96)
    clip = make_clip(dict(CLIP, frames=2 * CHUNK), 64, 96, 30.0, (1.0, 5.0), 5,
                     torch.device("cpu"))
    off = _export(cfg, clip)
    t0 = time.monotonic()
    profiling.enable()
    try:
        on = _export(cfg, clip)
    finally:
        profiling.disable()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    held = profiling.spans(t0, time.monotonic())
    steps = [s for s in held if s.name == "export.step"]
    assert [s.id for s in steps] == [0, CHUNK]
    for step in steps:
        kids = [s for s in held if s.parent is step]
        bands = cfg["levels"] - 1
        assert [s.name for s in kids] == (["phase_tp.build"]
                                          + ["phase_tp.difference", "phase_tp.scan",
                                             "phase_tp.amplify"] * bands
                                          + ["phase_tp.collapse"])
        assert all(s.id == step.id and s.device_ms is None for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert step.start_ns <= kids[0].start_ns and kids[-1].end_ns <= step.end_ns


def test_the_scan_bytes():
    # by hand at 20x30, levels 3, T 4: band levels 20x30 and 10x15,
    # (3 * 4 + 10) planes each, two components, 4 B
    assert time_parallel.scan_bytes(20, 30, 3, 4) == 2 * 22 * (600 + 150) * 4
    # 4K levels 6, a chunk of 32: 106 planes of the five band levels' 11,048,400 px
    assert time_parallel.scan_bytes(2160, 3840, 6, 32) == 9_369_043_200
    assert time_parallel.scan_seconds(2160, 3840, 6, 32) == pytest.approx(2.797e-3, rel=1e-3)


US = 1_000_000  # ns
SLICE_NS = 10_000 * US


def _ctx(monkeypatch, held, cfg=CONFIG):
    monkeypatch.setattr(profiling, "spans", lambda t0, t1: [
        s for s in held if s.start_ns <= t1 * 1e9 and s.end_ns >= t0 * 1e9])
    window = types.SimpleNamespace(setup_end=0.0)
    return readers.Context(window, None, (SLICE_NS * 1e-9, 2 * SLICE_NS * 1e-9), cfg)


def _chunk(cursor, at, frames, ms, h=2160, w=3840, levels=6, read=True):
    """A time-parallel chunk's spans: its h2d and step, and every stage with
    ``ms[stage]`` device ms in all, split evenly over its band levels."""
    step = Span("export.step", cursor, at, at + 50 * US, thread=1)
    held = [Span("export.h2d", cursor, at - US, at, 1, nbytes=frames * 3 * h * w), step]
    t = at
    for stage in STAGES:
        n = 1 if stage in ("build", "collapse") else levels - 1
        for _ in range(n):
            held.append(Span(f"phase_tp.{stage}", cursor, t, t + US, 1, step,
                             device_ms=ms[stage] / n if read else None))
            t += US
    return held


MS = {"build": 64.0, "difference": 96.0, "scan": 224.0, "amplify": 32.0, "collapse": 80.0}


def test_the_time_parallel_readers(monkeypatch):
    slow = {k: 10 * v for k, v in MS.items()}
    held = (_chunk(0, 0, 32, MS) + _chunk(32, 60 * US, 32, MS)
            + _chunk(64, SLICE_NS, 32, slow)                 # profiled: left out
            + _chunk(96, 3 * SLICE_NS, 16, MS, read=False))  # events not read: left out
    ctx = _ctx(monkeypatch, held)
    read = {name: load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")(ctx)
            for name in READERS}
    for stage in STAGES:
        assert read[f"tp_{stage}_device_ms.export"] == pytest.approx(MS[stage] / 32)
    # 2.797 ms of least time over 224 ms of scans
    assert read["tp_scan_roofline"] == pytest.approx(100 * 9_369_043_200 / 3.35e12 / 0.224)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_the_spans(monkeypatch, name):
    """A run of the sequential path, or of a program without the stage
    spans, holds export spans only: every reader returns None."""
    step = lambda c, at: [Span("export.h2d", c, at, at + US, 1, nbytes=32 * 3 * 2160 * 3840),
                          Span("export.step", c, at + US, at + 2 * US, 1)]
    ctx = _ctx(monkeypatch, step(0, 0) + step(32, 5 * US))
    assert load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")(ctx) is None
    assert load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")(_ctx(monkeypatch, [])) is None
