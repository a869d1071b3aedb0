"""``examples/demo_torch.py`` on the CPU: the port's ``magnify`` over the
demo's synthetic clip in every mode, at a small size."""

import functools
import importlib.util
from pathlib import Path

import numpy as np

from live_video_magnification_tpu_torch.io.video import iter_video

ROOT = Path(__file__).resolve().parent.parent


def _demo():
    spec = importlib.util.spec_from_file_location("demo_torch", ROOT / "examples" / "demo_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_writes_an_export_per_mode_with_the_clips_frames(tmp_path, monkeypatch, capsys):
    demo = _demo()
    monkeypatch.setattr(demo, "make_clip",
                        functools.partial(demo.make_clip, seconds=1.0, h=48, w=64))
    assert demo.main([str(tmp_path), "--device", "cpu"]) == 0
    clip = np.stack(list(iter_video(str(tmp_path / "demo_in.avi"))))
    assert clip.shape == (30, 48, 64, 3)
    for mode, _flags in demo.RUNS:
        out = np.stack(list(iter_video(str(tmp_path / f"demo_{mode}.avi"))))
        assert out.shape == (30, 48, 128, 3), mode  # original | magnified
    assert [m for m, _ in demo.RUNS] == ["phase", "laplace", "color"]
    assert "--device cpu" in capsys.readouterr().out


def test_demo_fails_without_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """The default device is the card: without one the first export fails
    (the port never falls back to the CPU) and the demo returns its code."""
    demo = _demo()
    monkeypatch.setattr(demo, "make_clip",
                        functools.partial(demo.make_clip, seconds=0.2, h=32, w=48))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert demo.main([str(tmp_path)]) == 1
    assert not (tmp_path / "demo_phase.avi").exists()
