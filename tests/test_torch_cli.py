"""The port's offline entry point on the CPU: ``io/video.py`` through cv2, and
``cli.py`` (``info``; ``magnify`` in every mode with ``--device cpu``) against
the reference package's CLI on the same clip.

Bars: the same ``info`` line; the same frame count and shape; decoded frames
>= 45 dB against the reference CLI's (the encoder may turn a 1-LSB difference
before encoding into a larger one after it).
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from live_video_magnification_tpu import cli as jcli
from live_video_magnification_tpu.io import video as jvideo
from live_video_magnification_tpu_torch import cli as tcli
from live_video_magnification_tpu_torch.io import video as tvideo
from live_video_magnification_tpu.export import exporter as jexporter
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu.export import types as jtypes
from live_video_magnification_tpu_torch.export import exporter as texporter
from live_video_magnification_tpu_torch.export import types as ttypes
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

FAST_VARS = ("LVMT_MXU_DTYPE", "LVMT_TAIL", "LVMT_TAIL_IO", "LVMT_PYR_IO")


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    """14 frames of 64x80 with sub-pixel motion and a brightness pulse, MJPG."""
    import cv2

    path = str(tmp_path_factory.mktemp("clips") / "in.avi")
    rng = np.random.default_rng(5)
    base = cv2.GaussianBlur(rng.random((96, 112, 3)).astype(np.float32), (0, 0), 3.0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (80, 64))
    for i in range(14):
        m = np.float32([[1, 0, 1.5 * math.sin(2 * math.pi * i / 30)],
                        [0, 1, math.cos(2 * math.pi * i / 30)]])
        s = cv2.warpAffine(base, m, (112, 96))[16:80, 16:96]
        pulse = 1.0 + 0.05 * math.sin(2 * math.pi * 1.1 * i / 30)
        w.write(np.clip(s * pulse * 255, 0, 255).astype(np.uint8))
    w.release()
    return path


def _read(path):
    frames = list(tvideo.iter_video(path))
    return np.stack(frames) if frames else np.empty((0,))


@pytest.fixture
def no_fast_flags(monkeypatch):
    """--fast writes the process environment: restore it after the test."""
    for var in FAST_VARS:
        monkeypatch.setenv(var, "sentinel")
        monkeypatch.delenv(var)


def test_video_round_trip_matches_reference_io(tmp_path):
    frames = moving_clip(6, 32, 48, seed=1)
    path = tvideo.write_video(str(tmp_path / "rt.avi"), frames, 25.0, fourcc="MJPG")
    assert tvideo.video_info(path) == jvideo.video_info(path)
    n, h, w, fps = tvideo.video_info(path)
    assert (n, h, w, round(fps)) == (6, 32, 48, 25)
    got, got_fps = tvideo.read_video(path)
    ref, ref_fps = jvideo.read_video(path)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == frames.shape and got_fps == ref_fps
    assert psnr_u8(got, frames) > 20.0  # a lossy codec, but the same pictures
    np.testing.assert_array_equal(np.stack(list(tvideo.iter_video(path, 2, 5))), ref[2:5])

    stream = tvideo.VideoWriterStream(str(tmp_path / "gray.avi"), 25.0, fourcc="MJPG")
    stream.write_chunk(frames[:3, :, :, 0])
    stream.write_chunk(frames[3:, :, :, 0])
    gray_path = stream.close()
    assert stream.frames_written == 6 and tvideo.video_info(gray_path)[0] == 6

    merged = tvideo.concat_videos([path, path], str(tmp_path / "both.avi"), 25.0)
    assert tvideo.video_info(merged)[0] == 12


def test_video_io_without_cv2_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="needs OpenCV"):
        tvideo.video_info(str(tmp_path / "x.avi"))
    with pytest.raises(ImportError, match="needs OpenCV"):
        next(tvideo.iter_video(str(tmp_path / "x.avi")))


def test_info_matches_reference(clip_path, capsys):
    assert jcli.main(["info", clip_path]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(["info", clip_path]) == 0
    got = capsys.readouterr().out
    assert got == ref and "frames=14" in got and "size=80x64" in got


@pytest.mark.parametrize("mode", ["laplace", "color", "phase"])
def test_magnify_matches_reference_cli(mode, clip_path, tmp_path):
    ref, got = str(tmp_path / "ref.avi"), str(tmp_path / "got.avi")
    args = [clip_path, "--mode", mode, "--chunk", "5"]
    assert jcli.main(["magnify", args[0], ref] + args[1:]) == 0
    assert tcli.main(["magnify", args[0], got] + args[1:] + ["--device", "cpu"]) == 0
    a, b = _read(got), _read(ref)
    assert a.shape == b.shape == (14, 64, 80, 3)
    dbs = [psnr_u8(x, y) for x, y in zip(a, b)]
    print(f"{mode}: min {min(dbs):.2f} dB against the reference CLI")
    assert min(dbs) >= 45.0, dbs


def test_magnify_defaults_to_laplace_and_fails_without_a_card(clip_path, tmp_path,
                                                              monkeypatch, capsys):
    out, laplace = str(tmp_path / "o.avi"), str(tmp_path / "laplace.avi")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        assert tcli.main(["magnify", clip_path, out]) == 1
        assert "no CUDA device" in capsys.readouterr().err and not os.path.exists(out)
    assert tcli.main(["magnify", clip_path, out, "--device", "cpu", "--end", "4"]) == 0
    assert tcli.main(["magnify", clip_path, laplace, "--device", "cpu", "--end", "4",
                      "--mode", "laplace"]) == 0
    np.testing.assert_array_equal(_read(out), _read(laplace))
    args = type("A", (), {"mode": "laplace", "fps": None, "amplification": None,
                          "wavelength": None, "low": None, "high": None, "chroma": None,
                          "levels": None, "downscale": 2, "roi": (0.1, 0.2, 0.5, 0.6),
                          "grayscale": True})()
    cfg, jcfg = tcli._config_from_args(args, 30.0), jcli._config_from_args(args, 30.0)
    assert repr(cfg) == repr(jcfg)


@pytest.mark.parametrize("flag", ["--distributed"])
def test_magnify_distributed_writes_every_frame_and_needs_a_card(flag, clip_path, tmp_path,
                                                                 capsys, monkeypatch):
    """--distributed: with --device cpu it writes every frame (one CPU
    shard: the time-parallel path's frames, through the parts' concat, so
    within the codec bar of the reference suite's distributed export test);
    without a card it fails with the no-CUDA message instead of falling
    back, and writes nothing."""
    out, tp = str(tmp_path / "o.avi"), str(tmp_path / "tp.avi")
    assert tcli.main(["magnify", clip_path, out, "--device", "cpu", "--mode", "phase",
                      "--chunk", "7", flag]) == 0
    assert "wrote 14 frames" in capsys.readouterr().err
    assert tcli.main(["magnify", clip_path, tp, "--device", "cpu", "--mode", "phase",
                      "--chunk", "7", "--time-parallel"]) == 0
    got, want = _read(out), _read(tp)
    assert got.shape == want.shape == (14, 64, 80, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 48 and d.mean() < 4.0, (d.max(), d.mean())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    none = str(tmp_path / "none.avi")
    assert tcli.main(["magnify", clip_path, none, "--mode", "phase", flag]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(none)


@pytest.mark.parametrize("mode", ["laplace", "color", "phase"])
def test_magnify_time_parallel_matches_reference_cli(mode, clip_path, tmp_path):
    """--time-parallel against the reference CLI's --time-parallel on the same
    clip, and against the port's own sequential run (two chunks of 7)."""
    ref, got, seq = (str(tmp_path / f"{n}.avi") for n in ("ref", "got", "seq"))
    args = [clip_path, "--mode", mode, "--chunk", "7"]
    assert jcli.main(["magnify", args[0], ref] + args[1:] + ["--time-parallel"]) == 0
    assert tcli.main(["magnify", args[0], got] + args[1:]
                     + ["--time-parallel", "--device", "cpu"]) == 0
    assert tcli.main(["magnify", args[0], seq] + args[1:] + ["--device", "cpu"]) == 0
    a, b, c = _read(got), _read(ref), _read(seq)
    assert a.shape == b.shape == c.shape == (14, 64, 80, 3)
    dbs = [psnr_u8(x, y) for x, y in zip(a, b)]
    seq_dbs = [psnr_u8(x, y) for x, y in zip(a, c)]
    print(f"{mode} --time-parallel: min {min(dbs):.2f} dB against the reference CLI, "
          f"{min(seq_dbs):.2f} dB against the sequential run")
    assert min(dbs) >= 45.0, dbs
    assert min(seq_dbs) >= 45.0, seq_dbs


def test_magnify_fast_sets_the_four_flags(clip_path, tmp_path, no_fast_flags, monkeypatch):
    out = str(tmp_path / "fast.avi")
    assert tcli.main(["magnify", clip_path, out, "--mode", "phase", "--chunk", "5",
                      "--end", "6", "--fast", "--device", "cpu"]) == 0
    assert {v: os.environ.get(v) for v in FAST_VARS} == {
        "LVMT_MXU_DTYPE": "bf16", "LVMT_TAIL": "mxu", "LVMT_TAIL_IO": "bf16",
        "LVMT_PYR_IO": "bf16"}
    assert _read(out).shape[0] == 6
    monkeypatch.setenv("LVMT_MXU_DTYPE", "hybrid")  # an explicit setting wins
    monkeypatch.setenv("LVMT_TAIL", "jnp")
    tcli._apply_fast_mode(type("A", (), {"fast": True})())
    assert (os.environ["LVMT_MXU_DTYPE"], os.environ["LVMT_TAIL"]) == ("hybrid", "jnp")


def test_magnify_range_and_split_composition(clip_path, tmp_path):
    args = [clip_path, "--start", "2", "--end", "12", "--chunk", "4", "--device", "cpu",
            "--mode", "color", "--fps", "8"]
    for split, shape in [(None, (64, 80)), ("left-right", (64, 160)), ("top-bottom", (128, 80))]:
        out = str(tmp_path / f"{split}.avi")
        extra = ["--split", split, "--labels"] if split else []
        assert tcli.main(["magnify", args[0], out] + args[1:] + extra) == 0
        assert _read(out).shape == (10,) + shape + (3,)


@pytest.mark.parametrize("split", ["none", "left-right", "top-bottom"])
def test_compose_matches_reference(split):
    clip = moving_clip(2, 31, 47, seed=2)
    original, processed = clip[0], clip[1]
    for proc in (processed, processed[..., 1]):  # a colour and a gray pane
        for overlay in (False, True):
            got = texporter.compose(original, proc, ttypes.SplitMode(split), overlay)
            ref = jexporter.compose(original, proc, jtypes.SplitMode(split), overlay)
            np.testing.assert_array_equal(got, ref)
    assert [m.value for m in ttypes.SplitMode] == [m.value for m in jtypes.SplitMode]


def test_export_request_validation_matches_reference(tmp_path):
    cases = [dict(output_path="", file_fps=0.0, start_frame=3, end_frame=2),
             dict(output_path=str(tmp_path / "o.mp4"), start_frame=5, end_frame=40),
             dict(output_path=str(tmp_path / "none" / "o.mp4"), start_frame=-1)]
    problems = []
    for kw in cases:
        for count in (None, 20):
            got = ttypes.validate_request(ttypes.ExportRequest(tparams.ProcessorConfig(), **kw),
                                          count)
            ref = jtypes.validate_request(jtypes.ExportRequest(jparams.ProcessorConfig(), **kw),
                                          count)
            assert got == ref
            problems.append(len(got))
    assert problems == [3, 3, 0, 1, 2, 2]


def test_magnify_resume_writes_a_part_file_and_merges_it(clip_path, tmp_path, capsys):
    out, ck = str(tmp_path / "out.avi"), str(tmp_path / "ck")
    base = ["magnify", clip_path, out, "--mode", "laplace", "--chunk", "4",
            "--device", "cpu", "--checkpoint", ck]
    assert tcli.main(base + ["--end", "8", "--checkpoint-every", "4"]) == 0
    assert _read(out).shape[0] == 8 and os.path.exists(ck + ".npz")
    assert tcli.main(base) == 0  # resumes at 8 into out.from8.avi, then merges
    err = capsys.readouterr().err
    assert "resuming at frame 8" in err and "out.from8.avi" in err
    assert _read(out).shape[0] == 14  # no ffmpeg here: the cv2 re-encode merged it
    assert not (tmp_path / "out.from8.avi").exists()
    assert not (tmp_path / "out.parts.json").exists()
    # resuming a complete export is a no-op success; another config is a clean error
    assert tcli.main(base) == 0
    assert tcli.main(["magnify", clip_path, str(tmp_path / "o3.avi"), "--mode", "phase",
                      "--device", "cpu", "--checkpoint", ck]) == 1
    assert "different configuration" in capsys.readouterr().err


def test_concat_resumed_parts_with_ffmpeg_follows_the_manifest(tmp_path, monkeypatch, capsys):
    """A stub ffmpeg replays the concat list: the manifest-listed parts are
    merged in start order, removed with the manifest; an unlisted .fromN file
    is warned about and left alone."""
    out = tmp_path / "clip.avi"
    out.write_bytes(b"BASE")
    (tmp_path / "clip.from8.avi").write_bytes(b"P8")
    (tmp_path / "clip.from20.avi").write_bytes(b"P20")
    (tmp_path / "clip.from3.avi").write_bytes(b"STALE")
    tcli._record_part(str(out), str(tmp_path / "clip.from20.avi"), 20)
    tcli._record_part(str(out), str(tmp_path / "clip.from8.avi"), 8)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "ffmpeg"
    stub.write_text(
        "#!/bin/sh\n"
        "lst=$7; dst=${10}\n"
        "grep \"^file \" \"$lst\" | sed \"s/^file '//;s/'$//\" | "
        "while read f; do cat \"$f\" >> \"$dst\"; done\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    tcli._concat_resumed_parts(str(out))
    assert out.read_bytes() == b"BASEP8P20"
    assert not (tmp_path / "clip.from8.avi").exists()
    assert not (tmp_path / "clip.parts.json").exists()
    assert (tmp_path / "clip.from3.avi").read_bytes() == b"STALE"
    assert "unlisted part" in capsys.readouterr().err


def test_concat_resumed_parts_keeps_everything_without_a_full_manifest(tmp_path, monkeypatch,
                                                                       capsys):
    monkeypatch.setenv("PATH", str(tmp_path / "definitely-empty"))
    out = tmp_path / "clip.avi"
    out.write_bytes(b"BASE")
    (tmp_path / "clip.from8.avi").write_bytes(b"P8")
    tcli._concat_resumed_parts(str(out))  # no manifest
    assert "no manifest" in capsys.readouterr().err
    tcli._record_part(str(out), str(tmp_path / "clip.from20.avi"), 20)  # never written
    tcli._record_part(str(out), str(tmp_path / "clip.from8.avi"), 8)
    tcli._concat_resumed_parts(str(out))
    assert "missing part" in capsys.readouterr().err
    assert out.read_bytes() == b"BASE" and (tmp_path / "clip.from8.avi").exists()


# ---------------------------------------------------------------- the streaming commands


def test_live_runs_the_synthetic_source_on_the_cpu(capsys):
    assert tcli.main(["live", "--size", "48", "64", "--duration", "1", "--device", "cpu",
                      "--mode", "phase", "--levels", "2"]) == 0
    err = capsys.readouterr().err
    assert "fps=" in err and "errors=0" in err
    assert not [t for t in threading.enumerate() if t.name == "ProcessingChain"]


def test_live_and_record_fail_without_a_card(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["live", "--size", "48", "64", "--duration", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    out = str(tmp_path / "r.avi")
    assert tcli.main(["record", out, "--size", "48", "64", "--duration", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err and not os.path.exists(out)


def test_record_writes_the_recording_magnified(tmp_path, capsys):
    out = str(tmp_path / "out.avi")
    assert tcli.main(["record", out, "--duration", "1", "--size", "48", "64",
                      "--device", "cpu", "--format", "avi", "--split", "left-right"]) == 0
    err = capsys.readouterr().err
    n = int(err.split("captured ")[1].split()[0])
    assert n >= 5 and f"wrote {n} frames to {out}" in err
    frames = _read(out)
    assert frames.shape == (n, 48, 128, 3)


def test_cameras_lists_capture_devices(capsys):
    assert tcli.main(["cameras"]) == 0
    out = capsys.readouterr().out
    assert out == "no cameras found\n" or all(": " in ln for ln in out.splitlines())


@pytest.mark.parametrize("flags", [["--gl"], ["--view", "side-by-side"]])
def test_live_gl_and_view_run_stats_only_without_a_display(flags, capsys):
    """``live --gl`` / ``--view`` run as the reference's: without a display
    ``--gl`` prints its "--gl unavailable" line and runs stats-only on the
    chain's own device; ``--view`` is accepted."""
    assert tcli.main(["live", "--device", "cpu", "--duration", "1", "--size", "32", "48"]
                     + flags) == 0
    err = capsys.readouterr().err
    assert "ROADMAP" not in err and "fps=" in err and "errors=0" in err
    if flags == ["--gl"] and not os.environ.get("DISPLAY"):
        assert "--gl unavailable (" in err and "); continuing stats-only" in err
    assert not [t for t in threading.enumerate() if t.name == "ProcessingChain"]


def test_live_gl_success_path_presents_headless(monkeypatch):
    """``live --gl``'s success branch, the main-thread paint / swap / stats
    loop of ``cmd_live``, headless: the EGL surfaceless context stands in
    for the glfw window. The engine's frames reach the GL textures (uploads
    advance) and closing the window ends the run. Skips, and does not fail,
    if its deadline passes before two uploads (a loaded host)."""
    pytest.importorskip("OpenGL")
    import time

    from live_video_magnification_tpu_torch.engine import gl_present

    if not gl_present.gl_available():
        pytest.skip("no EGL surfaceless GL context in this image")

    caps = {}

    class _Presenter(gl_present.GLPresenter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            caps["presenter"] = self

    class _Ctx(gl_present.HeadlessGLContext):
        """HeadlessGLContext + the window-only surface cmd_live touches
        (should_close); swap sleeps like vsync."""

        def __init__(self, w, h, title=""):
            super().__init__(w, h)
            self.swaps = 0
            self.deadline = time.monotonic() + 90.0
            caps["ctx"] = self

        def should_close(self):
            p = caps.get("presenter")
            done = p is not None and p.uploads >= 2 and self.swaps >= 3
            caps["expired"] = not done and time.monotonic() > self.deadline
            return done or caps["expired"]

        def swap(self):
            self.swaps += 1
            super().swap()
            time.sleep(1.0 / 120.0)

    monkeypatch.setattr(gl_present, "GLPresenter", _Presenter)
    monkeypatch.setattr(gl_present, "WindowGLContext", _Ctx)
    assert tcli.main(["live", "--size", "48", "64", "--duration", "300", "--mode", "laplace",
                      "--levels", "2", "--gl", "--device", "cpu"]) == 0
    if caps.get("expired"):
        pytest.skip("the 90 s deadline passed before two uploads (loaded host)")
    assert caps["presenter"].uploads >= 2  # real frames hit the textures
    assert caps["presenter"].reallocs >= 1  # the first geometry allocation ran
    assert caps["ctx"].swaps >= 3
    assert not [t for t in threading.enumerate() if t.name == "ProcessingChain"]


def test_live_playback_fps_flag_wires_to_controller(clip_path, monkeypatch):
    """``live --video ... --playback-fps`` drives
    ``PlaybackController.set_playback_fps`` for a file source
    (StatusStrip.cpp:122-158)."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController

    calls = []
    orig = PlaybackController.set_playback_fps
    monkeypatch.setattr(PlaybackController, "set_playback_fps",
                        lambda self, fps: (calls.append(fps), orig(self, fps))[1])
    assert tcli.main(["live", "--video", clip_path, "--duration", "0.5", "--playback-fps",
                      "12.5", "--mode", "laplace", "--device", "cpu"]) == 0
    assert calls == [12.5]
