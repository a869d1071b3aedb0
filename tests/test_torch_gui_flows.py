"""The GUI's flows driven headless through the port's own functions and
controller on the CPU, held against the reference package's same flow and
against the port's fresh chain.

* open file -> play -> trim [4..16) -> export with parameters edited away
  from the live state (the reference suite's ``tests/test_gui_xvfb.py``
  flow): the controller, ``trim_set_in`` / ``trim_set_out``,
  ``range_label_text``, ``export_start_guard``, the settings dialog's
  mapping (``build_export_config``), ``validate_request`` and the
  ``Exporter`` polled by ``export_poll_transition``, in each package on the
  xvfb file's smooth clip; the frames each exporter hands its writer within
  1 LSB of the reference's.
* record -> stop -> export (``chip_smoke.py::gui_record_flow``, the card's
  ``gui_flow_1080p`` at a small size): every written frame bit for bit a
  fresh chain's. The synthetic source's noise frames are not compared with
  the reference package (their ulps differences reach several LSB).
* the card's present phases at a small size: ``chip_smoke.gui_present``
  (``fit_view`` + ``PhotoCodec.ppm``) byte for byte the reference's
  ``MainWindow._poll_display`` body, and ``chip_smoke.gl_present`` on this
  machine's EGL.

Needs cv2 (the clip and the file source). Threaded steps wait at most 20 s
and close every controller in a ``finally``.
"""

import dataclasses
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import live_video_magnification_tpu.engine.controller as jcontroller
import live_video_magnification_tpu.export.exporter as jexporter
import live_video_magnification_tpu.export.sources as jsources
import live_video_magnification_tpu.export.types as jtypes
import live_video_magnification_tpu.gui as jgui
import live_video_magnification_tpu.models.params as jparams
import live_video_magnification_tpu_torch.engine.controller as tcontroller
import live_video_magnification_tpu_torch.export.exporter as texporter
import live_video_magnification_tpu_torch.export.sources as tsources
import live_video_magnification_tpu_torch.export.types as ttypes
import live_video_magnification_tpu_torch.gui as tgui
import live_video_magnification_tpu_torch.models.params as tparams
from live_video_magnification_tpu.engine.display import ViewMode as JViewMode
from live_video_magnification_tpu.engine.display import compose_view as jcompose_view
from live_video_magnification_tpu_torch.engine.display import DisplayLoop, ViewMode
from live_video_magnification_tpu_torch.engine.frame import Frame
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

DEADLINE_S = 20.0

REF = types.SimpleNamespace(gui=jgui, params=jparams, types=jtypes, exporter=jexporter,
                            sources=jsources, controller=lambda: jcontroller.PlaybackController(),
                            exporter_kw={})
PORT = types.SimpleNamespace(gui=tgui, params=tparams, types=ttypes, exporter=texporter,
                             sources=tsources,
                             controller=lambda: tcontroller.PlaybackController(device="cpu"),
                             exporter_kw={"device": "cpu"})


def _wait(cond, timeout=DEADLINE_S, interval=0.02):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _make_clip(path, t=24, h=64, w=80, fps=30.0):
    """The reference suite's xvfb clip: a blurred random base, pulsing."""
    import cv2

    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.random((h, w, 3)).astype(np.float32), (0, 0), 3.0)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for i in range(t):
        img = np.clip((base * (0.8 + 0.2 * np.sin(i / 3.0))) * 255, 0, 255)
        wr.write(img.astype(np.uint8))
    wr.release()
    return str(path)


def _params_in(pkg, params):
    """The port's MagnificationParams as ``pkg``'s."""
    fields = dataclasses.asdict(params)
    fields["mode"] = pkg.params.MagnificationMode(params.mode.value)
    return pkg.params.MagnificationParams(**fields)


# the export dialog's edits, as the xvfb test fills them in (with a colour
# case beside it): mode, amplification, resolution, grayscale, layout
EDITS = {"xvfb": dict(mode="laplace", amplification=80.0, downscale=2, gray=True,
                      split="none", labels=True),
         "color": dict(mode="color", amplification=60.0, downscale=1, gray=False,
                       split="left-right", labels=False)}


def _file_flow(pkg, clip, out, edits, monkeypatch):
    """The GUI's open file -> trim -> export flow on ``pkg``'s functions and
    classes; returns (the frames written, the export's config, the texts)."""
    g, P, T = pkg.gui, pkg.params, pkg.types
    written = []

    class Memory:
        def write(self, canvas):
            written.append(canvas.copy())

        def release(self):
            pass

    monkeypatch.setattr(pkg.exporter, "open_writer",
                        lambda fmt, path, fps, size: (Memory(), path, "memory"))
    ctrl = pkg.controller()
    try:
        # on_open_file: push_params (the panel's Laplace defaults), open, play
        ctrl.set_magnification(_params_in(pkg, chip_smoke.gui_params(
            tparams.MagnificationMode.LAPLACE)))
        assert ctrl.open_file(clip)
        ctrl.play()
        assert _wait(lambda: ctrl.stats().processed > 2)
        ctrl.pause()
        # trim via the GUI's transitions at the playhead; a paused seek shows
        # the frame sought and leaves the playhead one past it
        ctrl.seek_frame(3)
        assert _wait(lambda: ctrl.current_frame() == 4)
        in_f, out_f = g.trim_set_in(None, ctrl.current_frame())
        ctrl.set_in_out(in_f, out_f or 0)
        ctrl.seek_frame(15)
        assert _wait(lambda: ctrl.current_frame() == 16)
        in_f, out_f = g.trim_set_out(in_f, out_f, ctrl.current_frame())
        ctrl.set_in_out(in_f, out_f)
        label = g.range_label_text(in_f, out_f)
        guard = g.export_start_guard(False, True)
        # ExportSettingsDialog: seeded from the raw live state, mode switched
        # (its defaults seeded), then edited; _ok's casts
        live = ctrl.config_snapshot(raw_mode=True)
        mode = P.MagnificationMode(edits["mode"])
        d = P.defaults_for(mode)
        ui = P.MagUiValues(mode=mode, amplification=int(edits["amplification"]),
                           wavelength=float(d.wavelength), low=float(d.low),
                           high=float(d.high), chroma=int(d.chroma), levels=max(1, d.levels),
                           capture_fps=float(P.to_ui(live.magnification).capture_fps))
        cfg = g.build_export_config(live, ui, downscale=edits["downscale"],
                                    use_roi=bool(live.preprocess.roi_enabled),
                                    grayscale=edits["gray"])
        req = T.ExportRequest(config=cfg, output_path=out,
                              file_fps=float(ctrl.reported_fps() or 30.0),
                              split=T.SplitMode(edits["split"]), text_overlay=edits["labels"],
                              format=T.ExportFormat.AVI_MJPG, start_frame=in_f, end_frame=out_f)
        problems = T.validate_request(req, ctrl.frame_count())
        exp = pkg.exporter.Exporter(**pkg.exporter_kw)
        exp.start(pkg.sources.FileExportFrameSource(clip, req.start_frame, req.end_frame),
                  req, ctrl.mailbox)
        end = time.monotonic() + 60.0
        while True:
            p = exp.progress()
            action, text = g.export_poll_transition(p.phase, p.frames_done, p.frames_total,
                                                    p.error)
            if action == "finish" or time.monotonic() > end:
                break
            time.sleep(0.05)
        exp.join(timeout=5.0)
        live_after = ctrl.config_snapshot()
    finally:
        ctrl.close()
    return written, cfg, dict(label=label, guard=guard, problems=problems, text=text,
                              live_downscale=live_after.preprocess.downscale,
                              live_gray=live_after.grayscale)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return _make_clip(tmp_path_factory.mktemp("gui_flows") / "in.avi")


@pytest.mark.parametrize("case", list(EDITS))
def test_file_flow_exports_the_references_frames(case, clip, tmp_path, monkeypatch):
    edits = EDITS[case]
    out = str(tmp_path / "out.avi")
    got, cfg, texts = _file_flow(PORT, clip, out, edits, monkeypatch)
    ref, jcfg, jtexts = _file_flow(REF, clip, out, edits, monkeypatch)
    assert texts == jtexts == dict(label="[4..16)", guard="proceed", problems=[],
                                   text="Done — 12 frames written", live_downscale=1,
                                   live_gray=False)
    assert cfg.magnification.mode.value == edits["mode"] == jcfg.magnification.mode.value
    assert cfg.magnification.amplification == edits["amplification"]
    assert (cfg.grayscale, cfg.preprocess.downscale) == (edits["gray"], edits["downscale"])
    assert dataclasses.asdict(cfg.preprocess) == dataclasses.asdict(jcfg.preprocess)
    a, b = np.stack(got), np.stack(ref)
    h, w = 64 // edits["downscale"], 80 // edits["downscale"]
    assert a.shape == b.shape == (12, h, w * (2 if edits["split"] == "left-right" else 1), 3)
    assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
    assert not np.array_equal(a, np.stack([a[0]] * 12))  # the frames move


def test_record_flow_equals_a_fresh_chain():
    """``chip_smoke.gui_record_flow`` on the CPU: the flow runs to "Done",
    the export's amplification is the edited one and every written frame is
    a fresh chain's (checked inside)."""
    row = chip_smoke.gui_record_flow(torch, torch.device("cpu"), 40, 48, seconds=0.6)
    assert row["bit_equal_to_chain"] and row["frames"] >= 5
    assert (row["live_amplification"], row["export_amplification"]) == (50.0, 80.0)
    assert row["canvas"] == [40, 96, 3] and row["record_polls"] >= 3


@pytest.mark.parametrize("mode", ["phase", "laplace", "color"])
def test_gui_params_is_the_panels_mapping(mode):
    """The headless on_mode_change + push_params (the levels slider edited to
    6) equals the mapping composed of the reference's own functions: the
    mode's defaults, the Nyquist clamp, the band slider's snap and gap."""
    got = chip_smoke.gui_params(tparams.MagnificationMode(mode), 30.0, levels=6)
    ui = jparams.defaults_for(jparams.MagnificationMode(mode))
    ui.levels = 6
    jparams.clamp_band_to_nyquist(ui)
    low, high = sorted(jgui.slider_snap(min(max(v, 0.05), 15.0), 0.05) for v in (ui.low, ui.high))
    ui.low, ui.high = jgui.slider_enforce_gap(low, high, 0.05, 0.05, 15.0, "low")
    ref = jparams.to_params(ui)
    assert got.mode.value == ref.mode.value == mode
    assert dataclasses.asdict(got) == {**dataclasses.asdict(ref), "mode": got.mode}
    if mode == "color":  # the slider's 0.05 grid moves colour's default band
        assert jparams.to_ui(ref).low == pytest.approx(0.85)


def _reference_present(view, canvas):
    """The reference's ``_poll_display`` after poll_once, up to the PPM bytes."""
    fh, fw = view.shape[:2]
    dw, dh, x0, y0 = jgui.display_fit(canvas[0], canvas[1], fh, fw)
    if (dw, dh) != (fw, fh):
        ys = (np.arange(dh) * fh / dh).astype(int)
        xs = (np.arange(dw) * fw / dw).astype(int)
        view = view[ys][:, xs]
    return jgui.PhotoCodec().ppm(view)


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_gui_present_is_the_references_poll_display(gray):
    """``chip_smoke.gui_present`` on a side-by-side ``DisplayLoop`` (the
    ``live_4k30_gui`` phase at a small size): one poll composes, fits and
    encodes the pair into the reference's ``_poll_display`` bytes."""
    rng = np.random.default_rng(9)
    shape = (54, 96) if gray else (54, 96, 3)
    proc, orig = (rng.integers(0, 256, shape, np.uint8) for _ in range(2))
    mailbox = LatestFrameMailbox()
    mailbox.publish(DisplayFrame(Frame(seq=0, data=proc), Frame(seq=0, data=orig)))
    present = chip_smoke.gui_present((128, 72))
    encoded = []
    present.codec.ppm = lambda img, ppm=present.codec.ppm: encoded.append(ppm(img)) or encoded[-1]
    display = present.attach(DisplayLoop(mailbox, Instrumentation(), render=present.render,
                                         view_mode=ViewMode.SIDE_BY_SIDE))
    present.render(display.poll_once())
    assert display.poll_once() is None  # no new frame: nothing composed
    ref = _reference_present(jcompose_view(proc, orig, JViewMode.SIDE_BY_SIDE), (128, 72))
    assert encoded == [ref] and present.nbytes == len(ref)
    s = present.stats()
    assert s["presented"] == 1 and s["present_ms_mean"] >= s["ppm_ms_mean"] > 0


def test_gl_present_phase_on_this_machines_egl():
    """``chip_smoke.gl_present`` at a small size: displayed frames, uploads,
    and the framebuffer holding the last frame letterboxed (checked inside);
    "skipped" only where this machine makes no GL context."""
    from live_video_magnification_tpu_torch.engine.gl_present import gl_available

    row = chip_smoke.gl_present(torch, torch.device("cpu"), None, None, None, h=48, w=64,
                                fps=30.0, seconds=1.5, canvas=(128, 72))
    if not gl_available():
        assert "skipped" in row
        return
    assert row["displayed"] >= 2 and row["uploads"] == row["displayed"]
    assert row["viewport"] == [16, 0, 96, 72]
