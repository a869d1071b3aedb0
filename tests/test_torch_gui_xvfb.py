"""The port's ``MainWindow`` end to end under a real X display, case for case
as the reference suite's ``tests/test_gui_xvfb.py``, with the chain on the
CPU (``MainWindow(device="cpu")``).

Skips unless $DISPLAY is set (run it under ``xvfb-run -a``), exactly as the
reference file does. The tests drive the real tkinter widgets and dialogs:
open file -> trim -> export dialog (with edited, non-live parameters) ->
progress -> done, record -> stop -> export, the band slider, the Original
view, the theme toggle, fullscreen and the settings toggle. The modal
ExportSettingsDialog blocks in wait_window(); the tests wrap its __init__ to
schedule an autopilot ``after`` callback that edits the real dialog widgets
and presses its real OK path while the mainloop pumps.
"""

import os
import time

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("DISPLAY"),
    reason="needs an X display (CI runs this under xvfb-run)")


def _make_clip(path, t=24, h=64, w=80, fps=30.0):
    import cv2

    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.random((h, w, 3)).astype(np.float32), (0, 0), 3.0)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for i in range(t):
        img = np.clip((base * (0.8 + 0.2 * np.sin(i / 3.0))) * 255, 0, 255)
        wr.write(img.astype(np.uint8))
    wr.release()
    return str(path)


def _read(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.asarray(frames)


def _pump(win, seconds=1.0, until=None):
    """Run the Tk event loop for `seconds` or until `until()` is true."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        win.root.update()
        if until is not None and until():
            return True
        time.sleep(0.01)
    return until() if until is not None else True


@pytest.fixture
def win():
    from live_video_magnification_tpu_torch.gui import MainWindow

    w = MainWindow(device="cpu")
    yield w
    try:
        if w._exporter is not None:
            w._abort_export()
            w._exporter.join(timeout=10.0)
        w.controller.close()
        w.root.destroy()
    except Exception:
        pass


def _autopilot_export_dialog(monkeypatch, fill):
    """Wrap ExportSettingsDialog.__init__ so `fill(dlg)` runs (on the Tk event
    loop) while the real modal dialog is blocked in wait_window()."""
    import live_video_magnification_tpu_torch.gui as gui_mod

    orig_init = gui_mod.ExportSettingsDialog.__init__
    captured = {}

    def patched(self, root, cfg, **kw):
        def auto():
            try:
                fill(self)
                captured["config"] = self.result.config if self.result else None
            except Exception as e:  # surface autopilot failures as test output
                captured["error"] = repr(e)
                self.top.destroy()

        root.after(600, auto)
        orig_init(self, root, cfg, **kw)

    monkeypatch.setattr(gui_mod.ExportSettingsDialog, "__init__", patched)
    return captured


def test_export_flow_with_edited_params(win, tmp_path, monkeypatch):
    """open file -> play -> trim [4..16) -> export with params != live state
    -> progress dialog -> done file on disk."""
    from live_video_magnification_tpu_torch.models.params import MagnificationMode

    clip = _make_clip(tmp_path / "in.avi")
    out = tmp_path / "out.avi"
    monkeypatch.setattr(win.filedialog, "askopenfilename", lambda **k: clip)
    win.on_open_file()
    assert win._file_path == clip
    assert _pump(win, 90.0, until=lambda: win.controller.stats().processed > 2)
    # playback-fps spinbox enabled + seeded for file sources (item 6a)
    assert str(win.playback_fps_spin.cget("state")) == "normal"

    # trim via the real handlers
    win.controller.pause()
    win.controller.seek_frame(4)
    _pump(win, 0.3)
    win.on_set_in()
    win.controller.seek_frame(16)
    _pump(win, 0.3)
    win.on_set_out()
    assert (win._in_frame, win._out_frame) == (4, 16)
    assert win.range_label.cget("text") == "[4..16)"

    def fill(dlg):
        dlg.path_var.set(str(out))
        dlg.fmt_var.set("AVI (MJPG)")
        dlg.split_var.set("Processed only")
        # edit processing params AWAY from the live (phase-mode default) state
        dlg.mode_var.set("Laplace (motion)")
        dlg._seed_mode_defaults()
        dlg.amp_var.set(80.0)
        dlg.res_var.set("1/2")
        dlg.export_gray_var.set(True)
        dlg._ok()

    captured = _autopilot_export_dialog(monkeypatch, fill)
    win.on_export()
    assert "error" not in captured, captured
    cfg = captured["config"]
    assert cfg is not None
    # the export got its own config, different from live
    assert cfg.magnification.mode is MagnificationMode.LAPLACE
    assert cfg.magnification.amplification == 80.0
    assert cfg.grayscale is True
    assert cfg.preprocess.downscale == 2
    live = win.controller.config_snapshot()
    assert live.preprocess.downscale == 1
    assert live.grayscale is False

    assert _pump(win, 60.0, until=lambda: win._exporter is None)
    frames = _read(out)
    assert frames.shape[0] == 12           # [4..16)
    assert frames.shape[1:3] == (32, 40)   # 1/2 downscale applied


def test_record_flow_synthetic_camera(win, tmp_path, monkeypatch):
    """record (synthetic camera) -> stop -> export dialog -> done file."""
    out = tmp_path / "rec.avi"
    assert win.controller.open_synthetic(h=48, w=64, fps=30.0, as_camera=True)
    win.controller.play()
    win.push_params()
    _pump(win, 90.0, until=lambda: win.controller.stats().processed > 2)

    win.on_record()               # start recording
    assert win._recording_buf is not None
    _pump(win, 1.5, until=lambda: win._recording_buf.frame_count >= 8)
    assert win._recording_buf.frame_count >= 2

    def fill(dlg):
        dlg.path_var.set(str(out))
        dlg.fmt_var.set("AVI (MJPG)")
        dlg.split_var.set("Processed only")
        dlg._ok()

    captured = _autopilot_export_dialog(monkeypatch, fill)
    win.on_record()               # stop + export
    assert "error" not in captured, captured
    assert _pump(win, 60.0, until=lambda: win._exporter is None)
    assert _read(out).shape[0] >= 2


def test_band_slider_drag_updates_params(win):
    """The dual-handle band slider (reference RangeSlider) drives low/high and
    pushes params; programmatic set_values stays silent."""
    from types import SimpleNamespace

    win.push_params()
    s = win.band_slider
    s.canvas.configure(width=300)
    _pump(win, 0.5)
    if s.canvas.winfo_width() < 100:
        pytest.skip("canvas not realized wide enough for pixel-drag precision")

    pushed = []
    orig = win.push_params
    win.push_params = lambda: (pushed.append(1), orig())[1]
    # drag the high handle to ~mid-track (log axis)
    x_target = int(s._to_x(2.0))
    s._press(SimpleNamespace(x=int(s._to_x(s.high))))
    s._drag(SimpleNamespace(x=x_target))
    assert pushed, "user drag must fire push_params"
    assert win.high_var.get() < 5.0
    assert win.low_var.get() < win.high_var.get()

    pushed.clear()
    s.set_values(0.5, 3.0)  # silent
    assert not pushed
    assert (s.low, s.high) == (0.5, 3.0)


def test_original_view_short_circuits_magnification(win):
    """Selecting the Original view drives set_magnify_active(False)
    (item 6b; reference MainWindow.cpp:199-204)."""
    from live_video_magnification_tpu_torch.models.params import MagnificationMode

    win.push_params()
    assert win.controller.config_snapshot().magnification.mode is not \
        MagnificationMode.NONE
    win.view_var.set("original")
    win._set_view()
    assert win.controller.config_snapshot().magnification.mode is \
        MagnificationMode.NONE
    win.view_var.set("processed")
    win._set_view()
    assert win.controller.config_snapshot().magnification.mode is not \
        MagnificationMode.NONE


def test_theme_toggle_restyles_live_widgets(win):
    """The toolbar Theme toggle re-applies the full token set to the live
    window (reference Theme.cpp overrideScheme): the canvas ground and ttk
    base style flip between the dark and light palettes."""
    from live_video_magnification_tpu_torch import theme

    start = win._theme_state.scheme
    start_bg = win.canvas.cget("background")
    assert start_bg.upper() == theme.palette(start).bg.upper()
    win.on_theme_toggle()
    flipped = win._theme_state.scheme
    assert flipped == theme.toggled(start)
    assert win.canvas.cget("background").upper() == \
        theme.palette(flipped).bg.upper()
    assert not win._theme_state.following_system  # pinned by the toggle
    win.on_theme_toggle()
    assert win._theme_state.scheme == start


def test_fullscreen_and_settings_toggle(win):
    """Toolbar parity (MainWindow.cpp:97-100,346-389,407-421): the Settings
    checkbutton hides/shows the inspector panel; fullscreen hides the chrome
    (transport kept for a file source), F11 toggles and Escape exits; leaving
    fullscreen respects a hidden settings panel."""
    _pump(win, 0.2)
    assert win.panel.winfo_manager()          # inspector starts visible

    # settings toggle hides / shows the panel
    win.settings_var.set(False)
    win.on_settings_toggle()
    _pump(win, 0.2)
    assert not win.panel.winfo_manager()
    win.settings_var.set(True)
    win.on_settings_toggle()
    _pump(win, 0.2)
    assert win.panel.winfo_manager()

    # enter fullscreen: chrome hides; reconcile follows the ACTUAL state
    win.set_fullscreen(True)
    assert _pump(win, 2.0, until=lambda: win._fs.applied)
    assert not win.toolbar.winfo_manager()
    assert not win.panel.winfo_manager()
    assert not win.status.winfo_manager()

    # Escape exits; chrome returns
    win._on_fullscreen_key("Escape")
    assert _pump(win, 2.0, until=lambda: not win._fs.applied)
    assert win.toolbar.winfo_manager()
    assert win.panel.winfo_manager()
    assert win.status.winfo_manager()

    # hidden settings panel stays hidden across a fullscreen round trip
    win.settings_var.set(False)
    win.on_settings_toggle()
    win._on_fullscreen_key("F11")             # F11 enters
    assert _pump(win, 2.0, until=lambda: win._fs.applied)
    win._on_fullscreen_key("F11")             # F11 exits
    assert _pump(win, 2.0, until=lambda: not win._fs.applied)
    assert win.toolbar.winfo_manager()
    assert not win.panel.winfo_manager()      # explicitly-hidden child
