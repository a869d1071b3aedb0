"""The port's GUI logic (``gui.py``'s pure functions and ``PhotoCodec``, and
``theme.py``) on the CPU, case for case as the reference suite's
``tests/test_gui_logic.py`` and held against the reference package.

* The thirty cases of ``tests/test_gui_logic.py`` on the port's functions
  (the controller case with ``PlaybackController(device="cpu")``).
* Each pure function against the reference's on seeded inputs (hypothesis,
  derandomized): the band slider's maps, snap, gap and drag, the canvas and
  ROI maps, the trim machine and its label, the guards and transitions of
  the export, record and close flows, fullscreen, the status line, the
  letterbox fit, the timeline fraction, the canvas present's fit and the
  theme; ``PhotoCodec.ppm``'s bytes equal to the reference's (cv2) for BGR
  and gray frames of odd sizes, strided views included;
  ``build_export_config`` equal field for field.
"""

import dataclasses
import enum
import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

import live_video_magnification_tpu.gui as jgui
import live_video_magnification_tpu.theme as jtheme
import live_video_magnification_tpu_torch.gui as tgui
import live_video_magnification_tpu_torch.theme as ttheme
from live_video_magnification_tpu.engine.display import ViewMode as JViewMode
from live_video_magnification_tpu.export.types import ExportPhase as JPhase
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu_torch.engine.display import ViewMode

from live_video_magnification_tpu_torch.export.types import (
    ExportFormat,
    ExportPhase,
    ExportRequest,
    SplitMode,
    validate_request,
)
from live_video_magnification_tpu_torch.gui import (
    build_export_config,
    canvas_to_norm,
    drag_to_roi,
    range_label_text,
    slider_enforce_gap,
    slider_frac,
    slider_move_active,
    slider_snap,
    slider_value,
    trim_set_in,
    trim_set_out,
)
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    MagnificationParams,
    MagUiValues,
    PreprocessParams,
    ProcessorConfig,
    to_ui,
)


# ------------------------------------------------------------- canvas / ROI

def test_canvas_to_norm_maps_and_clamps():
    geom = (100, 50, 200, 100, 640, 480)  # x0, y0, dw, dh, fw, fh
    assert canvas_to_norm(geom, 100, 50) == (0.0, 0.0)
    assert canvas_to_norm(geom, 300, 150) == (1.0, 1.0)
    assert canvas_to_norm(geom, 200, 100) == (0.5, 0.5)
    # outside the letterboxed pane clamps to the pane edge
    assert canvas_to_norm(geom, 0, 0) == (0.0, 0.0)
    assert canvas_to_norm(geom, 900, 900) == (1.0, 1.0)
    assert canvas_to_norm(None, 10, 10) is None  # before the first frame


def test_drag_to_roi_normalizes_any_direction():
    # up-left drag == down-right drag
    assert drag_to_roi((0.8, 0.7), (0.2, 0.1)) == pytest.approx((0.2, 0.1, 0.6, 0.6))
    assert drag_to_roi((0.2, 0.1), (0.8, 0.7)) == pytest.approx((0.2, 0.1, 0.6, 0.6))


def test_drag_to_roi_rejects_degenerate():
    assert drag_to_roi((0.5, 0.5), (0.505, 0.9)) is None  # sub-1% width
    assert drag_to_roi((0.5, 0.5), (0.9, 0.505)) is None  # sub-1% height
    assert drag_to_roi(None, (0.9, 0.9)) is None          # no frame yet


# ------------------------------------------------------------- trim machine

def test_trim_set_in_discards_stale_out():
    assert trim_set_in(None, 10) == (10, None)
    assert trim_set_in(50, 10) == (10, 50)      # out still after in: kept
    assert trim_set_in(10, 10) == (10, None)    # out == new in: discarded
    assert trim_set_in(5, 10) == (10, None)     # out before new in: discarded


def test_trim_set_out_requires_after_in():
    assert trim_set_out(10, None, 30) == (10, 30)
    assert trim_set_out(10, 30, 5) == (10, 30)     # rejected, unchanged
    assert trim_set_out(10, 30, 10) == (10, 30)    # == in rejected (exclusive)


def test_range_label_text():
    assert range_label_text(0, None) == ""
    assert range_label_text(5, None) == "[5..end)"
    assert range_label_text(5, 90) == "[5..90)"


def test_export_seeds_from_raw_mode_snapshot():
    """With the 'Original' view active (magnification short-circuited to
    NONE), the export dialog must still seed from the REAL magnification
    params — config_snapshot(raw_mode=True) (code-review round-3 finding)."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController

    ctrl = PlaybackController(device="cpu")
    try:
        ctrl.set_magnification(MagnificationParams(
            mode=MagnificationMode.PHASE, amplification=50.0,
            co_wavelength=50.0, co_low=1.0, co_high=5.0, levels=5,
            framerate=30.0))
        ctrl.set_magnify_active(False)  # "Original" view
        assert ctrl.config_snapshot().magnification.mode is MagnificationMode.NONE
        raw = ctrl.config_snapshot(raw_mode=True)
        assert raw.magnification.mode is MagnificationMode.PHASE
        assert raw.magnification.co_low == 1.0
    finally:
        ctrl.close()


# --------------------------------------------------- dual-handle band slider

def test_slider_log_mapping_roundtrip():
    """Log pixel axis (reference RangeSlider.cpp:37-50): value<->fraction
    roundtrips; midpoint of [0.05, 15] log axis is the geometric mean."""
    mn, mx = 0.05, 15.0
    for v in (0.05, 0.5, 1.0, 5.0, 15.0):
        f = slider_frac(v, mn, mx, True)
        assert 0.0 <= f <= 1.0
        assert slider_value(f, mn, mx, True) == pytest.approx(v, rel=1e-9)
    assert slider_value(0.5, mn, mx, True) == pytest.approx((mn * mx) ** 0.5)
    # linear axis
    assert slider_frac(5.0, 0.0, 10.0, False) == 0.5
    assert slider_value(0.25, 0.0, 10.0, False) == 2.5


def test_slider_snap():
    assert slider_snap(1.234, 0.05) == pytest.approx(1.25)
    assert slider_snap(1.22, 0.05) == pytest.approx(1.20)
    assert slider_snap(7.0, 0.0) == 7.0  # degenerate step falls back to 1


def test_slider_enforce_gap_handles_cannot_cross():
    # moving low into high pushes high up
    assert slider_enforce_gap(5.0, 5.0, 0.05, 0.05, 15.0, "low") == \
        pytest.approx((5.0, 5.05))
    # moving high into low pulls low down
    assert slider_enforce_gap(5.0, 5.0, 0.05, 0.05, 15.0, "high") == \
        pytest.approx((4.95, 5.0))
    # at the top edge the other handle yields
    lo, hi = slider_enforce_gap(15.0, 15.0, 0.05, 0.05, 15.0, "low")
    assert hi == 15.0 and lo == pytest.approx(14.95)
    # already-valid gap untouched
    assert slider_enforce_gap(1.0, 5.0, 0.05, 0.05, 15.0, "low") == (1.0, 5.0)


def test_slider_drag_never_moves_inactive_handle():
    # reference moveActiveTo (RangeSlider.cpp:106-121): dragging low past high
    # clamps LOW at high-step — it never pushes high along (ADVICE round-3).
    assert slider_move_active(9.0, "low", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((4.95, 5.0))
    # dragging high below low clamps HIGH at low+step, low stays put
    assert slider_move_active(0.5, "high", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((2.0, 2.05))
    # in-range drags move only the active handle
    assert slider_move_active(3.0, "low", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((3.0, 5.0))
    assert slider_move_active(10.0, "high", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((2.0, 10.0))
    # track-edge clamps still apply to the active handle
    assert slider_move_active(-4.0, "low", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((0.05, 5.0))
    assert slider_move_active(99.0, "high", 2.0, 5.0, 0.05, 0.05, 15.0) == \
        pytest.approx((2.0, 15.0))


# ------------------------------------------------------- export config edit

def _live_cfg(roi=True):
    pre = PreprocessParams(downscale=2)
    if roi:
        pre = dataclasses.replace(pre, roi_enabled=True, roi_x=0.1, roi_y=0.2,
                                  roi_w=0.5, roi_h=0.6)
    return ProcessorConfig(
        grayscale=False, preprocess=pre,
        magnification=MagnificationParams(
            mode=MagnificationMode.PHASE, amplification=50.0, co_wavelength=50.0,
            co_low=1.0, co_high=5.0, levels=5, framerate=30.0))


def test_build_export_config_independent_of_live():
    """The export dialog can produce params != live state (reference
    ExportSettingsDialog.cpp:60-200): different mode, alpha, resolution,
    grayscale — while live config is untouched."""
    live = _live_cfg()
    ui = MagUiValues(mode=MagnificationMode.LAPLACE, amplification=80,
                     wavelength=40.0, low=0.5, high=3.0, chroma=10, levels=3,
                     capture_fps=30.0)
    cfg = build_export_config(live, ui, downscale=4, use_roi=True, grayscale=True)
    assert cfg.magnification.mode is MagnificationMode.LAPLACE
    assert cfg.magnification.amplification == 80.0
    assert cfg.magnification.levels == 3
    assert cfg.grayscale is True
    assert cfg.preprocess.downscale == 4
    # ROI rect preserved from live state
    assert cfg.preprocess.roi_enabled and cfg.preprocess.roi_x == 0.1
    # live config untouched
    assert live.magnification.mode is MagnificationMode.PHASE
    assert live.preprocess.downscale == 2


def test_build_export_config_drop_roi():
    cfg = build_export_config(_live_cfg(), to_ui(_live_cfg().magnification),
                              downscale=1, use_roi=False, grayscale=False)
    assert not cfg.preprocess.roi_enabled
    assert cfg.preprocess.downscale == 1


def test_build_export_config_clamps_band_to_nyquist():
    ui = MagUiValues(mode=MagnificationMode.COLOR, amplification=100,
                     low=0.8, high=40.0, levels=3, capture_fps=30.0)
    cfg = build_export_config(_live_cfg(), ui, downscale=1, use_roi=False,
                              grayscale=False)
    assert cfg.magnification.co_high <= 15.0  # fps/2


def test_validate_request_covers_config_numerics(tmp_path):
    bad = dataclasses.replace(
        _live_cfg(),
        preprocess=PreprocessParams(downscale=3),
        magnification=dataclasses.replace(
            _live_cfg().magnification, framerate=0.0, amplification=-1.0,
            levels=0))
    req = ExportRequest(config=bad, output_path=str(tmp_path / "o.mp4"),
                        file_fps=30.0, split=SplitMode.NONE, text_overlay=False,
                        format=ExportFormat.MP4_H264)
    problems = validate_request(req, 100)
    joined = "\n".join(problems)
    assert "framerate" in joined
    assert "amplification" in joined
    assert "levels" in joined
    assert "downscale" in joined


def test_validate_request_accepts_edited_config(tmp_path):
    ui = MagUiValues(mode=MagnificationMode.LAPLACE, amplification=20,
                     low=1.0, high=5.0, levels=4, capture_fps=30.0)
    cfg = build_export_config(_live_cfg(), ui, downscale=8, use_roi=True,
                              grayscale=False)
    req = ExportRequest(config=cfg, output_path=str(tmp_path / "o.mp4"),
                        file_fps=30.0, split=SplitMode.LEFT_RIGHT,
                        text_overlay=True, format=ExportFormat.MP4_H264)
    assert validate_request(req, 100) == []


# ------------------------------------------- export/record state machines

def test_export_flow_state_machine_end_to_end():
    """Guard -> processing ticks -> terminal texts, for every terminal phase
    (MainWindow.cpp:503-661 without a display; VERDICT r3 item 6)."""
    from live_video_magnification_tpu_torch.export.types import ExportPhase
    from live_video_magnification_tpu_torch.gui import (
        export_poll_transition,
        export_start_guard,
    )

    # guards
    assert export_start_guard(True, True) == "busy"
    assert export_start_guard(False, False) == "no_file"
    assert export_start_guard(False, True) == "proceed"

    # a full successful run: N processing ticks then DONE
    for _ in range(3):
        action, text = export_poll_transition(ExportPhase.PROCESSING, 5, 100, None)
        assert action == "continue" and text is None
    action, text = export_poll_transition(ExportPhase.DONE, 100, 100, None)
    assert action == "finish" and text == "Done — 100 frames written"

    # abort and failure terminals
    assert export_poll_transition(ExportPhase.ABORTED, 7, 100, None)[1] == \
        "Aborted — partial file deleted"
    assert export_poll_transition(ExportPhase.FAILED, 0, None, "boom")[1] == \
        "Failed: boom"


def test_record_flow_state_machine_end_to_end():
    """Record toggle guards -> RAM-cap autostop -> settings-or-nothing
    (MainWindow.cpp:568-585, the 8 GB cap at :49-51)."""
    from live_video_magnification_tpu_torch.gui import (
        record_poll_transition,
        record_start_guard,
        record_stop_decision,
    )

    assert record_start_guard(False, False) == "begin"
    assert record_start_guard(False, True) == "busy"
    assert record_start_guard(True, False) == "stop"   # toggle stops
    # polling: continues until the cap trips
    assert record_poll_transition(False) == "continue"
    assert record_poll_transition(True) == "autostop"
    # stop outcome
    assert record_stop_decision(0) == "nothing"
    assert record_stop_decision(120) == "open_settings"


def test_close_protection_decision():
    """Close blocked mid-export unless the user confirms abort
    (MainWindow.cpp:332-342)."""
    from live_video_magnification_tpu_torch.gui import close_decision

    assert close_decision(False, False, False) == "close"
    assert close_decision(True, False, False) == "ask"
    assert close_decision(False, True, False) == "ask"
    assert close_decision(True, False, True) == "abort_and_close"
    assert close_decision(False, True, True) == "abort_and_close"


def test_view_mode_magnify_dispatch():
    from live_video_magnification_tpu_torch.engine.display import ViewMode
    from live_video_magnification_tpu_torch.gui import view_magnify_active

    assert view_magnify_active(ViewMode.ORIGINAL) is False
    for m in (ViewMode.PROCESSED, ViewMode.SIDE_BY_SIDE, ViewMode.TOP_BOTTOM):
        assert view_magnify_active(m) is True


def test_stats_line_health_and_hint():
    """StatusStrip formatting + StatusHealth thresholds headless
    (StatusHealth.hpp: file ok>=0.95/warn>=0.80; camera warn>2%/bad>15%)."""
    from live_video_magnification_tpu_torch.gui import stats_line

    text, health = stats_line(59.0, 12.0, 20.0, 1, 0, 0.0, False, 60.0)
    assert health == "ok" and "59.0 / 60 fps" in text and "falling behind" not in text
    text, health = stats_line(50.0, 12.0, 20.0, 1, 0, 0.0, False, 60.0)
    assert health == "warn" and "falling behind" in text
    text, health = stats_line(20.0, 12.0, 20.0, 1, 0, 0.0, False, 60.0)
    assert health == "bad"
    text, health = stats_line(30.0, 5.0, 9.0, 0, 0, 0.01, True, 30.0)
    assert health == "ok" and "drops  1.0%" in text
    _text, health = stats_line(30.0, 5.0, 9.0, 0, 0, 0.20, True, 30.0)
    assert health == "bad"


def test_display_fit_letterbox_math():
    from live_video_magnification_tpu_torch.gui import display_fit, timeline_fraction

    # 16:9 frame in a square canvas: pillar/letter boxed and centered
    dw, dh, x0, y0 = display_fit(400, 400, 1080, 1920)
    assert (dw, dh) == (400, 225) and x0 == 0 and y0 == (400 - 225) // 2
    # canvas wider than frame aspect
    dw, dh, x0, y0 = display_fit(1000, 225, 1080, 1920)
    assert (dw, dh) == (400, 225) and x0 == 300 and y0 == 0
    # degenerate canvas never divides by zero
    assert display_fit(0, 0, 10, 10)[:2] == (1, 1)
    assert timeline_fraction(0, 100) == 0.0
    assert timeline_fraction(99, 100) == 1.0
    assert timeline_fraction(0, 1) == 0.0  # single-frame clip


# ----------------------------------------------------------------- theming

def test_theme_palettes_match_reference_tokens():
    """The published token values of Theme.cpp:227-261, verbatim (config
    constants the reference ships, like the MagnificationParamsUi defaults)."""
    from live_video_magnification_tpu_torch import theme

    d = theme.palette(theme.DARK)
    assert (d.bg, d.accent, d.accent_ink) == ("#15110D", "#F4A23C", "#2A1505")
    assert (d.ok, d.danger) == ("#8FCB8A", "#F2606B")
    l = theme.palette(theme.LIGHT)
    assert (l.bg, l.accent, l.accent_ink) == ("#EEF0F2", "#B8521C", "#FFFFFF")
    # every token is a well-formed color and differs between schemes
    import dataclasses

    for f in dataclasses.fields(d):
        dv, lv = getattr(d, f.name), getattr(l, f.name)
        assert dv.startswith("#") and len(dv) == 7
        assert lv.startswith("#") and len(lv) == 7


def test_theme_mix_and_toggle():
    from live_video_magnification_tpu_torch import theme

    assert theme.mix("#000000", "#FFFFFF", 0.0) == "#000000"
    assert theme.mix("#000000", "#FFFFFF", 1.0) == "#FFFFFF"
    assert theme.mix("#000000", "#FFFFFF", 0.5) == "#7F7F7F"
    assert theme.mix("#000000", "#FFFFFF", 2.0) == "#FFFFFF"  # clamped
    assert theme.toggled(theme.DARK) == theme.LIGHT
    assert theme.toggled(theme.LIGHT) == theme.DARK


def test_theme_scheme_resolution_and_pin():
    """LVMT_THEME pin -> OS hints -> Dark fallback (Theme.hpp:61-68);
    follow-the-OS until the user pins via toggle, nothing persisted."""
    from live_video_magnification_tpu_torch import theme

    assert theme.resolve_scheme({}) == theme.DARK  # reference fallback
    assert theme.resolve_scheme({"LVMT_THEME": "light"}) == theme.LIGHT
    assert theme.resolve_scheme({"GTK_THEME": "Adwaita-dark"}) == theme.DARK
    assert theme.resolve_scheme({"GTK_THEME": "Adwaita"}) == theme.LIGHT
    assert theme.resolve_scheme({"COLORFGBG": "0;15"}) == theme.LIGHT
    assert theme.resolve_scheme({"COLORFGBG": "15;0"}) == theme.DARK
    # pin wins over hints
    assert theme.resolve_scheme(
        {"LVMT_THEME": "dark", "GTK_THEME": "Adwaita"}) == theme.DARK

    st = theme.ThemeState(env={"GTK_THEME": "Adwaita"})
    assert st.scheme == theme.LIGHT and st.following_system
    assert st.toggle() == theme.DARK
    assert st.scheme == theme.DARK and not st.following_system
    assert st.toggle() == theme.LIGHT


def test_theme_style_map_uses_tokens_consistently():
    """Every ttk style derives from the palette (no hardcoded colors) and the
    accent button uses accent_ink for legibility (Theme.cpp QSS semantics)."""
    from live_video_magnification_tpu_torch import theme

    for scheme in (theme.DARK, theme.LIGHT):
        p = theme.palette(scheme)
        m = theme.style_map(p)
        assert m["."]["background"] == p.surface
        assert m["TEntry"]["fieldbackground"] == p.field
        assert m["Accent.TButton"]["background"] == p.accent
        assert m["Accent.TButton"]["foreground"] == p.accent_ink
        assert m["Dim.TLabel"]["foreground"] == p.dim
        w = theme.widget_defaults(p)
        assert w["*Canvas.background"] == p.bg
        assert w["*Listbox.selectBackground"] == p.accent


# ------------------------------------------------- fullscreen + settings toggle

def test_fullscreen_request_semantics():
    """setFullscreen request rules (MainWindow.cpp:346-357): blocked during
    export, idempotent, and leaving restores the remembered maximized
    state."""
    from live_video_magnification_tpu_torch.gui import FullscreenState

    fs = FullscreenState()
    # an export owns the UI lock
    assert fs.request(True, export_active=True, is_fullscreen=False,
                      is_maximized=False) == "noop"
    # already fullscreen: no re-request
    assert fs.request(True, False, is_fullscreen=True,
                      is_maximized=False) == "noop"
    # entering remembers maximized
    assert fs.request(True, False, False, is_maximized=True) == "enter"
    assert fs.request(False, False, is_fullscreen=True,
                      is_maximized=False) == "leave_max"
    # entering from a normal window leaves to normal
    assert fs.request(True, False, False, is_maximized=False) == "enter"
    assert fs.request(False, False, True, False) == "leave_normal"
    # leave while not fullscreen: nothing to do
    assert fs.request(False, False, is_fullscreen=False,
                      is_maximized=False) == "noop"


def test_fullscreen_reconcile_chrome_and_idempotency():
    """applyFullscreenUi semantics (MainWindow.cpp:359-380): chrome follows
    the ACTUAL granted state; repeated state-change events are no-ops; a file
    source keeps the transport scrubbable; ROI drawing disarms on entry."""
    from live_video_magnification_tpu_torch.gui import FullscreenState

    fs = FullscreenState()
    # WM denied the request: actual stays False -> nothing changes
    assert fs.reconcile(False, source_open=True, source_is_file=True,
                        settings_on=True) is None

    vis = fs.reconcile(True, source_open=True, source_is_file=True,
                       settings_on=True)
    assert vis == {"toolbar": False, "panel": False, "status": False,
                   "transport": True,      # file stays scrubbable
                   "disarm_roi": True, "focus_display": True}
    # duplicate WindowStateChange: idempotent
    assert fs.reconcile(True, True, True, True) is None

    # camera source: transport hides too
    fs2 = FullscreenState()
    vis = fs2.reconcile(True, source_open=True, source_is_file=False,
                        settings_on=True)
    assert vis["transport"] is False

    # leaving: everything back, but the settings panel only if its toggle is
    # still on (explicitly-hidden child survives)
    vis = fs2.reconcile(False, source_open=True, source_is_file=False,
                        settings_on=False)
    assert vis == {"toolbar": True, "panel": False, "status": True,
                   "transport": True, "disarm_roi": False,
                   "focus_display": False}


def test_fullscreen_keys():
    """F11 toggles, Escape only exits while fullscreen and otherwise
    propagates; both inert during export (MainWindow.cpp:407-421)."""
    from live_video_magnification_tpu_torch.gui import fullscreen_key

    assert fullscreen_key("F11", False, False) == "toggle"
    assert fullscreen_key("F11", True, False) == "toggle"
    assert fullscreen_key("Escape", True, False) == "exit"
    assert fullscreen_key("Escape", False, False) == "pass"  # propagates
    assert fullscreen_key("F11", False, True) == "pass"      # export lock
    assert fullscreen_key("Escape", True, True) == "pass"
    assert fullscreen_key("a", True, False) == "pass"


def test_photo_codec_matches_naive_ppm():
    """PhotoCodec's in-place PPM encode is byte-identical to the naive
    header + BGR->RGB + tobytes encode, for color and gray, across geometry
    changes (the buffer rebuilds on a new shape)."""
    import numpy as np

    from live_video_magnification_tpu_torch.gui import PhotoCodec

    def naive(img):
        if img.ndim == 2:
            rgb = np.repeat(img[..., None], 3, axis=-1)
        else:
            rgb = img[..., ::-1]
        h, w = rgb.shape[:2]
        return (f"P6 {w} {h} 255 ".encode()
                + np.ascontiguousarray(rgb).tobytes())

    codec = PhotoCodec()
    rng = np.random.default_rng(1)
    color = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    gray = rng.integers(0, 255, (32, 40), dtype=np.uint8)
    assert codec.ppm(color) == naive(color)
    assert codec.ppm(gray) == naive(gray)          # geometry switch
    color2 = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    assert codec.ppm(color2) == naive(color2)      # buffer reuse, new content


# ---------------------------------------------------------------- against the reference package

SEEDED = settings(max_examples=60, deadline=None, derandomize=True, database=None)
VALUES = hs.floats(-50.0, 50.0, allow_nan=False)
POSITIVE = hs.floats(0.01, 50.0, allow_nan=False)


def _same(name, *args, module=None):
    """The port's and the reference's ``name`` on the same arguments: the same
    result, or the same exception type."""
    def call(mod):
        try:
            return "ok", getattr(mod, name)(*args)
        except Exception as e:  # noqa: BLE001 - compared, not swallowed
            return "raised", type(e).__name__
    port, ref = (tgui, jgui) if module is None else module
    assert call(port) == call(ref), (name, args)


@SEEDED
@given(v=VALUES, mn=VALUES, span=hs.floats(0.0, 60.0), log=hs.booleans(),
       step=hs.sampled_from([0.0, 0.05, 0.1, 1.0]), frac=hs.floats(-0.5, 1.5),
       low=VALUES, high=VALUES, which=hs.sampled_from(["low", "high"]))
def test_slider_maps_equal_the_references(v, mn, span, log, step, frac, low, high, which):
    mx = mn + span
    _same("slider_frac", v, mn, mx, log)
    _same("slider_value", frac, mn, mx, log)
    _same("slider_snap", v, step)
    _same("slider_enforce_gap", low, high, step, mn, mx, which)
    _same("slider_move_active", v, which, low, high, step, mn, mx)


@SEEDED
@given(geom=hs.one_of(hs.none(), hs.tuples(VALUES, VALUES, POSITIVE, POSITIVE,
                                           hs.integers(1, 4096), hs.integers(1, 4096))),
       x=VALUES, y=VALUES, p0=hs.one_of(hs.none(), hs.tuples(hs.floats(0, 1), hs.floats(0, 1))),
       p1=hs.one_of(hs.none(), hs.tuples(hs.floats(0, 1), hs.floats(0, 1))),
       min_size=hs.sampled_from([0.0, 0.01, 0.2]))
def test_canvas_and_roi_maps_equal_the_references(geom, x, y, p0, p1, min_size):
    _same("canvas_to_norm", geom, x, y)
    _same("drag_to_roi", p0, p1, min_size)


@SEEDED
@given(in_frame=hs.integers(0, 50), out_frame=hs.one_of(hs.none(), hs.integers(0, 50)),
       current=hs.integers(0, 50))
def test_trim_machine_equals_the_references(in_frame, out_frame, current):
    _same("trim_set_in", out_frame, current)
    _same("trim_set_out", in_frame, out_frame, current)
    _same("range_label_text", in_frame, out_frame)


def test_flow_guards_and_transitions_equal_the_references():
    """Every input of the export, record and close guards, each export
    phase's poll transition, the view dispatch and the fullscreen keys."""
    for a, b, c in itertools.product([False, True], repeat=3):
        _same("export_start_guard", a, b)
        _same("record_start_guard", a, b)
        _same("close_decision", a, b, c)
        _same("record_poll_transition", a)
    for n in (0, 1, 120):
        _same("record_stop_decision", n)
    for phase in ExportPhase:
        for done, total, err in [(0, None, None), (7, 100, "boom"), (100, 100, None)]:
            assert tgui.export_poll_transition(phase, done, total, err) == \
                jgui.export_poll_transition(JPhase(phase.value), done, total, err)
    for mode in ViewMode:
        assert tgui.view_magnify_active(mode) is jgui.view_magnify_active(JViewMode(mode.value))
    for key, fs, busy in itertools.product(["F11", "Escape", "a"], [False, True], [False, True]):
        _same("fullscreen_key", key, fs, busy)


@SEEDED
@given(events=hs.lists(hs.tuples(hs.booleans(), hs.booleans(), hs.booleans(), hs.booleans(),
                                 hs.booleans()), max_size=12))
def test_fullscreen_state_equals_the_references(events):
    """The same run of requests and reconciles through both FullscreenStates."""
    port, ref = tgui.FullscreenState(), jgui.FullscreenState()
    for on, busy, is_fs, is_max, file_src in events:
        assert port.request(on, busy, is_fs, is_max) == ref.request(on, busy, is_fs, is_max)
        assert port.reconcile(is_fs, True, file_src, on) == ref.reconcile(is_fs, True, file_src, on)
        assert vars(port) == vars(ref)


@SEEDED
@given(fps=hs.floats(0, 240), lat=hs.floats(0, 500), p95=hs.floats(0, 900),
       depth=hs.integers(0, 16), errs=hs.integers(0, 5), drop=hs.floats(0, 1),
       camera=hs.booleans(), target=hs.floats(1, 240))
def test_stats_line_equals_the_references(fps, lat, p95, depth, errs, drop, camera, target):
    _same("stats_line", fps, lat, p95, depth, errs, drop, camera, target)


@SEEDED
@given(cw=hs.integers(-5, 4000), ch=hs.integers(-5, 3000), fh=hs.integers(1, 4320),
       fw=hs.integers(1, 7680), cur=hs.integers(0, 1000), count=hs.integers(0, 1000))
def test_display_fit_and_timeline_equal_the_references(cw, ch, fh, fw, cur, count):
    _same("display_fit", cw, ch, fh, fw)
    _same("timeline_fraction", cur, count)


def _reference_present_fit(view, cw, ch):
    """The reference's ``MainWindow._poll_display`` before the encode
    (``gui.py:1454-1460`` of the reference package), with its own
    ``display_fit``."""
    fh, fw = view.shape[:2]
    dw, dh, x0, y0 = jgui.display_fit(cw, ch, fh, fw)
    if (dw, dh) != (fw, fh):
        ys = (np.arange(dh) * fh / dh).astype(int)
        xs = (np.arange(dw) * fw / dw).astype(int)
        view = view[ys][:, xs]
    return view, (x0, y0, dw, dh, fw, fh)


@pytest.mark.parametrize("shape,canvas", [((45, 80, 3), (1280, 720)), ((48, 64, 3), (64, 48)),
                                          ((37, 53), (100, 31)), ((9, 7, 3), (1, 1)),
                                          ((108, 384, 3), (1280, 720))])
def test_fit_view_is_the_references_present_resize(shape, canvas):
    view = np.random.default_rng(len(shape) * 100 + shape[0]).integers(0, 256, shape, np.uint8)
    got, geom = tgui.fit_view(view, *canvas)
    ref, ref_geom = _reference_present_fit(view, *canvas)
    assert geom == ref_geom
    np.testing.assert_array_equal(got, ref)
    assert tgui.canvas_to_norm(geom, geom[0], geom[1]) == (0.0, 0.0)


PPM_SHAPES = [(1, 1, 3), (3, 5, 3), (47, 61, 3), (33, 17), (1, 9), (61, 47), (48, 64, 3)]


@pytest.mark.parametrize("shape", PPM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_photo_codec_bytes_equal_the_references(shape):
    """One codec of each package over frames of this shape, then of the next
    shape (a geometry switch), then this one again: the same bytes."""
    rng = np.random.default_rng(sum(shape))
    nxt = PPM_SHAPES[(PPM_SHAPES.index(shape) + 1) % len(PPM_SHAPES)]
    port, ref = tgui.PhotoCodec(), jgui.PhotoCodec()
    for s in (shape, nxt, shape):
        img = rng.integers(0, 256, s, np.uint8)
        assert port.ppm(img) == ref.ppm(img)


@pytest.mark.parametrize("kind", ["flipped", "cropped", "every_other_row"])
def test_photo_codec_takes_strided_views(kind):
    """Strided views (which the reference's cv2 conversion may refuse) encode
    as their contiguous copies do."""
    img = np.random.default_rng(5).integers(0, 256, (31, 43, 3), np.uint8)
    view = {"flipped": img[::-1], "cropped": img[2:-3, 1:-4],
            "every_other_row": img[::2]}[kind]
    assert tgui.PhotoCodec().ppm(view) == jgui.PhotoCodec().ppm(np.ascontiguousarray(view))


def _plain(x):
    """A config's ``dataclasses.asdict`` with enums as their values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x.value if isinstance(x, enum.Enum) else x


@SEEDED
@given(mode=hs.sampled_from(["laplace", "phase", "color"]), amp=hs.integers(0, 200),
       wave=hs.floats(0, 100), low=hs.floats(0.05, 20), high=hs.floats(0.05, 60),
       chroma=hs.integers(0, 100), levels=hs.integers(1, 8), fps=hs.floats(1, 120),
       downscale=hs.sampled_from([1, 2, 4, 8]), use_roi=hs.booleans(), gray=hs.booleans(),
       live_roi=hs.booleans())
def test_build_export_config_equals_the_references(mode, amp, wave, low, high, chroma, levels,
                                                   fps, downscale, use_roi, gray, live_roi):
    ui = dict(amplification=amp, wavelength=wave, low=low, high=high, chroma=chroma,
              levels=levels, capture_fps=fps)
    live = _live_cfg(roi=live_roi)
    jlive = jparams.ProcessorConfig(
        grayscale=live.grayscale,
        preprocess=jparams.PreprocessParams(**dataclasses.asdict(live.preprocess)),
        magnification=jparams.MagnificationParams(**{
            **dataclasses.asdict(live.magnification),
            "mode": jparams.MagnificationMode(live.magnification.mode.value)}))
    got = build_export_config(live, MagUiValues(mode=MagnificationMode(mode), **ui),
                              downscale=downscale, use_roi=use_roi, grayscale=gray)
    ref = jgui.build_export_config(jlive, jparams.MagUiValues(
        mode=jparams.MagnificationMode(mode), **ui), downscale=downscale, use_roi=use_roi,
        grayscale=gray)
    assert _plain(dataclasses.asdict(got)) == _plain(dataclasses.asdict(ref))


@SEEDED
@given(a=hs.integers(0, 0xFFFFFF), b=hs.integers(0, 0xFFFFFF), t=hs.floats(-1, 2),
       env=hs.dictionaries(hs.sampled_from(["LVMT_THEME", "GTK_THEME", "COLORFGBG"]),
                           hs.sampled_from(["", "dark", "light", "Adwaita", "Adwaita-dark",
                                            "0;15", "15;0", "7", "x;y"])))
def test_theme_equals_the_references(a, b, t, env):
    mods = (ttheme, jtheme)
    ca, cb = f"#{a:06X}", f"#{b:06X}"
    _same("mix", ca, cb, t, module=mods)
    _same("resolve_scheme", env, module=mods)
    port, ref = ttheme.ThemeState(env=env), jtheme.ThemeState(env=env)
    for _ in range(3):
        assert (port.scheme, port.following_system) == (ref.scheme, ref.following_system)
        assert port.toggle() == ref.toggle()


@pytest.mark.parametrize("scheme", ["dark", "light"])
def test_theme_tokens_and_styles_equal_the_references(scheme):
    p, r = ttheme.palette(scheme), jtheme.palette(scheme)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert ttheme.style_map(p) == jtheme.style_map(r)
    assert ttheme.widget_defaults(p) == jtheme.widget_defaults(r)
    assert ttheme.toggled(scheme) == jtheme.toggled(scheme)
    assert (ttheme.SPACE1, ttheme.SPACE5, ttheme.RADIUS) == (jtheme.SPACE1, jtheme.SPACE5,
                                                            jtheme.RADIUS)
