"""Desktop GUI front end (tkinter): the reference MainWindow's surface.

Mirrors the reference UI layer (src/ui/) on top of the same controller API the
CLI uses — nothing below this module knows it exists (the reference's "no pixel
data crosses signals/slots" rule maps to: the GUI pulls composed frames from
the display loop, and pushes only intent via PlaybackController setters):

  * toolbar: Open File / Open Camera (picker dialog) / Synthetic, Export,
    Record (camera sources), view-mode combo
  * display canvas with ROI rubber-band drag (normalized rect composed onto the
    active ROI by the controller, PlaybackController.cpp:210-227 semantics)
  * processing panel: mode combo (per-mode defaults on switch,
    MagnificationControls semantics), amplification / wavelength / band (Hz,
    Nyquist-clamped) / chroma / levels sliders, resolution segment, grayscale
  * transport: play / pause / stop, loop, timeline slider with IN/OUT trim
    (TimelineView semantics: out exclusive, seeds the export range)
  * export settings dialog pre-seeded from live state (ExportSettingsDialog
    field list: split/labels/format/file-fps/frame-range/path + validation +
    overwrite confirm) and a progress dialog with close==abort
    (ExportProgressDialog.cpp); playback pauses during export and the main
    window refuses to close mid-export (MainWindow.cpp:332-342, 503-661)
  * record flow: REC into an 8 GB-capped RecordingBuffer with auto-stop at the
    cap, then settings -> Exporter over the captured frames
    (CameraSource.cpp:70-80, MainWindow.cpp:576-585)
  * status strip: processed fps vs target or drop share with ok/warn/bad
    coloring (StatusHealth.hpp thresholds) + latency readout

The counterpart of the reference package's ``gui.py``: the same widgets, flows
and pure functions over the port's ``PlaybackController``, which runs the
chain on the card (``--device cuda``, the default; without a card the GUI
exits with an error before any window opens) or, when asked, on the CPU.
tkinter is imported inside the classes, so the module imports without tk;
``PhotoCodec`` needs no cv2.

Run: python -m live_video_magnification_tpu_torch.gui [--device cpu] [path]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np

from live_video_magnification_tpu_torch.engine.controller import PlaybackController
from live_video_magnification_tpu_torch.engine.display import DisplayLoop, ViewMode
from live_video_magnification_tpu_torch.engine.instrumentation import camera_health, file_health
from live_video_magnification_tpu_torch.export.types import (
    EXTENSION_FOR_FORMAT,
    ExportFormat,
    ExportPhase,
    ExportRequest,
    SplitMode,
    validate_request,
)
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    MagUiValues,
    PreprocessParams,
    ProcessorConfig,
    clamp_band_to_nyquist,
    defaults_for,
    to_params,
    to_ui,
)

_HEALTH_COLORS = {"ok": "#2e7d32", "warn": "#f9a825", "bad": "#c62828"}

_MODES = [
    ("Laplace (motion)", MagnificationMode.LAPLACE),
    ("Phase (Riesz)", MagnificationMode.PHASE),
    ("Color", MagnificationMode.COLOR),
]

_FORMATS = [
    ("MP4 (H.264)", ExportFormat.MP4_H264),
    ("AVI (MJPG)", ExportFormat.AVI_MJPG),
    ("MKV (FFV1, lossless)", ExportFormat.MKV_FFV1),
]

_SPLITS = [
    ("Processed only", SplitMode.NONE),
    ("Side by side", SplitMode.LEFT_RIGHT),
    ("Top / bottom", SplitMode.TOP_BOTTOM),
]


def slider_frac(v: float, mn: float, mx: float, log: bool) -> float:
    """Value -> [0,1] track fraction; log pixel mapping when log and mn>0
    (reference RangeSlider.cpp:37-50: value/step stay linear). Pure."""
    import math as _math

    v = min(max(v, mn), mx)
    if log and mn > 0.0 and mx > mn:
        return _math.log(v / mn) / _math.log(mx / mn)
    return 0.0 if mx <= mn else (v - mn) / (mx - mn)


def slider_value(frac: float, mn: float, mx: float, log: bool) -> float:
    """[0,1] track fraction -> value (inverse of slider_frac). Pure."""
    frac = min(max(frac, 0.0), 1.0)
    if log and mn > 0.0 and mx > mn:
        return mn * (mx / mn) ** frac
    return mn + frac * (mx - mn)


def slider_snap(v: float, step: float) -> float:
    """Snap to the step grid (reference RangeSlider.cpp:54-57). Pure."""
    s = step if step > 0.0 else 1.0
    return round(v / s) * s


def slider_enforce_gap(low: float, high: float, step: float, mn: float,
                       mx: float, moved: str):
    """Keep low < high by at least one step; the handle that did NOT move
    yields (push high up, else pull low down — RangeSlider.cpp:59-68). Pure."""
    s = step if step > 0.0 else 1.0
    low = min(max(low, mn), mx)
    high = min(max(high, mn), mx)
    if high - low >= s:
        return low, high
    if moved == "low":
        high = min(low + s, mx)
        if high - low < s:
            low = max(high - s, mn)
    else:
        low = max(high - s, mn)
        if high - low < s:
            high = min(low + s, mx)
    return low, high


def slider_move_active(v: float, active: str, low: float, high: float,
                       step: float, mn: float, mx: float):
    """Drag semantics (reference RangeSlider.cpp:106-121 moveActiveTo): the
    ACTIVE handle clamps at other -/+ step; the inactive handle never moves.
    Returns the new (low, high). Pure."""
    s = step if step > 0.0 else 1.0
    if active == "low":
        return min(max(v, mn), high - s), high
    return low, max(min(v, mx), low + s)


class RangeSlider:
    """Two-handle band slider on a tk Canvas — the reference's RangeSlider
    (RangeSlider.cpp: dual handles that cannot cross, step snap, optional log
    pixel axis). `command(low, high)` fires only on user changes;
    `set_values` is silent."""

    H = 22
    R = 6  # handle radius

    def __init__(self, parent, mn: float, mx: float, *, step: float = 0.05,
                 log: bool = True, width: int = 160, command=None):
        import tkinter as tk

        self.mn, self.mx, self.step, self.log = mn, mx, step, log
        self.low, self.high = mn, mx
        self.command = command
        self.canvas = tk.Canvas(parent, width=width, height=self.H,
                                highlightthickness=0)
        self.canvas.bind("<ButtonPress-1>", self._press)
        self.canvas.bind("<B1-Motion>", self._drag)
        self.canvas.bind("<Configure>", lambda e: self._redraw())
        self._active = "high"
        self._redraw()

    # tk geometry-manager passthroughs so the widget drops into grid layouts
    def grid(self, **kw):
        self.canvas.grid(**kw)

    def grid_remove(self):
        self.canvas.grid_remove()

    def set_range(self, mn: float, mx: float):
        self.mn, self.mx = mn, mx
        self.set_values(self.low, self.high)

    def set_values(self, low: float, high: float):
        """Silent programmatic update (clamped, snapped, gap-enforced)."""
        low = slider_snap(min(max(low, self.mn), self.mx), self.step)
        high = slider_snap(min(max(high, self.mn), self.mx), self.step)
        if high < low:
            low, high = high, low
        self.low, self.high = slider_enforce_gap(low, high, self.step,
                                                 self.mn, self.mx, "low")
        self._redraw()

    # -- internals ------------------------------------------------------------
    def _track(self):
        w = max(int(self.canvas.winfo_width()), 2 * self.R + 2)
        return self.R + 1, w - self.R - 1

    def _to_x(self, v):
        x0, x1 = self._track()
        return x0 + slider_frac(v, self.mn, self.mx, self.log) * (x1 - x0)

    def _to_v(self, x):
        x0, x1 = self._track()
        frac = (x - x0) / max(1, (x1 - x0))
        return slider_value(frac, self.mn, self.mx, self.log)

    def _press(self, e):
        dl = abs(e.x - self._to_x(self.low))
        dh = abs(e.x - self._to_x(self.high))
        self._active = "low" if dl < dh else "high"
        self._drag(e)

    def _drag(self, e):
        # moveActiveTo (RangeSlider.cpp:106-121): the ACTIVE handle clamps at
        # other -/+ step; the inactive handle never moves during a drag.
        # slider_enforce_gap only governs the programmatic set_values/set_range
        # paths (RangeSlider.cpp:59-68 enforceGap) — ADVICE round-3.
        v = slider_snap(self._to_v(e.x), self.step)
        low, high = slider_move_active(v, self._active, self.low, self.high,
                                       self.step, self.mn, self.mx)
        if (low, high) != (self.low, self.high):
            self.low, self.high = low, high
            self._redraw()
            if self.command is not None:
                self.command(low, high)

    def _redraw(self):
        c = self.canvas
        c.delete("all")
        x0, x1 = self._track()
        y = self.H // 2
        c.create_line(x0, y, x1, y, fill="#667", width=3)
        xl, xh = self._to_x(self.low), self._to_x(self.high)
        c.create_line(xl, y, xh, y, fill="#4fc3f7", width=3)
        for x in (xl, xh):
            c.create_oval(x - self.R, y - self.R, x + self.R, y + self.R,
                          fill="#e8e8e8", outline="#345")


def canvas_to_norm(img_geom, x, y):
    """Canvas pixel -> normalized coords within the letterboxed frame, clamped
    to [0,1] (DisplayWidget.cpp:326-375 pane-confined drag). img_geom is
    (x0, y0, draw_w, draw_h, frame_w, frame_h); None before the first frame.
    Pure (headless-testable)."""
    if img_geom is None:
        return None
    x0, y0, dw, dh, _fw, _fh = img_geom
    return (min(max((x - x0) / dw, 0.0), 1.0), min(max((y - y0) / dh, 0.0), 1.0))


def drag_to_roi(p0, p1, min_size: float = 0.01):
    """Two normalized drag endpoints -> (x, y, w, h) rect, or None when the
    drag is degenerate (sub-1% in either dimension). Pure."""
    if p0 is None or p1 is None:
        return None
    x = min(p0[0], p1[0])
    y = min(p0[1], p1[1])
    w = abs(p1[0] - p0[0])
    h = abs(p1[1] - p0[1])
    if w <= min_size or h <= min_size:
        return None
    return (x, y, w, h)


def trim_set_in(out_frame, current):
    """IN-trim state transition: IN moves unconditionally to the playhead
    (the previous IN does not participate); an OUT at or before the new IN is
    discarded (TimelineView out-exclusive semantics). Pure."""
    new_out = out_frame if (out_frame is None or out_frame > current) else None
    return current, new_out


def trim_set_out(in_frame, out_frame, current):
    """OUT-trim transition: OUT (exclusive) only moves if strictly after IN."""
    if current > in_frame:
        return in_frame, current
    return in_frame, out_frame


def range_label_text(in_frame, out_frame) -> str:
    """Transport-bar trim readout; empty when the full clip is selected."""
    if in_frame == 0 and out_frame is None:
        return ""
    out = out_frame if out_frame is not None else "end"
    return f"[{in_frame}..{out})"


def build_export_config(live_cfg: ProcessorConfig, ui: MagUiValues, *,
                        downscale: int, use_roi: bool,
                        grayscale: bool) -> ProcessorConfig:
    """Compose the export's OWN ProcessorConfig from the dialog's edited values
    (reference ExportSettingsDialog.cpp:60-200: an export may use different
    resolution / ROI / grayscale / magnification params than the live preview).
    The ROI rect itself always comes from the live state — the dialog only
    chooses whether to apply it. Pure (headless-testable)."""
    pre = live_cfg.preprocess
    if use_roi and pre.roi_enabled:
        new_pre = dataclasses.replace(pre, downscale=downscale)
    else:
        new_pre = PreprocessParams(downscale=downscale)
    mag = to_params(clamp_band_to_nyquist(ui))
    return ProcessorConfig(grayscale=grayscale, preprocess=new_pre,
                           magnification=mag)


# --- pure orchestration (headless-testable state machines, VERDICT r3 item 6) --
#
# The tk callbacks below delegate to these functions; every branch of the
# export/record/close flows and the status/display math is decided here on
# plain values, so tests/test_gui_logic.py can drive the state machines
# end-to-end without a display (reference MainWindow.cpp:503-661 semantics).


def export_start_guard(export_active: bool, has_file: bool) -> str:
    """'busy' | 'no_file' | 'proceed' (MainWindow.cpp:503-519)."""
    if export_active:
        return "busy"
    if not has_file:
        return "no_file"
    return "proceed"


def export_poll_transition(phase, frames_done: int, frames_total,
                           error) -> tuple:
    """One tick of the export progress poll (MainWindow.cpp:595-661).

    Returns (action, text): action 'continue' keeps polling with a progress
    update; 'finish' closes out the exporter (join, drop, resume-if-paused)
    with `text` shown in the finished dialog."""
    if phase is ExportPhase.PROCESSING:
        return "continue", None
    text = {ExportPhase.DONE: f"Done — {frames_done} frames written",
            ExportPhase.ABORTED: "Aborted — partial file deleted",
            ExportPhase.FAILED: f"Failed: {error}"}.get(phase, str(phase))
    return "finish", text


def record_start_guard(recording: bool, export_active: bool) -> str:
    """'stop' (toggle off) | 'busy' | 'begin' (MainWindow.cpp:568-585)."""
    if recording:
        return "stop"
    if export_active:
        return "busy"
    return "begin"


def record_poll_transition(limit_reached: bool) -> str:
    """'autostop' at the RAM cap (MainWindow.cpp:49-51), else 'continue'."""
    return "autostop" if limit_reached else "continue"


def record_stop_decision(frame_count: int) -> str:
    """'nothing' recorded vs 'open_settings' for the buffer export."""
    return "open_settings" if frame_count else "nothing"


def close_decision(export_active: bool, recording: bool,
                   confirmed: bool) -> str:
    """Close-protection (MainWindow.cpp:332-342): 'close' when idle;
    'ask' when busy and not yet confirmed; 'abort_and_close' when the user
    confirmed aborting the running export/recording."""
    if not (export_active or recording):
        return "close"
    return "abort_and_close" if confirmed else "ask"


def view_magnify_active(mode: ViewMode) -> bool:
    """'Original' doubles as magnification-off (MainWindow.cpp:199-204)."""
    return mode is not ViewMode.ORIGINAL


class FullscreenState:
    """Request-then-reconcile fullscreen (MainWindow.cpp:346-389).

    `request` only decides what to ASK the window manager for; the WM is
    authoritative (a Wayland/tiling-WM fullscreen request can be refused), so
    chrome changes happen exclusively in `reconcile`, fed the ACTUAL state
    after the request settles — and reconcile is idempotent because a state
    change can fire more than once per toggle (fullscreen_ guard,
    MainWindow.cpp:359-361). Pure (headless-testable)."""

    def __init__(self):
        self.applied = False        # last chrome state applied
        self.was_maximized = False  # restore this on leaving fullscreen

    def request(self, on: bool, export_active: bool, is_fullscreen: bool,
                is_maximized: bool) -> str:
        """'enter' | 'leave_max' | 'leave_normal' | 'noop'
        (MainWindow.cpp:346-357: an export owns the UI lock; entering
        remembers maximized so leaving restores it)."""
        if on:
            if export_active or is_fullscreen:
                return "noop"
            self.was_maximized = is_maximized
            return "enter"
        if not is_fullscreen:
            return "noop"
        return "leave_max" if self.was_maximized else "leave_normal"

    def reconcile(self, actual_fullscreen: bool, source_open: bool,
                  source_is_file: bool, settings_on: bool):
        """WindowStateChange -> chrome visibility decisions, or None when
        the state didn't actually change (MainWindow.cpp:359-380).

        Keeps the transport for a file source so it stays scrubbable; hides
        everything else. Entering disarms ROI drawing (the panel hosting the
        toggle is hidden; the active ROI region stays) and moves key focus to
        the display. The settings panel re-shows only if its toggle is still
        on (the reference's explicitly-hidden-child rule applied to the
        inspector)."""
        if self.applied == actual_fullscreen:
            return None
        self.applied = actual_fullscreen
        on = actual_fullscreen
        keep_transport = source_open and source_is_file
        return {
            "toolbar": not on,
            "panel": (not on) and settings_on,
            "status": not on,
            "transport": (not on) or keep_transport,
            "disarm_roi": on,
            "focus_display": on,
        }


def fullscreen_key(key: str, is_fullscreen: bool, export_active: bool) -> str:
    """F11/Escape handling (MainWindow.cpp:407-421): F11 toggles, Escape
    only acts while fullscreen (and otherwise propagates normally to
    dialogs/spinboxes), both inert during an export. Returns
    'toggle' | 'exit' | 'pass'. Pure."""
    if export_active:
        return "pass"
    if key == "F11":
        return "toggle"
    if key == "Escape" and is_fullscreen:
        return "exit"
    return "pass"


def stats_line(process_fps: float, latency_ms_mean: float,
               latency_ms_p95: float, queue_depth: int, proc_errors: int,
               drop_fraction: float, is_camera: bool, target_fps: float):
    """(text, health) for the status strip (StatusStrip.cpp:122-158,
    StatusHealth.hpp thresholds; hint text on non-ok)."""
    if is_camera:
        health = camera_health(drop_fraction)
        text = (f"{process_fps:5.1f} fps   drops {drop_fraction*100:4.1f}%   "
                f"latency {latency_ms_mean:5.1f} ms (p95 {latency_ms_p95:.0f})")
    else:
        health = file_health(process_fps, target_fps)
        text = (f"{process_fps:5.1f} / {target_fps:.0f} fps   q={queue_depth}   "
                f"latency {latency_ms_mean:5.1f} ms (p95 {latency_ms_p95:.0f})   "
                f"errors {proc_errors}")
    if health != "ok":
        text += "   — falling behind: shrink the ROI or increase downscale"
    return text, health


def display_fit(cw: int, ch: int, fh: int, fw: int):
    """Letterbox a fh x fw frame into a cw x ch canvas: returns
    (dw, dh, x0, y0) — the reference DisplayWidget's per-pane letterbox math
    (DisplayWidget.cpp:187-211). Pure."""
    cw, ch = max(1, cw), max(1, ch)
    scale = min(cw / fw, ch / fh)
    dw, dh = max(1, int(fw * scale)), max(1, int(fh * scale))
    return dw, dh, (cw - dw) // 2, (ch - dh) // 2


def fit_view(view: np.ndarray, cw: int, ch: int):
    """The canvas present's host work before the encode: the composed view
    letterboxed into a cw x ch canvas (``display_fit``) by a nearest-neighbour
    index resize. Returns (the fitted view, the image geometry
    (x0, y0, draw_w, draw_h, frame_w, frame_h) that ``canvas_to_norm``
    reads)."""
    fh, fw = view.shape[:2]
    dw, dh, x0, y0 = display_fit(cw, ch, fh, fw)
    if (dw, dh) != (fw, fh):
        ys = (np.arange(dh) * fh / dh).astype(int)
        xs = (np.arange(dw) * fw / dw).astype(int)
        view = view[ys][:, xs]
    return view, (x0, y0, dw, dh, fw, fh)


def timeline_fraction(current_frame: int, frame_count: int) -> float:
    return current_frame / max(1, frame_count - 1)


class PhotoCodec:
    """Reusable PPM-encode buffer for the tk PhotoImage present path.

    The naive encode (fancy-index BGR->RGB + ascontiguousarray + tobytes +
    header concat) moves ~3 payload copies per frame. Here the header is
    written once per geometry and the RGB payload is written IN PLACE by one
    numpy channel-swapping copy (gray broadcast to three channels) into a
    persistent buffer, byte for byte what cv2.cvtColor's BGR2RGB / GRAY2RGB
    write; the only remaining copy is the bytes() handoff tk requires. The
    reference's analogue is the upload-only-on-new-seq GL texture path
    (DisplayWidget.cpp:133-158)."""

    def __init__(self):
        self._buf: Optional[bytearray] = None
        self._key = None
        self._payload = None

    def ppm(self, img: np.ndarray) -> bytes:
        h, w = img.shape[:2]
        header = f"P6 {w} {h} 255 ".encode()
        key = (h, w, len(header))
        if self._key != key:
            self._buf = bytearray(len(header) + h * w * 3)
            self._buf[: len(header)] = header
            self._payload = np.frombuffer(
                memoryview(self._buf)[len(header):], dtype=np.uint8
            ).reshape(h, w, 3)
            self._key = key
        np.copyto(self._payload, img[..., None] if img.ndim == 2 else img[..., ::-1])
        return bytes(self._buf)


def _frame_to_photo(tk, img: np.ndarray, codec: Optional[PhotoCodec] = None):
    """BGR/gray u8 -> tk.PhotoImage via PPM bytes (no extra deps)."""
    data = (codec or PhotoCodec()).ppm(img)
    return tk.PhotoImage(data=data, format="PPM")


class CameraSelectDialog:
    """Modal device picker (reference CameraSelectDialog.cpp): lists
    enumerate_cameras(), returns the cv index or None."""

    def __init__(self, root, cameras):
        import tkinter as tk
        from tkinter import ttk

        self.result: Optional[int] = None
        self.top = tk.Toplevel(root)
        self.top.title("Select camera")
        self.top.transient(root)
        self.top.grab_set()
        ttk.Label(self.top, text="Capture devices:").pack(anchor="w", padx=8, pady=4)
        self._list = tk.Listbox(self.top, height=min(8, max(3, len(cameras))))
        for idx, name in cameras:
            self._list.insert("end", f"{idx}: {name}")
        self._list.pack(fill="both", expand=True, padx=8)
        if cameras:
            self._list.selection_set(0)
        self._cams = cameras
        row = ttk.Frame(self.top)
        row.pack(fill="x", pady=6)
        ttk.Button(row, text="Open", command=self._ok).pack(side="right", padx=8)
        ttk.Button(row, text="Cancel", command=self.top.destroy).pack(side="right")
        self._list.bind("<Double-Button-1>", lambda e: self._ok())
        root.wait_window(self.top)

    def _ok(self):
        sel = self._list.curselection()
        if sel:
            self.result = self._cams[sel[0]][0]
        self.top.destroy()


class ExportSettingsDialog:
    """Modal export configuration (reference ExportSettingsDialog.cpp):
    pre-seeded split/labels/format/file-fps/frame-range/path with range and
    overwrite validation, PLUS the reference's editable processing section —
    resolution segment, use-ROI, grayscale, and the full magnification
    parameter set pre-seeded from (not locked to) the live panel state
    (ExportSettingsDialog.cpp:60-200), so an export can use different settings
    than the preview. Returns an ExportRequest (with its own config) or None."""

    def __init__(self, root, cfg, *, frame_count: int = 0, in_frame: int = 0,
                 out_frame: Optional[int] = None, default_fps: float = 30.0,
                 allow_range: bool = True):
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk

        self.result: Optional[ExportRequest] = None
        self._cfg = cfg
        self._messagebox = messagebox
        self.top = tk.Toplevel(root)
        self.top.title("Export settings")
        self.top.transient(root)
        self.top.grab_set()
        body = ttk.Frame(self.top, padding=10)
        body.pack(fill="both", expand=True)
        row = 0

        ttk.Label(body, text="Output file").grid(row=row, column=0, sticky="w")
        self.path_var = tk.StringVar(value="")
        ttk.Entry(body, textvariable=self.path_var, width=36).grid(row=row, column=1)
        ttk.Button(body, text="…", width=2, command=lambda: self.path_var.set(
            filedialog.asksaveasfilename(defaultextension=".mp4") or self.path_var.get()
        )).grid(row=row, column=2)
        row += 1

        ttk.Label(body, text="Format").grid(row=row, column=0, sticky="w")
        self.fmt_var = tk.StringVar(value=_FORMATS[0][0])
        ttk.Combobox(body, textvariable=self.fmt_var, state="readonly",
                     values=[n for n, _ in _FORMATS]).grid(row=row, column=1, sticky="ew")
        row += 1

        ttk.Label(body, text="Layout").grid(row=row, column=0, sticky="w")
        self.split_var = tk.StringVar(value=_SPLITS[1][0])
        ttk.Combobox(body, textvariable=self.split_var, state="readonly",
                     values=[n for n, _ in _SPLITS]).grid(row=row, column=1, sticky="ew")
        row += 1

        self.labels_var = tk.BooleanVar(value=True)
        ttk.Checkbutton(body, text="Burn in pane labels", variable=self.labels_var
                        ).grid(row=row, column=0, columnspan=2, sticky="w")
        row += 1

        ttk.Label(body, text="File fps").grid(row=row, column=0, sticky="w")
        self.fps_var = tk.DoubleVar(value=float(default_fps))
        ttk.Entry(body, textvariable=self.fps_var, width=8).grid(row=row, column=1, sticky="w")
        row += 1

        self._allow_range = allow_range and frame_count > 0
        self.start_var = tk.IntVar(value=int(in_frame))
        self.end_var = tk.IntVar(value=int(out_frame if out_frame else frame_count))
        if self._allow_range:
            ttk.Label(body, text=f"Frame range (of {frame_count})").grid(
                row=row, column=0, sticky="w")
            rng = ttk.Frame(body)
            rng.grid(row=row, column=1, sticky="w")
            ttk.Entry(rng, textvariable=self.start_var, width=7).pack(side="left")
            ttk.Label(rng, text="to").pack(side="left", padx=4)
            ttk.Entry(rng, textvariable=self.end_var, width=7).pack(side="left")
            row += 1
        self._frame_count = frame_count

        # --- editable processing section (pre-seeded from live state) ------------------------
        proc = ttk.LabelFrame(body, text="Processing (pre-seeded from live preview)")
        proc.grid(row=row, column=0, columnspan=3, sticky="ew", pady=(8, 0))
        row += 1
        ui = to_ui(cfg.magnification)
        prow = 0

        ttk.Label(proc, text="Mode").grid(row=prow, column=0, sticky="w")
        self.mode_var = tk.StringVar(
            value=next((n for n, m in _MODES if m is ui.mode), _MODES[0][0]))
        mode_box = ttk.Combobox(proc, textvariable=self.mode_var, state="readonly",
                                values=[n for n, _ in _MODES], width=16)
        mode_box.grid(row=prow, column=1, sticky="w")
        mode_box.bind("<<ComboboxSelected>>", lambda e: self._seed_mode_defaults())
        prow += 1

        def num_entry(label_text, value, width=8):
            nonlocal prow
            ttk.Label(proc, text=label_text).grid(row=prow, column=0, sticky="w")
            var = tk.DoubleVar(value=value)
            ttk.Entry(proc, textvariable=var, width=width).grid(
                row=prow, column=1, sticky="w")
            prow += 1
            return var

        self.amp_var = num_entry("Amplification", float(ui.amplification))
        self.wave_var = num_entry("Wavelength %", float(ui.wavelength))
        self.low_var = num_entry("Band low (Hz)", float(ui.low))
        self.high_var = num_entry("Band high (Hz)", float(ui.high))
        self.chroma_var = num_entry("Chroma %", float(ui.chroma))
        self.levels_var = num_entry("Levels", float(ui.levels))
        self.capture_fps_var = num_entry("Capture FPS", float(ui.capture_fps))

        ttk.Label(proc, text="Resolution").grid(row=prow, column=0, sticky="w")
        self.res_var = tk.StringVar(value=f"1/{cfg.preprocess.downscale}")
        ttk.Combobox(proc, textvariable=self.res_var, state="readonly",
                     values=["1/1", "1/2", "1/4", "1/8"], width=6).grid(
            row=prow, column=1, sticky="w")
        prow += 1

        self.use_roi_var = tk.BooleanVar(value=bool(cfg.preprocess.roi_enabled))
        roi_chk = ttk.Checkbutton(proc, text="Use live ROI crop",
                                  variable=self.use_roi_var)
        roi_chk.grid(row=prow, column=0, columnspan=2, sticky="w")
        if not cfg.preprocess.roi_enabled:
            roi_chk.configure(state="disabled")  # no live ROI to apply
        prow += 1

        self.export_gray_var = tk.BooleanVar(value=bool(cfg.grayscale))
        ttk.Checkbutton(proc, text="Grayscale", variable=self.export_gray_var
                        ).grid(row=prow, column=0, columnspan=2, sticky="w")

        btns = ttk.Frame(body)
        btns.grid(row=row, column=0, columnspan=3, sticky="e", pady=(8, 0))
        ttk.Button(btns, text="Export", command=self._ok).pack(side="right", padx=4)
        ttk.Button(btns, text="Cancel", command=self.top.destroy).pack(side="right")
        root.wait_window(self.top)

    def _seed_mode_defaults(self):
        """Switching mode seeds that mode's defaults, like the live panel
        (MagnificationControls mode-switch semantics)."""
        mode = dict(_MODES)[self.mode_var.get()]
        d = defaults_for(mode)
        self.amp_var.set(float(d.amplification))
        self.wave_var.set(float(d.wavelength))
        self.low_var.set(float(d.low))
        self.high_var.set(float(d.high))
        self.chroma_var.set(float(d.chroma))
        self.levels_var.set(float(d.levels))

    def _ok(self):
        fmt = dict(_FORMATS)[self.fmt_var.get()]
        split = dict(_SPLITS)[self.split_var.get()]
        path = self.path_var.get().strip()
        if path and not os.path.splitext(path)[1]:
            path += EXTENSION_FOR_FORMAT[fmt]
        try:
            # tk vars raise TclError on non-numeric entry text; surface it via
            # the same error dialog as validate_request problems.
            file_fps = float(self.fps_var.get())
            start = int(self.start_var.get()) if self._allow_range else 0
            end = int(self.end_var.get()) if self._allow_range else None
            ui = MagUiValues(
                mode=dict(_MODES)[self.mode_var.get()],
                amplification=int(float(self.amp_var.get())),
                wavelength=float(self.wave_var.get()),
                low=float(self.low_var.get()),
                high=float(self.high_var.get()),
                chroma=int(float(self.chroma_var.get())),
                levels=max(1, int(float(self.levels_var.get()))),
                capture_fps=float(self.capture_fps_var.get()),
            )
            downscale = int(self.res_var.get().split("/")[1])
        except Exception:
            self._messagebox.showerror(
                "Export", "fps, frame range and parameters must be numbers",
                parent=self.top)
            return
        config = build_export_config(
            self._cfg, ui, downscale=downscale,
            use_roi=bool(self.use_roi_var.get()),
            grayscale=bool(self.export_gray_var.get()),
        )
        req = ExportRequest(
            config=config, output_path=path, file_fps=file_fps,
            split=split, text_overlay=bool(self.labels_var.get()), format=fmt,
            start_frame=start, end_frame=end,
        )
        problems = validate_request(req, self._frame_count or None)
        if problems:
            self._messagebox.showerror("Export", "\n".join(problems), parent=self.top)
            return
        if os.path.exists(req.output_path):
            if not self._messagebox.askyesno(
                "Export", f"{req.output_path} exists — overwrite?", parent=self.top
            ):
                return
        self.result = req
        self.top.destroy()


class ExportProgressDialog:
    """Two-phase modal progress (reference ExportProgressDialog.cpp): a
    Recording phase (blinking REC + elapsed/frames/bytes) and a Processing
    phase (progress bar); closing the window aborts unless finished."""

    POLL_MS = 100

    def __init__(self, root, *, on_abort):
        import tkinter as tk
        from tkinter import ttk

        self._tk = tk
        self._on_abort = on_abort
        self._finished = False
        self.top = tk.Toplevel(root)
        self.top.title("Export")
        self.top.transient(root)
        self.top.protocol("WM_DELETE_WINDOW", self._close_requested)
        self.label = ttk.Label(self.top, text="", width=46)
        self.label.pack(padx=12, pady=(10, 4))
        self.bar = ttk.Progressbar(self.top, length=320, mode="determinate")
        self.bar.pack(padx=12, pady=4)
        self.btn = ttk.Button(self.top, text="Abort", command=self._close_requested)
        self.btn.pack(pady=(4, 10))
        self._rec_t0 = time.monotonic()
        self._blink = False

    def show_recording(self, frames: int, bytes_: int):
        self._blink = not self._blink
        rec = "● REC" if self._blink else "  REC"
        dt = time.monotonic() - self._rec_t0
        self.label.configure(
            text=f"{rec}  {dt:5.1f}s   {frames} frames   {bytes_ / 1e6:.1f} MB")
        self.bar.configure(mode="indeterminate")
        self.btn.configure(text="Stop recording")

    def show_processing(self, done: int, total: Optional[int]):
        if total:
            self.bar.configure(mode="determinate", maximum=total, value=done)
            self.label.configure(text=f"Processing {done}/{total} frames")
        else:
            self.bar.configure(mode="indeterminate")
            self.label.configure(text=f"Processing frame {done}")
        self.btn.configure(text="Abort")

    def mark_finished(self, text: str):
        self._finished = True
        self.label.configure(text=text)
        self.btn.configure(text="Close")

    def _close_requested(self):
        if not self._finished:
            self._on_abort()
        self.close()

    def close(self):
        if self.top.winfo_exists():
            self.top.destroy()


class MainWindow:
    def __init__(self, device=None):
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.messagebox = messagebox
        # the chain's device: CUDA unless asked for the CPU; raises without
        # a card before any window or thread exists
        self.controller = PlaybackController(device=device)
        self.display = DisplayLoop(self.controller.mailbox, self.controller._instr)

        self.root = tk.Tk()
        self.root.title("Live Video Magnification (CUDA)")
        self.root.geometry("1280x760")
        self.root.protocol("WM_DELETE_WINDOW", self.on_close)

        # design tokens: follow the OS appearance until the user pins a
        # scheme via the toolbar toggle (reference Theme.hpp:64-68)
        from live_video_magnification_tpu_torch import theme as _theme

        self._theme = _theme
        self._theme_state = _theme.ThemeState()
        self.palette = _theme.apply(self.root, self._theme_state.scheme)

        # --- toolbar -------------------------------------------------------------------------
        bar = ttk.Frame(self.root)
        bar.pack(side="top", fill="x")
        self.toolbar = bar
        ttk.Button(bar, text="Open File", command=self.on_open_file).pack(side="left")
        ttk.Button(bar, text="Open Camera", command=self.on_open_camera).pack(side="left")
        ttk.Button(bar, text="Synthetic", command=self.on_open_synthetic).pack(side="left")
        ttk.Button(bar, text="Export…", command=self.on_export).pack(side="left")
        self.record_btn = ttk.Button(bar, text="Record", command=self.on_record)
        self.record_btn.pack(side="left")
        ttk.Button(bar, text="Theme", command=self.on_theme_toggle).pack(side="right")
        # Settings: checkable inspector show/hide (MainWindow.cpp:97-100,205-207)
        self.settings_var = tk.BooleanVar(value=True)
        ttk.Checkbutton(bar, text="Settings", variable=self.settings_var,
                        command=self.on_settings_toggle,
                        style="Toolbutton").pack(side="right")
        ttk.Button(bar, text="Fullscreen",
                   command=lambda: self.set_fullscreen(
                       not self._is_fullscreen())).pack(side="right")
        self.view_var = tk.StringVar(value="processed")
        view = ttk.Combobox(bar, textvariable=self.view_var, state="readonly", width=14,
                            values=[m.value for m in ViewMode])
        view.pack(side="right")
        view.bind("<<ComboboxSelected>>", lambda e: self._set_view())

        # --- center: canvas + panel ----------------------------------------------------------
        center = ttk.Frame(self.root)
        center.pack(fill="both", expand=True)
        self.canvas = tk.Canvas(center, bg=self.palette.bg, highlightthickness=0)
        self.canvas.pack(side="left", fill="both", expand=True)
        self.canvas.bind("<ButtonPress-1>", self.on_roi_press)
        self.canvas.bind("<B1-Motion>", self.on_roi_drag)
        self.canvas.bind("<ButtonRelease-1>", self.on_roi_release)

        panel = ttk.Frame(center, padding=8)
        panel.pack(side="right", fill="y")
        self.center = center
        self.panel = panel
        self._build_panel(panel)

        # --- transport -----------------------------------------------------------------------
        transport = ttk.Frame(self.root, padding=4)
        transport.pack(side="top", fill="x")
        self.transport = transport
        ttk.Button(transport, text="▶", width=3, command=self.controller.play).pack(side="left")
        ttk.Button(transport, text="⏸", width=3, command=self.controller.pause).pack(side="left")
        ttk.Button(transport, text="⏹", width=3, command=self.controller.stop).pack(side="left")
        self.loop_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(transport, text="Loop", variable=self.loop_var,
                        command=lambda: self.controller.set_loop(self.loop_var.get())
                        ).pack(side="left")
        self.timeline = ttk.Scale(transport, from_=0, to=1, command=self.on_seek)
        self.timeline.pack(side="left", fill="x", expand=True, padx=8)
        self._scrubbing = False
        self.timeline.bind("<ButtonPress-1>", self._scrub_start)
        self.timeline.bind("<ButtonRelease-1>", self._scrub_end)
        # IN/OUT trim (reference TimelineView drag handles; out exclusive)
        ttk.Button(transport, text="[ In", width=4, command=self.on_set_in).pack(side="left")
        ttk.Button(transport, text="Out ]", width=5, command=self.on_set_out).pack(side="left")
        ttk.Button(transport, text="✕", width=2, command=self.on_clear_in_out).pack(side="left")
        self.range_label = ttk.Label(transport, text="")
        self.range_label.pack(side="left", padx=4)
        # Playback-FPS spinbox for file sources (reference StatusStrip.cpp:122-158);
        # disabled for cameras, which free-run at their reported rate.
        ttk.Label(transport, text="Playback fps").pack(side="left", padx=(8, 2))
        self.playback_fps_var = tk.DoubleVar(value=30.0)
        self.playback_fps_spin = ttk.Spinbox(
            transport, from_=1, to=240, increment=1, width=6,
            textvariable=self.playback_fps_var, command=self.on_playback_fps)
        self.playback_fps_spin.pack(side="left")
        self.playback_fps_spin.bind("<Return>", lambda e: self.on_playback_fps())
        self.playback_fps_spin.configure(state="disabled")

        # --- status strip --------------------------------------------------------------------
        self.status = tk.Label(self.root, anchor="w", fg="white", bg="#202428")
        self.status.pack(side="bottom", fill="x")

        self._photo = None
        self._photo_codec = PhotoCodec()  # reusable PPM buffer (present path)
        self._img_geom = None  # (x0, y0, draw_w, draw_h, frame_w, frame_h)
        self._roi_start = None
        self._roi_rect_id = None
        self._file_path: Optional[str] = None
        self._in_frame = 0
        self._out_frame: Optional[int] = None
        self._exporter = None
        self._export_dialog: Optional[ExportProgressDialog] = None
        self._resume_after_export = False
        self._recording_buf = None
        self._was_scrub_playing = False

        # fullscreen: request-then-reconcile against the WM + F11/Esc
        # (MainWindow.cpp:346-389,407-421); Escape handled here, not as an
        # always-on shortcut, so it propagates normally when not fullscreen
        self._fs = FullscreenState()
        self.root.bind("<F11>", lambda e: self._on_fullscreen_key("F11"))
        self.root.bind("<Escape>", lambda e: self._on_fullscreen_key("Escape"))

        self.root.after(8, self._poll_display)       # ~120 Hz present timer
        self.root.after(250, self._poll_stats)       # 4 Hz stats
        self.root.after(60, self._poll_timeline)     # timeline refresh

    # --- processing panel ----------------------------------------------------------------------

    def _build_panel(self, panel):
        tk, ttk = self.tk, __import__("tkinter.ttk", fromlist=["ttk"])
        row = 0

        def label(text):
            nonlocal row
            ttk.Label(panel, text=text).grid(row=row, column=0, sticky="w")

        self.mode_var = tk.StringVar(value=_MODES[0][0])
        label("Mode")
        mode_box = ttk.Combobox(panel, textvariable=self.mode_var, state="readonly",
                                values=[n for n, _ in _MODES], width=18)
        mode_box.grid(row=row, column=1)
        mode_box.bind("<<ComboboxSelected>>", lambda e: self.on_mode_change())
        row += 1

        # Each parameter row keeps its widgets so per-mode visibility can hide
        # whole rows (MagnificationControls row-visibility semantics) and a
        # readout label shows the live value (+BPM for the Hz band, the
        # reference's dual-handle band readout).
        self._rows = {}

        def slider(key, text, frm, to, init, fmt=lambda v: f"{v:.0f}"):
            nonlocal row
            lbl = ttk.Label(panel, text=text)
            lbl.grid(row=row, column=0, sticky="w")
            var = tk.DoubleVar(value=init)
            readout = ttk.Label(panel, text=fmt(init), width=14)

            def on_move(_e, v=None):
                readout.configure(text=fmt(var.get()))
                self.push_params()

            s = ttk.Scale(panel, from_=frm, to=to, variable=var, command=on_move)
            s.grid(row=row, column=1, sticky="ew")
            readout.grid(row=row, column=2, sticky="w")
            self._rows[key] = (lbl, s, readout, fmt, var)
            row += 1
            return var

        self.amp_var = slider("amp", "Amplification", 0, 200, 20)
        self.wave_var = slider("wave", "Wavelength %", 0, 100, 50)

        # Dual-handle Hz band on a log axis with step snap — the reference's
        # RangeSlider row (RangeSlider.cpp; MagnificationControls band row).
        band_lbl = ttk.Label(panel, text="Band (Hz)")
        band_lbl.grid(row=row, column=0, sticky="w")
        self.low_var = tk.DoubleVar(value=1.0)
        self.high_var = tk.DoubleVar(value=5.0)

        def band_fmt(_v=None):
            lo, hi = self.low_var.get(), self.high_var.get()
            return f"{lo:.2f}–{hi:.2f} Hz ({lo * 60:.0f}–{hi * 60:.0f} BPM)"

        band_readout = ttk.Label(panel, text="", width=24)

        def on_band(low, high):
            self.low_var.set(low)
            self.high_var.set(high)
            band_readout.configure(text=band_fmt())
            self.push_params()

        self.band_slider = RangeSlider(panel, 0.05, 15.0, step=0.05, log=True,
                                       command=on_band)
        self.band_slider.set_values(self.low_var.get(), self.high_var.get())
        self.band_slider.grid(row=row, column=1, sticky="ew")
        band_readout.grid(row=row, column=2, sticky="w")
        band_readout.configure(text=band_fmt())
        self._rows["band"] = (band_lbl, self.band_slider, band_readout,
                              band_fmt, self.low_var)
        self._band_readout, self._band_fmt = band_readout, band_fmt
        row += 1

        self.chroma_var = slider("chroma", "Chroma %", 0, 100, 0)
        self.levels_var = slider("levels", "Levels", 1, 8, 4)
        self.fps_var = slider("fps", "Capture FPS", 1, 120, 30)

        self.gray_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(panel, text="Grayscale", variable=self.gray_var,
                        command=lambda: self.controller.set_grayscale(self.gray_var.get())
                        ).grid(row=row, column=0, columnspan=2, sticky="w")
        row += 1

        ttk.Label(panel, text="Resolution").grid(row=row, column=0, sticky="w")
        self.res_var = tk.StringVar(value="1/1")
        res = ttk.Combobox(panel, textvariable=self.res_var, state="readonly",
                           values=["1/1", "1/2", "1/4", "1/8"], width=6)
        res.grid(row=row, column=1, sticky="w")
        res.bind("<<ComboboxSelected>>", lambda e: self.controller.set_downscale(
            int(self.res_var.get().split("/")[1])))
        row += 1
        ttk.Button(panel, text="Reset ROI", command=self.controller.reset_roi).grid(
            row=row, column=0, columnspan=2, sticky="ew")
        self._update_row_visibility()

    def _mode(self) -> MagnificationMode:
        for name, mode in _MODES:
            if name == self.mode_var.get():
                return mode
        return MagnificationMode.LAPLACE

    # Which parameter rows each mode exposes (MagnificationControls per-mode
    # row visibility: Color has no wavelength/chroma; Phase has no chroma).
    _MODE_ROWS = {
        MagnificationMode.LAPLACE: {"amp", "wave", "band", "chroma",
                                    "levels", "fps"},
        MagnificationMode.PHASE: {"amp", "wave", "band", "levels", "fps"},
        MagnificationMode.COLOR: {"amp", "band", "levels", "fps"},
    }

    def _update_row_visibility(self):
        visible = self._MODE_ROWS[self._mode()]
        for key, (lbl, scale, readout, _fmt, _var) in self._rows.items():
            if key in visible:
                lbl.grid()
                scale.grid()
                readout.grid()
            else:
                lbl.grid_remove()
                scale.grid_remove()
                readout.grid_remove()

    def on_mode_change(self):
        ui = defaults_for(self._mode())
        self.amp_var.set(ui.amplification)
        self.wave_var.set(ui.wavelength)
        self.low_var.set(ui.low)
        self.high_var.set(ui.high)
        self.chroma_var.set(ui.chroma)
        self.levels_var.set(ui.levels)
        self.band_slider.set_values(ui.low, ui.high)  # silent
        for _lbl, _s, readout, fmt, var in self._rows.values():
            readout.configure(text=fmt(var.get()))
        self._update_row_visibility()
        self.push_params()

    def push_params(self):
        ui = defaults_for(self._mode())
        ui.amplification = int(self.amp_var.get())
        ui.wavelength = float(self.wave_var.get())
        ui.low = float(self.low_var.get())
        ui.high = float(self.high_var.get())
        ui.chroma = int(self.chroma_var.get())
        ui.levels = int(self.levels_var.get())
        ui.capture_fps = float(self.fps_var.get())
        clamp_band_to_nyquist(ui)
        # Nyquist clamp drives the band slider's range too
        # (MagnificationControls.cpp:256-260): [0.05, fps/2] — and any handle
        # the range clamp moved is written back to the vars + readout so the
        # display never diverges from the pushed params.
        if hasattr(self, "band_slider"):
            self.band_slider.set_range(0.05, max(0.1, ui.capture_fps / 2.0))
            s = self.band_slider
            if (s.low, s.high) != (ui.low, ui.high):
                ui.low, ui.high = s.low, s.high
                self.low_var.set(s.low)
                self.high_var.set(s.high)
                self._band_readout.configure(text=self._band_fmt())
        self.controller.set_magnification(to_params(ui))

    # --- sources / transport ---------------------------------------------------------------------

    def on_playback_fps(self):
        """File-source playback pacing (reference StatusStrip.cpp:122-158)."""
        try:
            fps = float(self.playback_fps_var.get())
        except Exception:
            return
        if fps > 0 and not self.controller.is_camera:
            self.controller.set_playback_fps(fps)

    def _sync_playback_fps_control(self):
        """Enable the spinbox for file sources and seed it with the source rate."""
        if self.controller.is_camera or self._file_path is None:
            self.playback_fps_spin.configure(state="disabled")
        else:
            reported = self.controller.reported_fps()
            if reported and reported > 0:
                self.playback_fps_var.set(round(float(reported), 2))
            self.playback_fps_spin.configure(state="normal")

    def on_open_file(self):
        path = self.filedialog.askopenfilename()
        if path:
            self._file_path = path  # export needs the source path (round-1 GUI bug)
            self._in_frame, self._out_frame = 0, None
            self._update_range_label()
            self.push_params()
            self.controller.open_file(path)
            self.controller.play()
            self._sync_playback_fps_control()

    def on_open_camera(self):
        from live_video_magnification_tpu_torch.engine.source import enumerate_cameras

        cams = enumerate_cameras()
        if not cams:
            self.messagebox.showinfo("Camera", "No capture devices found")
            return
        dlg = CameraSelectDialog(self.root, cams)
        if dlg.result is None:
            return
        self._file_path = None
        self.push_params()
        self.controller.open_camera(dlg.result)
        self.controller.play()
        self._sync_playback_fps_control()

    def on_open_synthetic(self):
        self._file_path = None
        self.push_params()
        self.controller.open_synthetic(h=480, w=640, fps=30.0)
        self.controller.play()
        self._sync_playback_fps_control()

    def _scrub_start(self, _e):
        self._scrubbing = True
        # pause-resume semantics (TimelineView): only resume if it was playing
        self._was_scrub_playing = self.controller.is_playing()
        self.controller.pause()

    def _scrub_end(self, _e):
        self._scrubbing = False
        if self._was_scrub_playing:
            self.controller.play()

    def on_seek(self, value):
        if self._scrubbing and self.controller.seekable():
            total = self.controller.frame_count()
            self.controller.seek_frame(int(float(value) * max(1, total - 1)))

    # --- in/out trim -----------------------------------------------------------------------------

    def on_set_in(self):
        if not self.controller.seekable():
            return
        self._in_frame, self._out_frame = trim_set_in(
            self._out_frame, self.controller.current_frame())
        self.controller.set_in_out(self._in_frame, self._out_frame or 0)
        self._update_range_label()

    def on_set_out(self):
        if not self.controller.seekable():
            return
        before = (self._in_frame, self._out_frame)
        self._in_frame, self._out_frame = trim_set_out(
            self._in_frame, self._out_frame, self.controller.current_frame())
        if (self._in_frame, self._out_frame) != before:
            self.controller.set_in_out(self._in_frame, self._out_frame)
            self._update_range_label()

    def on_clear_in_out(self):
        self._in_frame, self._out_frame = 0, None
        self.controller.set_in_out(0, 0)
        self._update_range_label()

    def _update_range_label(self):
        self.range_label.configure(
            text=range_label_text(self._in_frame, self._out_frame))

    # --- export ----------------------------------------------------------------------------------

    def _export_active(self) -> bool:
        if self._exporter is None:
            return False
        return self._exporter.progress().phase in (ExportPhase.PROCESSING,
                                                   ExportPhase.RECORDING)

    def on_export(self):
        guard = export_start_guard(self._export_active(),
                                   self._file_path is not None)
        if guard != "proceed":
            self.messagebox.showinfo("Export", {
                "busy": "An export is already running",
                "no_file": "Open a video file first (camera sources use Record)",
            }[guard])
            return
        dlg = ExportSettingsDialog(
            self.root, self.controller.config_snapshot(raw_mode=True),
            frame_count=self.controller.frame_count(),
            in_frame=self._in_frame, out_frame=self._out_frame,
            default_fps=self.controller.reported_fps() or 30.0,
        )
        if dlg.result is None:
            return
        from live_video_magnification_tpu_torch.export.exporter import Exporter
        from live_video_magnification_tpu_torch.export.sources import FileExportFrameSource

        req = dlg.result
        # Pause playback during export; only resume if it was actually playing
        # (MainWindow.cpp:567).
        self._resume_after_export = self.controller.is_playing()
        self.controller.pause()
        self._exporter = Exporter(device=self.controller.device)
        self._exporter.start(
            FileExportFrameSource(self._file_path, req.start_frame, req.end_frame),
            req, self.controller.mailbox,
        )
        self._export_dialog = ExportProgressDialog(self.root, on_abort=self._abort_export)
        self.root.after(ExportProgressDialog.POLL_MS, self._poll_export)

    def _abort_export(self):
        if self._exporter is not None:
            self._exporter.abort()

    def _poll_export(self):
        if self._exporter is None:
            return
        p = self._exporter.progress()
        action, text = export_poll_transition(p.phase, p.frames_done,
                                              p.frames_total, p.error)
        dlg = self._export_dialog
        if action == "continue":
            if dlg is not None and dlg.top.winfo_exists():
                dlg.show_processing(p.frames_done, p.frames_total)
            self.root.after(ExportProgressDialog.POLL_MS, self._poll_export)
            return
        if dlg is not None and dlg.top.winfo_exists():
            dlg.mark_finished(text)
        self._exporter.join(timeout=5.0)
        self._exporter = None
        if self._resume_after_export:
            self._resume_after_export = False
            self.controller.play()

    # --- record (camera) ---------------------------------------------------------------------

    def on_record(self):
        guard = record_start_guard(self._recording_buf is not None,
                                   self._export_active())
        if guard == "stop":
            self._stop_record_and_export()
            return
        if guard == "busy":
            self.messagebox.showinfo("Record", "An export is already running")
            return
        buf = self.controller.start_recording()
        if buf is None:
            self.messagebox.showinfo("Record", "Recording needs a camera source")
            return
        self._recording_buf = buf
        self.record_btn.configure(text="Stop Rec")
        self._export_dialog = ExportProgressDialog(
            self.root, on_abort=self._stop_record_and_export)
        self.root.after(ExportProgressDialog.POLL_MS, self._poll_recording)

    def _poll_recording(self):
        buf = self._recording_buf
        if buf is None:
            return
        dlg = self._export_dialog
        if dlg is not None and dlg.top.winfo_exists():
            dlg.show_recording(buf.frame_count, buf.byte_count)
        if record_poll_transition(buf.limit_reached) == "autostop":
            self._stop_record_and_export()  # 8 GB cap (MainWindow.cpp:49-51)
            return
        self.root.after(ExportProgressDialog.POLL_MS, self._poll_recording)

    def _stop_record_and_export(self):
        frames = self.controller.stop_recording()
        self._recording_buf = None
        self.record_btn.configure(text="Record")
        if self._export_dialog is not None:
            self._export_dialog.close()
            self._export_dialog = None
        if record_stop_decision(len(frames)) == "nothing":
            self.messagebox.showinfo("Record", "Nothing recorded")
            return
        dlg = ExportSettingsDialog(
            self.root, self.controller.config_snapshot(raw_mode=True),
            frame_count=len(frames), default_fps=self.controller.reported_fps() or 30.0,
            allow_range=False,
        )
        if dlg.result is None:
            return
        from live_video_magnification_tpu_torch.export.exporter import Exporter
        from live_video_magnification_tpu_torch.export.sources import BufferExportFrameSource

        # Pause the camera while exporting: two producers on the latest-wins
        # mailbox (live preview + export preview) would flicker-race.
        self._resume_after_export = self.controller.is_playing()
        self.controller.pause()
        self._exporter = Exporter(device=self.controller.device)
        self._exporter.start(BufferExportFrameSource(frames), dlg.result,
                             self.controller.mailbox)
        self._export_dialog = ExportProgressDialog(self.root, on_abort=self._abort_export)
        self.root.after(ExportProgressDialog.POLL_MS, self._poll_export)

    # --- close protection ------------------------------------------------------------------------

    def on_close(self):
        busy = self._export_active() or self._recording_buf is not None
        confirmed = busy and self.messagebox.askyesno(
            "Export running", "An export/recording is running. Abort and quit?")
        d = close_decision(self._export_active(),
                           self._recording_buf is not None, confirmed)
        if d == "ask":
            return
        if d == "abort_and_close":
            if self._recording_buf is not None:
                self.controller.stop_recording()
                self._recording_buf = None
            self._abort_export()
            if self._exporter is not None:
                self._exporter.join(timeout=10.0)
        self.root.destroy()

    # --- ROI drag ------------------------------------------------------------------------------

    def _canvas_to_norm(self, x, y):
        return canvas_to_norm(self._img_geom, x, y)

    def on_roi_press(self, e):
        self._roi_start = (e.x, e.y)

    def on_roi_drag(self, e):
        if self._roi_start is None:
            return
        if self._roi_rect_id is not None:
            self.canvas.delete(self._roi_rect_id)
        self._roi_rect_id = self.canvas.create_rectangle(
            *self._roi_start, e.x, e.y, outline=self.palette.accent)

    def on_roi_release(self, e):
        if self._roi_start is None:
            return
        p0 = self._canvas_to_norm(*self._roi_start)
        p1 = self._canvas_to_norm(e.x, e.y)
        self._roi_start = None
        if self._roi_rect_id is not None:
            self.canvas.delete(self._roi_rect_id)
            self._roi_rect_id = None
        rect = drag_to_roi(p0, p1)
        if rect is not None:
            self.controller.set_roi(*rect)

    # --- timers --------------------------------------------------------------------------------

    def on_theme_toggle(self):
        self.palette = self._theme.apply(self.root, self._theme_state.toggle())
        self.canvas.configure(bg=self.palette.bg)

    # --- settings toggle + fullscreen (MainWindow.cpp:97-100,205-207,346-421) --------------------

    def on_settings_toggle(self):
        """Show/hide the inspector panel; inert while fullscreen hides all
        chrome (the reconcile re-applies the toggle state on leave)."""
        if self._fs.applied:
            return
        if self.settings_var.get():
            self.panel.pack(side="right", fill="y", before=self.canvas)
        else:
            self.panel.pack_forget()

    def _is_fullscreen(self) -> bool:
        try:
            return bool(int(self.root.attributes("-fullscreen")))
        except Exception:
            return False

    def _is_maximized(self) -> bool:
        # X11 exposes maximize as the -zoomed attribute; absent elsewhere
        try:
            return bool(int(self.root.attributes("-zoomed")))
        except Exception:
            return self.root.state() == "zoomed"

    def set_fullscreen(self, on: bool):
        act = self._fs.request(on, self._export_active(),
                               self._is_fullscreen(), self._is_maximized())
        if act == "noop":
            return
        self.root.attributes("-fullscreen", act == "enter")
        if act == "leave_max":
            try:
                self.root.attributes("-zoomed", True)
            except Exception:
                try:
                    self.root.state("zoomed")
                except Exception:
                    pass
        # the WM is authoritative: reconcile chrome to what was GRANTED once
        # the request settles (MainWindow.cpp changeEvent semantics)
        self.root.after(50, self._reconcile_fullscreen)

    def _reconcile_fullscreen(self):
        vis = self._fs.reconcile(
            self._is_fullscreen(),
            source_open=self.controller._source is not None,
            source_is_file=not self.controller.is_camera,
            settings_on=self.settings_var.get(),
        )
        if vis is None:
            return
        self._apply_chrome(vis)

    def _apply_chrome(self, vis: dict):
        """Map the pure reconcile decisions onto pack geometry. Re-packing
        uses `before=` anchors so the stacking order survives round trips."""
        def show(w, on, **pack_kw):
            if on and not w.winfo_manager():
                w.pack(**pack_kw)
            elif not on and w.winfo_manager():
                w.pack_forget()

        show(self.toolbar, vis["toolbar"], side="top", fill="x",
             before=self.center)
        show(self.panel, vis["panel"], side="right", fill="y",
             before=self.canvas)
        show(self.status, vis["status"], side="bottom", fill="x")
        show(self.transport, vis["transport"], side="top", fill="x",
             after=self.center)
        if vis["disarm_roi"]:
            self._roi_start = None
            if self._roi_rect_id is not None:
                self.canvas.delete(self._roi_rect_id)
                self._roi_rect_id = None
        if vis["focus_display"]:
            self.canvas.focus_set()

    def _on_fullscreen_key(self, key: str):
        act = fullscreen_key(key, self._is_fullscreen(), self._export_active())
        if act == "toggle":
            self.set_fullscreen(not self._is_fullscreen())
        elif act == "exit":
            self.set_fullscreen(False)

    def _set_view(self):
        mode = ViewMode(self.view_var.get())
        self.display.view_mode = mode
        self.controller.set_magnify_active(view_magnify_active(mode))

    def _poll_display(self):
        view = self.display.poll_once()
        if view is not None:
            view, geom = fit_view(view, self.canvas.winfo_width(),
                                  self.canvas.winfo_height())
            self._photo = _frame_to_photo(self.tk, view, self._photo_codec)
            self.canvas.delete("frame")
            self.canvas.create_image(geom[0], geom[1], image=self._photo, anchor="nw",
                                     tags="frame")
            self._img_geom = geom
        self.root.after(8, self._poll_display)

    def _poll_stats(self):
        s = self.controller.stats()
        text, health = stats_line(
            s.process_fps, s.latency_ms_mean, s.latency_ms_p95, s.queue_depth,
            s.proc_errors, s.drop_fraction, self.controller.is_camera,
            self.controller.reported_fps())
        self.status.configure(text=" " + text, bg=_HEALTH_COLORS[health])
        self.root.after(250, self._poll_stats)

    def _poll_timeline(self):
        if not self._scrubbing and self.controller.seekable():
            self.timeline.set(timeline_fraction(self.controller.current_frame(),
                                                self.controller.frame_count()))
        self.root.after(60, self._poll_timeline)

    def run(self):
        try:
            self.root.mainloop()
        finally:
            self.controller.close()


def main(argv=None) -> int:
    """``[--device DEV] [path]``: ``--device`` (``cuda`` by default, or
    ``cpu``) picks where the chain runs, as in the port's ``cli.py``; without
    a card, ``cuda`` exits 1 with the error instead of falling back."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m live_video_magnification_tpu_torch.gui")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where frames are processed (default cuda; no fallback)")
    ap.add_argument("path", nargs="?", default=None, help="a video file to open")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    try:
        win = MainWindow(device=args.device)
    except RuntimeError as e:
        print(f"error: {e} (here: --device cpu)", file=sys.stderr)
        return 1
    if args.path:
        win._file_path = args.path
        win.controller.open_file(args.path)
        win.controller.play()
        win._sync_playback_fps_control()
    win.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
