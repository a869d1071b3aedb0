"""The port's GL present path, executed headless (EGL surfaceless + llvmpipe),
case for case as the reference suite's ``tests/test_gl_present.py`` and held
against the reference package's ``GLPresenter``.

* The sixteen cases of ``tests/test_gl_present.py`` on the port's classes:
  pane layouts and letterbox math, the BGR swizzle and gray replication,
  letterbox bars, upload only on a new seq, re-allocation on a geometry
  change, row-padded and flipped views, the split views, the Original view,
  seq gaps as display skips, an empty mailbox, the live engine through
  ``GLDisplayLoop`` (``PlaybackController(device="cpu")``) and the loop alone.
* The composited framebuffer (``read_pixels``) after every paint equals the
  reference presenter's byte for byte on the same frames, each package's
  presenter in turn on one context: the four view modes with BGR and gray
  panes, a row-padded view, a flipped view and a run of geometry changes;
  uploads, re-allocations and display skips equal too.

Skips where no GL context can be made, as the reference file does.
"""

import time

import numpy as np
import pytest

from live_video_magnification_tpu.engine import frame as jframe
from live_video_magnification_tpu.engine import gl_present as jgl
from live_video_magnification_tpu.engine import instrumentation as jinstr
from live_video_magnification_tpu.engine import mailbox as jmailbox
from live_video_magnification_tpu.engine.display import ViewMode as JViewMode
from live_video_magnification_tpu_torch.engine.display import ViewMode
from live_video_magnification_tpu_torch.engine.frame import Frame
from live_video_magnification_tpu_torch.engine.gl_present import (
    GLDisplayLoop,
    GLPresenter,
    HeadlessGLContext,
    gl_available,
    letterbox,
    pane_layout,
)
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox

pytestmark = pytest.mark.skipif(
    not gl_available(), reason="no EGL surfaceless GL context in this image"
)

W, H = 128, 96
DEADLINE_S = 20.0


@pytest.fixture(scope="module")
def ctx():
    c = HeadlessGLContext(W, H)
    yield c
    c.destroy()


@pytest.fixture()
def presenter(ctx):
    ctx.make_current()
    p = GLPresenter()
    yield p
    p.destroy()


def bgr(b, g, r, h=48, w=64):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :, 0], img[:, :, 1], img[:, :, 2] = b, g, r
    return img


def pair(img, seq, orig=None):
    return DisplayFrame(Frame(seq=seq, data=img),
                        Frame(seq=seq, data=img if orig is None else orig))


def _wait(cond, timeout=DEADLINE_S):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.05)
    return cond()


# ---------------------------------------------------------------- tests/test_gl_present.py


def test_pane_layout_matches_reference_modes():
    assert pane_layout(ViewMode.PROCESSED, 100, 80) == [(0, 0, 100, 80, False)]
    assert pane_layout(ViewMode.ORIGINAL, 100, 80) == [(0, 0, 100, 80, True)]
    assert pane_layout(ViewMode.SIDE_BY_SIDE, 101, 80) == [
        (0, 0, 50, 80, True), (50, 0, 51, 80, False)]
    assert pane_layout(ViewMode.TOP_BOTTOM, 100, 81) == [
        (0, 0, 100, 40, True), (0, 40, 100, 41, False)]
    for mode in ViewMode:
        for w, h in [(100, 80), (101, 81), (1, 1), (1280, 720)]:
            assert pane_layout(mode, w, h) == jgl.pane_layout(JViewMode(mode.value), w, h)


def test_letterbox_centers_and_fits():
    assert letterbox(200, 100, 0, 0, 100, 100) == (0, 25, 100, 50)
    assert letterbox(100, 200, 0, 0, 100, 100) == (25, 0, 50, 100)
    assert letterbox(0, 10, 0, 0, 100, 100) is None
    assert letterbox(10, 10, 0, 0, 0, 100) is None
    rng = np.random.default_rng(3)
    for args in rng.integers(0, 400, (200, 6)).tolist():
        assert letterbox(*args) == jgl.letterbox(*args)


def test_bgr_swizzle(ctx, presenter):
    presenter.paint(pair(bgr(255, 0, 0), seq=0), W, H)  # blue frame
    out = ctx.read_pixels()
    assert tuple(out[H // 2, W // 2]) == (0, 0, 255)  # display RGB blue


def test_gray_replicates_across_rgb(ctx, presenter):
    img = np.full((48, 64), 100, np.uint8)
    presenter.paint(pair(img, seq=0), W, H)
    out = ctx.read_pixels()
    assert tuple(out[H // 2, W // 2]) == (100, 100, 100)


def test_letterbox_bars_are_black(ctx, presenter):
    presenter.paint(pair(bgr(0, 0, 255, h=32, w=64), seq=0), W, H)
    out = ctx.read_pixels()
    assert tuple(out[H // 2, W // 2]) == (255, 0, 0)  # red content
    assert tuple(out[2, W // 2]) == (0, 0, 0)          # top bar
    assert tuple(out[H - 3, W // 2]) == (0, 0, 0)      # bottom bar
    assert tuple(out[H // 2, 2]) == (255, 0, 0)        # full width


def test_upload_only_on_new_seq(ctx, presenter):
    p0 = pair(bgr(10, 20, 30), seq=0)
    presenter.paint(p0, W, H)
    assert presenter.uploads == 1
    presenter.paint(p0, W, H)          # same seq: redraw, no upload
    presenter.paint(p0, W, H)
    assert presenter.uploads == 1
    presenter.paint(pair(bgr(1, 2, 3), seq=1), W, H)
    assert presenter.uploads == 2


def test_geometry_change_reallocates(ctx, presenter):
    presenter.paint(pair(bgr(1, 2, 3, h=48, w=64), seq=0), W, H)
    assert (presenter.uploads, presenter.reallocs) == (1, 1)
    presenter.paint(pair(bgr(1, 2, 3, h=48, w=64), seq=1), W, H)
    assert (presenter.uploads, presenter.reallocs) == (2, 1)  # sub-image
    presenter.paint(pair(bgr(1, 2, 3, h=24, w=32), seq=2), W, H)
    assert (presenter.uploads, presenter.reallocs) == (3, 2)  # re-alloc


def _painted_content_matches(ctx, presenter, view):
    """A (48, 64, 3) BGR frame fills the 128x96 framebuffer at 2x: probe
    pixels carry the right row and column (stride and row-shift faults)."""
    presenter.paint(pair(np.ascontiguousarray(view) * 0, seq=0), W, H)  # alloc
    presenter.paint(pair(view, seq=1), W, H)
    out = ctx.read_pixels()
    for fy, fx in [(5, 5), (5, 58), (42, 5), (42, 58), (24, 32)]:
        got = out[fy * 2 + 1, fx * 2 + 1].astype(int)
        b, g, r = (int(v) for v in view[fy, fx])
        assert abs(got[0] - r) <= 2 and abs(got[1] - g) <= 2 \
            and abs(got[2] - b) <= 2, (fy, fx, got, (r, g, b))


def _padded_view():
    backing = np.zeros((48, 80, 3), np.uint8)
    backing[:, :, 0] = np.arange(48, dtype=np.uint8)[:, None] * 4   # B encodes the row
    backing[:, :, 1] = np.arange(80, dtype=np.uint8)[None, :] * 3   # G the column
    backing[:, :, 2] = 200
    return backing[:, :64]


def _flipped_view():
    img = np.zeros((48, 64, 3), np.uint8)
    img[:, :, 0] = np.arange(48, dtype=np.uint8)[:, None] * 4
    img[:, :, 1] = np.arange(64, dtype=np.uint8)[None, :] * 3
    return img[::-1]


def test_row_padded_frame_uploads_correctly(ctx, presenter):
    _painted_content_matches(ctx, presenter, _padded_view())


def test_flipped_view_uploads_correctly(ctx, presenter):
    _painted_content_matches(ctx, presenter, _flipped_view())


def test_side_by_side_panes(ctx):
    p = GLPresenter(view_mode=ViewMode.SIDE_BY_SIDE)
    try:
        proc = bgr(0, 0, 255, h=48, w=32)   # red (processed, right)
        orig = bgr(0, 255, 0, h=48, w=32)   # green (original, left)
        p.paint(pair(proc, seq=0, orig=orig), W, H)
        out = ctx.read_pixels()
        assert tuple(out[H // 2, W // 4]) == (0, 255, 0)
        assert tuple(out[H // 2, 3 * W // 4]) == (255, 0, 0)
        assert p.uploads == 2  # both panes from ONE seq check
    finally:
        p.destroy()


def test_top_bottom_panes(ctx):
    p = GLPresenter(view_mode=ViewMode.TOP_BOTTOM)
    try:
        proc = bgr(0, 0, 255, h=24, w=64)
        orig = bgr(255, 0, 0, h=24, w=64)
        p.paint(pair(proc, seq=0, orig=orig), W, H)
        out = ctx.read_pixels()
        assert tuple(out[H // 4, W // 2]) == (0, 0, 255)       # blue top
        assert tuple(out[3 * H // 4, W // 2]) == (255, 0, 0)   # red bottom
    finally:
        p.destroy()


def test_original_mode_uploads_only_original(ctx):
    p = GLPresenter(view_mode=ViewMode.ORIGINAL)
    try:
        p.paint(pair(bgr(0, 0, 255), seq=0, orig=bgr(255, 0, 0)), W, H)
        out = ctx.read_pixels()
        assert tuple(out[H // 2, W // 2]) == (0, 0, 255)  # the ORIGINAL blue
        assert p.uploads == 1  # needProc false in Original mode
    finally:
        p.destroy()


def test_seq_gap_counts_display_skips(ctx):
    instr = Instrumentation()
    p = GLPresenter(instr=instr)
    try:
        p.paint(pair(bgr(1, 1, 1), seq=0), W, H)
        p.paint(pair(bgr(2, 2, 2), seq=5), W, H)
        s = instr.snapshot()
        assert s.displayed == 2
        assert s.display_skipped == 4
    finally:
        p.destroy()


def test_empty_mailbox_paints_black(ctx, presenter):
    assert presenter.paint(None, W, H) is False
    out = ctx.read_pixels()
    assert out.max() == 0


def test_gl_loop_presents_live_engine_frames(ctx):
    """The ``cli.py live --gl`` seam: PlaybackController on the CPU (a
    synthetic source, the port's chain) -> mailbox -> GLDisplayLoop on the
    headless context; displayed frames land in the controller's
    Instrumentation (DisplayWidget.cpp:229-236 accounting)."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
    )

    ctrl = PlaybackController(device="cpu")
    ctx.release_current()
    loop = GLDisplayLoop(ctrl.mailbox, ctrl.instr, ctx, poll_hz=240.0)
    try:
        ctrl.set_magnification(MagnificationParams(
            mode=MagnificationMode.LAPLACE, amplification=10.0,
            co_low=0.3, co_high=0.6, levels=2, framerate=30.0))
        assert ctrl.open_synthetic(h=48, w=64, fps=30.0)
        ctrl.play()
        loop.start()
        _wait(lambda: ctrl.stats().displayed >= 3)
    finally:
        loop.stop()
        ctrl.close()
    assert ctrl.stats().displayed >= 3
    ctx.make_current()
    out = ctx.read_pixels()
    assert out.max() > 0  # the painted frame reached the framebuffer


def test_gl_display_loop_end_to_end(ctx):
    mailbox = LatestFrameMailbox()
    instr = Instrumentation()
    img = bgr(0, 128, 0)
    mailbox.publish(DisplayFrame(Frame(seq=0, data=img), Frame(seq=0, data=img)))
    ctx.release_current()  # the loop thread takes the context
    loop = GLDisplayLoop(mailbox, instr, ctx, poll_hz=240.0)
    loop.start()
    try:
        deadline = time.monotonic() + 5.0
        seq = 0
        while instr.snapshot().displayed < 3 and time.monotonic() < deadline:
            seq += 1
            mailbox.publish(
                DisplayFrame(Frame(seq=seq, data=img), Frame(seq=seq, data=img)))
            time.sleep(0.02)
    finally:
        loop.stop()
    assert instr.snapshot().displayed >= 3
    ctx.make_current()  # hand it back for the other tests


# ---------------------------------------------------------------- against the reference presenter


def _content(rng, h, w, gray):
    shape = (h, w) if gray else (h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _paint_all(ctx, package, view, steps):
    """Each (processed, original, seq) of ``steps`` painted by ``package``'s
    presenter (a fresh one, on ``ctx``); returns the framebuffer after every
    paint, the presenter's counters and its display accounting."""
    if package == "ref":
        mk_frame, mk_pair = jframe.Frame, jmailbox.DisplayFrame
        instr = jinstr.Instrumentation()
        p = jgl.GLPresenter(instr, view_mode=JViewMode(view.value))
    else:
        mk_frame, mk_pair = Frame, DisplayFrame
        instr = Instrumentation()
        p = GLPresenter(instr, view_mode=view)
    shots = []
    try:
        for proc, orig, seq in steps:
            p.paint(mk_pair(mk_frame(seq=seq, data=proc), mk_frame(seq=seq, data=orig)), W, H)
            shots.append(ctx.read_pixels().copy())
        s = instr.snapshot()
        return shots, (p.uploads, p.reallocs, s.displayed, s.display_skipped)
    finally:
        p.destroy()


def _same_as_reference(ctx, view, steps):
    ctx.make_current()
    ref, ref_counts = _paint_all(ctx, "ref", view, steps)
    got, got_counts = _paint_all(ctx, "port", view, steps)
    assert got_counts == ref_counts
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.tobytes() == b.tobytes(), f"framebuffer {i} differs"
    assert max(int(a.max()) for a in got) > 0  # something was drawn
    return got_counts


@pytest.mark.parametrize("kind", ["bgr", "gray"])
@pytest.mark.parametrize("view", list(ViewMode), ids=lambda v: v.value)
def test_framebuffer_equals_the_references(ctx, view, kind):
    """Seeded frames (the processed pane 48x64, the original 40x64 so the
    panes letterbox differently), seqs 0, 1, 1 (no upload) and 4 (two
    skipped), in every view mode: each framebuffer byte for byte the
    reference presenter's."""
    rng = np.random.default_rng(11)
    gray = kind == "gray"
    frames = [(_content(rng, 48, 64, gray), _content(rng, 40, 64, gray)) for _ in range(3)]
    steps = [(*frames[0], 0), (*frames[1], 1), (*frames[1], 1), (*frames[2], 4)]
    uploads, reallocs, displayed, skipped = _same_as_reference(ctx, view, steps)
    assert (displayed, skipped) == (3, 2)
    assert uploads == (3 if view in (ViewMode.PROCESSED, ViewMode.ORIGINAL) else 6)


@pytest.mark.parametrize("which", ["row_padded", "flipped"])
def test_strided_views_equal_the_references(ctx, which):
    view = _padded_view() if which == "row_padded" else _flipped_view()
    assert not view.flags.c_contiguous
    steps = [(view, view, 0), (view[::-1], view, 1)]
    _same_as_reference(ctx, ViewMode.SIDE_BY_SIDE, steps)


def test_geometry_changes_equal_the_references(ctx):
    """Frames that change size (odd sizes included) and channel count, with
    seq gaps: re-allocations, sub-image uploads, skips and every framebuffer
    the reference's."""
    rng = np.random.default_rng(12)
    sizes = [(48, 64, False), (48, 64, False), (24, 32, False), (33, 47, True),
             (33, 47, True), (96, 128, False)]
    steps = [(_content(rng, h, w, g), _content(rng, h, w, g), seq)
             for (h, w, g), seq in zip(sizes, [0, 1, 2, 5, 6, 9])]
    uploads, reallocs, displayed, skipped = _same_as_reference(ctx, ViewMode.TOP_BOTTOM, steps)
    assert (uploads, reallocs, displayed, skipped) == (12, 8, 6, 4)
