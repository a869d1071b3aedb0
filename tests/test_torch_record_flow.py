"""The port's record -> export flow and camera source on the CPU.

* The cases of the reference suite's ``tests/test_record_flow.py`` (record ->
  RecordingBuffer -> stop -> Exporter; the byte cap; the detach handshake;
  file-kind sources; request validation; rapid reconfiguration; a failed
  open) and ``tests/test_camera_source.py`` (a scripted cv2.VideoCapture:
  transient read errors, the wedged-grab rebuild, the API fallback, the
  record bypass), on the port's classes with ``device="cpu"``.
* ``Exporter`` against the reference's on the same recorded frames, with
  ``open_writer`` replaced by an in-memory writer in both: the written
  frames (the chain's bar: within 1 LSB where nothing is magnified, >= 40
  dB where it is), the progress, the phases and the preview.
* Abort deletes the partial file and an empty range is an error (cv2
  writer); a gray pane composes as cv2.COLOR_GRAY2BGR does.
"""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

import live_video_magnification_tpu.export.exporter as jexporter
import live_video_magnification_tpu_torch.engine.source as tsource
import live_video_magnification_tpu_torch.export.exporter as texporter
from live_video_magnification_tpu.engine.mailbox import LatestFrameMailbox as JMailbox
from live_video_magnification_tpu.export.sources import BufferExportFrameSource as JBufferSource
from live_video_magnification_tpu.export.types import ExportRequest as JRequest
from live_video_magnification_tpu.export.types import SplitMode as JSplit
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu_torch.engine.controller import PlaybackController
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.pool import FramePool
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue, OverflowPolicy
from live_video_magnification_tpu_torch.engine.source import CameraSource, IFrameSink
from live_video_magnification_tpu_torch.export.recording import RecordingBuffer
from live_video_magnification_tpu_torch.export.sources import (
    BufferExportFrameSource,
    FileExportFrameSource,
)
from live_video_magnification_tpu_torch.export.types import (
    ExportFormat,
    ExportPhase,
    ExportRequest,
    SplitMode,
    validate_request,
)
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    MagnificationParams,
    ProcessorConfig,
)
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8

torch.set_num_threads(2)

DEADLINE_S = 20.0


def _wait(cond, timeout=DEADLINE_S, interval=0.02):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(interval)
    return False


def _controller():
    return PlaybackController(device="cpu")


MOTION = MagnificationParams(mode=MagnificationMode.LAPLACE, amplification=15,
                             co_wavelength=200, co_low=0.2, co_high=0.7, levels=2,
                             framerate=60.0)


# ---------------------------------------------------------------- tests/test_record_flow.py


def test_record_stop_export_end_to_end(tmp_path):
    """Synthetic 'camera' -> start_recording -> frames accumulate -> stop
    (ordered close -> quiesce -> detach) -> Exporter -> playable file."""
    import cv2

    ctrl = _controller()
    try:
        ctrl.set_magnification(MOTION)
        assert ctrl.open_synthetic(h=32, w=40, fps=60.0, as_camera=True)
        assert ctrl.is_camera
        ctrl.play()
        buf = ctrl.start_recording()
        assert buf is not None
        assert _wait(lambda: buf.frame_count >= 6), "no frames recorded"
        # recording bypasses the queue; the raw preview is published
        processed_during = ctrl.stats().processed
        assert ctrl.mailbox.latest() is not None
        frames = ctrl.stop_recording()
        cfg = ctrl.config_snapshot()
    finally:
        ctrl.close()
    assert len(frames) >= 6 and frames[0].shape == (32, 40, 3)
    assert processed_during == 0

    out = str(tmp_path / "rec.avi")
    req = ExportRequest(config=cfg, output_path=out, file_fps=30.0, split=SplitMode.LEFT_RIGHT,
                        text_overlay=True, format=ExportFormat.AVI_MJPG)
    assert validate_request(req) == []
    exp = texporter.Exporter(device="cpu")
    exp.start(BufferExportFrameSource(frames), req)
    exp.join(timeout=DEADLINE_S)
    p = exp.progress()
    assert p.phase is ExportPhase.DONE, p.error
    assert p.frames_done == len(frames)
    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    assert n == len(frames) and w == 80  # left-right split doubles width


def test_record_cap_auto_stops():
    """Byte cap reached -> the buffer closes itself and on_limit fires; the
    captured prefix is kept."""
    ctrl = _controller()
    hits = []
    try:
        assert ctrl.open_synthetic(h=32, w=40, fps=120.0, as_camera=True)
        ctrl.play()
        buf = ctrl.start_recording(max_bytes=4 * 32 * 40 * 3 + 1,
                                   on_limit=lambda: hits.append(1))
        assert buf is not None
        assert _wait(lambda: buf.limit_reached), "cap never reached"
        frames = ctrl.stop_recording()
    finally:
        ctrl.close()
    assert hits == [1]
    assert len(frames) == 4  # exactly the frames that fit under the cap


def test_record_detach_handshake_no_lost_append():
    """set_record_target(None) blocks until an in-flight append completes."""

    class SlowSink(IFrameSink):
        def __init__(self):
            self.mid_append = threading.Event()
            self.release = threading.Event()
            self.completed = 0

        def append(self, data, pts_us):
            self.mid_append.set()
            self.release.wait(timeout=5.0)
            self.completed += 1
            return True

    ctrl = _controller()
    sink = SlowSink()
    try:
        assert ctrl.open_synthetic(h=16, w=16, fps=240.0, as_camera=True)
        ctrl.play()
        assert ctrl.begin_camera_recording(sink)
        assert sink.mid_append.wait(timeout=DEADLINE_S)
        detached = threading.Event()

        def detach():
            ctrl.end_camera_recording()  # must block on the in-flight append
            detached.set()

        t = threading.Thread(target=detach)
        t.start()
        time.sleep(0.1)
        assert not detached.is_set(), "detach returned while an append was in flight"
        before = sink.completed
        sink.release.set()
        t.join(timeout=DEADLINE_S)
        assert detached.is_set()
        assert sink.completed >= before + 1  # the in-flight append completed
    finally:
        sink.release.set()
        ctrl.close()


def test_recording_unavailable_for_file_kind_sources():
    ctrl = _controller()
    try:
        assert ctrl.open_synthetic(h=16, w=16, fps=30.0)  # file semantics
        assert ctrl.start_recording() is None
        assert ctrl.stop_recording() == []
    finally:
        ctrl.close()


def test_validate_request_rejects_bad_fields(tmp_path):
    cfg = ProcessorConfig()
    ok = ExportRequest(config=cfg, output_path=str(tmp_path / "x.mp4"))
    assert validate_request(ok, 100) == []
    bad_dir = ExportRequest(config=cfg, output_path="/nonexistent/dir/x.mp4")
    assert any("directory" in p for p in validate_request(bad_dir))
    bad_range = ExportRequest(config=cfg, output_path=str(tmp_path / "x.mp4"),
                              start_frame=50, end_frame=10)
    assert any("end frame" in p for p in validate_request(bad_range, 100))
    beyond = ExportRequest(config=cfg, output_path=str(tmp_path / "x.mp4"),
                           start_frame=0, end_frame=200)
    assert any("beyond" in p for p in validate_request(beyond, 100))
    bad_fps = ExportRequest(config=cfg, output_path=str(tmp_path / "x.mp4"), file_fps=0.0)
    assert any("fps" in p for p in validate_request(bad_fps))
    no_path = ExportRequest(config=cfg, output_path="")
    assert any("path" in p for p in validate_request(no_path))


def test_controller_rapid_reconfigure_stress():
    """Rapid open/seek/reconfigure/play/stop loops neither deadlock nor raise
    processing errors (the teardown unblocks queue and pool before joining)."""
    ctrl = _controller()
    try:
        for i in range(12):
            assert ctrl.open_synthetic(h=24, w=32, fps=240.0, n_frames=40)
            ctrl.play()
            ctrl.set_downscale([1, 2][i % 2])
            ctrl.set_grayscale(i % 3 == 0)
            ctrl.set_magnification(MagnificationParams(
                mode=[MagnificationMode.LAPLACE, MagnificationMode.COLOR][i % 2],
                amplification=10 + i % 5, co_low=0.2, co_high=0.6,
                levels=1 + i % 2, framerate=240.0,
            ))
            if ctrl.seekable():
                ctrl.seek_frame(i % 40)
            time.sleep(0.02)
            ctrl.pause()
            ctrl.play()
            ctrl.stop()
        s = ctrl.stats()
    finally:
        ctrl.close()
    assert s.proc_errors == 0 and s.read_errors == 0


def test_failed_open_leaves_no_stale_source():
    ctrl = _controller()
    try:
        assert not ctrl.open_file("/nonexistent/clip.mp4")
        assert ctrl._source is None
        ctrl.play()  # no crash: the factory's rebuild fails again
        assert ctrl._source is None
    finally:
        ctrl.close()


# ---------------------------------------------------------------- tests/test_camera_source.py


class FakeCapture:
    """Scriptable cv2.VideoCapture: ``script`` yields (ok, frame) per read()."""

    def __init__(self, script, opened=True, fps=30.0):
        self._script = iter(script)
        self._opened = opened
        self._fps = fps

    def isOpened(self):
        return self._opened

    def get(self, prop):
        return self._fps

    def read(self):
        try:
            return next(self._script)
        except StopIteration:
            return False, None

    def release(self):
        pass


def _img():
    return np.full((16, 20, 3), 128, np.uint8)


def _endless_frames():
    return itertools.repeat((True, _img()))


def _make_camera(monkeypatch, captures, mailbox=None):
    import cv2

    calls = []

    def fake_cap(index, api=None):
        calls.append((index, api))
        return captures.pop(0) if captures else FakeCapture([], opened=False)

    monkeypatch.setattr(cv2, "VideoCapture", fake_cap)
    queue = BoundedQueue(4)
    queue.set_policy(OverflowPolicy.DROP)
    instr = Instrumentation()
    cam = CameraSource(0, FramePool(8), queue, instr, mailbox=mailbox)
    return cam, queue, instr, calls


def test_transient_read_failures_retry_and_count(monkeypatch):
    script = itertools.chain([(True, _img())], [(False, None)] * 3, _endless_frames())
    cam, _, instr, _ = _make_camera(monkeypatch, [FakeCapture(script)])
    assert cam.open()
    cam.start()
    try:
        cam.play()
        assert _wait(lambda: instr.snapshot().captured >= 5), "frames never flowed"
    finally:
        cam.stop()
    s = instr.snapshot()
    assert s.read_errors == 3 and s.captured >= 5


def test_wedged_grab_times_out_and_controller_rebuilds(monkeypatch):
    import cv2

    monkeypatch.setattr(CameraSource, "READ_TIMEOUT_S", 0.15)
    captures = [
        FakeCapture([(True, _img())] + [(False, None)] * 100000),  # probe ok, then wedged
        FakeCapture(itertools.chain([(True, _img())], _endless_frames())),  # the rebuild works
    ]
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda index, api=None: captures.pop(0) if captures
                        else FakeCapture([], opened=False))
    ctrl = _controller()
    try:
        assert ctrl.open_camera(0)
        ctrl.play()
        src1 = ctrl._source
        assert _wait(src1.finished), "wedged source never bailed"
        ctrl.play()  # dead source -> rebuild
        assert ctrl._source is not src1
        assert _wait(lambda: ctrl.stats().captured >= 3), "rebuilt camera not producing"
        assert _wait(lambda: ctrl.stats().processed >= 1)
        assert ctrl.stats().proc_errors == 0
    finally:
        ctrl.close()


def test_open_falls_back_through_api_preferences(monkeypatch):
    captures = [FakeCapture([], opened=False),
                FakeCapture(itertools.chain([(True, _img())], _endless_frames()))]
    cam, _, _, calls = _make_camera(monkeypatch, captures)
    assert cam.open()
    assert len(calls) == 2  # tried two APIs
    assert cam.native_size() == (16, 20) and cam.native_channels() == 3


def test_open_fails_when_no_api_works(monkeypatch):
    cam, _, _, _ = _make_camera(monkeypatch, [FakeCapture([], opened=False),
                                              FakeCapture([], opened=False)])
    assert not cam.open()


def test_record_bypass_publishes_raw_preview_and_skips_queue(monkeypatch):
    mailbox = LatestFrameMailbox()
    cam, queue, _, _ = _make_camera(
        monkeypatch, [FakeCapture(itertools.chain([(True, _img())], _endless_frames()))],
        mailbox=mailbox)
    assert cam.open()
    buf = RecordingBuffer(max_bytes=10**9)
    cam.set_record_target(buf)
    cam.start()
    try:
        cam.play()
        assert _wait(lambda: buf.frame_count >= 3)
        assert queue.depth() == 0  # the queue is bypassed while recording
        df = mailbox.latest()
        assert df is not None  # the raw preview is published
        np.testing.assert_array_equal(df.processed.data, _img())
        cam.set_record_target(None)
        assert _wait(lambda: queue.depth() > 0)  # normal flow resumes
    finally:
        cam.stop()


# ---------------------------------------------------------------- Exporter against the reference


class MemoryWriter:
    def __init__(self, size_wh):
        self.size_wh, self.frames, self.released = size_wh, [], False

    def write(self, canvas):
        assert canvas.shape[:2] == self.size_wh[::-1] and canvas.dtype == np.uint8
        self.frames.append(canvas.copy())

    def release(self):
        self.released = True


def _memory_writers(monkeypatch, module):
    writers = []

    def open_writer(fmt, path, fps, size_wh):
        writers.append(MemoryWriter(size_wh))
        return writers[-1], path, "memory"

    monkeypatch.setattr(module, "open_writer", open_writer)
    return writers


@pytest.fixture(scope="module")
def recorded():
    """About 10 frames of a 40x48 synthetic camera, through the port's record path."""
    ctrl = _controller()
    try:
        assert ctrl.open_synthetic(h=40, w=48, fps=120.0, as_camera=True)
        ctrl.play()
        buf = ctrl.start_recording()
        assert _wait(lambda: buf.frame_count >= 10)
        frames = ctrl.stop_recording()[:10]
    finally:
        ctrl.close()
    assert len(frames) == 10
    return frames


def _run_exporter(exp, source, request, preview):
    exp.start(source, request, preview=preview)
    exp.join(timeout=DEADLINE_S)
    assert exp._thread is None, "export did not finish"
    return exp.progress()


EXPORTS = [("laplace", "left-right", False, False), ("phase", "top-bottom", False, True),
           ("color", "none", False, False), ("laplace", "none", True, False),
           ("none", "left-right", True, True)]


@pytest.mark.parametrize("mode,split,gray,labels", EXPORTS)
def test_exporter_writes_the_references_frames(mode, split, gray, labels, recorded, monkeypatch,
                                               tmp_path):
    kw = dict(amplification=20, co_wavelength=40.0, co_low=1.0, co_high=5.0, levels=2,
              framerate=30.0)
    jcfg = jparams.ProcessorConfig(grayscale=gray, magnification=jparams.MagnificationParams(
        mode=jparams.MagnificationMode(mode), **kw))
    tcfg = ProcessorConfig(grayscale=gray, magnification=MagnificationParams(
        mode=MagnificationMode(mode), **kw))
    out = str(tmp_path / "x.avi")
    jwriters = _memory_writers(monkeypatch, jexporter)
    twriters = _memory_writers(monkeypatch, texporter)
    jbox, tbox = JMailbox(), LatestFrameMailbox()
    ref = _run_exporter(jexporter.Exporter(), JBufferSource(recorded),
                        JRequest(config=jcfg, output_path=out, split=JSplit(split),
                                 text_overlay=labels), jbox)
    got = _run_exporter(texporter.Exporter(device="cpu"), BufferExportFrameSource(recorded),
                        ExportRequest(config=tcfg, output_path=out, split=SplitMode(split),
                                      text_overlay=labels), tbox)
    assert (got.phase.value, got.frames_done, got.frames_total, got.error) == \
        (ref.phase.value, ref.frames_done, ref.frames_total, ref.error) == ("done", 10, 10, None)
    assert len(twriters) == len(jwriters) == 1 and twriters[0].released and jwriters[0].released
    assert twriters[0].size_wh == jwriters[0].size_wh
    a, b = np.stack(twriters[0].frames), np.stack(jwriters[0].frames)
    assert a.shape == b.shape and a.shape[0] == 10
    lsb = int(np.abs(a.astype(np.int16) - b).max())
    if mode == "none":
        assert lsb <= 1
    else:  # the chain's bar; the recorded frames are uniform noise (test_torch_engine.py)
        assert min(psnr_u8(x, y) for x, y in zip(a, b)) >= 40.0, f"max {lsb} LSB"
    tp, jp = tbox.latest(), jbox.latest()
    assert tp.processed.seq == jp.processed.seq == 9
    assert tp.processed.data.shape == jp.processed.data.shape
    np.testing.assert_array_equal(tp.original.data, jp.original.data)


class _AbortAt(BufferExportFrameSource):
    def __init__(self, frames, at, exporter):
        super().__init__(frames)
        self._at, self._exporter, self._n = at, exporter, 0

    def next(self):
        self._n += 1
        if self._n == self._at:
            self._exporter.abort()
        return super().next()


def test_exporter_abort_deletes_the_partial_file(recorded, tmp_path):
    out = str(tmp_path / "aborted.avi")
    exp = texporter.Exporter(device="cpu")
    source = _AbortAt(recorded, 4, exp)
    p = _run_exporter(exp, source, ExportRequest(
        config=ProcessorConfig(magnification=MOTION), output_path=out,
        format=ExportFormat.AVI_MJPG), None)
    assert p.phase is ExportPhase.ABORTED and p.frames_done == 4
    assert not os.path.exists(out)


def test_exporter_empty_range_is_an_error(tmp_path):
    out = str(tmp_path / "empty.avi")
    exp = texporter.Exporter(device="cpu")
    p = _run_exporter(exp, BufferExportFrameSource([]), ExportRequest(
        config=ProcessorConfig(), output_path=out, format=ExportFormat.AVI_MJPG), None)
    assert p.phase is ExportPhase.FAILED and p.error == "empty export range"
    assert not os.path.exists(out)


def test_exporter_writes_a_file_through_the_file_source(tmp_path):
    """FileExportFrameSource re-decodes [start, end) of a file; the cv2 writer
    and its codec fallback write the export."""
    import cv2

    from live_video_magnification_tpu_torch.io.video import write_video
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    src_path = write_video(str(tmp_path / "in.avi"), moving_clip(8, 32, 48, seed=2), 30.0,
                           fourcc="MJPG")
    out = str(tmp_path / "out.avi")
    exp = texporter.Exporter(device="cpu")
    p = _run_exporter(exp, FileExportFrameSource(src_path, 2, 7), ExportRequest(
        config=ProcessorConfig(magnification=MOTION), output_path=out,
        format=ExportFormat.AVI_MJPG), None)
    assert p.phase is ExportPhase.DONE and p.frames_done == p.frames_total == 5
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


def test_gray_panes_compose_as_cv2_gray2bgr():
    import cv2

    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (17, 30), dtype=np.uint8)
    bgr = rng.integers(0, 256, (17, 30, 3), dtype=np.uint8)
    np.testing.assert_array_equal(texporter._to_bgr(gray), cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
    assert texporter._to_bgr(bgr) is bgr
    for split in SplitMode:
        np.testing.assert_array_equal(
            texporter.compose(bgr, gray, split, False),
            jexporter.compose(bgr, gray, JSplit(split.value), False))


def test_exporter_preview_mailbox_and_record_source_without_cv2(recorded, monkeypatch):
    """The synthetic source renders and the Exporter composes without cv2
    (absent on the card's machine): only the writer needs it."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    writers = _memory_writers(monkeypatch, texporter)
    src = tsource.SyntheticSource(FramePool(2), BoundedQueue(2), Instrumentation(), 24, 32,
                                  channels=1)
    assert src._render(3).shape == (24, 32)
    box = LatestFrameMailbox()
    p = _run_exporter(texporter.Exporter(device="cpu"), BufferExportFrameSource(recorded),
                      ExportRequest(config=ProcessorConfig(grayscale=True), output_path="x.avi",
                                    split=SplitMode.LEFT_RIGHT), box)
    assert p.phase is ExportPhase.DONE, p.error
    assert len(writers[0].frames) == 10 and box.latest().processed.data.ndim == 2
