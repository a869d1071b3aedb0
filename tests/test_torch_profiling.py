"""The port's span recorder (``engine/profiling.py``) on the CPU.

Off, a span is a shared null context that records nothing and enters no
``record_function``; on, spans nest by thread, take their parent's id where
they have none, the ring keeps its bound, the live consumer and the clip
export open their spans at the layer boundaries, the colour step opens its
three inside the consumer's and one for each operator it builds, each copy
span lands on the profiler's clock beside its ``record_function`` twin while
a device span has none, and the outputs are bit for bit those of a run with
the recorder off.
"""

import statistics
import threading
import time

import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch.engine import profiling
from live_video_magnification_tpu_torch.engine.config import AtomicConfig
from live_video_magnification_tpu_torch.engine.frame import Frame
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.processing import ProcessingChain
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue, OverflowPolicy
from live_video_magnification_tpu_torch.export.batch import ClipProcessor, export_frames
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    MagUiValues,
    ProcessorConfig,
    to_params,
)
from live_video_magnification_tpu_torch.ops.temporal import ideal_bandpass_operator

torch.set_num_threads(2)

H, W = 24, 32


def _cfg(mode=MagnificationMode.LAPLACE) -> ProcessorConfig:
    return ProcessorConfig(magnification=to_params(
        MagUiValues(mode=mode, amplification=20, levels=2, chroma=30)))


def _color_cfg(fps: float = 8.0) -> ProcessorConfig:
    """Colour at ``fps``: a window of optimal_buffer_size(fps) frames (16 at 8 fps)."""
    return ProcessorConfig(magnification=to_params(MagUiValues(
        mode=MagnificationMode.COLOR, amplification=100, low=0.8, high=1.2, levels=2,
        capture_fps=fps)))


def _clip(t: int, seed: int = 0) -> np.ndarray:
    """[T, H, W, 3] u8."""
    return np.random.default_rng(seed).integers(0, 256, (t, H, W, 3), dtype=np.uint8)


@pytest.fixture
def recorder():
    t0 = time.monotonic()
    profiling.enable()
    try:
        yield lambda: profiling.spans(t0, time.monotonic())
    finally:
        profiling.disable()


def test_off_records_nothing_and_enters_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    t0 = time.monotonic()
    assert profiling.span("a") is profiling.span("b", 1, copy=torch.device("cpu"), nbytes=8)
    with profiling.span("a", 1) as s:
        assert s is None
    ClipProcessor(_cfg(), H, W, 3, device="cpu").process_chunk(_clip(2).transpose(0, 3, 1, 2))
    assert profiling.spans(t0, time.monotonic()) == []


def test_spans_nest_by_thread(recorder):
    ready = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.span(f"{tag}.outer", tag):
            ready.wait()
            with profiling.span(f"{tag}.inner", tag):
                ready.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in recorder()}
    assert set(got) == {"x.outer", "x.inner", "y.outer", "y.inner"}
    for tag in "xy":
        outer, inner = got[f"{tag}.outer"], got[f"{tag}.inner"]
        assert outer.parent is None and inner.parent is outer
        assert inner.thread == outer.thread and inner.id == tag
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert got["x.outer"].thread != got["y.outer"].thread


def test_a_span_without_an_id_takes_its_parents(recorder):
    with profiling.span("outer", 7):
        with profiling.span("inner"):
            with profiling.span("own", 9):
                with profiling.span("deepest"):
                    pass
    with profiling.span("alone"):
        pass
    got = {s.name: s.id for s in recorder()}
    assert got == {"outer": 7, "inner": 7, "own": 9, "deepest": 9, "alone": None}


def test_copy_spans_read_as_before_and_device_spans_have_no_twin(recorder, monkeypatch):
    """A ``copy=`` span enters its ``record_function`` twin and carries its
    bytes, as before; a ``device=`` span enters none; neither has CUDA events
    off a card."""
    entered = []
    twin = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or twin(name))
    cpu = torch.device("cpu")
    with profiling.span("x.copy", 3, copy=cpu, nbytes=64):
        with profiling.span("x.region", device=cpu):
            pass
    copy, region = sorted(recorder(), key=lambda s: s.start_ns)
    assert entered == ["x.copy"]
    assert (copy.name, copy.id, copy.nbytes, copy.device_ms) == ("x.copy", 3, 64, None)
    assert (region.parent, region.id, region.nbytes, region.device_ms) == (copy, 3, 0, None)


def test_the_ring_keeps_its_bound(recorder, monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    monkeypatch.setattr(profiling, "_ring", [None] * 8)
    for i in range(20):
        with profiling.span("s", i):
            pass
    held = recorder()
    assert [s.id for s in held] == list(range(12, 20))


class _KeepAll(LatestFrameMailbox):
    def __init__(self):
        super().__init__()
        self.all = []

    def publish(self, frame):
        super().publish(frame)
        self.all.append(frame)


def _consume(frames: np.ndarray, cfg: ProcessorConfig = None):
    queue = BoundedQueue(4, OverflowPolicy.BLOCK)
    mailbox = _KeepAll()
    chain = ProcessingChain(queue, mailbox, AtomicConfig(cfg or _cfg()), Instrumentation(), "cpu")
    chain.start()
    try:
        for seq, data in enumerate(frames):
            queue.push(Frame(seq=seq, capture_ts=time.monotonic(), width=W, height=H,
                             data=data.copy()))
        end = time.monotonic() + 60
        while len(mailbox.all) < len(frames) and time.monotonic() < end:
            time.sleep(0.005)
    finally:
        queue.stop()
        chain.stop()
    assert len(mailbox.all) == len(frames)
    return [(f.processed.data, f.original.data) for f in mailbox.all]


def test_the_consumer_spans_each_frame(recorder):
    _consume(_clip(3))
    held = recorder()
    frames = {s.id: s for s in held if s.name == "consumer.frame"}
    assert sorted(frames) == [0, 1, 2]
    parts = ["consumer.h2d", "consumer.step", "consumer.readback", "consumer.publish"]
    for seq, frame in frames.items():
        assert frame.parent is None
        kids = [s for s in held if s.parent is frame]
        assert [s.name for s in kids] == parts and all(s.id == seq for s in kids)
        assert frame.start_ns <= kids[0].start_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[-1].end_ns <= frame.end_ns
        assert kids[0].nbytes == H * W * 3 and kids[2].nbytes == 2 * H * W * 3
        assert kids[0].device_ms is None  # CUDA events only on a card


def test_the_colour_step_spans_each_frame_under_the_consumer(recorder):
    _consume(_clip(4), _color_cfg())
    held = recorder()
    steps = {s.id: s for s in held if s.name == "consumer.step"}
    assert sorted(steps) == [0, 1, 2, 3]
    parts = ["color.pyramid", "color.bandpass", "color.reconstruct"]
    for seq, step in steps.items():
        kids = [s for s in held if s.parent is step]
        # the first frame passes through once the window holds it: nothing to reconstruct
        assert [s.name for s in kids] == (parts[:2] if seq == 0 else parts)
        assert all(s.id == seq and s.device_ms is None for s in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert step.start_ns <= kids[0].start_ns and kids[-1].end_ns <= step.end_ns


def test_an_operator_is_built_once_for_each_window_length(recorder):
    """The window of 16 fills over the first 16 frames: frames 1..15 (lengths
    2..16) each build their operator inside ``color.bandpass``; the full
    window's frames build none."""
    ideal_bandpass_operator.cache_clear()
    _consume(_clip(24), _color_cfg(fps=8.0))
    held = recorder()
    builds = [s for s in held if s.name == "color.operator"]
    assert [s.id for s in builds] == list(range(1, 16))
    assert all(s.parent.name == "color.bandpass" and s.parent.id == s.id for s in builds)
    _consume(_clip(3), _color_cfg(fps=8.0))  # a new stream: every length is cached
    assert len([s for s in recorder() if s.name == "color.operator"]) == 15


@pytest.mark.parametrize("time_parallel", [False, True])
def test_the_export_spans_each_chunk(recorder, time_parallel):
    proc = ClipProcessor(_cfg(), H, W, 3, time_parallel=time_parallel, device="cpu")
    chunk = np.ascontiguousarray(_clip(4).transpose(0, 3, 1, 2))
    proc.process_chunk(chunk[:2])
    proc.process_chunk(chunk[2:])
    held = recorder()
    chunks = [s for s in held if s.name == "export.chunk"]
    assert [s.id for s in chunks] == [0, 2]
    for c in chunks:
        kids = [s for s in held if s.parent is c]
        steps = ["export.step"] if time_parallel else ["export.step"] * 2
        assert [s.name for s in kids] == ["export.h2d", *steps, "export.readback"]
        assert [s.id for s in kids[1:-1]] == ([c.id] if time_parallel else [c.id, c.id + 1])
        assert kids[0].nbytes == 2 * 3 * H * W and kids[-1].nbytes == 2 * 2 * 3 * H * W


@pytest.mark.parametrize("time_parallel", [False, True])
def test_the_cpu_export_reads_back_without_a_copy_stream(recorder, time_parallel):
    """On the CPU the processor has no copy stream: no ``export.d2h`` span,
    one ``export.readback`` a chunk holding both stacks' bytes, and the
    chunk's ``export.h2d`` with its frames' bytes."""
    proc = ClipProcessor(_cfg(), H, W, 3, time_parallel=time_parallel, device="cpu")
    assert proc._copies is None
    chunk = np.ascontiguousarray(_clip(5).transpose(0, 3, 1, 2))
    proc.process_chunk(chunk[:3])
    proc.process_chunk(chunk[3:])
    held = recorder()
    assert not [s for s in held if s.name == "export.d2h"]
    readbacks = [s for s in held if s.name == "export.readback"]
    assert [s.id for s in readbacks] == [0, 3]
    assert [s.nbytes for s in readbacks] == [2 * 3 * 3 * H * W, 2 * 2 * 3 * H * W]
    assert [s.nbytes for s in held if s.name == "export.h2d"] == [3 * 3 * H * W, 2 * 3 * H * W]
    assert all(s.device_ms is None for s in readbacks)


def test_spans_land_beside_their_record_function_twins(recorder):
    proc = ClipProcessor(_cfg(), H, W, 3, device="cpu")
    chunk = np.ascontiguousarray(_clip(3).transpose(0, 3, 1, 2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            proc.process_chunk(chunk)
    held = recorder()
    twins = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("export."):
            twins.setdefault(e.name(), []).append(e.start_ns())
    assert sorted(len(v) for v in twins.values()) == [3, 3, 3, 9]
    off = []
    for s in held:
        mapped = profiling.to_trace_ns(s.start_ns)
        off.append(min(abs(t - mapped) for t in twins[s.name]))
    assert len(off) == 18 and max(off) < 1_000_000, statistics.median(off)


def test_outputs_are_the_same_with_the_recorder_on():
    clip = np.ascontiguousarray(_clip(5, seed=3).transpose(0, 3, 1, 2))

    def outputs():
        exported = [x for pair in export_frames(clip, _cfg(), chunk_size=2, device="cpu")
                    for x in pair]
        return exported + [x for pair in _consume(clip.transpose(0, 2, 3, 1)) for x in pair]

    off = outputs()
    profiling.enable()
    try:
        on = outputs()
    finally:
        profiling.disable()
    assert len(off) == len(on) == 6 + 10
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_the_colour_frames_are_the_same_with_the_recorder_off(monkeypatch):
    """Off, the colour step and the operator builds record nothing and enter
    no ``record_function``; the frames are bit for bit those of a run with
    the recorder on."""
    clip = _clip(20, seed=4)
    cfg = _color_cfg()

    def outputs():
        ideal_bandpass_operator.cache_clear()
        exported = [x for pair in export_frames(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)),
                                                cfg, chunk_size=8, device="cpu") for x in pair]
        return exported + [x for pair in _consume(clip, cfg) for x in pair]

    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    t0 = time.monotonic()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", entered)
        off = outputs()
    assert profiling.spans(t0, time.monotonic()) == []
    profiling.enable()
    try:
        on = outputs()
    finally:
        profiling.disable()
    assert {"color.pyramid", "color.operator"} <= {s.name for s in
                                                    profiling.spans(t0, time.monotonic())}
    assert len(off) == len(on) == 3 * 2 + 20 * 2  # three chunks of both panes, 20 pairs
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_the_anchor_maps_onto_the_wall_clock():
    offset = profiling.anchor()
    mono, wall = time.monotonic_ns(), time.time_ns()
    assert abs(mono + offset - wall) < 1_000_000
    assert not hasattr(profiling, "DeviceProfiler") and not hasattr(profiling, "annotate")
