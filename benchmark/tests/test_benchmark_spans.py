"""The readers of the program's spans (``harness/spans.py`` and the
``program_span`` metrics that read them) on fixed spans and gaps, the gaps kept beside
``reduce_events``'s outputs, traced runs on the CPU, and, on the card, a
traced run of each cell reading every one of them."""

from __future__ import annotations

import dataclasses
import math
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import readers, spans, trace
from benchmark.harness.cell import load_reader
from benchmark.run import run_cell
from live_video_magnification_tpu_torch.engine import profiling
from live_video_magnification_tpu_torch.engine.profiling import Span
from test_benchmark_harness import SEED, _run, _small_copy

ROOT = Path(__file__).resolve().parents[2]
LIVE = ("step_issue_ms.live", "readback_ms.live", "copy_device_ms.live")
EXPORT = ("step_issue_ms.export", "readback_ms.export", "idle_in_issue_ms.export",
          "copy_device_ms.export")
US = 1_000


def _read(name, ctx):
    return load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")(ctx)


SLICE_NS = 1_000_000  # the profiled slice: ctx.span = (1 ms, 2 ms)


def _live_spans(at=0, slow=1):
    held = []
    for seq, (step, back, dev) in enumerate([(2, 5, (0.1, 0.5)), (3, 6, (0.2, 0.6)),
                                             (4, 7, (0.3, 0.7)), (9, 9, (0.4, None))]):
        t = at + seq * 30 * US
        frame = Span("consumer.frame", seq, t, t + 20 * slow * US, thread=1)
        held += [frame,
                 Span("consumer.h2d", seq, t, t + US, 1, frame, device_ms=dev[0]),
                 Span("consumer.step", seq, t + US, t + (1 + step * slow) * US, 1, frame),
                 Span("consumer.readback", seq, t + 10 * US, t + (10 + back * slow) * US, 1,
                      frame, device_ms=dev[1])]
    return held


def _export_spans(at=0):
    chunk = Span("export.chunk", 0, at, at + 100 * US, thread=1)
    return [chunk, Span("export.h2d", 0, at, at + 10 * US, 1, chunk, nbytes=2 * 3 * 4 * 5,
                        device_ms=0.2),
            Span("export.step", 0, at + 10 * US, at + 40 * US, 1, chunk),
            Span("export.step", 1, at + 40 * US, at + 70 * US, 1, chunk),
            Span("export.readback", 0, at + 80 * US, at + 100 * US, 1, chunk, device_ms=0.6)]


GAPS_US = [(5, 15), (50, 60), (72, 78), (90, 95), (120, 130)]  # 41 us idle, from the slice's start


def _ctx(monkeypatch, held):
    """A traced run's context: ``held`` recorded, a slice from 1 ms to 2 ms with GAPS_US."""
    monkeypatch.setattr(profiling, "spans", lambda t0, t1: [
        s for s in held if s.start_ns <= t1 * 1e9 and s.end_ns >= t0 * 1e9])
    gaps = np.array([[profiling.to_trace_ns(SLICE_NS + a * US),
                      profiling.to_trace_ns(SLICE_NS + b * US)] for a, b in GAPS_US])
    sl = trace.Slice(0.001, 0.0005, 2, {}, {}, 0, {}, {})
    sl.gaps = gaps
    window = types.SimpleNamespace(setup_end=0.0)
    return readers.Context(window, sl, (SLICE_NS * 1e-9, 2 * SLICE_NS * 1e-9),
                           {"height": 4, "width": 5})


def test_the_live_readers(monkeypatch):
    # the frames inside the profiled slice read slower; they are left out
    ctx = _ctx(monkeypatch, _live_spans() + _live_spans(at=SLICE_NS, slow=3))
    assert _read("step_issue_ms.live", ctx) == pytest.approx(3.5e-3)
    assert _read("readback_ms.live", ctx) == pytest.approx(6.5e-3)
    # the frame whose readback events were not read is left out
    assert _read("copy_device_ms.live", ctx) == pytest.approx(0.8)


def test_the_export_readers(monkeypatch):
    ctx = _ctx(monkeypatch, _export_spans() + _export_spans(at=SLICE_NS)[:-1])
    assert _read("step_issue_ms.export", ctx) == pytest.approx(30e-3)
    assert _read("readback_ms.export", ctx) == pytest.approx(10e-3)
    # two frames a chunk; the profiled chunk is left out
    assert _read("copy_device_ms.export", ctx) == pytest.approx(0.4)
    unread = _export_spans()
    unread[-1].device_ms = None  # a chunk whose readback events were not read is left out
    ctx = _ctx(monkeypatch, unread)
    assert _read("copy_device_ms.export", ctx) is None
    profiled = _export_spans(at=SLICE_NS)
    ctx = _ctx(monkeypatch, _export_spans() + profiled)
    # 15 us of idle inside the steps, over the slice's 2 frames
    assert _read("idle_in_issue_ms.export", ctx) == pytest.approx(7.5e-3)
    split = spans.idle_split(ctx.slice.gaps, profiled)
    assert {k: round(v * 1e6, 6) for k, v in split.items()} == {
        "export.chunk": 6.0, "export.h2d": 5.0, "export.step": 15.0, "export.readback": 5.0,
        "outside": 10.0}


def test_nothing_to_read_is_none(monkeypatch):
    ctx = _ctx(monkeypatch, [])
    for name in LIVE + EXPORT:
        assert _read(name, ctx) is None
    monkeypatch.setattr(spans, "_RECORDER", False)  # a program without the recorder
    ctx = _ctx(monkeypatch, _export_spans() + _live_spans() + _export_spans(at=SLICE_NS))
    for name in LIVE + EXPORT:
        assert _read(name, ctx) is None


def test_the_gaps_come_beside_the_reduction():
    spans.install()
    spans.install()
    ms = 1_000_000
    events = [
        ("stencil9_kernel<1>", True, 0, 2 * ms), ("band5_kernel", True, 1 * ms, 3 * ms),
        ("Memcpy HtoD (Pageable -> Device)", True, 5 * ms, 6 * ms),
        ("Memcpy DtoH (Device -> Pageable)", True, 9 * ms, 10 * ms),
        ("aten::add", True, 6 * ms, 7 * ms), ("Activity Buffer Request", True, 0, 10 * ms),
        ("engine.queue_pop", False, 7 * ms, 9 * ms), ("aten::copy_", False, 3 * ms, 5 * ms),
        ("outer", False, 0, 10 * ms)]
    # a program span over kernels, and the profiler's device-side shadow of it
    shadowed = events + [("export.step", False, 2 * ms, 9 * ms),
                         ("export.step", True, 2 * ms, 9 * ms)]
    sl = trace.reduce_events(shadowed, 0.010, frames=2)
    plain = trace.reduce_events.__wrapped__(events, 0.010, frames=2)
    assert dataclasses.asdict(sl) == dataclasses.asdict(plain)
    assert math.isclose(sl.busy_s, 0.006)
    assert sl.gaps.tolist() == [[3 * ms, 5 * ms], [7 * ms, 9 * ms]]
    assert trace.reduce_events.__wrapped__(shadowed, 0.010, frames=2).busy_s > 0.009
    assert spans.device_gaps([]).shape == (0, 2)
    # a device event named as a host event that is none of the program's spans stays
    named = events + [("aten::add", False, 6 * ms, 7 * ms)]
    assert spans.device_work(named) == named


def test_the_traced_runs_read_the_spans_on_the_cpu(tmp_path):
    root, bench = tmp_path, _small_copy(tmp_path)
    for workload, host in (("laplace720p_live50", LIVE[:2]), ("laplace720p_export", EXPORT[:2])):
        r = _run(root, bench, workload, trace=True, seconds=0.8)
        assert r["correct"] and all(r["metrics"][m]["value"] > 0 for m in host), r["metrics"]
        # no card: no CUDA events and no device gaps
        assert not {"copy_device_ms.live", "copy_device_ms.export",
                    "idle_in_issue_ms.export"} & set(r["metrics"])
    assert not profiling._on
    u = _run(root, bench, "laplace720p_export", seconds=0.5)
    assert not set(LIVE + EXPORT) & set(u["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,names", [("phase4k_export", EXPORT),
                                            ("laplace720p_live50", LIVE),
                                            ("laplace720p_export", EXPORT)])
def test_a_traced_run_on_the_card_reads_every_span_metric(cuda_device, workload, names):
    r = run_cell(ROOT, workload, SEED, 4.0, True, device=cuda_device)
    assert r["correct"]
    for name in names:
        assert r["metrics"][name]["value"] > 0, (name, r["metrics"])
