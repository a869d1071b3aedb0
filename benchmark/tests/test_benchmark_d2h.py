"""The reader of ``d2h_device_ms.export`` (the clip export's per-frame
``export.d2h`` copy spans) on fixed spans, beside the span readers of
``test_benchmark_spans.py``, and on the card in a traced run of each export
cell."""

from __future__ import annotations

import pytest

from benchmark.run import run_cell
from live_video_magnification_tpu_torch.engine import profiling
from live_video_magnification_tpu_torch.engine.profiling import Span
from test_benchmark_harness import SEED
from test_benchmark_spans import ROOT, SLICE_NS, US, _ctx, _export_spans, _read

NAME = "d2h_device_ms.export"


def _d2h_spans(at=0, first=0, device_ms=(0.9, 1.3, 1.0)):
    """A chunk of frames ``first``, ``first`` + 1, ... with each frame's
    ``export.d2h`` after its ``export.step``."""
    chunk = Span("export.chunk", first, at, at + 100 * US, thread=1)
    held = [chunk]
    for i, ms in enumerate(device_ms):
        t = at + 30 * i * US
        held += [Span("export.step", first + i, t, t + 25 * US, 1, chunk),
                 Span("export.d2h", first + i, t + 25 * US, t + 26 * US, 1, chunk,
                      nbytes=2 * 3 * 4 * 5, device_ms=ms)]
    return held


def test_the_d2h_reader(monkeypatch):
    # the median frame; the profiled chunk (slower under the profiler) is left out
    ctx = _ctx(monkeypatch, _d2h_spans() + _d2h_spans(at=SLICE_NS, first=3,
                                                      device_ms=(5.0, 5.0, 5.0)))
    assert _read(NAME, ctx) == pytest.approx(1.0)
    # a frame whose events were not read is left out
    ctx = _ctx(monkeypatch, _d2h_spans(device_ms=(0.9, None, 1.3)))
    assert _read(NAME, ctx) == pytest.approx(1.1)


def test_no_d2h_span_is_none(monkeypatch):
    # a program that reads back pageable stacks (the parent), or the CPU: no such span
    ctx = _ctx(monkeypatch, _export_spans() + _export_spans(at=SLICE_NS))
    assert _read(NAME, ctx) is None
    ctx = _ctx(monkeypatch, _d2h_spans(device_ms=(None, None, None)))
    assert _read(NAME, ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda t0, t1: [])
    assert _read(NAME, ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["phase4k_export", "laplace720p_export"])
def test_a_traced_export_run_on_the_card_reads_the_d2h_metric(cuda_device, workload):
    r = run_cell(ROOT, workload, SEED, 4.0, True, device=cuda_device)
    assert r["correct"] and r["metrics"][NAME]["value"] > 0, r["metrics"]
