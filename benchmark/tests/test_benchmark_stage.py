"""The reader of ``staged_share.export`` (the clip export's ``export.stage``
spans over its ``export.step`` spans) on fixed spans, beside the span readers
of ``test_benchmark_spans.py``, and on the card in a traced run of each
sequential export cell."""

from __future__ import annotations

import pytest

from benchmark.run import run_cell
from live_video_magnification_tpu_torch.engine.profiling import Span
from test_benchmark_harness import SEED
from test_benchmark_spans import ROOT, SLICE_NS, US, _ctx, _export_spans, _read

NAME = "staged_share.export"


def _stage_spans(at=0, first=0, staged=(True, True, True, True)):
    """A chunk of frames ``first``, ``first`` + 1, ...: its ``export.h2d``,
    an ``export.stage`` for each frame that ``staged`` marks (frame 0's
    inside the ``export.h2d``, frame i+1's before frame i's ``export.step``),
    an ``export.step`` for each frame and its ``export.readback``."""
    n = len(staged)
    chunk = Span("export.chunk", first, at, at + 200 * US, thread=1)
    h2d = Span("export.h2d", first, at, at + 5 * US, 1, chunk, nbytes=n * 3 * 4 * 5,
               device_ms=0.2)
    held = [chunk, h2d, Span("export.readback", first, at + 170 * US, at + 200 * US, 1, chunk,
                             device_ms=0.6)]
    for i, s in enumerate(staged):
        t = at + (5 + 40 * i) * US
        if s:
            parent = h2d if i == 0 else chunk
            held.append(Span("export.stage", first + i, t - 5 * US, t - 2 * US, 1, parent,
                             nbytes=3 * 4 * 5, device_ms=0.1))
        held.append(Span("export.step", first + i, t, t + 30 * US, 1, chunk))
    return held


def test_the_staged_share_reader(monkeypatch):
    # frames of the measured window; the profiled chunk (none staged here) is left out
    ctx = _ctx(monkeypatch, _stage_spans(staged=(True, True, False, True))
               + _stage_spans(at=SLICE_NS, first=4, staged=(False,) * 4))
    assert _read(NAME, ctx) == pytest.approx(0.75)
    ctx = _ctx(monkeypatch, _stage_spans() + _stage_spans(at=SLICE_NS, first=4))
    assert _read(NAME, ctx) == pytest.approx(1.0)


def test_the_export_readers_count_a_staged_chunk_by_its_h2d(monkeypatch):
    """The chunk's one ``export.h2d`` still carries the chunk's bytes, so the
    readers that count a chunk's frames by it read a staged chunk a frame
    as an unstaged one."""
    ctx = _ctx(monkeypatch, _stage_spans() + _stage_spans(at=SLICE_NS, first=4))
    assert _read("step_issue_ms.export", ctx) == pytest.approx(30e-3)
    assert _read("readback_ms.export", ctx) == pytest.approx(30e-3 / 4)
    assert _read("copy_device_ms.export", ctx) == pytest.approx((0.2 + 0.6) / 4)


def test_an_unstaged_export_reads_zero_and_no_step_span_reads_none(monkeypatch):
    # the time-parallel path, or a program that copies each chunk whole
    ctx = _ctx(monkeypatch, _export_spans() + _export_spans(at=SLICE_NS))
    assert _read(NAME, ctx) == 0.0
    ctx = _ctx(monkeypatch, [])
    assert _read(NAME, ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["phase4k_export", "laplace720p_export"])
def test_a_traced_export_run_on_the_card_stages_every_window_frame(cuda_device, workload):
    r = run_cell(ROOT, workload, SEED, 4.0, True, device=cuda_device)
    assert r["correct"] and r["metrics"][NAME]["value"] == 1.0, r["metrics"]
