"""The reader of ``graph_replay_share.export`` (the clip export's ``export.replay``
spans over its ``export.step`` spans) on fixed spans, beside the span readers
of ``test_benchmark_spans.py``, and on the card in a traced run of each export
cell; and on the card, a wrong tile in every replayed 4K frame is not
``correct``."""

from __future__ import annotations

import pytest

from benchmark.run import run_cell
from live_video_magnification_tpu_torch.engine.profiling import Span
from live_video_magnification_tpu_torch.models import riesz as riesz_mode
from test_benchmark_harness import SEED
from test_benchmark_spans import ROOT, SLICE_NS, US, _ctx, _export_spans, _read

NAME = "graph_replay_share.export"


def _replay_spans(at=0, first=0, replayed=(False, True, True, True)):
    """A chunk of frames ``first``, ``first`` + 1, ..., an ``export.replay``
    inside each ``export.step`` that ``replayed`` marks."""
    chunk = Span("export.chunk", first, at, at + 200 * US, thread=1)
    held = [chunk]
    for i, r in enumerate(replayed):
        t = at + 40 * i * US
        step = Span("export.step", first + i, t, t + 30 * US, 1, chunk)
        held.append(step)
        if r:
            held.append(Span("export.replay", first + i, t + US, t + 2 * US, 1, step))
    return held


def test_the_replay_share_reader(monkeypatch):
    # frames of the measured window; the profiled chunk (all eager here) is left out
    ctx = _ctx(monkeypatch, _replay_spans() + _replay_spans(at=SLICE_NS, first=4,
                                                            replayed=(False,) * 4))
    assert _read(NAME, ctx) == pytest.approx(0.75)
    ctx = _ctx(monkeypatch, _replay_spans(replayed=(True,) * 4))
    assert _read(NAME, ctx) == pytest.approx(1.0)


def test_an_eager_export_reads_zero_and_no_step_span_reads_none(monkeypatch):
    # a failed capture, or a program without the step graph: every frame eager
    ctx = _ctx(monkeypatch, _export_spans() + _export_spans(at=SLICE_NS))
    assert _read(NAME, ctx) == 0.0
    ctx = _ctx(monkeypatch, [])
    assert _read(NAME, ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["phase4k_export", "laplace720p_export"])
def test_a_traced_export_run_on_the_card_replays_every_window_frame(cuda_device, workload):
    r = run_cell(ROOT, workload, SEED, 4.0, True, device=cuda_device)
    assert r["correct"] and r["metrics"][NAME]["value"] >= 0.99, r["metrics"]


@pytest.mark.cuda
def test_a_wrong_tile_in_every_replayed_frame_is_not_correct(cuda_device, monkeypatch):
    """One 128x64 tile of every frame after the first wrong in the 4K export,
    whose frames replay the step captured on frame 1: a fault in the step
    reaches every replayed frame only if it is there from the first steady
    frame on (the graph does not re-read a host condition of its own). About
    990 pixels a million: ``over4_ppm`` fails it, ``over1_ppm`` passes it."""
    step = riesz_mode.step

    def altered(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        if state.count > 0:
            out = out.clone()
            out[..., 256:384, 512:576] = out[..., 256:384, 512:576] // 2 + 3
        return new_state, out

    monkeypatch.setattr(riesz_mode, "step", altered)
    r = run_cell(ROOT, "phase4k_export", SEED, 3.0, False, device=cuda_device)
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert r["checks"]["over4_ppm"]["value"] > r["checks"]["over4_ppm"]["limit"]
    assert r["checks"]["over1_ppm"]["value"] <= r["checks"]["over1_ppm"]["limit"]
