"""The configuration ``phase_4k_l6_tp`` (``lvmt magnify --time-parallel``)
and its cell ``phase4k_export_tp``: the cell at a CPU size against the plain
phase reference, a wrong answer and a state that never moves caught, the bf16
control failing, and on the card a traced run at the cell's size reading the
stage spans and the scan's share of its roofline."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.run import run_cell
from live_video_magnification_tpu_torch.models import riesz as riesz_mode
from test_benchmark_harness import SEED, _run, _small_copy

ROOT = Path(__file__).resolve().parents[2]
CELL = "phase4k_export_tp"
STAGES = ("build", "difference", "scan", "amplify", "collapse")


@pytest.fixture
def small(tmp_path):
    bench = _small_copy(tmp_path)
    path = bench / "configs" / "phase_4k_l6_tp.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), height=135, width=240,
                                    levels=4)))
    return tmp_path, bench


def test_the_configuration_is_the_sequential_ones_by_the_time_parallel_form():
    seq = json.loads((ROOT / "benchmark" / "configs" / "phase_4k_l6.json").read_text())
    tp = json.loads((ROOT / "benchmark" / "configs" / "phase_4k_l6_tp.json").read_text())
    differ = {k for k in set(seq) | set(tp) if seq.get(k) != tp.get(k)}
    assert differ == {"name", "source", "deployment", "assumed", "controls", "clip_processor"}
    assert tp["clip_processor"] == {"time_parallel": True}
    assert set(tp["controls"]) == {"tf32_reference", "bf16_reference"}
    assert tp["limits"] == seq["limits"] and tp["mode"] == "phase"


def test_the_cell_runs_and_agrees_on_the_cpu(small):
    root, bench = small
    r = _run(root, bench, CELL)
    assert r["correct"] and r["notes"]["frames_compared"] >= 2, (r["checks"], r["notes"])
    assert set(r["metrics"]) == {"export_fps", "setup_s"}
    t = _run(root, bench, CELL, trace=True)
    assert t["correct"]
    # no card: the spans have no CUDA events, so the stage readers stay silent
    assert t["metrics"]["step_issue_ms.export"]["value"] > 0
    assert not {m for m in t["metrics"] if m.startswith("tp_")}, t["metrics"]
    c = _run(root, bench, CELL, seconds=0.3, control="bf16_reference")
    assert not c["correct"], c["checks"]


def test_an_altered_answer_is_not_correct(small, monkeypatch):
    root, bench = small
    clip = riesz_mode.process_clip_parallel

    def altered(frames, dyn, **kw):
        state, out = clip(frames, dyn, **kw)
        if kw["state"].count > 0:
            out = out.clone()
            out[:, :, 8:24, 8:24] = out[:, :, 8:24, 8:24] // 2 + 3
        return state, out

    monkeypatch.setattr(riesz_mode, "process_clip_parallel", altered)
    r = _run(root, bench, CELL)
    # 256 pixels of 32,400: under over1_ppm's limit, over over4_ppm's
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["over4_ppm"]["value"] > r["checks"]["over4_ppm"]["limit"]


def test_a_chunk_that_keeps_its_state_is_not_correct(small, monkeypatch):
    """Every chunk starts from the zero state, as a clip's first does."""
    root, bench = small
    clip = riesz_mode.process_clip_parallel

    def stuck(frames, dyn, **kw):
        _, out = clip(frames, dyn, **kw)
        return kw["state"], out

    monkeypatch.setattr(riesz_mode, "process_clip_parallel", stuck)
    r = _run(root, bench, CELL)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_stage(cuda_device):
    r = run_cell(ROOT, CELL, SEED, 6.0, True, device=cuda_device)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for stage in STAGES:
        assert m[f"tp_{stage}_device_ms.export"] > 0, m
    assert 0 < m["tp_scan_roofline"] <= 100, m
    assert m["launches_per_frame.export"] > 0 and m["stencils_roofline"] > 0, m
