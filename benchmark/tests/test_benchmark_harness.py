"""The harness on the CPU at tiny sizes: a cell made of new files only, the
judgement of wrong, passed-through and lost frames, the trace reduction, the
stencils' counts, and ``BENCHMARK.json`` against its contract."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import roofline
from benchmark.harness.cell import load_cell
from benchmark.harness.trace import breakdown, reduce_events
from benchmark.run import run_cell
from live_video_magnification_tpu_torch.models import motion as motion_mode
from live_video_magnification_tpu_torch.models import riesz as riesz_mode
from live_video_magnification_tpu_torch.models.chain import MagnificationChain

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SIZES = {"phase_4k_l6": dict(height=135, width=240, levels=4),
         "laplace_720p_l5": dict(height=72, width=128, levels=3)}
SEED = 2**31 + 11


def _small_copy(tmp_path: Path, extra_cells=(), extra_layer=()) -> Path:
    """The benchmark's files in ``tmp_path`` with every configuration cut to
    a CPU size, plus any cells and per-layer metrics given."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, size in SIZES.items():
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **size)))
    b = json.loads(json.dumps(BENCH))
    b["workloads"] += list(extra_cells)
    b["per_layer"] += list(extra_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return bench


def _run(root, bench, workload, trace=False, seconds=0.6, **kw):
    torch.set_num_threads(2)
    return run_cell(root, workload, SEED, seconds, trace, device="cpu", bench_dir=bench, **kw)


NEW_KIND = '''"""A kind added as a file: frames one at a time through ``process_chunk``."""
import time
from benchmark.harness import program
from benchmark.harness.traffic import Window

LAYOUT = "tchw"


def run(r):
    proc = program.clip_processor(r.cfg, r.device)
    n, done, samples = r.clip.shape[0], 0, {}
    proc.process_chunk(r.clip[0:1])
    t0 = time.monotonic()
    while time.monotonic() - t0 < r.seconds or done < 2:
        processed, original = proc.process_chunk(r.clip[(1 + done) % n][None])
        samples[1 + done] = (processed[0].copy(), original[0].copy())
        done += 1
    window = time.monotonic() - t0
    return Window(window, done, done, {"export_fps": done / window},
                  [i % n for i in range(1 + done)], samples, "chw", [], [], {}, setup_end=t0)
'''

NEW_REFERENCE = '''"""A reference added as a file for a mode no cell had: it marks that it ran."""
from pathlib import Path


class Reference:
    def __init__(self, cfg, device, dtype):
        Path(__file__).with_suffix(".ran").write_text(cfg["mode"])

    def step(self, frame_u8):
        return frame_u8
'''


def test_a_cell_of_new_files_only(tmp_path):
    """New cells, a configuration of a mode no cell had (colour) with its own
    reference, a mix of a new kind and a per-layer metric, all as new files:
    the harness finds each by name and needs no edit."""
    bench = _small_copy(
        tmp_path,
        extra_cells=[{"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix",
                      "chips": 1, "why": "a test"},
                     {"name": "dummy_kind_cell", "config": "dummy_lap", "traffic": "dummy_kind",
                      "chips": 1, "why": "a test"},
                     {"name": "dummy_color_cell", "config": "dummy_color", "traffic": "dummy_mix",
                      "chips": 1, "why": "a test"}],
        extra_layer=[{"name": "dummy_frames", "unit": "frames", "better": "higher",
                      "source": "program_counter", "layer": "step", "moves": "export_fps"}])
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    next(m for m in b["end_to_end"] if m["name"] == "export_fps")["workloads"] += [
        "dummy_cell", "dummy_kind_cell", "dummy_color_cell"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = dict(json.loads((bench / "configs" / "phase_4k_l6.json").read_text()),
               name="dummy_cfg", height=96, width=160, levels=3)
    cfg["clip"]["frames"] = 16
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    lap = dict(json.loads((bench / "configs" / "laplace_720p_l5.json").read_text()),
               name="dummy_lap", height=72, width=128, levels=3)
    lap["clip"]["frames"] = 16
    (bench / "configs" / "dummy_lap.json").write_text(json.dumps(lap))
    color = dict(cfg, name="dummy_color", mode="color", reference="dummy_color_ref",
                 amplification=100, low_hz=0.84, high_hz=1.43)
    (bench / "configs" / "dummy_color.json").write_text(json.dumps(color))
    (bench / "reference" / "dummy_color_ref.py").write_text(NEW_REFERENCE)
    (bench / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"kind": "closed", "chunk": 8, "warmup_chunks": 1}))
    (bench / "traffic" / "dummy_kind.json").write_text(json.dumps({"kind": "one_by_one"}))
    (bench / "kinds" / "one_by_one.py").write_text(NEW_KIND)
    (bench / "metrics" / "dummy_frames.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.sequence))\n")

    r = _run(tmp_path, bench, "dummy_cell")
    assert r["correct"] and r["failed"] == 0, r
    assert set(r["metrics"]) == {"export_fps", "setup_s"}
    assert r["device"]["platform"] == "cpu"  # a CPU run never claims to be the card
    t = _run(tmp_path, bench, "dummy_cell", trace=True)
    assert t["correct"]
    assert t["metrics"]["dummy_frames"]["value"] >= 16
    # the device readers find no card in a CPU trace and stay silent
    assert "launches_per_frame.export" not in t["metrics"]
    assert list(r)[-1] == "checks"

    k = _run(tmp_path, bench, "dummy_kind_cell")
    assert k["correct"] and k["notes"]["frames_compared"] >= 2, (k["checks"], k["notes"])
    # the colour path of the program, judged by the new reference (which
    # returns its input, so the magnified frames do not match it)
    c = _run(tmp_path, bench, "dummy_color_cell")
    assert (bench / "reference" / "dummy_color_ref.ran").read_text() == "color"
    assert c["notes"]["frames_compared"] >= 2 and set(c["checks"]) == set(color["limits"])


def test_a_configuration_passes_preprocess_and_clip_options_through():
    """ROI, downscale and grayscale go into ``ProcessorConfig`` as the file
    gives them, and ``clip_processor``'s options into ``ClipProcessor``."""
    from benchmark.harness import program

    cfg = dict(json.loads((ROOT / "benchmark" / "configs" / "phase_4k_l6.json").read_text()),
               height=96, width=160, levels=3, grayscale=False,
               preprocess={"downscale": 2, "roi_enabled": True, "roi_x": 0.25, "roi_y": 0.25,
                           "roi_w": 0.5, "roi_h": 0.5},
               clip_processor={"time_parallel": True})
    pc = program.processor_config(cfg)
    assert pc.preprocess.downscale == 2 and pc.preprocess.roi_enabled
    assert (pc.preprocess.roi_x, pc.preprocess.roi_w) == (0.25, 0.5)
    assert program.clip_processor(cfg, "cpu").time_parallel is True
    plain = program.processor_config(json.loads(
        (ROOT / "benchmark" / "configs" / "phase_4k_l6.json").read_text()))
    assert plain.preprocess.downscale == 1 and not plain.preprocess.roi_enabled


@pytest.fixture
def small(tmp_path):
    return tmp_path, _small_copy(tmp_path)


def test_the_cells_run_and_agree_on_the_cpu(small):
    root, bench = small
    for w in ("phase4k_export", "laplace720p_live50"):
        r = _run(root, bench, w)
        assert r["correct"], (w, r)
        assert r["notes"]["frames_compared"] >= 2


def test_a_passthrough_counts_as_failed(small, monkeypatch):
    """The consumer publishes the input as both panes when the chain raises."""
    root, bench = small

    def broken(self, frame, cfg):
        raise RuntimeError("forced")

    monkeypatch.setattr(MagnificationChain, "process", broken)
    r = _run(root, bench, "laplace720p_live50")
    assert r["failed"] > 0 and not r["correct"]
    assert r["notes"]["proc_errors"] > 0


def _alter(out):
    out = out.clone()
    out[:, 8:48, 8:48] = out[:, 8:48, 8:48] // 2 + 3
    return out


@pytest.mark.parametrize("workload,module", [("phase4k_export", riesz_mode),
                                             ("laplace720p_export", motion_mode),
                                             ("laplace720p_live50", motion_mode)])
def test_an_altered_answer_is_not_correct(small, monkeypatch, workload, module):
    root, bench = small
    step = module.step

    def altered(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        return new_state, (_alter(out) if state.count > 2 else out)

    monkeypatch.setattr(module, "step", altered)
    r = _run(root, bench, workload)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["over1_ppm"]["value"] > r["checks"]["over1_ppm"]["limit"]


@pytest.mark.parametrize("workload,module", [("phase4k_export", riesz_mode),
                                             ("laplace720p_export", motion_mode)])
def test_a_step_that_keeps_its_state_is_not_correct(small, monkeypatch, workload, module):
    root, bench = small
    step = module.step

    def stuck(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        return (new_state if state.count == 0 else state), out

    monkeypatch.setattr(module, "step", stuck)
    r = _run(root, bench, workload)
    assert not r["correct"]


def test_the_controls_are_not_correct(small):
    """The bf16 reference in the program's place fails both configurations'
    limits at a CPU size."""
    root, bench = small
    for workload in ("phase4k_export", "laplace720p_export"):
        r = _run(root, bench, workload, control="bf16_reference")
        assert not r["correct"], (workload, r["checks"])


def test_the_fast_control_departs_on_the_cpu(small):
    """The program's own bf16 path (``--fast``) engages only on levels whose
    short side is at least 96, two of them at 270x480: it reads far above the
    f32 program there, and fails the limit at the cell's size on the card
    (``test_the_fast_control_fails_on_the_card``)."""
    root, bench = small
    path = bench / "configs" / "phase_4k_l6.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), height=270, width=480)))
    plain = _run(root, bench, "phase4k_export")["checks"]["over1_ppm"]["value"]
    fast = _run(root, bench, "phase4k_export", control="fast")["checks"]["over1_ppm"]["value"]
    assert fast > 20 * max(plain, 10.0), (plain, fast)


@pytest.mark.cuda
def test_the_fast_control_fails_on_the_card(cuda_device):
    r = run_cell(ROOT, "phase4k_export", SEED, 4.0, False, device=cuda_device, control="fast")
    assert not r["correct"], r["checks"]
    r = run_cell(ROOT, "laplace720p_export", SEED, 4.0, False, device=cuda_device,
                 control="bf16_reference")
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,module,number", [("phase4k_export", riesz_mode, "over4_ppm"),
                                                    ("laplace720p_live50", motion_mode,
                                                     "over1_ppm")])
def test_a_wrong_tile_at_the_cells_size_is_not_correct(cuda_device, monkeypatch, workload,
                                                       module, number):
    """One 128x64 tile of every frame wrong, at the cell's own size (the tile
    of a stencil kernel). At 4K that is about 990 pixels a million, under
    ``over1_ppm``'s limit there: ``over4_ppm`` fails it; at 720p it is about
    8,900, over ``over1_ppm``'s."""
    step = module.step

    def altered(state, frame, dyn, **kw):
        new_state, out = step(state, frame, dyn, **kw)
        if state.count > 2:
            out = out.clone()
            out[..., 256:384, 512:576] = out[..., 256:384, 512:576] // 2 + 3
        return new_state, out

    monkeypatch.setattr(module, "step", altered)
    r = run_cell(ROOT, workload, SEED, 3.0, False, device=cuda_device)
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
    if number != "over1_ppm":
        assert r["checks"]["over1_ppm"]["value"] <= r["checks"]["over1_ppm"]["limit"]


def test_stencil_counts_match_the_kernel_table():
    """Launches and bounds of K1-K4 a 4K frame: the kernel table's bound column
    at level 0 (0.0198, 0.0297, 0.0124, 0.0124 ms, all bytes) and its
    launches a frame (10, 5, 5, 5 at 4K; 9, 4, 4, 5 at 1080p, K5 on 68x120)."""
    costs = roofline.launch_costs(2160, 3840, 6)
    ms = {n: round(roofline.bound_seconds(b, o)[0] * 1e3, 4) for n, lvl, b, o in costs if lvl == 0}
    assert ms == {"conv9": 0.0198, "band5": 0.0297, "lp9_decimate": 0.0124, "lp9_inject": 0.0124}
    assert all(roofline.bound_seconds(b, o)[1] == "bytes" for _, lvl, b, o in costs if lvl == 0)
    count = lambda c: {k: sum(1 for n, *_ in c if n == k)
                       for k in ("conv9", "band5", "lp9_decimate", "lp9_inject")}
    assert count(costs) == {"conv9": 10, "band5": 5, "lp9_decimate": 5, "lp9_inject": 5}
    assert count(roofline.launch_costs(1080, 1920, 6)) == {
        "conv9": 9, "band5": 4, "lp9_decimate": 4, "lp9_inject": 5}
    # level 2 of 4K: 540x960, half the bytes of level 1 a side
    lvl2 = [b for n, lvl, b, o in costs if n == "band5" and lvl == 2]
    assert lvl2 == [3 * 540 * 960 * 4]


def test_trace_reduction():
    ms = 1_000_000
    events = [  # (name, on the device, start ns, end ns)
        ("stencil9_kernel<1>", True, 0, 2 * ms), ("band5_kernel", True, 1 * ms, 3 * ms),
        ("Memcpy HtoD (Pageable -> Device)", True, 5 * ms, 6 * ms),
        ("Memcpy DtoH (Device -> Pageable)", True, 9 * ms, 10 * ms),
        ("aten::add", True, 6 * ms, 7 * ms), ("Activity Buffer Request", True, 0, 10 * ms),
        ("engine.queue_pop", False, 7 * ms, 9 * ms), ("aten::copy_", False, 3 * ms, 5 * ms),
        ("outer", False, 0, 10 * ms)]
    sl = reduce_events(events, 0.010, frames=2)
    assert math.isclose(sl.busy_s, 0.006)
    assert sl.kernel_count == 3 and sl.copy_seconds == {"HtoD": 0.001, "DtoH": 0.001}
    assert {k: round(v, 6) for k, v in sl.idle_by_host.items()} == {
        "aten::copy_": 0.002, "engine.queue_pop": 0.002}
    bd = breakdown(sl)
    assert bd["device_ops"][0][0] == "stencil9_kernel<1>" and len(bd["idle_gaps"]) == 2


def test_the_stencil_share_counts_every_launch():
    costs = roofline.launch_costs(2160, 3840, 6)
    least = sum(roofline.bound_seconds(b, o)[0] for _, _, b, o in costs)
    names = {"void stencil9_kernel<1, 32>": 15, "void band5_kernel<128>": 5,
             "void inject9_kernel<32>": 5}
    per = least / 25
    secs = {n: c * per * 2 for n, c in names.items()}  # every launch at half its roofline
    share = roofline.stencil_share(secs, names, 1, 2160, 3840, 6)
    assert math.isclose(share, 50.0)
    assert roofline.stencil_share(secs, dict(names, **{"void band5_kernel<128>": 4}),
                                  1, 2160, 3840, 6) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_its_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        held = json.loads((ROOT / c["file"]).read_text())
        assert held["reduced"] == c["reduced"] and held["name"] == c["name"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layer = {m["name"]: m for m in b["per_layer"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", [w["name"] for w in b["workloads"]]))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").is_file()
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{w['config']}.json").read_text())
        ref = cfg.get("reference", cfg["mode"])
        assert (ROOT / "benchmark" / "reference" / f"{ref}.py").is_file()
        assert len(w["why"]) <= 200
        cell = load_cell(ROOT, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert len(json.dumps(b)) < 64 * 1024 and not set(layer) & set(e2e)


def test_run_exits_without_a_card(tmp_path):
    """No card (this machine), or a checkout that holds only the benchmark:
    a non-zero exit and no result line."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "phase4k_export",
                              "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=cwd, timeout=120)
        assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_tf32_changes_nothing_on_the_card(cuda_device):
    """The reference in TF32 in the program's place reads as the f32 one: no
    f32 operation of these paths runs on tensor cores, so the control is bf16."""
    r = run_cell(ROOT, "laplace720p_export", SEED, 4.0, False, device=cuda_device,
                 control="tf32_reference")
    assert r["correct"] and r["checks"]["over1_ppm"]["value"] == 0.0
