#!/usr/bin/env python3
"""Run one cell of the benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics; their files lie under ``benchmark/``.
The run makes its clip from the seed on the card, builds the program
(``live_video_magnification_tpu_torch``) through its public entries, warms
up every shape the mix uses (set-up, timed as ``setup_s`` from the start of
the process to the first timed frame), measures for ``--seconds``, then
checks the frames against the plain reference (``benchmark/reference/``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` profiles a
short steady slice of the window and prints the per-layer metrics, with the
device's busy time and a breakdown. The numbers compared for ``correct`` go
to standard error as its last lines, and under ``checks``, the last key of
the result. Without a CUDA card, without as many cards as the cell asks for,
or with JAX or the JAX package loaded, the run exits non-zero and prints no
result. The program's kernels build into ``build/`` of the checkout on the
first run and load from there after it.
"""

from __future__ import annotations

import time

PROCESS_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.cell import BENCH_DIR, load_cell  # noqa: E402

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "live_video_magnification_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def environment(root: Path, flags: dict):
    """The program's kernel flags as the configuration states them, and every
    compile cache inside the checkout, for the length of one run."""
    cache = root / "build" / "benchmark_cache"
    values = {"TRITON_CACHE_DIR": str(cache / "triton"),
              "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"), "USE_FLAX": "0",
              **{k: str(v) for k, v in flags.items()}}
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, control: str = None, bench_dir: Path = BENCH_DIR,
             start: float = PROCESS_START, traffic_changes: dict = None) -> dict:
    """One run of one cell; returns the result line as a dict. ``control``
    names a lower-precision arm of the configuration's ``controls`` (read by
    ``readings.py``, never by the benchmark's own runs); ``traffic_changes``
    overrides parameters of the mix (``sweep.py``'s rates)."""
    cell = load_cell(root, workload, bench_dir)
    cell.traffic.update(traffic_changes or {})
    arm = cell.config["controls"][control] if control else {}
    with environment(root, {**cell.config["flags"], **arm.get("flags", {})}):
        return _run(cell, seed, seconds, trace, device, arm, start, bench_dir)


def _run(cell, seed, seconds, trace, device, arm, start, bench_dir) -> dict:
    cfg = cell.config
    import torch

    from benchmark.harness import compare, readers, traffic
    from benchmark.harness.clip import make_clip
    from benchmark.harness.trace import Tracer, breakdown

    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", 0)
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    kind = traffic.load_kind(bench_dir, cell.traffic["kind"])
    clip = make_clip(cfg["clip"], cfg["height"], cfg["width"], cfg["capture_fps"],
                     (cfg["low_hz"], cfg["high_hz"]), seed, device, kind.LAYOUT)
    tracer = Tracer(trace, device)
    window = kind.run(traffic.Run(cfg, cell.traffic, clip, seconds, seed, device, tracer))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"error: modules loaded in the run: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cfg["limits"]
    worst, compared, bad = compare.replay(window, clip, cfg, device, limits, bench_dir, arm)
    lost = window.attempted - window.completed - int(window.notes.get("queue_drops", 0)) \
        - int(window.notes.get("pool_drops", 0))
    failed = bad + len(window.passthrough) + max(0, lost)
    checks = compare.judge(worst, limits)
    correct = failed == 0 and compared > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if trace:
        ctx = readers.Context(window, tracer.reduce(), tracer.span, cfg)
        for name, read in cell.per_layer.items():
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.per_layer_units[name]}
    else:
        values = dict(window.end_to_end, setup_s=window.setup_end - start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and tracer.slice is not None:
        dev["busy_s"] = tracer.slice.busy_s
        dev["window_s"] = tracer.slice.window_s
        result["breakdown"] = breakdown(tracer.slice)
    result["notes"] = dict(window.notes, frames_compared=compared, lost=max(0, lost),
                           passthrough=len(window.passthrough), trace_retries=tracer.retries,
                           **worst)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"error: modules loaded in the run: {', '.join(found)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()

    import torch

    chips = load_cell(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
