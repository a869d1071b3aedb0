"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the root of the checkout lists the cells. A cell names
its configuration (``<bench>/configs/<config>.json``) and its traffic mix
(``<bench>/traffic/<traffic>.json``); the mix's ``kind`` names the module that runs it
(``<bench>/kinds/<kind>.py``, found by ``traffic.load_kind``), the
configuration's ``reference`` (or ``mode``) its plain reference
(``<bench>/reference/<name>.py``, found by ``compare.reference``); each
per-layer metric is a reader of its own (``<bench>/metrics/<metric>.py``, a
function ``read(ctx)``). A later cell, configuration, mix, kind, reference or
metric is a new file: nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCHMARK_FILE = "BENCHMARK.json"
BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]       # this cell's end-to-end metrics, setup_s included
    per_layer: Dict[str, Callable]  # metric name -> read(ctx)
    per_layer_units: Dict[str, str]


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = json.loads((root / BENCHMARK_FILE).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {BENCHMARK_FILE}: {sorted(cells)}")
    w = cells[workload]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    reported = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=e2e,
        per_layer={m["name"]: load_reader(bench_dir / "metrics" / f"{m['name']}.py")
                   for m in layer},
        per_layer_units={m["name"]: m["unit"] for m in layer})
