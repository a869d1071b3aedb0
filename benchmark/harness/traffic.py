"""The one generator of traffic: a mix is a data file, ``traffic/<mix>.json``,
whose ``kind`` names the module that runs it, ``kinds/<kind>.py``.

A kind is a module with ``LAYOUT`` (the host layout of the clip it feeds:
"tchw" chunks or "thwc" camera frames) and ``run(run: Run) -> Window``. It
drives the program through its public entries for ``run.seconds``, records
the clip index of every frame in the order the program processed it (so the
reference replays exactly that sequence), and keeps the panes of a sample of
frames, drawn from the seed. A later mix of a known kind is a new data file;
a new kind is a new file beside the others. Nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List

import numpy as np

from benchmark.harness.trace import Tracer

SAMPLES = 16  # frames compared a run, about


@dataclasses.dataclass
class Stamp:
    seq: int
    due: float
    pop: float
    pub: float


@dataclasses.dataclass
class Window:
    seconds: float                  # the window's length
    attempted: int                  # frames due (camera) or processed (export) in it
    completed: int                  # frames whose result came back in it
    end_to_end: Dict[str, float]
    sequence: List[int]             # clip index of every processed frame, in order
    samples: Dict[int, tuple]       # position in ``sequence`` -> (processed, original)
    layout: str                     # "chw" or "hwc" panes
    passthrough: List[int]          # positions the program passed through on an error
    stamps: List[Stamp]             # camera: every window frame published
    notes: Dict[str, float]
    setup_end: float = 0.0


@dataclasses.dataclass
class Run:
    """What a kind's ``run`` gets: the configuration and mix as their files hold them,
    the clip made from the seed, and the run's device and tracer."""
    cfg: dict
    traffic: dict
    clip: np.ndarray
    seconds: float
    seed: int
    device: object
    tracer: Tracer


def pick(rng: np.random.Generator, n: int, k: int) -> set:
    return set(rng.choice(n, size=min(k, n), replace=False).tolist())


def load_kind(bench_dir: Path, kind: str):
    path = Path(bench_dir) / "kinds" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_kind_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
