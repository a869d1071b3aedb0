"""Nothing the benchmark or the program loads is JAX or the JAX package.

Every module of ``benchmark/`` (its metric readers and traffic kinds loaded
by path, as ``run.py`` loads them) and of ``live_video_magnification_tpu_torch`` is
imported in a fresh interpreter; the top-level name of each module then
loaded (the part before the first dot) is compared whole with the forbidden
names, so ``live_video_magnification_tpu_torch`` is not taken for
``live_video_magnification_tpu``. The plain reference imports nothing of the
program.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "live_video_magnification_tpu"}
PORT = "live_video_magnification_tpu_torch"

WALK = f"""
import importlib, json, pkgutil, sys
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
roots = sys.argv[1:]
for name in roots:
    pkg = importlib.import_module(name)
    for m in pkgutil.walk_packages(pkg.__path__, name + "."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
if "benchmark" in roots:
    from benchmark.harness.cell import BENCH_DIR, load_reader
    from benchmark.harness.traffic import load_kind
    for path in sorted((BENCH_DIR / "metrics").glob("*.py")):
        load_reader(path)
    for path in sorted((BENCH_DIR / "kinds").glob("*.py")):
        load_kind(BENCH_DIR, path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""


def _top_level_names(*packages) -> set:
    out = subprocess.run([sys.executable, "-c", WALK, *packages], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_the_benchmark_or_the_program():
    names = _top_level_names("benchmark", PORT)
    assert PORT in names and "benchmark" in names
    assert not names & FORBIDDEN, sorted(names & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names("benchmark.reference")
    assert PORT not in names and not names & FORBIDDEN


def test_the_reference_sources_name_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & (FORBIDDEN | {PORT}), (path.name, tops)


def test_the_names_are_compared_whole():
    tops = {m.split(".")[0] for m in (f"{PORT}.engine.queue", "jax_free.x", "flaxen")}
    assert not tops & FORBIDDEN
    assert {"jax"} == {m.split(".")[0] for m in ("jax.numpy",)} & FORBIDDEN
