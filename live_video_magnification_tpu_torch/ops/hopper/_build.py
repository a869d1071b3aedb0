"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, into ``build/lvmt_torch_kernels/`` at the root of the checkout, under a
file name keyed by a digest of the source and the flags, so an edited source
is rebuilt and an unchanged one is not. Nothing is built or imported when this
module is imported; a machine without ``nvcc`` can import it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES: Dict[str, str] = {"stencils": "stencils.cu", "tail": "tail.cu", "halo": "halo.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir() -> Path:
    """``build/lvmt_torch_kernels`` beside the package, at the checkout root."""
    return Path(__file__).resolve().parents[3] / "build" / "lvmt_torch_kernels"


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"liblvmt_{name}_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is missing, one nvcc per source, all
    started together. Returns the library paths. The compiler's register and
    shared-memory report goes to ``<library>.log``."""
    paths = {n: library_path(n) for n in names}
    missing = {n: p for n, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in missing.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed (once per process)."""
    return ctypes.CDLL(str(build([name])[name]))


def launch(fn: Callable[..., int], what: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream; raise if it returns a CUDA error (a refused launch never runs,
    and no later synchronize reports it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with cudaError {err}")
