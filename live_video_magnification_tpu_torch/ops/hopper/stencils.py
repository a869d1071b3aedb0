"""The Riesz pyramid's four stencils: CUDA kernels for Hopper and their plain
PyTorch versions.

Each public function takes [H, W] float32 contiguous tensors. On a CUDA
tensor it launches its kernel from ``csrc/stencils.cu`` on the current stream
(or raises); on a CPU tensor it runs the plain version beside it, the
composition of ``ops/conv.py`` functions that the kernel must equal. There is
no switch and no fallback.

================  =========================================  ======================
function          replaces (reference package)               bound at 2160x3840
================  =========================================  ======================
conv9             ops/pallas/conv9_mxu.py::conv9_mxu         bytes ~ operations
band5             ops/pallas/conv9_mxu.py::band5_mxu         bytes
lp9_decimate      ops/pallas/conv9_mxu.py::lp9_decimate_mxu  bytes
lp9_inject        ops/pallas/conv9_mxu.py::lp9_inject_mxu    bytes
================  =========================================  ======================

The design notes (tiles, reflect-101 by index mirroring, the exact tap order)
are at the top of the CUDA source. Unlike the TPU kernels, these take any side
of at least 5 (reflect-101 with a 4-px reach), odd sides included, so the
port needs no size gate: every pyramid level runs its kernel.

``LAUNCHES`` counts the kernel launches of each function; a run that resets
it can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import (
    correlate2d,
    correlate_cols,
    correlate_rows,
)
from live_video_magnification_tpu_torch.ops.hopper._build import launch, load_library
from live_video_magnification_tpu_torch.ops.resize import resize_nearest_even_inject

LAUNCHES = {"conv9": 0, "band5": 0, "lp9_decimate": 0, "lp9_inject": 0}

MIN_SIDE = 5


# ---------------------------------------------------------------- plain versions


def conv9_plain(x: torch.Tensor, k9) -> torch.Tensor:
    return correlate2d(x, k9)


def band5_plain(hp: torch.Tensor, taps) -> Tuple[torch.Tensor, torch.Tensor]:
    return correlate_rows(hp, taps), correlate_cols(hp, taps)


def lp9_decimate_plain(x: torch.Tensor, k9) -> torch.Tensor:
    return correlate2d(x, k9)[::2, ::2].contiguous()


def lp9_inject_plain(small: torch.Tensor, k9, out_hw: Tuple[int, int]) -> torch.Tensor:
    return correlate2d(resize_nearest_even_inject(small, out_hw), k9)


# ---------------------------------------------------------------- launching


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("stencils")
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "lvmt_conv9": [p, p, i, i, p, p],
        "lvmt_lp9_decimate": [p, p, i, i, p, p],
        "lvmt_band5": [p, p, p, i, i, p, p],
        "lvmt_lp9_inject": [p, p, i, i, i, i, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_plane(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: expected an [H, W] plane, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if min(x.shape) < MIN_SIDE:
        raise ValueError(
            f"{what}: sides {tuple(x.shape)} below {MIN_SIDE}: reflect-101 with a "
            "4-px reach is undefined"
        )
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _taps(k, n: int) -> np.ndarray:
    t = np.ascontiguousarray(np.asarray(k, dtype=np.float32).reshape(-1))
    if t.size != n:
        raise ValueError(f"expected {n} taps, got {t.size}")
    return t


def _launch(name: str, device: torch.device, *args) -> None:
    launch(getattr(_lib(), "lvmt_" + name), name, device, *args)
    LAUNCHES[name] += 1


def conv9(x: torch.Tensor, k9) -> torch.Tensor:
    """correlate2d(x, k9), 9x9, reflect-101: [H, W] -> [H, W]."""
    _check_plane(x, "conv9")
    taps = _taps(k9, 81)
    if x.device.type == "cpu":
        return conv9_plain(x, taps.reshape(9, 9))
    out = torch.empty_like(x)
    h, w = x.shape
    _launch("conv9", x.device, x.data_ptr(), out.data_ptr(), h, w, taps.ctypes.data)
    return out


def band5(hp: torch.Tensor, taps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correlate_rows(hp, taps), correlate_cols(hp, taps)), 5 taps, reflect-101."""
    _check_plane(hp, "band5")
    t5 = _taps(taps, 5)
    if hp.device.type == "cpu":
        return band5_plain(hp, t5)
    r = torch.empty_like(hp)
    i = torch.empty_like(hp)
    h, w = hp.shape
    _launch("band5", hp.device, hp.data_ptr(), r.data_ptr(), i.data_ptr(), h, w,
            t5.ctypes.data)
    return r, i


def lp9_decimate(x: torch.Tensor, k9) -> torch.Tensor:
    """correlate2d(x, k9)[::2, ::2]: [H, W] -> [ceil(H/2), ceil(W/2)]."""
    _check_plane(x, "lp9_decimate")
    taps = _taps(k9, 81)
    if x.device.type == "cpu":
        return lp9_decimate_plain(x, taps.reshape(9, 9))
    h, w = x.shape
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=x.dtype, device=x.device)
    _launch("lp9_decimate", x.device, x.data_ptr(), out.data_ptr(), h, w, taps.ctypes.data)
    return out


def lp9_inject(small: torch.Tensor, k9, out_hw: Tuple[int, int]) -> torch.Tensor:
    """correlate2d(resize_nearest_even_inject(small, out_hw), k9): [h, w] ->
    out_hw, for any out_hw with ceil(out/2) <= the small side."""
    _check_plane(small, "lp9_inject")
    taps = _taps(k9, 81)
    h, w = (int(v) for v in out_hw)
    sh, sw = small.shape
    if min(h, w) < MIN_SIDE or (h + 1) // 2 > sh or (w + 1) // 2 > sw:
        raise ValueError(f"lp9_inject: target {out_hw} does not fit source {(sh, sw)}")
    if small.device.type == "cpu":
        return lp9_inject_plain(small, taps.reshape(9, 9), (h, w))
    out = torch.empty((h, w), dtype=small.dtype, device=small.device)
    _launch("lp9_inject", small.device, small.data_ptr(), out.data_ptr(), sh, sw, h, w,
            taps.ctypes.data)
    return out
