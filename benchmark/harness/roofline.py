"""Peaks of the card and the least time the pyramid stencils need.

The counts are those of the program's ``chip_smoke.py::time_phase``: each
input byte read once and each output byte written once, f32; the operations
of the taps that are not zero, a multiply and an add each. A bound is the
larger of bytes over the memory peak and operations over the f32 peak, and
names which of the two it is. They depend only on a level's shape, so the
count is the same whatever kernel does the work.

The phase step runs per band level (every level but the residual) the 9x9
high-pass (conv9), its Riesz pair (band5) and the 2*LP9 decimation
(lp9_decimate), except where the level's short side is 16 to 95 (a
one-pass build there: K5), and in the collapse the zero-injected upsample
(lp9_inject) and the high-pass again: at 2160x3840 levels 6, K1 10, K2 5,
K3 5, K4 5 launches a frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.common import HIGHPASS9, RIESZ_BAND

# NVIDIA H100 SXM data sheet, dense, at the full 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
F32 = 4
FUSED_FROM, SPLIT_FROM = 16, 96  # short sides: one-pass build in [16, 96), K1-K3 from 96
# the device kernels of K1-K4 by name (stencil9_kernel is K1 and K3)
KERNEL_NAMES = ("stencil9_kernel", "band5_kernel", "inject9_kernel")


def level_sizes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    sizes = []
    for i in range(levels):
        sizes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return sizes


def launch_costs(h: int, w: int, levels: int) -> List[Tuple[str, int, int, int]]:
    """Every K1-K4 launch of one frame: (kernel, level, bytes, operations)."""
    nnz = lambda k: int(np.count_nonzero(k))
    out = []
    sizes = level_sizes(h, w, levels)
    for lvl, ((lh, lw), (sh, sw)) in enumerate(zip(sizes[:-1], sizes[1:])):
        hw, shw = lh * lw, sh * sw
        if not FUSED_FROM <= min(lh, lw) < SPLIT_FROM:  # K5 builds those levels
            out += [("conv9", lvl, 2 * hw * F32, 2 * nnz(HIGHPASS9) * hw),
                    ("band5", lvl, 3 * hw * F32, 2 * 2 * nnz(RIESZ_BAND) * hw),
                    ("lp9_decimate", lvl, (hw + shw) * F32, 2 * 81 * shw)]
        out += [("lp9_inject", lvl, (shw + hw) * F32, 2 * 81 * hw // 4),  # 81/4 taps an output
                ("conv9", lvl, 2 * hw * F32, 2 * nnz(HIGHPASS9) * hw)]
    return out


def bound_seconds(nbytes: float, ops: float) -> Tuple[float, str]:
    b, o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(b, o), ("bytes" if b >= o else "operations")


def stencil_share(op_seconds: Dict[str, float], op_counts: Dict[str, int], frames: int,
                  h: int, w: int, levels: int) -> Optional[float]:
    """K1-K4's bound time over their measured device time, in percent, for
    ``frames`` frames of the slice; None where the slice's launches are not
    exactly the frames' (another kernel does the work, or the slice is cut)."""
    launches = launch_costs(h, w, levels)
    names = [n for n in op_seconds if any(k in n for k in KERNEL_NAMES)]
    if not names or sum(op_counts[n] for n in names) != frames * len(launches):
        return None
    least = frames * sum(bound_seconds(b, o)[0] for _, _, b, o in launches)
    return 100.0 * least / sum(op_seconds[n] for n in names)
