#!/usr/bin/env python3
"""The desktop front ends' cells on one card, without the rest of chip_smoke.py.

    python3 tools/front_end_cells.py

Prints the card's nvidia-smi name and power limit, builds the port's
kernels, then runs chip_smoke.py's front-end phases with their checks:
``gui_flow_1080p`` (the GUI's record -> export flow, bit for bit a fresh
chain), ``gl_present`` (or its "skipped" line where PyOpenGL or EGL is
missing) and ``live_4k30`` / ``live_4k30_gui`` alternately, twice (the
GUI's canvas present on the display loop beside the plain run); one JSON
line each, then the seconds they took.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import torch

    import chip_smoke as cs
    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import halo as hl
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl

    if not torch.cuda.is_available():
        print("front_end_cells: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    cs.log(phase="build", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cs.gui_flow_1080p(torch, dev, st, tl, hl)
    cs.gl_present(torch, dev, st, tl, hl)
    cs.live_4k30_runs(torch, dev, st, tl, hl)
    cs.log(phase="front_end_cells", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
