#!/usr/bin/env python3
"""The live engine's cells on one card, without the rest of chip_smoke.py.

    python3 tools/live_cells.py

Prints the card's nvidia-smi name and power limit, builds the port's
kernels, then runs chip_smoke.py's live phases with their checks:
``engine_consumer_4k`` (and its profile), ``live_4k30``, ``live_1080p60``,
``live_1080p60_roi`` on the Python and the native transport, and
``record_export_1080p``; one JSON line each, then the seconds they took.
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
        print("live_cells: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build()
    cs.log(phase="build", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cs.engine_consumer_4k(torch, dev, st, tl, hl)
    cs.live_phases(torch, dev, st, tl, hl)
    cs.record_export_1080p(torch, dev, st, tl, hl)
    cs.log(phase="live_cells", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
