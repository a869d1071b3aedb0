#!/usr/bin/env python3
"""The time mesh over every card of one machine, without the rest of
chip_smoke.py.

    python3 tools/time_mesh_cards.py

Builds the port's kernels (making chip_smoke.py's 4K clip of TP_CHUNK
frames meanwhile), then, for each mode of chip_smoke.TP_MODES: the unsharded
time-parallel path and the mesh of TM_SHARDS virtual shards of cuda:0 on the
same chunk (one JSON line, ``virtual_baseline``); chip_smoke.py's
``slice_time_mesh_multi_gpu`` (one shard a card, with ``over_one_card``
against the virtual shards; "skipped" on one card) and
``distributed_2rank`` (NCCL where there are two cards or more); and the
``cuda`` tests of the time mesh and of the cross-card branch
(``-k "time_mesh or across_two_cards"``). Every line carries the card's name;
the nvidia-smi line of each card comes first.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import halo as hl
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    dev = resolve_device("cuda")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.build)
        frames = cs.frames_4k(t=cs.TP_CHUNK)
        building.result()
    tchw = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    t, h, w = tchw.shape[0], tchw.shape[2], tchw.shape[3]
    modules = (st, tl, hl)
    virtual = {}
    for mode in cs.TP_MODES:
        cfg = cs.tp_cfg(mode)
        with cs.flag_env({}):
            proc = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=dev)
            ref, sec, _, _ = cs.run_clip(torch, dev, proc, [tchw], modules)
            del proc
            outs, secs, _, peak, _ = cs.run_time_mesh(torch, [dev] * cs.TM_SHARDS, cfg, [tchw],
                                                      modules)
        cs.log(phase="virtual_baseline", mode=cs.TP_NAMES[mode],
               card=torch.cuda.get_device_name(dev), shards=cs.TM_SHARDS,
               unsharded_ms_per_frame=1e3 * sec / t, mesh_ms_per_frame=1e3 * secs[0] / t,
               peak_memory_bytes=peak,
               against_unsharded=cs.tm_check("virtual shards", outs[0], ref, mode == "phase"))
        virtual[mode] = (ref, 1e3 * secs[0] / t)
    cs.slice_time_mesh_multi_gpu(torch, st, tl, hl, frames, virtual)
    del virtual, frames, tchw
    cs.distributed_2rank(torch, dev)
    tests = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
                            "tests/test_torch_cuda.py", "-q", "-p", "no:cacheprovider",
                            "-k", "time_mesh or across_two_cards"],
                           cwd=HERE, capture_output=True, text=True, timeout=900)
    print(tests.stdout[-3000:], flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
