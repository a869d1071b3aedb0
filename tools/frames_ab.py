#!/usr/bin/env python3
"""Compare the 4K frames of the PyTorch port with an earlier commit's, under
every configuration of chip_smoke.py, on one CUDA card.

    git archive <commit> live_video_magnification_tpu_torch | tar -x -C build/parent
    python3 tools/frames_ab.py build/parent [--frames 4]

The port under PARENT and the port of this checkout each run in a process of
their own: chip_smoke.py's 2160x3840 levels=6 clip (its first ``--frames``
frames) through MagnificationChain under each configuration of
chip_smoke.CONFIGS, the u8 frames written to build/frames_ab/<tree>/. Then,
for each configuration, one JSON line: the pixels (channel values) that
differ between the two trees and the largest difference. The frames are
deleted at the end.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "frames_ab")


def _smoke():
    """chip_smoke.py of this checkout (configurations, clip, chain runner)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_frames",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: str, frames: int) -> int:
    """Every configuration's frames with the port importable from the
    working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl

    if not torch.cuda.is_available():
        print("frames_ab: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    clip = smoke.frames_4k(t=frames)
    cfg = smoke.cfg_4k()
    os.makedirs(os.path.join(OUT, tree), exist_ok=True)
    for name, (flags, _) in smoke.CONFIGS.items():
        with smoke.flag_env(flags):
            out = smoke.run_chain(torch, dev, clip, cfg, (st, tl))[0]
        np.save(os.path.join(OUT, tree, f"{name}.npy"), out)
        del out
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="a directory holding the earlier port")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        return run_tree(args.tree, args.frames)
    if not args.parent:
        ap.error("give the parent tree")
    shutil.rmtree(OUT, ignore_errors=True)
    for tree, root in (("parent", os.path.abspath(args.parent)), ("change", HERE)):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                               "--frames", str(args.frames)], cwd=root, timeout=1200)
        if done.returncode:
            return done.returncode
    for name in _smoke().CONFIGS:
        a = np.load(os.path.join(OUT, "parent", f"{name}.npy"))
        b = np.load(os.path.join(OUT, "change", f"{name}.npy"))
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        print(json.dumps(dict(phase="frames_ab", config=name, shape=list(a.shape),
                              differing=int(np.count_nonzero(diff)),
                              max_lsb=int(diff.max()))), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
