"""End-to-end demo of the PyTorch port: synthesize a clip with motion and
colour changes too subtle to see, then magnify it with all three Eulerian
pipelines through the port's CLI.

    python examples/demo_torch.py [outdir] [--device cuda|cpu]

Writes outdir/demo_in.avi plus one side-by-side (original | magnified) export
per mode. The clip carries three nearly invisible signals, one per pipeline:

  - ~0.35 px breathing displacement at 0.30 Hz  -> phase / laplace (motion)
  - a 1.1 Hz brightness pulse of ~1.5 u8        -> color (Eulerian color)
  - a static textured background so the motion has structure to ride on

On an NVIDIA card (``--device cuda``, the default) the exports run the
port's CUDA kernels; ``--device cpu`` runs the same code's plain PyTorch
path. OpenCV (cv2) writes and reads the clip, as ``magnify`` needs it to.
"""

import argparse
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# mode, flags tuned to the embedded signals
RUNS = [
    ("phase", ["--levels", "4", "--low", "0.2", "--high", "0.6",
               "--amplification", "30", "--wavelength", "40"]),
    ("laplace", ["--levels", "4", "--low", "0.2", "--high", "0.6",
                 "--amplification", "25", "--wavelength", "40"]),
    ("color", ["--levels", "3", "--low", "0.9", "--high", "1.3",
               "--amplification", "60"]),
]


def make_clip(path: str, seconds: float = 6.0, fps: float = 30.0,
              h: int = 240, w: int = 320) -> None:
    import cv2
    import numpy as np

    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(
        rng.random((h + 16, w + 16, 3)).astype(np.float32), (0, 0), 2.5)
    base = 0.25 + 0.5 * base  # mid-tone texture, room for the pulse

    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    n = int(seconds * fps)
    for i in range(n):
        t = i / fps
        dx = 0.35 * math.sin(2 * math.pi * 0.30 * t)   # breathing, sub-pixel
        dy = 0.20 * math.sin(2 * math.pi * 0.30 * t + 1.1)
        m = np.float32([[1, 0, dx], [0, 1, dy]])
        frame = cv2.warpAffine(base, m, (w + 16, h + 16))[8:8 + h, 8:8 + w]
        pulse = 1.0 + (1.5 / 255.0) * math.sin(2 * math.pi * 1.1 * t)  # ~1.5 u8
        wr.write(np.clip(frame * pulse * 255.0, 0, 255).astype(np.uint8))
    wr.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("outdir", nargs="?", default="demo_out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    clip = os.path.join(args.outdir, "demo_in.avi")
    print(f"synthesizing {clip} ...")
    make_clip(clip)

    # the port's package is importable from the repo root wherever this runs
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for mode, flags in RUNS:
        out = os.path.join(args.outdir, f"demo_{mode}.avi")
        cmd = [sys.executable, "-m", "live_video_magnification_tpu_torch.cli",
               "magnify", clip, out, "--mode", mode, "--chunk", "30",
               "--split", "left-right", "--labels", "--device", args.device, *flags]
        print(f"\n== {mode}: {' '.join(cmd)}", flush=True)
        rc = subprocess.call(cmd, env=env)
        if rc != 0:
            print(f"{mode} export failed (rc={rc})", file=sys.stderr)
            return rc
    print(f"\ndone — compare the panes in {args.outdir}/demo_*.avi")
    return 0


if __name__ == "__main__":
    sys.exit(main())
