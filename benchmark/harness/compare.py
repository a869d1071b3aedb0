"""Whether the timed path produced the right frames.

After the window has closed and the program's state is freed, the plain
reference (``benchmark/reference/``) replays on the device exactly the
sequence of clip frames the program processed, from the first frame of
set-up on, carrying its own state; at each sampled position it is compared
with the panes the program returned there:

* ``over1_ppm``, ``over4_ppm``, ``over8_ppm``: pixels of the processed pane
  more than 1, 4 or 8 LSB away from the reference's, per million, in the
  worst sampled frame;
* ``max_lsb``: the largest difference of a processed pixel, in the worst frame;
* ``original_max_lsb``: the original pane against the input frame (exact).

A frame the program passed through on an error, and a frame due in the
window whose result never came, count as failed, whatever the numbers say.
Each number compared has its limit in the configuration's file
(``limits``); the numbers without one are printed and not judged. A
configuration holds ``over1_ppm`` against the rounding of the whole frame
and, where its limit there is loose, ``over4_ppm`` against a fault confined
to a small part of it (one wrong 128x64 tile of a 4K frame is about 990 of
a million).

The reference is found by name: ``reference/<name>.py`` holds one class,
``Reference``, where the name is the configuration's ``reference`` (its
``mode`` where it names none). A later configuration with a reference of its
own is a new file there.

The control (``readings.py --control``) is either the program with a
lower-precision path of its own switched on (judged as the program is), or
the reference itself computed in a lower precision put in the program's
place.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.common import disable_tf32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NUMBERS = ("over1_ppm", "over4_ppm", "over8_ppm", "max_lsb", "original_max_lsb")


def reference(cfg: dict, device, bench_dir: Path, dtype=torch.float32):
    name = cfg.get("reference", cfg["mode"])
    path = Path(bench_dir) / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Reference(cfg, device, dtype)


def _chw(pane, layout: str, device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(pane)).to(device)
    return t.permute(2, 0, 1) if layout == "hwc" else t


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    ppm = lambda k: float((d > k).sum()) * 1e6 / d.numel()
    return {"over1_ppm": ppm(1), "over4_ppm": ppm(4), "over8_ppm": ppm(8),
            "max_lsb": float(d.max())}


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def replay(window, clip: np.ndarray, cfg: dict, device, limits: Dict[str, float],
           bench_dir: Path, arm: Optional[dict] = None) -> Tuple[Dict[str, float], int, int]:
    """(worst numbers over the sampled frames, frames compared, frames over a
    limit). A control ``arm`` with ``reference_dtype`` puts the reference,
    computed in that dtype (and in TF32 where ``tf32`` is set), in the
    program's place."""
    disable_tf32()
    arm = arm or {}
    ref = reference(cfg, device, bench_dir)
    judged = None
    if "reference_dtype" in arm:
        judged = reference(cfg, device, bench_dir, DTYPES[arm["reference_dtype"]])
    tf32 = bool(arm.get("tf32"))
    worst = dict.fromkeys(NUMBERS, 0.0)
    last = max(window.samples, default=-1)
    compared = bad = 0
    with torch.no_grad():
        for pos, idx in enumerate(window.sequence[:last + 1]):
            frame = _chw(clip[idx], window.layout, device)
            want = ref.step(frame)
            other = None
            if judged is not None:
                _set_tf32(tf32)
                other = judged.step(frame)
                _set_tf32(False)
            if pos not in window.samples:
                continue
            processed, original = window.samples[pos]
            got = other if other is not None else _chw(processed, window.layout, device)
            nums = frame_numbers(got, want)
            nums["original_max_lsb"] = frame_numbers(_chw(original, window.layout, device),
                                                     frame)["max_lsb"]
            worst = {k: max(worst[k], nums[k]) for k in worst}
            compared += 1
            bad += any(nums[k] > lim for k, lim in limits.items())
    return worst, compared, bad


def judge(worst: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers compared, each beside its limit (a number passes at or under it)."""
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}
