"""Device mesh helpers.

The counterpart of the reference package's ``parallel/mesh.py``. A ``Mesh``
is an object array of ``torch.device``s with named axes. A device may appear
more than once: n shards on one card are n virtual devices, each shard in its
own memory, as the reference's tests run n virtual CPU devices; the CPU tests
build meshes of ``["cpu"] * n``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: numpy object array of torch.device, one axis per name."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("batch", "tile"),
    devices=None,
) -> Mesh:
    """A Mesh over ``devices`` (default: every CUDA device; raises without a
    card). Devices may repeat. The default shape puts every device on the
    last axis ('tile') and 1 on the others, as the reference does."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    n = len(devs)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} does not "
                         f"hold {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))
