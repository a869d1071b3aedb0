"""Device mesh helpers.

The counterpart of the reference package's ``parallel/mesh.py``. A ``Mesh``
is an object array of ``torch.device``s with named axes. A device may appear
more than once: n shards on one card are n virtual devices, each shard in its
own memory, as the reference's tests run n virtual CPU devices; the CPU tests
build meshes of ``["cpu"] * n``. A mesh over several processes also records
which rank owns each entry (``ranks``), as JAX knows which process each
device of a global mesh belongs to.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: numpy object array of torch.device, one axis per name.
    ``ranks``: the process rank that owns each entry, an int array of the
    same shape; None when every entry belongs to this process."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: Optional[np.ndarray] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def owned(self, rank: int) -> np.ndarray:
        """Flat indices of the entries that ``rank`` owns (all of them for
        a mesh of one process)."""
        if self.ranks is None:
            return np.arange(self.devices.size)
        return np.flatnonzero(self.ranks.reshape(-1) == rank)


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("batch", "tile"),
    devices=None,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A Mesh over ``devices`` (default: every CUDA device; raises without a
    card). Devices may repeat. The default shape puts every device on the
    last axis ('tile') and 1 on the others, as the reference does.
    ``ranks`` gives the process rank that owns each device (one process
    when None)."""
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
    if ranks is not None:
        if len(ranks) != n:
            raise ValueError(f"{len(ranks)} ranks for {n} devices")
        ranks = np.asarray(ranks, dtype=np.int64).reshape(shape)
    return Mesh(arr.reshape(shape), tuple(axis_names), ranks)
