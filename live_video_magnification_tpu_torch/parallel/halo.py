"""Halo exchanges for sharded stencils.

The counterpart of the reference package's ``parallel/halo.py``:

  * halo_exchange_rows / sharded_correlate2d / make_sharded_conv: a dense 2-D
    correlation with the rows (H) split over a mesh axis, reflect-101 at the
    global top and bottom, neighbour rows at interior boundaries; the row
    exchange is also every exchange of the row-sharded steps
    (parallel/row_sharded.py);
  * halo_exchange_cols_rdma: the column exchange between lane shards, K10,
    the CUDA kernel of ops/hopper/halo.py.

Shards are lists of tensors, one per device of the axis, in mesh order; a
neighbour's rows move to the shard's device with ``.to``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import correlate2d
from live_video_magnification_tpu_torch.ops.hopper.halo import (
    RIGHT_MODES,
    halo_exchange_cols_rdma,
)
from live_video_magnification_tpu_torch.parallel.mesh import Mesh

__all__ = ["halo_exchange_rows", "sharded_correlate2d", "make_sharded_conv",
           "halo_exchange_cols_rdma"]


def halo_exchange_rows(shards: Sequence[torch.Tensor], halo: int,
                       bottom_mode: str = "reflect", dim: int = 0) -> List[torch.Tensor]:
    """Row shards (rows on ``dim``: [h_local, ...] by default, [..., h_local,
    w] with dim=-2) -> h_local + 2*halo rows each, with the neighbours' rows
    at interior boundaries and reflect-101 at the global top and bottom,
    exactly matching an unsharded reflect pad. ``bottom_mode="symmetric"``
    pads the global bottom SYMMETRIC instead: the zero-injection quirk, the
    row twin of K10's ``right_mode``. A neighbour's rows move to the shard's
    device with ``.to`` (a copy within a card or between cards); rows on
    dim 0 or -2 are contiguous blocks, so no kernel is needed. Requires
    h_local > halo."""
    if bottom_mode not in RIGHT_MODES:
        raise ValueError(f"bottom_mode {bottom_mode!r}: expected one of {RIGHT_MODES}")
    n = len(shards)
    out = []
    for k, x in enumerate(shards):
        if x.shape[dim] <= halo:
            raise ValueError(f"{x.shape[dim]} local rows cannot give a halo of {halo}")
        rows = lambda a, b: x.narrow(dim, a, b - a)
        h = x.shape[dim]
        top = (torch.flip(rows(1, halo + 1), dims=(dim,)) if k == 0
               else shards[k - 1].narrow(dim, h - halo, halo).to(x.device))
        if k < n - 1:
            bot = shards[k + 1].narrow(dim, 0, halo).to(x.device)
        elif bottom_mode == "symmetric":
            bot = torch.flip(rows(h - halo, h), dims=(dim,))
        else:
            bot = torch.flip(rows(h - halo - 1, h - 1), dims=(dim,))
        out.append(torch.cat([top, x, bot], dim=dim))
    return out


def sharded_correlate2d(shards: Sequence[torch.Tensor], kernel) -> List[torch.Tensor]:
    """Row-sharded dense 2-D correlation with reflect-101 global borders:
    each [h_local, w] shard of an [H, w] array -> its rows of the result.
    The haloed strip goes to the plain correlation, whose own row padding
    only touches the discarded halo rows."""
    rh = np.asarray(kernel).shape[0] // 2
    h_local = shards[0].shape[0]
    return [correlate2d(x, kernel)[rh: rh + h_local] for x in halo_exchange_rows(shards, rh)]


def make_sharded_conv(mesh: Mesh, axis_name: str, kernel) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(x[H, W]) running the correlation row-sharded over ``axis_name`` (the
    devices along it, at index 0 of every other axis); the result is
    gathered on the first of them."""
    axis = mesh.axis_names.index(axis_name)
    index = [0] * mesh.devices.ndim
    index[axis] = slice(None)
    devices = list(mesh.devices[tuple(index)])

    def fn(x: torch.Tensor) -> torch.Tensor:
        n = len(devices)
        if x.shape[0] % n:
            raise ValueError(f"H={x.shape[0]} does not split {n}-way")
        hl = x.shape[0] // n
        shards = [x[k * hl: (k + 1) * hl].to(d) for k, d in enumerate(devices)]
        out = sharded_correlate2d(shards, kernel)
        return torch.cat([o.to(devices[0]) for o in out], dim=0)

    return fn
