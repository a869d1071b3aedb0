"""The column halo exchange between lane shards: a CUDA kernel for Hopper and
its plain PyTorch version.

``halo_exchange_cols_rdma`` replaces the reference package's
``parallel/halo.py::halo_exchange_cols_rdma`` (K10, a Pallas
make_async_remote_copy ring over ICI). The reference runs it inside
shard_map on one shard per device; here it takes the list of the shards of
one tile row, in mesh order, and returns the list of their haloed strips:
shard k's [..., w_l] becomes [..., w_l + 2 * halo] with its neighbours' edge
columns, reflect-101 at the global edges (``right_mode="symmetric"`` pads the
last shard's right edge symmetric: the zero-injection quirk). Shards may sit
on one device (virtual shards) or on several.

On CPU tensors it runs the plain version. On CUDA tensors it launches
``halo_cols_kernel`` of ``csrc/halo.cu`` once per device, for every shard that
device holds, or raises; there is no fallback. A shard's threads read the
neighbour's edge columns through its device pointer: for a neighbour on
another card the wrapper checks ``torch.cuda.can_device_access_peer``,
enables peer access once, makes the device's stream wait on an event
recorded on the neighbour's stream (the reference's barrier semaphore) and
marks the neighbour tensor used by that stream (``record_stream``), so the
caching allocator does not reuse it before the read. f32 only, as the slice.

``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from live_video_magnification_tpu_torch.ops.hopper._build import launch, load_library

LAUNCHES = {"halo_exchange_cols_rdma": 0}

MAX_SHARDS = 8  # the kernel's pointer table
RIGHT_MODES = ("reflect", "symmetric")

_peers_enabled = set()


def _edges(x: torch.Tensor, halo: int, right_mode: str):
    """(left, right) reflect-101 pads of one shard's columns; the right one
    symmetric under ``right_mode="symmetric"``."""
    left = torch.flip(x[..., 1: halo + 1], dims=(-1,))
    if right_mode == "symmetric":
        right = torch.flip(x[..., -halo:], dims=(-1,))
    else:
        right = torch.flip(x[..., -halo - 1: -1], dims=(-1,))
    return left, right


def halo_exchange_cols_rdma_plain(shards: Sequence[torch.Tensor], halo: int,
                                  right_mode: str = "reflect") -> List[torch.Tensor]:
    """Slices, flips and concatenation; a neighbour's edge moves to the shard's
    device with ``.to``."""
    n = len(shards)
    out = []
    for k, x in enumerate(shards):
        reflect_l, reflect_r = _edges(x, halo, right_mode)
        left = reflect_l if k == 0 else shards[k - 1][..., -halo:].to(x.device)
        right = reflect_r if k == n - 1 else shards[k + 1][..., :halo].to(x.device)
        out.append(torch.cat([left, x, right], dim=-1))
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("halo")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lvmt_halo_cols.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.lvmt_halo_cols.restype = ctypes.c_int
    lib.lvmt_enable_peer_access.argtypes = [i, i]
    lib.lvmt_enable_peer_access.restype = ctypes.c_int
    return lib


def _check(shards: Sequence[torch.Tensor], halo: int, right_mode: str) -> str:
    """Every shard of one shape, w_l > halo >= 1; all on the CPU or all on CUDA.
    Returns the device type."""
    if not shards:
        raise ValueError("halo_exchange_cols_rdma: no shards")
    if right_mode not in RIGHT_MODES:
        raise ValueError(f"unknown right_mode {right_mode!r}: expected one of "
                         f"{', '.join(RIGHT_MODES)}")
    first = shards[0]
    for x in shards:
        if not isinstance(x, torch.Tensor) or x.shape != first.shape or x.dtype != first.dtype:
            raise ValueError("halo_exchange_cols_rdma: shards of one shape and dtype expected")
        if x.device.type != first.device.type or x.device.type not in ("cuda", "cpu"):
            raise ValueError("halo_exchange_cols_rdma: shards all on CUDA or all on the CPU")
    if first.ndim < 1 or not 1 <= halo < first.shape[-1]:
        raise ValueError(f"halo_exchange_cols_rdma: halo {halo} needs local width "
                         f"> halo, got shape {tuple(first.shape)}")
    return first.device.type


def _enable_peer(device: torch.device, peer: torch.device) -> None:
    if (device.index, peer.index) in _peers_enabled:
        return
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(f"halo_exchange_cols_rdma: {device} cannot access {peer}'s memory "
                           "(no peer access); the exchange has no host-copy route")
    with torch.cuda.device(device):
        err = _lib().lvmt_enable_peer_access(device.index, peer.index)
    if err != 0:
        raise RuntimeError(f"halo_exchange_cols_rdma: enabling peer access {device} -> "
                           f"{peer} failed with cudaError {err}")
    _peers_enabled.add((device.index, peer.index))


def halo_exchange_cols_rdma(shards: Sequence[torch.Tensor], halo: int,
                            right_mode: str = "reflect") -> List[torch.Tensor]:
    """[..., w_l] shards of one tile row, in mesh order -> their
    [..., w_l + 2 * halo] haloed strips, each on its shard's device."""
    if _check(shards, halo, right_mode) == "cpu":
        return halo_exchange_cols_rdma_plain(shards, halo, right_mode)
    if shards[0].dtype != torch.float32:
        raise TypeError(f"halo_exchange_cols_rdma: expected float32, got {shards[0].dtype}")
    if any(not x.is_contiguous() for x in shards):
        raise ValueError("halo_exchange_cols_rdma: expected contiguous shards")
    n = len(shards)
    lead, wl = shards[0].shape[:-1], shards[0].shape[-1]
    rows = 1
    for d in lead:
        rows *= int(d)
    outs = [torch.empty((*lead, wl + 2 * halo), dtype=torch.float32, device=x.device)
            for x in shards]
    by_device = {}
    for k, x in enumerate(shards):
        by_device.setdefault(x.device, []).append(k)
    for dev, ks in by_device.items():
        if len(ks) > MAX_SHARDS:
            raise ValueError(f"halo_exchange_cols_rdma: {len(ks)} shards on {dev}, at most "
                             f"{MAX_SHARDS}")
        stream = torch.cuda.current_stream(dev)
        neighbours = [shards[j] for k in ks for j in (k - 1, k + 1)
                      if 0 <= j < n and shards[j].device != dev]
        for peer in {x.device for x in neighbours}:
            _enable_peer(dev, peer)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(peer))
            stream.wait_event(ready)
        table = [(shards[k].data_ptr(),
                  shards[k - 1].data_ptr() if k > 0 else None,
                  shards[k + 1].data_ptr() if k < n - 1 else None,
                  outs[k].data_ptr()) for k in ks]
        ptrs = [(ctypes.c_void_p * len(ks))(*col) for col in zip(*table)]
        launch(_lib().lvmt_halo_cols, "halo_exchange_cols_rdma", dev, *ptrs, len(ks), rows,
               wl, halo, int(right_mode == "symmetric"))
        LAUNCHES["halo_exchange_cols_rdma"] += 1
        for x in neighbours:
            x.record_stream(stream)
    return outs
