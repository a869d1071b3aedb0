"""The boundary step of a chunk whose time axis is split into shards.

The reference package shards a chunk's frames over a ("time",) mesh and makes
one T-sharded ``jax.jit`` call of ``models/*.py::process_clip_parallel``: XLA
splits each ``associative_scan`` into local scans and inserts the combines at
the shard boundaries itself (its ``parallel/batch_export.py``). PyTorch has no
partitioner, so this module holds those combines, written out:

  * the exclusive fold of the shard totals (``fold_carries``): shard 0 scans
    from the carried state, every later shard from a zero state, and
    s_in[k+1] = M_final[k] s_in[k] + local_final[k], shard by shard in shard
    order, on every process alike, so that 2 processes of 4 shards give the
    bits of 8 shards in one;
  * the one-frame halo (``last_frames``): each shard's prior for its frame 0
    is the last frame's pyramid of the shard before it;
  * colour's halo (``all_rows``): a shard's windows reach back over the
    earlier shards' pyramid tops.

A group of shards lies in one process (the n shards' devices may repeat: n
virtual shards of one card, or ``["cpu"] * n`` in the tests) or spans
processes of a ``torch.distributed`` group; each process holds a contiguous
run of shards in shard order and exchanges with ``all_gather``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TimeShards:
    """The shards of one chunk's time axis that this process holds.

    ``devices``: the devices of this process's shards, in shard order (they
    may repeat); ``first``: the global index of the first of them; ``count``:
    the shards of the whole group; ``group``: the torch.distributed process
    group when the shards span processes (None: all of them are here);
    ``staged``: exchanges of CUDA tensors go through host memory (gloo has
    no all_gather for CUDA tensors)."""

    devices: Tuple[torch.device, ...]
    first: int = 0
    count: Optional[int] = None
    group: object = None
    staged: bool = False

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if self.count is None:
            object.__setattr__(self, "count", len(self.devices))
        if not 0 <= self.first <= self.count - len(self.devices):
            raise ValueError(f"shards {self.first}..{self.first + len(self.devices) - 1} "
                             f"are not in a group of {self.count}")
        if self.count > len(self.devices) and self.group is None:
            raise ValueError("shards that span processes need a process group")

    @classmethod
    def single(cls, device) -> "TimeShards":
        """One shard on ``device``: the unsharded time-parallel path."""
        return cls((torch.device(device),))

    @property
    def home(self) -> torch.device:
        """Where this process keeps the carried state: its first shard's device."""
        return self.devices[0]

    def index(self, j: int) -> int:
        """The global index of this process's shard ``j``."""
        return self.first + j

    def gather(self, local: Sequence[Sequence[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """Every shard's tensors, in shard order, from ``local``: one list of
        tensors for each of this process's shards (the same shapes and one
        dtype in every shard). This process's own come back as given; the
        others' arrive on ``home``."""
        if len(local) != len(self.devices):
            raise ValueError(f"{len(local)} shards given, {len(self.devices)} held")
        if self.group is None:
            return [list(ts) for ts in local]
        import torch.distributed as dist

        shapes = [t.shape for t in local[0]]
        sizes = [math.prod(s) for s in shapes]
        flat = torch.stack([torch.cat([t.reshape(-1).to(self.home) for t in ts])
                            for ts in local])
        if self.staged:
            flat = flat.cpu()
        bufs = [torch.empty_like(flat) for _ in range(self.count // len(self.devices))]
        dist.all_gather(bufs, flat, group=self.group)
        out: List[List[torch.Tensor]] = []
        for rows in bufs:
            for row in rows.to(self.home):
                out.append([p.reshape(s) for p, s in zip(torch.split(row, sizes), shapes)])
        out[self.first:self.first + len(local)] = [list(ts) for ts in local]
        return out


def fold_carries(finals: Sequence[Sequence[torch.Tensor]],
                 carry: Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]],
                                 Sequence[torch.Tensor]]):
    """The exclusive fold of shard totals, in shard order.

    ``finals[0]``: shard 0's state after its last frame (it scanned from the
    carried state); ``finals[k]``, k > 0: shard k's last state scanned from
    a zero state. ``carry(local_final, s_in)`` is the shard's last state with
    ``s_in`` carried in (M_final s_in + local_final). Returns (ins, last):
    ins[k] the state entering shard k (ins[0] is None) and ``last`` the
    chunk's final state. Each step runs on the device of the shard's
    tensors."""
    ins: List[Optional[Tuple[torch.Tensor, ...]]] = [None]
    state = tuple(finals[0])
    for local in finals[1:]:
        state = tuple(s.to(local[0].device) for s in state)
        ins.append(state)
        state = tuple(carry(local, state))
    return ins, state


def last_frames(shards: TimeShards, lasts: Sequence[Sequence[torch.Tensor]]):
    """The one-frame halo. ``lasts``: for each of this process's shards, the
    tensors of its last frame. Returns (priors, final): priors[j] is the
    shard before local shard j's last frame (None for global shard 0), on
    shard j's device; ``final`` the whole chunk's last frame (the last
    shard's), on ``home``."""
    every = shards.gather(lasts)
    priors = []
    for j, dev in enumerate(shards.devices):
        k = shards.index(j)
        priors.append(None if k == 0 else [x.to(dev) for x in every[k - 1]])
    return priors, [x.to(shards.home) for x in every[-1]]


def all_rows(shards: TimeShards, rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Colour's halo: every shard's [T_k, ...] rows (here, each pyramid top
    flattened) in shard order as one [T, ...] tensor on ``home``, from this
    process's shards' ``rows``."""
    every = shards.gather([[r] for r in rows])
    return torch.cat([r[0].to(shards.home) for r in every])
