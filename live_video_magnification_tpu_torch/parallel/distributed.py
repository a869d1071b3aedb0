"""Multi-process bring-up over torch.distributed, the global mesh, and the
scaling-efficiency harness.

The counterpart of the reference package's ``parallel/distributed.py``.
Every process runs the same program; ``initialize`` wires them into one
``torch.distributed`` group, ``global_mesh`` spans every process's devices
(each entry records its owning rank), and the sharded programs
(``parallel/batch_export.py``) run on it.

    from live_video_magnification_tpu_torch.parallel import distributed
    distributed.initialize()            # env-driven (COORDINATOR_ADDRESS, ...)
    mesh = distributed.global_mesh(("time",))

The backend follows from the layout, before any work, and never changes
after a failure: ``nccl`` when each rank drives cards of its own, ``gloo`` on
the CPU and when ranks share a card (NCCL refuses two ranks on one GPU; gloo
has no all_gather for CUDA tensors, so those exchanges are staged through
host memory, ``parallel/time_shard.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence, Tuple

import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.parallel.mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place in the group: its rank, the group's size, the
    backend and the devices this rank drives."""

    rank: int
    world: int
    backend: str
    devices: Tuple[torch.device, ...]

    @property
    def staged(self) -> bool:
        """Exchanges of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.devices[0].type == "cuda"


_LAYOUT: Optional[Layout] = None


def plan_layout(device, world: int, rank: int, local_world: Optional[int] = None,
                local_rank: Optional[int] = None) -> Layout:
    """The backend and devices of ``rank`` among ``world`` processes, of
    which ``local_world`` share this host (default: LOCAL_WORLD_SIZE, else
    all of them) with ``local_rank`` its index there (default: LOCAL_RANK,
    else rank mod local_world). On the CPU: gloo, one CPU device. With at
    least as many cards as local ranks: nccl, each rank its own equal share
    of the cards. With fewer: gloo, the ranks sharing the cards in turn."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Layout(rank, world, "gloo", (dev,))
    local_world = local_world or _int_env("LOCAL_WORLD_SIZE") or world
    if local_rank is None:
        local_rank = _int_env("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank % local_world
    cards = torch.cuda.device_count()
    if cards >= local_world:
        per = cards // local_world
        return Layout(rank, world, "nccl",
                      tuple(torch.device("cuda", local_rank * per + i) for i in range(per)))
    return Layout(rank, world, "gloo", (torch.device("cuda", local_rank % cards),))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Bring up torch.distributed from arguments or the environment.

    Env (the reference's names): COORDINATOR_ADDRESS (host:port),
    NUM_PROCESSES, PROCESS_ID; or, with LVMT_DISTRIBUTED=1 and none of them,
    torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK. ``device``
    ("cuda" by default, raising without a card; or "cpu") decides the
    layout (``plan_layout``). Returns True when a multi-process group was
    initialized, False for a single process (a no-op: everything still
    works on the local devices)."""
    global _LAYOUT
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        if os.environ.get("LVMT_DISTRIBUTED") != "1":
            return False
        init_method = "env://"
        num_processes, process_id = _int_env("WORLD_SIZE"), _int_env("RANK")
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the number of processes and this "
                         "process's id (NUM_PROCESSES, PROCESS_ID)")
    layout = plan_layout(device, num_processes, process_id)
    if layout.backend == "nccl":
        torch.cuda.set_device(layout.devices[0])
    dist.init_process_group(layout.backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _LAYOUT = layout
    return dist.get_world_size() > 1


def layout() -> Optional[Layout]:
    """This process's layout after ``initialize``, or None in a single process."""
    return _LAYOUT


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices this process drives: its layout's after ``initialize``;
    in a single process every CUDA device, or the CPU when ``device`` is
    "cpu"."""
    if _LAYOUT is not None:
        return _LAYOUT.devices
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def global_mesh(axis_names: Sequence[str] = ("batch", "tile"),
                tile_per_host: bool = False, device=None) -> Mesh:
    """Mesh over every process's devices, in rank order, each entry with its
    owning rank. Default: everything on the last axis. ``tile_per_host``
    puts the processes on the first axis and each one's devices on the last
    (the reference's hosts on 'batch', chips on 'tile')."""
    mine = local_devices(device)
    if _LAYOUT is None:
        devices, ranks, n_hosts = list(mine), [0] * len(mine), 1
    else:
        import torch.distributed as dist

        every = [None] * _LAYOUT.world
        dist.all_gather_object(every, [str(d) for d in mine])
        devices = [torch.device(d) for ds in every for d in ds]
        ranks = [r for r, ds in enumerate(every) for _ in ds]
        n_hosts = _LAYOUT.world
    if tile_per_host:
        shape = (1,) * (len(axis_names) - 2) + (n_hosts, len(devices) // n_hosts)
    else:
        shape = (1,) * (len(axis_names) - 1) + (len(devices),)
    return make_mesh(shape, axis_names, devices, ranks=ranks)


def measure_scaling_efficiency(
    build_step,                       # (mesh) -> (step, state)
    make_inputs,                      # (mesh) -> tuple of step args after state
    steps: int = 10,
    axis_names: Sequence[str] = ("batch", "tile"),
    devices=None,
) -> dict:
    """Throughput of the same step (the lane-sharded phase step,
    ``parallel/riesz_sharded.py::build_sharded_riesz_step``) on 1 device
    against all of ``devices`` (default: every CUDA device of this process).

    efficiency = (fps_N / fps_1) / N. Each timed run ends in a synchronize
    of every device of the mesh. Returns a dict with both measurements."""
    devices = list(devices) if devices is not None else list(local_devices())
    n = len(devices)

    def run(mesh) -> float:
        step, state = build_step(mesh)
        args = make_inputs(mesh)
        state, out = step(state, *args)            # warm
        _sync(mesh)
        t0 = time.monotonic()
        for _ in range(steps):
            state, out = step(state, *args)
        _sync(mesh)
        return steps / (time.monotonic() - t0)

    fps_1 = run(make_mesh((1,) * len(axis_names), axis_names, devices[:1]))
    fps_n = run(make_mesh((1,) * (len(axis_names) - 1) + (n,), axis_names, devices))
    return {
        "devices": n,
        "fps_1": fps_1,
        "fps_n": fps_n,
        "speedup": fps_n / fps_1,
        "efficiency": (fps_n / fps_1) / n,
    }


def _sync(mesh: Mesh) -> None:
    """Wait for every CUDA device of ``mesh`` (the CPU runs in order)."""
    for d in dict.fromkeys(mesh.devices.reshape(-1)):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
