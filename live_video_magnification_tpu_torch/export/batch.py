"""Clip processing with carried state and checkpoint/resume.

The counterpart of the reference package's ``export/batch.py``: frames go
through the same chain step as live use, in chunks, with the temporal state
carried across chunks, in every mode. Under ``time_parallel=True`` a chunk
goes through the stateless stages batched and then the mode's time-parallel
form (``models/chain.py::parallel_clip_fn``), with the same carried state,
so checkpoints and chunk boundaries are interchangeable between the two
paths. The state plus the frame cursor is saved to ``.npz`` with the
reference's leaf order and format version (the host-int ``count`` as an
int32 scalar), so a long export can resume.

On a card the sequential path replays the step as a CUDA graph
(``models/chain.py::StepGraph``) on every frame that the step's own
``steady`` rule admits (``replays``): the host then issues three calls a
frame in place of the step's hundreds of launches, and the card runs the
same kernels in the same order, so the frames are bit for bit the eager
step's. The processor captures the step once, on its first such frame;
``self.state`` then holds the graph's static buffers. Where the capture
fails the processor warns once and stays eager. The kernel wrappers' host
launch counters (``ops/hopper/{stencils,tail}.py``) count the calls of the
eager frames, the warm-up's and the capture's; a replay runs the captured
kernels without a call, so only a device trace counts its launches.

On a card the sequential path uploads a chunk on the host one frame ahead
of its steps (``stages``), through a ring of ``RING`` frame slots that the
processor allocates on its first such chunk and keeps (``_UploadRing``; made
anew only for another frame shape): a pinned host slot and a device buffer
each, and an upload stream of the ring's own, so the copy engine carries
frame i+1 while the card runs step i. The host copies frame i+1 into its
pinned slot (a pinned chunk too) before it issues step i, once the slot's
last upload is done; the upload stream waits until the slot's device buffer
is free (its last frame's panes copied out on the copy stream, which waited
for that frame's step) and enqueues the copy; the step waits for its
frame's upload. The steps, the graph and the readback are those of a chunk
already on the card, so the frames are bit for bit the same. A chunk
already on the card is not copied; the time-parallel path copies the whole
chunk at once (its first kernel reads every frame), as does the CPU.

The panes come back into host tensors fresh each chunk: on a card pinned
ones (PyTorch's caching host allocator reuses freed ones), filled on a copy
stream of the processor's own, where frame i's two copies are enqueued right
after its step, so they run while the host issues frame i+1, and the chunk's
end waits only for the last of them; on the CPU plain ones, filled by plain
copies. The time-parallel path fills them once, after the chunk.

A chunk is traced as ``export.chunk`` (id: the cursor) holding
``export.h2d`` (id: the cursor, bytes: the chunk's; staged, the part of the
upload that nothing hides: frame 0's staging and copy, its CUDA events on
the upload stream), on the staged path an ``export.stage`` for each frame
(id: its index in the clip, bytes: the frame's; its staging and copy, events
on the upload stream; frame 0's inside ``export.h2d``, frame i+1's before
frame i's step), an ``export.step`` for each frame (id: its index in the
clip; one around the whole chunk on the time-parallel path) with an
``export.replay`` inside where the frame replays the graph, on a card an
``export.d2h`` on the copy stream for each frame's copies (one for the
chunk's time-parallel), and ``export.readback``: on a card the wait for the
copy stream (``engine/profiling.py``; inert unless it is enabled).
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.convert import state_from_numpy, state_to_numpy
from live_video_magnification_tpu_torch.engine.profiling import span
from live_video_magnification_tpu_torch.models.chain import (
    ChainStep,
    MagnificationChain,
    StepGraph,
    _build_pre_stages,
    _build_step,
    parallel_clip_fn,
)
from live_video_magnification_tpu_torch.models.params import ProcessorConfig
from live_video_magnification_tpu_torch.models.riesz import KernelFlags

# Carried-state format, as the reference package's: v2 (phase: the 10-plane
# RieszState with the shared phase accumulator; motion and colour unchanged).
STATE_FORMAT_VERSION = 2

RING = 3  # the upload ring's frame slots (module docstring)


def replays(step: ChainStep, device: torch.device, time_parallel: bool, count: int, dyn) -> bool:
    """Whether a frame of the clip export replays the captured step: on a
    CUDA device, on the sequential path, where the step's ``steady`` rule
    admits the frame. Every other frame runs eagerly."""
    return (device.type == "cuda" and not time_parallel and step.steady is not None
            and step.steady(count, dyn))


def stages(device: torch.device, time_parallel: bool, frames: torch.Tensor) -> bool:
    """Whether a chunk is uploaded one frame ahead of its steps through the
    processor's upload ring: on a CUDA device, on the sequential path, for a
    chunk on the host. A chunk on the card needs no copy; every other chunk
    is copied whole before its first step."""
    return device.type == "cuda" and not time_parallel and frames.device.type == "cpu"


class _UploadRing:
    """``RING`` slots of one [C, H, W] frame shape: a pinned host slot and a
    device buffer each, an upload stream, and two events a slot: ``uploaded``
    (the slot's last copy, on the upload stream) and ``freed`` (the slot's
    last frame's panes copied out, on the copy stream)."""

    def __init__(self, frame: torch.Tensor, device: torch.device):
        self.key = (frame.shape, frame.dtype)
        self.stream = torch.cuda.Stream(device)
        self.pinned = [torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
                       for _ in range(RING)]
        self.frames = [torch.empty(frame.shape, dtype=frame.dtype, device=device)
                       for _ in range(RING)]
        self.uploaded = [torch.cuda.Event() for _ in range(RING)]
        self.freed = [torch.cuda.Event() for _ in range(RING)]
        self._next = 0

    def put(self, frame: torch.Tensor) -> int:
        """Copy ``frame`` into the next slot's pinned memory and enqueue its
        copy into the slot's device buffer on the upload stream (the current
        stream); returns the slot."""
        s, self._next = self._next, (self._next + 1) % RING
        self.uploaded[s].synchronize()  # the slot's last copy has read it
        self.pinned[s].copy_(frame)
        self.stream.wait_event(self.freed[s])
        self.frames[s].copy_(self.pinned[s], non_blocking=True)
        self.uploaded[s].record(self.stream)
        return s


class ClipProcessor:
    """Processor for [T, C, H, W] u8 chunks with carried state.

    time_parallel=False: the chain step, one frame after another.
    time_parallel=True: the whole chunk at once, the mode's temporal
    recurrences as associative scans or window gathers
    (``models/*.py::process_clip_parallel``).

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, cfg: ProcessorConfig, h: int, w: int, channels: int,
                 time_parallel: bool = False, device=None):
        chain = MagnificationChain(device=device)
        self.cfg = cfg
        self.device = chain.device
        self.key = chain.static_key(cfg, h, w, channels)
        self._step = _build_step(self.key, self.device)
        self._dyn = chain._dyn_params(cfg, self.key)
        self.state = self._step.init_state()
        self.cursor = 0
        self.time_parallel = time_parallel
        # the step's CUDA graph once captured; False where the capture failed
        self._graph = None
        # the readbacks' stream (module docstring); none on the CPU
        self._copies = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._ring: Optional[_UploadRing] = None  # made by the first chunk that stages

    def process_chunk(self, frames_u8) -> Tuple[np.ndarray, np.ndarray]:
        """frames_u8: [T, C, H, W] u8 (numpy or a tensor on any device).
        Returns (processed, original) numpy stacks: views of host tensors new
        to this call (pinned on a card), which they keep alive."""
        cursor, copies = self.cursor, self._copies
        with span("export.chunk", cursor):
            frames = torch.as_tensor(frames_u8)
            if stages(self.device, self.time_parallel, frames):
                on_card = self._staged(cursor, frames)
            else:
                with span("export.h2d", cursor, copy=self.device, nbytes=frames.nbytes):
                    frames = on_card = frames.to(self.device)
            if self.time_parallel:
                with span("export.step", cursor):
                    self.state, panes = self._chunk_raw(self.state, frames)
                hosts = self._hosts(panes)
                self._d2h(cursor, panes, hosts)
            else:
                held = []  # every pane stays referenced until its copy is done
                for i, frame in enumerate(on_card):
                    with span("export.step", cursor + i):
                        if self._graphed(frame):
                            with span("export.replay", cursor + i):
                                self.state, *panes = self._graph(self.state, frame)
                        else:
                            self.state, *panes = self._step.raw_fn(self.state, frame, self._dyn)
                    if i == 0:
                        hosts = self._hosts(panes, len(frames))
                    self._d2h(cursor + i, panes, [x[i] for x in hosts])
                    held.append(panes)
            with torch.cuda.stream(copies), span("export.readback", cursor, copy=self.device,
                                                 nbytes=sum(x.nbytes for x in hosts)):
                if copies is not None:
                    copies.synchronize()
                result = hosts[0].numpy(), hosts[1].numpy()
            self.cursor += frames.shape[0]
        return result

    def _staged(self, cursor, frames) -> Iterator[torch.Tensor]:
        """The frames of a host chunk on the card, one at a time, through the
        upload ring (module docstring): frame i is yielded once the current
        stream waits for its upload and frame i+1's is enqueued; its slot is
        marked free on the copy stream when the caller asks for frame i+1,
        after frame i's panes are enqueued there."""
        if self._ring is None or self._ring.key != (frames.shape[1:], frames.dtype):
            self._ring = _UploadRing(frames[0], self.device)
        ring, n = self._ring, len(frames)
        compute = torch.cuda.current_stream(self.device)

        def stage(i):
            with torch.cuda.stream(ring.stream), span("export.stage", cursor + i,
                                                      copy=self.device, nbytes=frames[i].nbytes):
                return ring.put(frames[i])

        with torch.cuda.stream(ring.stream), span("export.h2d", cursor, copy=self.device,
                                                  nbytes=frames.nbytes):
            ahead = stage(0)
        for i in range(n):
            slot = ahead
            if i + 1 < n:
                ahead = stage(i + 1)
            compute.wait_event(ring.uploaded[slot])
            yield ring.frames[slot]
            ring.freed[slot].record(self._copies)

    def _graphed(self, frame) -> bool:
        """Whether ``frame`` replays the step's CUDA graph (``replays``),
        which the first frame that may captures. A capture that fails warns,
        once, and leaves the processor eager."""
        count = getattr(self.state, "count", 0)  # the identity's state has none
        if self._graph is False or not replays(self._step, self.device, self.time_parallel,
                                               count, self._dyn):
            return False
        if self._graph is None:
            try:
                self._graph = StepGraph(self._step.raw_fn, self.state, frame, self._dyn)
            except RuntimeError as exc:
                self._graph = False
                warnings.warn(f"the clip export's step could not be captured as a CUDA graph "
                              f"({exc}); it runs eagerly", RuntimeWarning, stacklevel=3)
                return False
        return True

    def _hosts(self, panes, *lead):
        """Host tensors shaped as ``panes`` behind the ``lead`` dims: pinned
        (PyTorch's caching host allocator) where there is a copy stream."""
        return [torch.empty((*lead, *x.shape), dtype=x.dtype, pin_memory=self._copies is not None)
                for x in panes]

    def _d2h(self, index, panes, hosts) -> None:
        """Copy ``panes`` into ``hosts``: on the CPU in place; on a card
        enqueued on the copy stream, behind the work issued so far on the
        current one, traced as ``export.d2h`` (id: ``index``), its CUDA
        events on the copy stream."""
        copies = self._copies
        if copies is None:
            for host, pane in zip(hosts, panes):
                host.copy_(pane)
            return
        copies.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(copies), span("export.d2h", index, copy=self.device,
                                             nbytes=sum(x.nbytes for x in panes)):
            for host, pane in zip(hosts, panes):
                host.copy_(pane, non_blocking=True)

    def _chunk_raw(self, state, frames, shards=None):
        """(state, (processed, original)) of a chunk by the time-parallel
        form, the counterpart of the reference's ``_chunk_raw``: the
        stateless stages batched over T, then the mode's
        ``process_clip_parallel``; the identity path returns the
        magnification input. ``frames``: a [T, C, H, W] u8 tensor; with
        ``shards`` (``parallel/time_shard.py::TimeShards``) one such tensor
        for each shard this process holds, on its device, and the outputs
        are lists of the same. ``state`` is not modified."""
        preprocess, _, gray_stage = _build_pre_stages(self.key)
        parts = [frames] if shards is None else list(frames)
        pre = [preprocess(f) for f in parts]
        magin = [gray_stage(p) for p in pre]
        par_fn = parallel_clip_fn(self.key)
        if par_fn is None:
            outs = magin
        elif shards is None:
            state, out = par_fn(magin[0].contiguous(), self._dyn, state=state)
            outs = [out]
        else:
            state, outs = par_fn([m.contiguous() for m in magin], self._dyn, state=state,
                                 shards=shards)
        return state, ((outs[0], pre[0]) if shards is None else (outs, pre))

    # -- checkpoint / resume ---------------------------------------------------------------------

    def _config_digest(self) -> str:
        """A digest of the static key and the config. The kernel flags enter
        it only where they differ from their defaults, so a checkpoint
        written before the key had them (same state layout) still loads."""
        key, defaults = self.key, type(self.key)._field_defaults
        shown = [f for f in key._fields
                 if f not in KernelFlags._fields or getattr(key, f) != defaults[f]]
        key_repr = (f"{type(key).__name__}("
                    + ", ".join(f"{f}={getattr(key, f)!r}" for f in shown) + ")")
        return hashlib.sha256((key_repr + repr(self.cfg)).encode()).hexdigest()[:16]

    def save_checkpoint(self, path: str) -> None:
        arrays = {f"leaf_{i}": a for i, a in enumerate(state_to_numpy(self.state))}
        meta = json.dumps({"cursor": self.cursor, "digest": self._config_digest(),
                           "version": STATE_FORMAT_VERSION})
        np.savez(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)

    def load_checkpoint(self, path: str) -> int:
        """Restores state; returns the frame cursor to resume from."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            # version before digest: a layout change also changes the digest,
            # and "different configuration" would mislead
            found = meta.get("version", 1)
            if found != STATE_FORMAT_VERSION:
                raise ValueError(
                    f"incompatible checkpoint state-format version (checkpoint "
                    f"v{found}, this build writes v{STATE_FORMAT_VERSION}): the "
                    "carried-state layout changed; re-export from the start")
            if meta["digest"] != self._config_digest():
                raise ValueError("checkpoint was written for a different configuration")
            n = len(data.files) - 1
            leaves = [data[f"leaf_{i}"] for i in range(n)]
        self.state = state_from_numpy(self.state, leaves, self.device)
        self.cursor = int(meta["cursor"])
        return self.cursor


def export_frames(
    frames_u8_tchw: np.ndarray,
    cfg: ProcessorConfig,
    chunk_size: int = 32,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    time_parallel: bool = False,
    device=None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (processed, original) chunks for a [T, C, H, W] u8 clip."""
    t, c, h, w = frames_u8_tchw.shape
    proc = ClipProcessor(cfg, h, w, c, time_parallel=time_parallel, device=device)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path + ".npz"):
        start = proc.load_checkpoint(checkpoint_path)
    done = start
    for i in range(start, t, chunk_size):
        chunk = frames_u8_tchw[i : i + chunk_size]
        yield proc.process_chunk(chunk)
        done += chunk.shape[0]
        if checkpoint_path and checkpoint_every and (done % checkpoint_every) < chunk_size:
            proc.save_checkpoint(checkpoint_path)
