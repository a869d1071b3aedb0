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

On a card the sequential path replays the step as a CUDA graph wherever
``replays`` allows (phase and Laplace, every frame after the first): the
host then issues three calls a frame in place of the step's hundreds of
launches, and the card runs the same kernels in the same order, so the
frames are bit for bit the eager step's. ``_StepGraph`` captures the step
once a processor, on its first such frame; the carried state lives in the
graph's static buffers from then on (``self.state`` holds them, with the
host-int ``count``), and a state that is not theirs (a checkpoint loaded, an
eager frame) is copied into them before the next replay. Where the capture
fails the processor warns once and stays eager. The kernel wrappers' host
launch counters (``ops/hopper/{stencils,tail}.py``) count the calls of the
eager frames, the warm-up's and the capture's; a replay runs the captured
kernels without a call, so only a device trace counts its launches.

On a card the panes come back on a copy stream of the processor's own, into
pinned host tensors fresh each chunk (PyTorch's caching host allocator
reuses freed ones): frame i's two copies are enqueued right after its step,
so they run while the host issues frame i+1, and the chunk's end waits only
for the last of them. The time-parallel path copies its two stacks once,
after the chunk. On the CPU the panes are stacked and returned as they are.

A chunk is traced as ``export.chunk`` (id: the cursor) holding
``export.h2d``, an ``export.step`` for each frame (id: its index in the clip;
one around the whole chunk on the time-parallel path) with an
``export.replay`` inside where the frame replays the graph, on a card an
``export.d2h`` on the copy stream for each frame's copies (one for the
chunk's time-parallel), and ``export.readback``: on the CPU both stacks'
``.numpy()``, on a card the wait for the copy stream (``engine/profiling.py``;
inert unless it is enabled).
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.convert import (
    state_from_numpy,
    state_to_numpy,
    tree_leaves,
    tree_unflatten,
)
from live_video_magnification_tpu_torch.engine.profiling import span
from live_video_magnification_tpu_torch.models.chain import (
    MagnificationChain,
    _build_pre_stages,
    _build_step,
    _StaticKey,
    parallel_clip_fn,
)
from live_video_magnification_tpu_torch.models.params import MagnificationMode, ProcessorConfig

# Carried-state format, as the reference package's: v2 (phase: the 10-plane
# RieszState with the shared phase accumulator; motion and colour unchanged).
STATE_FORMAT_VERSION = 2
# The static key's kernel flags: they enter the digest only where they differ
# from their defaults, so a checkpoint written before the key had them (the
# same state layout) still loads.
_FLAG_FIELDS = ("phase_fused", "tail", "build", "mxu_dtype", "pyr_io", "tail_io")


def _pinned(shape, like: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor of ``like``'s dtype, from PyTorch's caching host
    allocator."""
    return torch.empty(shape, dtype=like.dtype, pin_memory=True)


def replays(key: _StaticKey, device: torch.device, time_parallel: bool, count: int, dyn) -> bool:
    """Whether a frame of the clip export replays the captured step: on a
    CUDA device, on the sequential path, in phase (>= 3 channels) or Laplace,
    and not on the first frame (``count`` 0) nor, in phase, on a frame whose
    ``dyn`` resets the filters or forces the re-init. Those frames take the
    step's other branches, which the graph does not hold, and run eagerly, as
    every frame does on the CPU, on the time-parallel path and in colour
    (whose window and operator change with ``count``) or the identity. The
    graph freezes every host branch of the step at its capture-time value,
    so a steady step may branch only on what this reads and on ``dyn``,
    which a processor holds fixed."""
    if device.type != "cuda" or time_parallel or count == 0:
        return False
    if key.mode is MagnificationMode.LAPLACE:
        return True
    return (key.mode is MagnificationMode.PHASE and key.channels >= 3
            and not (dyn.reset_filters or dyn.force_init))


def _tensors(state) -> List[torch.Tensor]:
    return [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]


class _StepGraph:
    """A step (``raw_fn``) captured as a CUDA graph from ``state``, ``frame``
    and ``dyn``, and called as ``raw_fn`` is, less ``dyn``, for the frames
    that replay it.

    The graph reads the carried state from static buffers and the frame from
    a static [C, H, W] u8 one, and ends by copying each new state leaf into
    its buffer (a leaf that passes its input through, as motion's residual,
    is that buffer already). ``dyn`` is baked in: the processor's is fixed.
    The capture runs nothing; a warm-up call on a side stream before it sets
    up what the step sets up on its first call, as ``torch.cuda.graphs``
    requires."""

    def __init__(self, raw_fn, state, frame: torch.Tensor, dyn):
        device = frame.device
        self.state = tree_unflatten(state, [x.clone() if isinstance(x, torch.Tensor) else x
                                            for x in tree_leaves(state)])
        self._leaves = _tensors(self.state)
        self._frame = frame.clone()
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                raw_fn(self.state, self._frame, dyn)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                new, self._out, self._orig = raw_fn(self.state, self._frame, dyn)
                # one multi-tensor copy: a graph runs each copy_'s memcpy
                # node as a kernel of its own, 68 a 4K phase frame
                pairs = [(d, s) for d, s in zip(self._leaves, _tensors(new)) if s is not d]
                torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])

    def __call__(self, state, frame: torch.Tensor):
        """(state, processed, original) of ``frame``, as ``raw_fn`` gives them:
        the state is the static buffers', the panes are new tensors (the
        processed pane a copy out of the graph's pool, which the next replay
        overwrites; the original ``frame`` itself where the step passes its
        input through)."""
        with torch.cuda.device(frame.device):
            held = _tensors(state)
            if any(a is not b for a, b in zip(held, self._leaves)):
                torch._foreach_copy_(self._leaves, held)
            self._frame.copy_(frame)
            self.graph.replay()
            out = self._out.clone()
            orig = frame if self._orig is self._frame else self._orig.clone()
        return self.state._replace(count=state.count + 1), out, orig


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

    def process_chunk(self, frames_u8) -> Tuple[np.ndarray, np.ndarray]:
        """frames_u8: [T, C, H, W] u8 (numpy or a tensor on any device).
        Returns (processed, original) numpy stacks; on a card, views of
        pinned host tensors new to this call, which they keep alive."""
        cursor, device, copies = self.cursor, self.device, self._copies
        with span("export.chunk", cursor):
            frames = torch.as_tensor(frames_u8)
            with span("export.h2d", cursor, copy=device, nbytes=frames.nbytes):
                frames = frames.to(device)
            if self.time_parallel:
                with span("export.step", cursor):
                    self.state, (processed, original) = self._chunk_raw(self.state, frames)
                if copies is not None:
                    hosts = [_pinned(x.shape, x) for x in (processed, original)]
                    self._d2h(cursor, (processed, original), hosts)
            else:
                steps = []  # every pane stays referenced until its copy is done
                for i, frame in enumerate(frames):
                    with span("export.step", cursor + i):
                        if self._graphed(frame):
                            with span("export.replay", cursor + i):
                                self.state, out, orig = self._graph(self.state, frame)
                        else:
                            self.state, out, orig = self._step.raw_fn(self.state, frame, self._dyn)
                    steps.append((out, orig))
                    if copies is not None:
                        if i == 0:
                            hosts = [_pinned((len(frames), *x.shape), x) for x in (out, orig)]
                        self._d2h(cursor + i, (out, orig), [x[i] for x in hosts])
                if copies is None:
                    processed, original = (torch.stack(x) for x in zip(*steps))
            if copies is None:
                with span("export.readback", cursor, copy=device,
                          nbytes=processed.nbytes + original.nbytes):
                    result = processed.cpu().numpy(), original.cpu().numpy()
            else:
                with torch.cuda.stream(copies), span("export.readback", cursor, copy=device,
                                                     nbytes=sum(x.nbytes for x in hosts)):
                    copies.synchronize()
                    result = hosts[0].numpy(), hosts[1].numpy()
            self.cursor += frames.shape[0]
        return result

    def _graphed(self, frame) -> bool:
        """Whether ``frame`` replays the step's CUDA graph (``replays``),
        which the first frame that may captures. A capture that fails warns,
        once, and leaves the processor eager."""
        # the identity path's state is a bare tensor, with no count
        count = getattr(self.state, "count", 0)
        if self._graph is False or not replays(self.key, self.device, self.time_parallel,
                                               count, self._dyn):
            return False
        if self._graph is None:
            try:
                self._graph = _StepGraph(self._step.raw_fn, self.state, frame, self._dyn)
            except RuntimeError as exc:
                self._graph = False
                warnings.warn(f"the clip export's step could not be captured as a CUDA graph "
                              f"({exc}); it runs eagerly", RuntimeWarning, stacklevel=3)
                return False
        return True

    def _d2h(self, index, panes, hosts) -> None:
        """Enqueue the copies of ``panes`` (device) into ``hosts`` (pinned) on
        the copy stream, behind the work issued so far on the current one;
        traced as ``export.d2h`` (id: ``index``), its CUDA events on the copy
        stream."""
        copies = self._copies
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
        """A digest of the static key and the config. The flag fields enter
        it only where they differ from their defaults, so a checkpoint
        written before the key had them (same state layout) still loads."""
        key, defaults = self.key, type(self.key)._field_defaults
        shown = [f for f in key._fields
                 if f not in _FLAG_FIELDS or getattr(key, f) != defaults[f]]
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
