"""The program under test, built through its public entries only.

Export cells drive ``export/batch.py::ClipProcessor.process_chunk`` (the
sequential path of ``magnify``). Camera cells drive the live engine as
``engine/controller.py::PlaybackController._build_and_start`` wires it: a
``FramePool``, a ``BoundedQueue`` with the Drop policy, the
``ProcessingChain`` consumer reading an ``AtomicConfig``, and a
``LatestFrameMailbox``. The queue and the mailbox here are subclasses that
stamp each frame when the consumer pops it and when it publishes its result,
and keep a sample of the published panes for the correctness check.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

from live_video_magnification_tpu_torch.engine.config import AtomicConfig
from live_video_magnification_tpu_torch.engine.frame import now
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.pool import FramePool
from live_video_magnification_tpu_torch.engine.processing import (
    ProcessingChain,
    prepare_device,
)
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue, OverflowPolicy
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    MagUiValues,
    PreprocessParams,
    ProcessorConfig,
    to_params,
)

import torch


def processor_config(cfg: dict) -> ProcessorConfig:
    """The configuration's UI values through the program's own mapping, as
    the CLI and the GUI pass them. A configuration's ``preprocess`` (ROI,
    downscale: ``PreprocessParams``' fields) and ``grayscale`` pass through
    as they are."""
    ui = MagUiValues(mode=MagnificationMode(cfg["mode"]), amplification=cfg["amplification"],
                     wavelength=cfg["wavelength"], low=cfg["low_hz"], high=cfg["high_hz"],
                     chroma=cfg["chroma"], levels=cfg["levels"], capture_fps=cfg["capture_fps"])
    return ProcessorConfig(grayscale=bool(cfg.get("grayscale", False)),
                           preprocess=PreprocessParams(**cfg.get("preprocess", {})),
                           magnification=to_params(ui))


def clip_processor(cfg: dict, device) -> ClipProcessor:
    """``magnify``'s processor; a configuration's ``clip_processor`` passes its
    keyword arguments (``time_parallel``) through."""
    return ClipProcessor(processor_config(cfg), cfg["height"], cfg["width"], 3, device=device,
                         **cfg.get("clip_processor", {}))


def span(name: str):
    """A named region on the profiler's timeline (inert when it is off)."""
    return torch.profiler.record_function(name)


class StampedQueue(BoundedQueue):
    """The engine's queue; records when the consumer takes each frame, and
    can hold the consumer at its next pop (``parked``), so that the traced
    run starts and stops the profiler while no frame is in flight."""

    def __init__(self, capacity: int, policy: OverflowPolicy):
        super().__init__(capacity, policy)
        self.popped: Dict[int, float] = {}
        self._park = threading.Event()
        self._parked = threading.Event()
        self._resume = threading.Event()

    @contextlib.contextmanager
    def parked(self, timeout: float = 10.0):
        self._resume.clear()
        self._park.set()
        try:
            yield self._parked.wait(timeout)
        finally:
            self._park.clear()
            self._resume.set()

    def pop(self, timeout: Optional[float] = None):
        if self._park.is_set():
            self._parked.set()
            self._resume.wait()
            self._parked.clear()
        with span("engine.queue_pop"):
            item = super().pop(timeout)
        if item is not None:
            self.popped[item.seq] = now()
        return item


class StampedMailbox(LatestFrameMailbox):
    """The engine's mailbox; records each publish in order, whether it was a
    passthrough (the consumer's degrade path publishes one frame as both
    panes), and keeps the panes of the positions ``keep`` chooses."""

    def __init__(self, keep: Callable[[int], bool]):
        super().__init__()
        self._keep = keep
        self._order_lock = threading.Lock()
        self.order: List[int] = []          # seq of each publish
        self.published: Dict[int, float] = {}
        self.passthrough: List[int] = []    # positions in ``order``
        self.kept: Dict[int, DisplayFrame] = {}  # position -> panes

    def publish(self, frame: DisplayFrame) -> None:
        t = now()
        super().publish(frame)
        with self._order_lock:
            pos = len(self.order)
            self.order.append(frame.processed.seq)
            self.published[frame.processed.seq] = t
            if frame.processed is frame.original:
                self.passthrough.append(pos)
            if self._keep(pos):
                self.kept[pos] = frame

    def count(self) -> int:
        with self._order_lock:
            return len(self.order)


class Engine:
    """The live engine's consumer side, started and stopped by the camera mix."""

    def __init__(self, cfg: dict, traffic: dict, device, keep: Callable[[int], bool]):
        self.device = prepare_device(device)
        self.pool = FramePool(traffic["pool"])
        self.queue = StampedQueue(traffic["queue"], OverflowPolicy(traffic["policy"]))
        self.mailbox = StampedMailbox(keep)
        self.instr = Instrumentation()
        self.config = AtomicConfig(processor_config(cfg))
        self.chain = ProcessingChain(self.queue, self.mailbox, self.config, self.instr,
                                     self.device)
        self.chain.start()

    def stop(self) -> None:
        self.queue.stop()
        self.pool.stop()
        self.chain.stop()
