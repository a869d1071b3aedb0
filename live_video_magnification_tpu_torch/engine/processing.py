"""The processing consumer: one worker, frames strictly in order (invariant 3).

The counterpart of the reference package's ``engine/processing.py``
(ProcessingChain.{hpp,cpp}): pop a frame -> read the RCU config once -> run
the chain on the device -> read both panes back -> publish the {processed,
original} pair to the latest-wins mailbox. On any exception the stage state
is reset and the input is published as both panes — degrade, don't crash
(ProcessingChain.cpp:50-62). Capture->processed latency is recorded per frame.

Because that handler turns every failure into a passthrough frame, the device
is resolved and the kernel libraries of the live path are built and loaded
by :func:`prepare_device` in the caller's thread, before any worker starts:
a missing card or a failed ``nvcc`` build raises there instead of becoming a
stream of unmagnified frames. The worker names its device on every call
(``MagnificationChain(device=...)``), never the thread's current device.

The copy to the card reads the pooled buffer synchronously (``.to(device)``
of pageable memory), and both panes come back by an explicit
``.cpu().numpy()``, so the buffer returns to the pool only after the device
is done with it.

Each frame is traced as ``consumer.frame`` (from the pop's return to after
the publish) holding ``consumer.h2d``, ``consumer.step``,
``consumer.readback`` and ``consumer.publish``, all with the frame's ``seq``
(``engine/profiling.py``; inert unless it is enabled).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.engine.config import AtomicConfig
from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat, now
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.profiling import span
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue
from live_video_magnification_tpu_torch.models.chain import MagnificationChain
from live_video_magnification_tpu_torch.models.params import ProcessorConfig

# The kernel libraries the chain can reach: the stencils (K1-K5 and their
# bf16 arms) and the tail kernels (K6-K9, under the kernel flags of
# models/riesz.py::KernelFlags, which a running stream may change).
LIVE_LIBRARIES = ("stencils", "tail")


def prepare_device(device=None) -> torch.device:
    """Resolve ``device`` (CUDA by default; raises without a card) and, on a
    card, build and load the live path's kernel libraries in this thread, so
    that a failure raises here rather than in a worker."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from live_video_magnification_tpu_torch.ops.hopper import _build

        _build.build(LIVE_LIBRARIES)
        for name in LIVE_LIBRARIES:
            _build.load_library(name)
    return dev


def hwc_result(t: torch.Tensor) -> np.ndarray:
    """The chain's [H, W, C] result tensor -> numpy, squeezing gray to [H, W].

    A contiguous copy of its own: made contiguous on the device, then one
    explicit readback (on the CPU a copy, so a pane never aliases the pooled
    input buffer it may have come from)."""
    if t.ndim == 3 and t.shape[2] == 1:
        t = t[..., 0]
    return t.detach().contiguous().to("cpu", copy=True).numpy()


class ProcessingChain:
    def __init__(
        self,
        queue: BoundedQueue,
        mailbox: LatestFrameMailbox,
        config: AtomicConfig,
        instr: Instrumentation,
        device=None,
    ):
        self._queue = queue
        self._mailbox = mailbox
        self._config = config
        self._instr = instr
        self._chain = MagnificationChain(device=device)
        self._device = self._chain.device
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    def start(self) -> None:
        self._stopping.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="ProcessingChain")
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        # queue.stop() (done by the controller) unblocks the pop
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def reset_chain(self) -> None:
        self._chain.reset()

    def _run(self) -> None:
        while not self._stopping.is_set():
            frame = self._queue.pop()
            if frame is None:
                return  # stopped
            with span("consumer.frame", frame.seq):
                self._consume(frame)

    def _consume(self, frame: Frame) -> None:
        cfg = self._config.read() or ProcessorConfig()
        device, seq = self._device, frame.seq
        try:
            with span("consumer.h2d", seq, copy=device, nbytes=frame.data.nbytes):
                data = torch.as_tensor(frame.data).to(device)
            with span("consumer.step", seq):
                processed_dev, original_dev = self._chain.process(data, cfg)
            with span("consumer.readback", seq, copy=device,
                      nbytes=processed_dev.nbytes + original_dev.nbytes):
                processed = hwc_result(processed_dev)
                original = hwc_result(original_dev)
            with span("consumer.publish", seq):
                pf = Frame(
                    seq=seq, pts_us=frame.pts_us, capture_ts=frame.capture_ts,
                    width=processed.shape[1], height=processed.shape[0],
                    format=PixelFormat.GRAY8 if processed.ndim == 2 else PixelFormat.BGR8,
                    data=processed,
                )
                of = Frame(
                    seq=seq, pts_us=frame.pts_us, capture_ts=frame.capture_ts,
                    width=original.shape[1], height=original.shape[0],
                    format=PixelFormat.GRAY8 if original.ndim == 2 else PixelFormat.BGR8,
                    data=original,
                )
                self._mailbox.publish(DisplayFrame(pf, of))
                self._instr.on_processed()
                self._instr.record_latency(now() - frame.capture_ts)
        except Exception:
            # Degrade, don't crash: count, reset temporal state, passthrough.
            self._instr.on_proc_error()
            self._chain.reset()
            copy = Frame(
                seq=seq, pts_us=frame.pts_us, capture_ts=frame.capture_ts,
                width=frame.width, height=frame.height, format=frame.format,
                data=np.array(frame.data, copy=True),
            )
            self._mailbox.publish(DisplayFrame(copy, copy))
        finally:
            frame.release()
