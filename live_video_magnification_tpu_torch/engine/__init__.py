"""Host-side streaming runtime.

The counterpart of the reference package's ``engine/``, the re-design of the
reference's core runtime + pipeline layers (src/core/, src/pipeline/):
bounded-queue transport with Block/Drop overflow, latest-wins display
mailbox, RCU config snapshots, pooled frames, instrumentation, threaded
sources, and the playback controller that wires a source -> processing chain
(on the card) -> mailbox.

Semantics preserved from the reference (SURVEY.md §1 invariants):
  1. lossless-by-default temporal path (file=Block, camera=Drop; frames may be
     skipped, never reordered),
  2. display is the only lossy hop (latest-wins mailbox),
  3. one processing consumer, frames strictly in order,
  4. live preview and export share one chain implementation,
  5. config is RCU-published, read once per frame,
  6. frames are immutable after publish; pooled buffers bound memory.

Not ported yet (ROADMAP.md, queue 1 item 3): ``engine/gl_present.py``.
"""

from live_video_magnification_tpu_torch.engine.frame import Frame, PixelFormat
from live_video_magnification_tpu_torch.engine.queue import BoundedQueue, OverflowPolicy
from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame, LatestFrameMailbox
from live_video_magnification_tpu_torch.engine.config import AtomicConfig
from live_video_magnification_tpu_torch.engine.pool import FramePool
from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation, StatsSnapshot
from live_video_magnification_tpu_torch.engine.processing import ProcessingChain
from live_video_magnification_tpu_torch.engine.controller import PlaybackController
