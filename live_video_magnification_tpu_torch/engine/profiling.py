"""Tracing / profiling: host counters + device traces.

The counterpart of the reference package's ``engine/profiling.py`` on
``torch.profiler``: :class:`DeviceProfiler` records the host and, where a
card is present, the CUDA timeline into a TensorBoard trace directory
(``torch.profiler.tensorboard_trace_handler``, viewable in TensorBoard or
Perfetto), and :func:`annotate` names a region on that timeline
(``record_function``), so a trace shows decode -> chain -> publish phases.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

import torch


class DeviceProfiler:
    """Start/stop torch.profiler traces around a streaming or batch run."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lvmt_profile")
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(self.log_dir))
        self._prof.start()

    def stop(self) -> Optional[str]:
        if self._prof is None:
            return None
        self._prof.stop()  # writes the trace (on_trace_ready)
        self._prof = None
        return self.log_dir

    @contextlib.contextmanager
    def trace(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region on the profiler timeline (record_function)."""
    with torch.profiler.record_function(name):
        yield
