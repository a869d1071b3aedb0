"""idle_in_issue_ms.export: Device idle ms a frame of the profiled chunk (every gap between device
intervals) that falls inside ``export.step``, while the host issues the step; spans put on the
profiler's clock by ``engine/profiling.py::to_trace_ns``. Fewer or cheaper launches shrink it."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.idle_ms_per_frame(ctx, "export.step")
