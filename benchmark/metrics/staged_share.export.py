"""staged_share.export: The share of the window's frames that the clip export uploaded one frame
ahead of their steps, through its pinned upload ring: ``export.stage`` spans over ``export.step``
spans (export/batch.py::ClipProcessor.process_chunk), outside the profiled chunk. 0 where no frame
staged (the time-parallel path, or a program that copies each chunk whole); None where there is no
``export.step`` span."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    held = spans.unprofiled(ctx)
    steps = sum(s.name == "export.step" for s in held)
    return sum(s.name == "export.stage" for s in held) / steps if steps else None
