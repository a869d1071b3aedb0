"""copy_device_ms.export: Device ms a frame of the clip export's copies, by the CUDA events of its
``export.h2d`` (the chunk's ``.to``) and ``export.readback`` (both stacks' ``.cpu()``) spans in
ClipProcessor.process_chunk: the stream's time over each region, the pageable staging included,
over the window's chunks outside the profiled one (which the profiler slows)."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.export_copy_device_ms(ctx)
