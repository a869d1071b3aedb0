"""readback_ms.export: Host ms a frame inside ``export.readback`` (both stacks' ``.cpu().numpy()``
in ClipProcessor.process_chunk, the wait for the chunk's device work included), over the window's
chunks outside the profiled one."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.export_ms_per_frame(ctx, "export.readback")
