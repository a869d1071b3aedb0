"""d2h_device_ms.export: Median device ms a frame of the clip export's readback, by the CUDA events
of its ``export.d2h`` spans (ClipProcessor.process_chunk on a card: one a frame, around the two
panes' copies into pinned host memory on the processor's copy stream, so the pair times that
frame's transfer there), over the window's frames outside the profiled chunk. None where the
program has no such span (the CPU; a checkout that reads back pageable stacks)."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.copy_device_ms(ctx, ("export.d2h",))
