"""color_reconstruct_device_ms.live: Median device ms a frame of the colour step's ``color.reconstruct`` span
(models/color.py::step: the pyrUps, the resize, the add to the input and the rescale to u8), by the span's CUDA events, over the window's frames outside the
profiled slice. None where the program has no such span."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.copy_device_ms(ctx, ("color.reconstruct",))
