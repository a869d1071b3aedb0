"""color_pyramid_device_ms.live: Median device ms a frame of the colour step's ``color.pyramid`` span
(models/color.py::step: the Gaussian pyramid: the frame to f32 and its ``levels`` pyrDowns), by the span's CUDA events, over the window's frames outside the
profiled slice. None where the program has no such span."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.copy_device_ms(ctx, ("color.pyramid",))
