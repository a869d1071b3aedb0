"""readback_ms.live: Median host ms of the live consumer's ``consumer.readback`` span (both
``hwc_result`` calls), which holds the wait for the step's device work, over the window's frames
outside the profiled slice."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.median_ms(ctx, "consumer.readback")
