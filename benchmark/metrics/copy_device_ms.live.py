"""copy_device_ms.live: Median device ms a frame of the live consumer's copies, by the CUDA events
of its ``consumer.h2d`` (the pooled frame's ``.to``) and ``consumer.readback`` (both panes'
``hwc_result``) spans, over the window's frames outside the profiled slice. Each pair reads the
stream's time over its region: the transfer, CUDA's staging of pageable memory, and
``hwc_result``'s ``.contiguous()`` on the card."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.copy_device_ms(ctx, ("consumer.h2d", "consumer.readback"))
