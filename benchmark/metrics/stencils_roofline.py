"""stencils_roofline: K1-K4's share of their roofline, in percent: the sum of their bound times (bytes
and operations of each launch's shape over the H100's peaks) over the sum of
their device times in the profiled chunk."""

from benchmark.harness import readers


def read(ctx):
    return readers.stencils_roofline(ctx)
