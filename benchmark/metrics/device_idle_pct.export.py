"""device_idle_pct.export: Share of the profiled chunk in which no kernel, copy or memset ran on the card."""

from benchmark.harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
