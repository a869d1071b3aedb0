"""consumer_ms.live: Median ms a frame spends in the live consumer (engine/processing.py::ProcessingChain:
H2D, the chain, both readbacks, publish): from its pop off the queue to its publish."""

from benchmark.harness import readers


def read(ctx):
    return readers.consumer_ms(ctx)
