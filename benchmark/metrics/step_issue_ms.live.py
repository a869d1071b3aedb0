"""step_issue_ms.live: Median host ms of the live consumer's ``consumer.step`` span
(engine/processing.py::ProcessingChain: MagnificationChain.process, which issues the step to the
card and returns before the card is done), over the window's frames outside the profiled slice."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.median_ms(ctx, "consumer.step")
