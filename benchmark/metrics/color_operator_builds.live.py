"""color_operator_builds.live: Colour bandpass operators built in the measured window outside the
profiled slice: the ``color.operator`` spans (ops/temporal.py::ideal_bandpass_operator, whose body
runs only on a cache miss). 0 in the steady state, once the warm-up has filled the window; a
change that builds an operator every frame reads the frames here. None where the program has no
colour step spans."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    held = spans.unprofiled(ctx)
    if not any(s.name == "color.bandpass" for s in held):
        return None
    return float(sum(s.name == "color.operator" for s in held))
