"""launches_per_frame.export: Device kernels a frame in the profiled chunk, copies and memsets left out (the
step's launches: models/riesz.py::step, models/motion.py::step)."""

from benchmark.harness import readers


def read(ctx):
    return readers.launches_per_frame(ctx)
