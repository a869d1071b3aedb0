"""tp_amplify_device_ms.export: Device ms a frame of the time-parallel phase path's
``phase_tp.amplify`` spans (models/riesz.py::process_clip_parallel: each band level's normalize
and amplify), by their CUDA events, summed over a chunk, over the chunk's frames, median over
the window's chunks outside the profiled one (harness/time_parallel.py). None where the program
has no such span."""

from benchmark.harness import spans, time_parallel

spans.install()


def read(ctx):
    return time_parallel.stage_device_ms(ctx, "amplify")
