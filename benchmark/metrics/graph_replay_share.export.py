"""graph_replay_share.export: The share of the window's frames whose step replayed the clip
export's CUDA graph: ``export.replay`` spans over ``export.step`` spans (export/batch.py::
ClipProcessor.process_chunk), outside the profiled chunk. 0 where every frame ran eagerly (a
failed capture, or a program without the step graph); None where there is no ``export.step``
span."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    held = spans.unprofiled(ctx)
    steps = sum(s.name == "export.step" for s in held)
    return sum(s.name == "export.replay" for s in held) / steps if steps else None
