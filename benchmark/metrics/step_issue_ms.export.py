"""step_issue_ms.export: Host ms a frame inside ``export.step`` (export/batch.py::ClipProcessor
.process_chunk: each frame's ``raw_fn`` call, the host issuing the step), over the window's chunks
outside the profiled one."""

from benchmark.harness import spans

spans.install()


def read(ctx):
    return spans.export_ms_per_frame(ctx, "export.step")
