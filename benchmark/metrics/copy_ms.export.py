"""copy_ms.export: Device ms of the host<->device copies a frame (Memcpy HtoD and DtoH: the chunk's
``.to`` and the two panes' ``.cpu()`` in ClipProcessor.process_chunk)."""

from benchmark.harness import readers


def read(ctx):
    return readers.copy_ms(ctx)
