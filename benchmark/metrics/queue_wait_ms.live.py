"""queue_wait_ms.live: Median ms from a frame's due time to the consumer's pop (engine/queue.py, Drop):
the wait in the queue, plus how late the camera ran."""

from benchmark.harness import readers


def read(ctx):
    return readers.queue_wait_ms(ctx)
