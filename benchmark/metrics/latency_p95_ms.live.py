"""latency_p95_ms.live: 95th percentile of due-to-publish ms of a camera below the engine's knee: the
queue's wait plus the consumer's time; where it nears a frame's period, drops begin and live_fps falls.
Recorded, not bounded: it follows the host's speed, which drifts from run to run."""

from benchmark.harness import readers


def read(ctx):
    return readers.latency_p95_ms(ctx)
