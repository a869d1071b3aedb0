"""``"kind": "closed"``: ``lvmt magnify`` of a file.

Chunks of ``chunk`` frames go through ``ClipProcessor.process_chunk`` one
after another, each as soon as the last one's panes are back on the host.
``warmup_chunks`` run in set-up. The window holds the chunks that start
within ``--seconds`` and ends when the last of them is back; ``export_fps``
is its frames over its length.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import program
from benchmark.harness.traffic import Run, Window

LAYOUT = "tchw"


def run(r: Run) -> Window:
    clip, device, tracer = r.clip, r.device, r.tracer
    proc = program.clip_processor(r.cfg, device)
    chunk, n = int(r.traffic["chunk"]), clip.shape[0]
    if n % chunk:
        raise ValueError(f"clip of {n} frames does not hold whole chunks of {chunk}")
    chunk_at = lambda k: clip[(k * chunk) % n:(k * chunk) % n + chunk]
    warm = int(r.traffic["warmup_chunks"])
    for k in range(warm):
        proc.process_chunk(chunk_at(k))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rng = np.random.default_rng(r.seed)
    samples, k, done, times = {}, warm, 0, []
    t0 = time.monotonic()
    end = t0
    while end - t0 < r.seconds:
        begin = end
        traced = tracer.enabled and k == warm + 1
        if traced:
            tracer.start()
        processed, original = proc.process_chunk(chunk_at(k))
        if traced:
            tracer.stop(frames=chunk)
        end = time.monotonic()
        times.append(end - begin)
        i = int(rng.integers(chunk))
        samples[k * chunk + i] = (processed[i].copy(), original[i].copy())
        last = (processed[-1].copy(), original[-1].copy())
        k += 1
        done += chunk
    samples[k * chunk - 1] = last
    if tracer.enabled and not tracer.done:  # a window of one chunk: trace one more
        tracer.start()
        proc.process_chunk(chunk_at(k))
        tracer.stop(frames=chunk)
        k += 1
    del proc
    window = end - t0
    return Window(window, done, done, {"export_fps": done / window},
                  [i % n for i in range(k * chunk)], samples, "chw", [], [],
                  {"chunks": k - warm, "chunk_s_min": min(times),
                   "chunk_s_median": float(np.median(times)), "chunk_s_max": max(times)},
                  setup_end=t0)
