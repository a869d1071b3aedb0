#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it needs one;
without it, or without the port's package beside it, it exits non-zero and
prints no result). It builds the port's CUDA kernels from the sources in the
checkout (making the 4K slice's frames on the host meanwhile), then:

  1. kernels: each stencil kernel (ops/hopper/stencils.py) against its plain
     PyTorch version on the card, at odd shapes, at every level shape of a
     2160x3840 levels=6 frame and (conv9, lp9_decimate, lp9_inject) at every
     edge of their tiles and with random taps; band5 bit for bit at every
     edge of its tiles (stencils.band5_shapes()), and all eight of its
     instantiations so (``band5_exact``: aligned and one element off, with
     zeros, -0 and subnormal pixels, the main bank and two others); the
     plain tail's 13x13 amplitude blur (blur13) bit for bit at every shape
     of stencils.blur13_shapes() (``blur13_exact``: aligned and one element
     off, with zeros, -0, subnormals, NaN and infinities, and on batches of
     planes); times
     by CUDA events over back-to-back calls, the wrapper's host cost
     included (``ms``: kernel, plain version, one PyTorch library call
     where one computes the same function), and the
     kernel alone by CUDA graph replay (``graph_ms``); the bound from
     published H100 SXM peaks, and for the 9x9 stencils and the inject a
     second computed bound, the exactness floor (``exact_floor_ms``,
     EXACT_F32_OPS_PER_S);
  2. tail kernels (ops/hopper/tail.py): each entry point against its plain
     version on standard-normal inputs at odd shapes and at every active
     level of the 4K frame, both preweighted and both rebuild arms, within
     the stated bars; the amplify kernel's f32 arms (both entry points)
     equal to the plain version bit for bit at every shape of
     tail.amplify13_shapes(); times by events and by graph replay, bounds,
     shares and (amplify) the exactness floor at each active level;
  3. slice at 4K: 2160x3840, levels=6, phase mode, jnp tail, through
     MagnificationChain.process (HWC u8) and ClipProcessor.process_chunk on the
     same frames; outputs bit-equal, launch counts per frame as expected
     (the chain's by the host counters; a chunk of ClipProcessor's, whose
     frames replay its step's CUDA graph, by the profiler's device kernels),
     frames magnified after the first; steady ms/frame, fps, peak memory and a
     profiler breakdown of device time;
  4. the same slice under every other configuration (LVMT_TAIL pallas, mxu,
     level; LVMT_PHASE_FUSED=1 alone and with pallas; LVMT_BUILD=fused; the
     four flags of --fast): launch counts per frame as expected, frames
     within 1 LSB of the jnp tail's (fast: >= 40 dB against the f32 mxu
     frames, dB and max LSB logged), steady ms/frame, peak memory, device
     kernels per frame; for level also ClipProcessor against the chain and a
     profiler breakdown; then every configuration, jnp included, timed again
     in the reverse order;
  4b. the port's bench (``bench.py``) through ``cli.main(["bench", ...])`` in
     this process (``port_bench``): the 4K headline with ``fast_mode_fps``,
     then ``--matrix`` into a temporary file, every JSON line it prints
     logged; no entry may fail (the GL entry is "skipped" only where no GL
     context can be made); the launches a frame of every kernel in each of
     its loops and sharded calls as derived (the headline's default and
     fast runs as the 4K slice's jnp and fast runs, K5 once a frame in
     the matrix's 1080p phase entry, K10 as the plan's exchanges); the
     headline's warm checksum equal to a plain loop of
     ``models/riesz.py::step`` over the same 8 frames; slice_4k's ms/frame
     logged beside the headline's;
  5. slice on the card against the CPU: 1080x1920, levels=6, >= 40 dB a
     frame, under the jnp and the level tails (K5 launched once a frame, at
     level 4) and under the fast flags;
  6. the fused build (K5, riesz_build_level) against its plain version at odd
     shapes, 68x120, every 4K band level and every edge of its tiles (bit
     for bit, the sign of a zero included, and so against K1+K2+K3), timed
     beside K1+K2+K3 at
     the same shape by events and by graph replay, with its exactness floor;
     every bf16 arm of K1-K4 and K6 against its plain version
     (the 9x9 arms also at every edge of their tiles, the amplify kernel's
     fourteen other instantiations bit for bit at every shape of
     tail.amplify13_shapes()), timed as in 1. at every 4K level with a cuDNN
     bf16 conv2d where one computes the same function;
  7. the column halo exchange (K10, ops/hopper/halo.py) against its plain
     version, bit for bit, for 1, 2, 4 and 8 shards on the card, halos 2, 4
     and 6, both right modes, with and without a leading stack of 6 planes,
     and every exchange of the 4K sharded frame; timed at those shapes by
     events and by graph replay, with the bound's share of each;
  8. the lane-sharded phase step (parallel/riesz_sharded.py, every halo
     exchange through K10) at 2160x3840, levels=6, the 4K clip's first 6
     frames, tail mxu: a
     (1,4) mesh of cuda:0 repeated (virtual shards), and a mesh of 1 with the
     default plan and forced sharded; frames against the unsharded step's
     (1 LSB; mesh of 1 bit-equal), K10 launches a frame as derived from the
     plan; then the same on real cards when there are two or more, with its
     ms/frame beside the mesh of 1's;
  9. motion and colour (no kernel of K1-K10 on their paths, asserted) at
     2160x3840 at each mode's defaults (motion levels 4; colour levels 3,
     30 fps) through the per-chunk calls of ``cli.py magnify``
     (``ClipProcessor.process_chunk`` of one host frame, then ``compose``
     left-right), in two passes, the second in reverse order: steady
     ms/frame, peak memory, device kernels a frame, frames equal to
     ``MagnificationChain.process``'s (its steady ms/frame beside, output
     left on the card, and a profile of two of its frames in the first
     pass), and the colour window's shift by events; then at 1080x1920 on the card against the port's CPU path
     (motion 4 frames within 1 LSB; colour 20 frames at 8 fps, >= 45 dB),
     and one steady step of each under
     ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises).
     cuBLAS and cuDNN are asserted IEEE f32 first;
 10. the time-parallel clip path (``ClipProcessor(time_parallel=True)``,
     ``models/*.py::process_clip_parallel``) at 2160x3840 in all three modes
     (phase levels 6; motion and colour at their defaults), one chunk of
     TP_CHUNK host frames as ``cli.py magnify --time-parallel`` passes it,
     beside the sequential ClipProcessor on the same frames, in two passes,
     the second in reverse order: ms/frame, peak memory and launches of each
     path; phase launches its 25 f32 stencils a frame (K1-K4) and no tail
     kernel, motion and colour none of K1-K10; the time-parallel frames
     against the sequential ones (motion and colour within 1 LSB, phase
     >= 40 dB a frame, with its max LSB and share of pixels over 1 LSB), and
     two chunks against one within the same bars; then at 1080x1920 on the
     card against the port's CPU path (phase and motion 4 frames, colour 20
     at 8 fps so its window rolls, each in two chunks);
 11. the time mesh (``parallel/batch_export.py::DistributedClipExporter``,
     the boundary step of ``parallel/time_shard.py``): the boundary step
     alone by events; then at 2160x3840 in all three modes one chunk of
     TP_CHUNK host frames on TM_SHARDS virtual shards of the card, with and
     without the original stack's readback, beside the unsharded
     time-parallel path on the same frames, in two passes (the second
     reversed): ms/frame, peak memory, launches (phase: 25 f32 stencils a
     frame summed over the shards, no tail or halo kernel; motion and
     colour none of K1-K10), frames against the unsharded path (phase
     >= 40 dB, max LSB and pixels over 1 LSB; motion and colour within
     1 LSB), and in the first pass a partial tail of TM_TAIL frames run
     unsharded; the same over the real cards when there are two or more,
     with its ms/frame over the virtual shards'; then two ranks started by
     this script (``--rank``) at 1080x1920 phase, 4 shards each (NCCL on
     two cards where there are two, else gloo on one), their frames bit
     for bit those of one process's 8 virtual shards;
 11b. the row-sharded steps (``parallel/row_sharded.py`` through
     ``parallel/sharding.py::build_sharded_step``) on virtual shards of the
     card: motion and colour at 2160x3840 at their defaults, two streams
     on a (2,2) mesh and one on (1,4), and phase at 768x1366 levels 6 on
     (1,4) (the fallback for a width that does not lane-shard), ROW_FRAMES
     frames each, beside the unsharded step on the same frames in two
     passes (the second reversed): ms/frame, peak memory, frames against
     the unsharded step (phase and motion bit for bit, colour within one
     LSB, max LSB and pixels differing), launches (phase exactly
     ``row_stencil_launches(plan)`` a frame and stream and no K10; motion
     and colour none of K1-K10); the same over the real cards when there
     are two or more, with its ms/frame over one card's unsharded step;
 12. the live engine (``engine/*``, phase under the default flags): the
     consumer alone (``engine_consumer_4k``: ``ProcessingChain`` on a Block
     queue holding 16 pooled 2160x3840 synthetic frames, each published pair
     bit for bit ``MagnificationChain.process``'s); ``PlaybackController``
     runs of a paced ``SyntheticSource`` (``live_4k30``: 2160x3840 at 30 fps,
     camera semantics; ``live_1080p60``: 1080x1920 at 60 fps;
     ``live_1080p60_roi``: BASELINE config 4 as ``bench.py:215-263`` sets
     it up, on the Python transport and on the native one, LVMT_NATIVE=1)
     with a ``DisplayLoop`` polling at 120 Hz: steady and EMA fps, latency
     mean and p95, captured / processed / drops / display skipped, queue
     depth, the source's render ms alone, the consumer's copies by events,
     and exactly ``ops/riesz.py::stencil_launches`` a processed frame with
     no other kernel, no processing or read error, and every sampled frame
     after the first magnified; then ``record_export_1080p``: about 2 s of
     a synthetic camera recorded through ``start_recording`` /
     ``stop_recording`` and exported by ``Exporter`` (left-right, an
     in-memory writer in place of ``exporter.open_writer``: the card's
     machine has no cv2), every written frame bit for bit a fresh chain's
     frames composed by ``compose``;
 13. the desktop front ends (``gui.py``, ``engine/gl_present.py``), which
     launch only what the live path launches: ``gui_flow_1080p``, the GUI's
     record -> export flow headless at 1080x1920 through its own functions
     (the panel switched to phase at levels 6, ``record_start_guard``,
     ``record_poll_transition``, ``record_stop_decision``,
     ``build_export_config`` with the amplification edited, ``Exporter``
     polled by ``export_poll_transition``), every written frame bit for bit
     a fresh chain's and exactly ``stencil_launches`` a frame;
     ``live_4k30_gui``, ``live_4k30`` with the GUI's canvas present
     (``compose_view`` side by side, ``fit_view`` into 1280x720,
     ``PhotoCodec.ppm``) on the 120 Hz display loop, run alternately with
     the plain ``live_4k30``, twice: present ms (mean, p95, and its parts)
     and frames presented beside each run's fps, drops and latency; and
     ``gl_present``, ``GLDisplayLoop`` on a 1280x720 ``HeadlessGLContext``
     against the live 1080p60 stream, where PyOpenGL imports and EGL makes a
     context (else one line with "skipped" and the error): upload and paint
     ms, frames displayed and skipped, the framebuffer read back.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}; every line before them carries the seconds
since the start (``elapsed_s``). Any failed check raises and exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, data sheet, at 700 W
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM f32 outside the tensor cores, FMA = 2 ops
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor rate, f32 accumulation
# The kernels held bit for bit to their plain versions round every product
# and every sum on its own (__fmul_rn, __fadd_rn: never fused), so each is
# one f32 instruction at least, at most one a lane a cycle: 132 SMs x 128 f32
# lanes x 1.98 GHz (H100 SXM boost). A 9x9 stencil's used tap is two of them.
EXACT_F32_OPS_PER_S = 132 * 128 * 1.98e9
SEED = 20261016
REPLACES = {
    "conv9": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:287",
    "band5": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:482",
    "lp9_decimate": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:656",
    "lp9_inject": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:376",
    "blur13": "none: live_video_magnification_tpu/ops/riesz.py::amplitude_blur is jnp",
}
SOURCE = "live_video_magnification_tpu_torch/ops/hopper/csrc/stencils.cu"
# levels=6; blur13: the plain tail's three blurs a band level
PER_FRAME = {"conv9": 10, "band5": 5, "lp9_decimate": 5, "lp9_inject": 5, "blur13": 15}
STENCIL_KERNELS = ("stencil9_kernel", "band5_kernel", "inject9_kernel",
                   "build_level_kernel", "blur13_kernel")  # in the CUDA source
BUILD_REPLACES = "live_video_magnification_tpu/ops/pallas/riesz_build.py:125"
# The bf16 operand arms (the reference's _mxu_dot bf16 branch,
# conv9_mxu.py:89-101, in each of these kernels)
BF16_REPLACES = {
    "conv9[bf16]": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:287",
    "band5[bf16]": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:482",
    "lp9_decimate[bf16]": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:656",
    "lp9_inject[bf16]": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:376",
    "riesz_amplify_mxu[bf16]": "live_video_magnification_tpu/ops/pallas/riesz_amplify_mxu.py:353",
}
FAST_ENV = {"LVMT_MXU_DTYPE": "bf16", "LVMT_TAIL": "mxu", "LVMT_TAIL_IO": "bf16",
            "LVMT_PYR_IO": "bf16"}  # the reference's cli.py:61-64
FLAG_DEFAULTS = {"LVMT_TAIL": "jnp", "LVMT_PHASE_FUSED": "0", "LVMT_BUILD": "auto",
                 "LVMT_MXU_DTYPE": "f32", "LVMT_PYR_IO": "f32", "LVMT_TAIL_IO": "f32"}

TAIL_SOURCE = "live_video_magnification_tpu_torch/ops/hopper/csrc/tail.cu"
TAIL_REPLACES = {
    "riesz_phase_df2_fused": "live_video_magnification_tpu/ops/pallas/riesz_phase_fused.py:126",
    "riesz_amplify_fused": "live_video_magnification_tpu/ops/pallas/riesz_amplify.py:126",
    "riesz_amplify_mxu": "live_video_magnification_tpu/ops/pallas/riesz_amplify_mxu.py:353",
    "riesz_level_mxu": "live_video_magnification_tpu/ops/pallas/riesz_level_mxu.py:224",
}
TAIL_KERNELS = ("phase_df2_kernel", "amplify13_kernel", "level_tail_kernel")  # in tail.cu
# f32 operations a pixel, counted from the CUDA source (each add, multiply,
# divide, square root, compare-select, sine and cosine as one): the phase
# front ~50, a DF-II pair on its accumulator ~44 (~42 on the shared one), the
# three separable 13-tap blurs 150, the rotation ~19, the weighting 2.
TAIL_OPS_PER_PIXEL = {"riesz_phase_df2_fused": 94, "riesz_amplify_fused": 171,
                      "riesz_amplify_mxu": 171, "riesz_level_mxu": 261}
TAIL_BLUR_OPS_PER_PIXEL = 150  # of K6's 171: the ones on bf16 operands in its bf16 arm
# The bf16 arm's blur products are exact (bf16 operands), so each tap is one
# fused multiply-add with the same bits: 6 sums of 13 taps, 78 instructions
# for the 150 operations; its exactness floor counts those.
TAIL_BF16_BLUR_INSTRUCTIONS = 6 * 13
# planes read + written, each once (rebuild off: the prior pyramid and state are read)
TAIL_PLANES = {"riesz_phase_df2_fused": 18 + 15, "riesz_amplify_fused": 6 + 1,
               "riesz_amplify_mxu": 6 + 1, "riesz_level_mxu": 16 + 11}
# The reference suite's kernel-against-jnp bars (atol, rtol).
TAIL_BARS = {"riesz_phase_df2_fused": {"out": (1e-5, 1e-5)},
             "riesz_amplify_fused": {"out": (2e-4, 1e-4)},
             "riesz_amplify_mxu": {"out": (2e-4, 1e-4)},
             "riesz_level_mxu": {"out": (5e-4, 1e-3), "state": (1e-4, 1e-4)}}
# name -> (flags that differ from FLAG_DEFAULTS, kernel launches per frame
# at 4K levels=6 besides the default build's PER_FRAME). The five active
# levels are all >= 16 px and all >= 96, so the default build never fuses at
# 4K; fused runs K5 on all five and K1 only in the collapse. The fast
# pairing takes the bf16 arms wherever the reference's MXU kernels run:
# every build level, the collapse steps onto levels 0-3 (135x240 is odd), K6
# on all five levels. A tail kernel blurs in place of blur13 (phase_fused's
# plain branch blurs with blur13 too).
CONFIGS = {
    "jnp": ({}, {}),
    "pallas": ({"LVMT_TAIL": "pallas"}, {"riesz_amplify_fused": 5, "blur13": 0}),
    "mxu": ({"LVMT_TAIL": "mxu"}, {"riesz_amplify_mxu": 5, "blur13": 0}),
    "level": ({"LVMT_TAIL": "level"}, {"riesz_level_mxu": 5, "blur13": 0}),
    "phase_fused": ({"LVMT_PHASE_FUSED": "1"}, {"riesz_phase_df2_fused": 5}),
    "phase_fused+pallas": ({"LVMT_PHASE_FUSED": "1", "LVMT_TAIL": "pallas"},
                           {"riesz_phase_df2_fused": 5, "riesz_amplify_fused": 5, "blur13": 0}),
    "fused": ({"LVMT_BUILD": "fused"},
              {"conv9": 5, "band5": 0, "lp9_decimate": 0, "riesz_build_level": 5}),
    "fast": (FAST_ENV, {"conv9": 1, "band5": 0, "lp9_decimate": 0, "lp9_inject": 1,
                        "conv9[bf16]": 9, "band5[bf16]": 5, "lp9_decimate[bf16]": 5,
                        "lp9_inject[bf16]": 4, "riesz_amplify_mxu[bf16]": 5, "blur13": 0}),
}
# the configuration whose run supplies each tail kernel's launch count
TAIL_MAIN_PATH = {"riesz_phase_df2_fused": "phase_fused", "riesz_amplify_fused": "pallas",
                  "riesz_amplify_mxu": "mxu", "riesz_level_mxu": "level"}
HALO_SOURCE = "live_video_magnification_tpu_torch/ops/hopper/csrc/halo.cu"
HALO_REPLACES = "live_video_magnification_tpu/parallel/halo.py:152"
SHARDED_TAIL = "mxu"  # the tail of the sharded runs: K6 on every sharded level
SHARDED_FRAMES = 6   # of the 4K clip, for the lane-sharded cell
BENCH_STEPS = 8      # --steps of the port bench's runs: a warm loop and three timed, each 8 frames


_T0 = time.perf_counter()


def log(**kw) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**kw, "elapsed_s": time.perf_counter() - _T0}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed: the kernels alone, without the host's cost of each call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up (and the kernel build) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (replays * iters)


def exact_floor_ms(instructions: int) -> float:
    """The least time of f32 instructions that may not be fused (every product
    and sum rounded on its own), at EXACT_F32_OPS_PER_S: a 9x9 stencil's
    2 x used taps an output; the amplify kernel's TAIL_OPS_PER_PIXEL (its
    bf16 arm's blurs TAIL_BF16_BLUR_INSTRUCTIONS)."""
    return instructions / EXACT_F32_OPS_PER_S * 1e3


def stencil9_shapes():
    """Shapes that reach every edge of conv9's and lp9_decimate's tiles: the
    smallest sides; one block of each tile (conv9 8x128 and 32x128 outputs,
    decimate 8x64 and 16x128 outputs, i.e. 16x128 and 32x256 inputs) and
    one more row or column; widths of each residue mod 4 (16-byte rows or
    not), small and large enough for the tall tiles (two blocks an SM)."""
    shapes = [(5, 5), (5, 9), (9, 5)]
    for th, tw in [(8, 128), (32, 128), (16, 128), (32, 256)]:
        shapes += [(th, tw), (th + 1, tw), (th, tw + 1)]
    shapes += [(37, 200 + m) for m in range(4)] + [(545, 2048 + m) for m in range(4)]
    return shapes + [(544, 2048), (1088, 4096), (1089, 4097)]


def random_taps(rng):
    """A standard-normal 9x9 bank with scattered zeros: the kernel's run-time
    tap test (the "any" pattern)."""
    k = rng.standard_normal((9, 9)).astype(np.float32)
    k.flat[rng.choice(81, 9, replace=False)] = 0.0
    k[4, 3] = 0.0  # an interior zero, whatever the draw
    return k


def kernel_phase(dev, st, sizes):
    """Kernel vs plain on the card at every shape; times at the finest level."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )
    from live_video_magnification_tpu_torch.ops.riesz import LOWPASS_2X

    rng = np.random.default_rng(SEED)
    plane = lambda h, w: torch.from_numpy(rng.random((h, w), dtype=np.float32) * 100.0).to(dev)
    odd = [(33, 257), (97, 201), (135, 241), (128, 128)]
    build_shapes = odd + sizes[:-1]
    inject_pairs = [((17, 129), (33, 257)), ((49, 101), (97, 201)), ((68, 121), (135, 241)),
                    ((64, 64), (128, 128))]
    inject_pairs += [(sizes[i + 1], sizes[i]) for i in range(len(sizes) - 1)]
    inject_pairs += [p for p in st.inject9_shapes() if p not in inject_pairs]
    any_inject = [((5, 5), (9, 9)), ((17, 129), (33, 257)), ((273, 1025), (545, 2049)),
                  ((540, 960), (1080, 1920))]
    s9_shapes = build_shapes + stencil9_shapes()
    kr = random_taps(rng)
    if st.tap_pattern(kr) != "any" or st.tap_pattern(LOWPASS_2X) != "dense" or \
            st.tap_pattern(RIESZ_HIGHPASS_9x9) != "no_corners":
        raise AssertionError("tap patterns misclassified")
    any_shapes = [(5, 9), (33, 257), (545, 2049), (544, 2048), (1080, 1920)]

    cases = {
        "conv9": [(lambda x: st.conv9(x, RIESZ_HIGHPASS_9x9),
                   lambda x: st.conv9_plain(x, RIESZ_HIGHPASS_9x9), s) for s in s9_shapes]
        + [(lambda x: st.conv9(x, kr), lambda x: st.conv9_plain(x, kr), s) for s in any_shapes],
        "band5": [(lambda x: st.band5(x, RIESZ_BAND_KERNEL),
                   lambda x: st.band5_plain(x, RIESZ_BAND_KERNEL), s) for s in st.band5_shapes()],
        "lp9_decimate": [(lambda x: st.lp9_decimate(x, LOWPASS_2X),
                          lambda x: st.lp9_decimate_plain(x, LOWPASS_2X), s)
                         for s in s9_shapes]
        + [(lambda x: st.lp9_decimate(x, kr), lambda x: st.lp9_decimate_plain(x, kr), s)
           for s in any_shapes],
        "lp9_inject": [(lambda x, o=o: st.lp9_inject(x, LOWPASS_2X, o),
                        lambda x, o=o: st.lp9_inject_plain(x, LOWPASS_2X, o), s)
                       for s, o in inject_pairs]
        + [(lambda x, o=o: st.lp9_inject(x, kr, o), lambda x, o=o: st.lp9_inject_plain(x, kr, o), s)
           for s, o in any_inject],
        "blur13": [(st.blur13, st.blur13_plain, s) for s in st.blur13_shapes()],
    }
    # The kernels keep every product and sum apart in the plain version's
    # order, so they should agree exactly; the stated tolerance leaves room
    # for nothing but a last-bit difference. band5 and blur13 are also held
    # bit for bit.
    tol_rel = 1e-6
    bit_equal = {"band5", "blur13"}
    errs = {}
    for name, runs in cases.items():
        worst = 0.0
        for kernel, plain, shape in runs:
            x = plane(*shape)
            got, ref = kernel(x), plain(x)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g.shape != r.shape:
                    raise AssertionError(f"{name} at {shape}: shape {tuple(g.shape)} != {tuple(r.shape)}")
                err = float((g - r).abs().max())
                bar = tol_rel * max(1.0, float(r.abs().max()))
                if not err <= bar:
                    raise AssertionError(f"{name} at {shape}: max |kernel - plain| {err} > {bar}")
                if name in bit_equal and not same_bits(g, r):
                    raise AssertionError(f"{name} at {shape}: not bit-equal to its plain version")
                worst = max(worst, err)
        errs[name] = worst
        log(phase="kernel_check", kernel=name, shapes=len(runs), max_abs_err=worst,
            tolerance=f"{tol_rel} x max(1, max|plain|)"
            + ("; bit for bit" if name in bit_equal else ""), bit_equal=name in bit_equal)
    return errs


def same_bits(got, ref) -> bool:
    """Bit-equal, the sign of a zero included."""
    import torch

    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (got.shape == ref.shape and got.dtype == ref.dtype
            and torch.equal(got.view(as_int[got.dtype]), ref.view(as_int[ref.dtype])))


def zeros_and_tiny(x):
    """x with a band of zeros (signed zeros in the outputs), a patch of -0
    and a patch of tiny and subnormal values (products below f32's smallest
    subnormal, bf16 operands included), where the shape allows."""
    import torch

    x = x.clone()
    h, w = x.shape
    x[: h // 3] = 0.0
    x[h // 3:, : min(3, w)] = -0.0
    if h > 8 and w > 12:
        x[h // 2: h // 2 + 4, 4:12] = torch.tensor([1e-30, -3e-36, 1e-39, -1e-42],
                                                   device=x.device)[:, None]
    return x


def misaligned(x):
    """A contiguous copy of x one element past an aligned start."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def same_bits_nan(got, ref) -> bool:
    """same_bits where ref is not NaN, and NaN where ref is NaN."""
    import torch

    nan = torch.isnan(ref)
    return (got.shape == ref.shape and got.dtype == ref.dtype
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan]))


def blur13_exact(dev, st):
    """blur13 against its plain version bit for bit (NaN where it has NaN) at
    every shape of st.blur13_shapes(), the plane aligned and one element off,
    with zeros, -0, tiny and subnormal values, NaN and infinities; and on
    [T, H, W] and [B, T, H, W] batches, aligned and one element off."""
    import torch

    rng = np.random.default_rng(SEED + 14)
    plane = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                            * 30.0).to(dev)
    cases = []
    for shape in st.blur13_shapes():
        x = zeros_and_tiny(plane(*shape))
        h, w = shape
        x[(2 * h) // 3, (2 * w) // 3] = float("nan")
        if h * w > 4:
            x[h - 1, w - 1] = float("inf")
            x[h // 2, 0] = float("-inf")
        cases.append(x)
    cases += [plane(5, 135, 241), plane(3, 2, 70, 64), plane(32, 270, 480), plane(2, 7, 13)]
    calls = 0
    for x in cases:
        for offset in (0, 1):
            xi = misaligned(x) if offset else x
            got, ref = st.blur13(xi), st.blur13_plain(xi)
            torch.cuda.synchronize()
            if not same_bits_nan(got, ref):
                raise AssertionError(f"blur13 at {tuple(x.shape)} (offset {offset}): not "
                                     "bit-equal to its plain version")
            calls += 1
    log(phase="blur13_exact", shapes=[list(x.shape) for x in cases], offsets=[0, 1],
        calls=calls, max_abs_err=0.0,
        tolerance="bit for bit, the sign of a zero included; NaN where the plain version has NaN")


def band5_exact(dev, st):
    """All eight band5 instantiations (f32 or bf16 input, f32 or bf16
    outputs, f32 or bf16 operands) against the plain version bit for bit,
    the sign of a zero included, at every shape of st.band5_shapes(), the
    plane aligned and one element off, with zeros, -0 and tiny and subnormal
    pixels, under the main bank, a random bank with a zero and a bank of the
    main pattern with taps below 2^-7 (the last two: run-time taps)."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import RIESZ_BAND_KERNEL

    rng = np.random.default_rng(SEED + 12)
    plane = lambda h, w: torch.from_numpy(rng.random((h, w), dtype=np.float32) * 100.0
                                          - 20.0).to(dev)
    small = np.array([-0.2, -1e-3, 0.0, 1e-3, 0.2], np.float32)
    shapes = st.band5_shapes()
    calls = 0
    for shape in shapes:
        kr = rng.standard_normal(5).astype(np.float32)
        kr[rng.integers(5)] = 0.0
        x = zeros_and_tiny(plane(*shape))
        for offset in (0, 1):
            for dtype in (torch.float32, torch.bfloat16):
                hp = x.to(dtype)
                if offset:
                    hp = misaligned(hp)
                for bank, taps in (("main", RIESZ_BAND_KERNEL), ("random", kr), ("small", small)):
                    for bf16 in (False, True):
                        for od in ("f32", "bf16"):
                            got = st.band5(hp, taps, bf16=bf16, out_dtype=od)
                            ref = st.band5_plain(hp, taps, bf16, od)
                            torch.cuda.synchronize()
                            for part, g, r in zip("ri", got, ref):
                                if not same_bits(g, r):
                                    raise AssertionError(
                                        f"band5 {part} at {shape} (offset {offset}, {dtype}, "
                                        f"{bank} bank, bf16 {bf16}, out {od}): not bit-equal "
                                        "to its plain version")
                            calls += 1
    log(phase="band5_exact", instantiations=8, banks=["main", "random", "small taps"],
        offsets=[0, 1], shapes=[list(s) for s in shapes], calls=calls, max_abs_err=0.0,
        tolerance="bit for bit, the sign of a zero included")


def time_phase(dev, st, sizes):
    """ms of kernel, plain version and library call at each level shape."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        AMPLITUDE_BLUR_KERNEL_1D,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )
    from live_video_magnification_tpu_torch.ops.riesz import LOWPASS_2X

    rng = np.random.default_rng(SEED + 1)
    plane = lambda h, w: torch.from_numpy(rng.random((h, w), dtype=np.float32) * 100.0).to(dev)
    f4 = 4  # bytes per f32

    def conv_module(k, stride=1, out=1):
        m = torch.nn.Conv2d(1, out, k.shape[-1], stride=stride, padding=k.shape[-1] // 2,
                            padding_mode="reflect", bias=False).to(dev)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(np.ascontiguousarray(k, np.float32)).reshape(m.weight.shape))
        return m

    band_w = np.zeros((2, 1, 5, 5), np.float32)
    band_w[0, 0, 2, :] = RIESZ_BAND_KERNEL
    band_w[1, 0, :, 2] = RIESZ_BAND_KERNEL
    g13 = np.asarray(AMPLITUDE_BLUR_KERNEL_1D, np.float32)
    lib = {
        "conv9": conv_module(RIESZ_HIGHPASS_9x9),
        "band5": conv_module(band_w, out=2),
        "lp9_decimate": conv_module(LOWPASS_2X, stride=2),
        "lp9_inject": None,  # no PyTorch call has reflect-101 on the injected array
        # the 13x13 outer product of the taps, one reflect-padded convolution
        "blur13": conv_module(np.outer(g13, g13)),
    }
    nnz = lambda k: int(np.count_nonzero(k))
    rows = []
    for lvl in range(len(sizes) - 1):
        (h, w), (sh, sw) = sizes[lvl], sizes[lvl + 1]
        x = plane(h, w)
        small = plane(sh, sw)
        hw, shw = h * w, sh * sw
        oh, ow = (h + 1) // 2, (w + 1) // 2
        specs = {
            # name: (kernel call, plain call, library call input, bytes, operations)
            "conv9": (lambda: st.conv9(x, RIESZ_HIGHPASS_9x9),
                      lambda: st.conv9_plain(x, RIESZ_HIGHPASS_9x9), x,
                      2 * hw * f4, 2 * nnz(RIESZ_HIGHPASS_9x9) * hw),
            "band5": (lambda: st.band5(x, RIESZ_BAND_KERNEL),
                      lambda: st.band5_plain(x, RIESZ_BAND_KERNEL), x,
                      3 * hw * f4, 2 * 2 * nnz(RIESZ_BAND_KERNEL) * hw),
            "lp9_decimate": (lambda: st.lp9_decimate(x, LOWPASS_2X),
                             lambda: st.lp9_decimate_plain(x, LOWPASS_2X), x,
                             (hw + oh * ow) * f4, 2 * 81 * oh * ow),
            # each output meets the taps of its parity class: 81/4 on average
            "lp9_inject": (lambda: st.lp9_inject(small, LOWPASS_2X, (h, w)),
                           lambda: st.lp9_inject_plain(small, LOWPASS_2X, (h, w)), None,
                           (shw + hw) * f4, 2 * 81 * hw // 4),
            # two passes of 13 products and 12 sums an output
            "blur13": (lambda: st.blur13(x), lambda: st.blur13_plain(x), x,
                       2 * hw * f4, 2 * 25 * hw),
        }
        floors = {"conv9": 2 * nnz(RIESZ_HIGHPASS_9x9) * hw, "lp9_decimate": 2 * 81 * oh * ow,
                  "lp9_inject": 2 * 81 * hw // 4, "blur13": 2 * 25 * hw}
        iters = 50 if lvl == 0 else 200
        for name, (kernel, plain, lib_in, nbytes, ops) in specs.items():
            ms = cuda_ms(kernel, iters)
            plain_ms = cuda_ms(plain, max(5, iters // 10), warmup=1)
            lib_ms = None
            if lib[name] is not None:
                inp = lib_in[None, None]
                with torch.no_grad():
                    lib_ms = cuda_ms(lambda: lib[name](inp), iters)
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
            rows.append(dict(kernel=name, level=lvl, shape=[h, w], ms=ms,
                             graph_ms=graph_ms(kernel, iters), plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
                             bound_share=max(bytes_ms, ops_ms) / ms,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             bytes=nbytes, operations=ops))
            if name in floors:
                rows[-1]["exact_floor_ms"] = exact_floor_ms(floors[name])
            log(phase="kernel_time", **rows[-1])
    return rows


@contextlib.contextmanager
def flag_env(flags):
    """The chain's kernel flags (FLAG_DEFAULTS overridden by ``flags``) in
    the environment, where the chain reads them; restored after."""
    saved = {k: os.environ.get(k) for k in FLAG_DEFAULTS}
    os.environ.update({**FLAG_DEFAULTS, **flags})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_counts(*modules) -> None:
    for m in modules:
        for counts in (m.LAUNCHES, getattr(m, "LAUNCHES_BF16", {})):
            for k in counts:
                counts[k] = 0


def launch_counts(*modules) -> dict:
    """Every launch count of the modules; the bf16 arms as "name[bf16]"."""
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
        out.update({f"{k}[bf16]": v for k, v in getattr(m, "LAUNCHES_BF16", {}).items()})
    return out


def expected_counts(frames: int, per_frame: dict, *modules) -> dict:
    """The default build's PER_FRAME updated by ``per_frame``, every other
    count 0, times ``frames``."""
    want = {k: 0 for k in launch_counts(*modules)}
    want.update(PER_FRAME)
    want.update(per_frame)
    return {k: v * frames for k, v in want.items()}


def tail_coeffs():
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs

    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(1.0, 30.0),
                                  butterworth_bandpass_coeffs(5.0, 30.0))
    return [np.asarray(c, np.float32) for c in (b_lo, a_lo, b_hi, a_hi)]


def tail_args(rng, entry, shape, arm, dev, coeffs):
    """Standard-normal planes for one entry point. ``arm`` is the rebuild flag
    of the phase and level kernels and the preweighted flag of the amplify
    kernels (whose amplitude plane is the magnitude of a standard normal)."""
    import torch

    def planes(n):
        return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                for _ in range(n)]

    alpha, threshold = 50.0, float(np.float32(0.5 * np.pi))
    if entry == "riesz_phase_df2_fused":
        x = planes(18)
        return (*x[:6], tuple(x[6:12]), tuple(x[12:]), *coeffs, arm), {}
    if entry == "riesz_level_mxu":
        x = planes(16)
        return (*x[:6], tuple(x[6:8]), tuple(x[8:12]), tuple(x[12:]), *coeffs, arm,
                alpha, threshold), {}
    amp, cc, cs, lp, rr, ri = planes(6)
    amp = amp.abs()
    if arm:
        cc, cs = cc * amp, cs * amp
    return (amp, cc, cs, lp, rr, ri, alpha, threshold), {"preweighted": arm}


def tail_parts(entry, out):
    """(bar name, plane) pairs of one entry point's outputs."""
    if entry == "riesz_phase_df2_fused":
        return [("out", x) for x in (*out[:3], *out[3], *out[4])]
    if entry == "riesz_level_mxu":
        return [("out", out[0])] + [("state", x) for x in (*out[1], *out[2], *out[3])]
    return [("out", out)]


def tail_plain(tl, entry):
    return {"riesz_phase_df2_fused": tl.riesz_phase_df2_fused_plain,
            "riesz_amplify_fused": tl.riesz_amplify_plain,
            "riesz_amplify_mxu": tl.riesz_amplify_plain,
            "riesz_level_mxu": tl.riesz_level_mxu_plain}[entry]


def bar_excess(got, ref, atol, rtol):
    """(max |got - ref|, max |got - ref| / (atol + rtol |ref|)); a NaN in both
    counts as equal, a NaN in one as an infinite error."""
    import torch

    both_nan = torch.isnan(got) & torch.isnan(ref)
    diff = torch.where(both_nan, torch.zeros_like(got), (got - ref).abs())
    diff = torch.nan_to_num(diff, nan=float("inf"))
    ratio = diff / (atol + rtol * torch.nan_to_num(ref.abs(), nan=0.0))
    return float(diff.max()), float(ratio.max())


def tail_kernel_check(dev, tl, sizes):
    """Every tail entry point against its plain version on the card, both
    arms, at odd shapes and at every active level of the 4K frame."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    coeffs = tail_coeffs()
    shapes = [(16, 16), (33, 257), (97, 201), (135, 241)] + list(sizes[:-1])
    errs = {}
    for entry in TAIL_REPLACES:
        worst = {part: [0.0, 0.0] for part in TAIL_BARS[entry]}
        for shape in shapes:
            for arm in (False, True):
                args, kw = tail_args(rng, entry, shape, arm, dev, coeffs)
                got = getattr(tl, entry)(*args, **kw)
                ref = tail_plain(tl, entry)(*args, **kw)
                torch.cuda.synchronize()
                for (part, g), (_, r) in zip(tail_parts(entry, got), tail_parts(entry, ref)):
                    if g.shape != r.shape or g.device != r.device:
                        raise AssertionError(f"{entry} at {shape}: {g.shape} vs {r.shape}")
                    atol, rtol = TAIL_BARS[entry][part]
                    err, ratio = bar_excess(g, r, atol, rtol)
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"{entry} at {shape}, arm {arm}: {part} off by {err} "
                            f"({ratio:.3g} x the bar atol {atol} + rtol {rtol} x |plain|)")
                    worst[part] = [max(worst[part][0], err), max(worst[part][1], ratio)]
        errs[entry] = max(v[0] for v in worst.values())
        log(phase="tail_kernel_check", kernel=entry, shapes=[list(s) for s in shapes],
            arms="preweighted" if "amplify" in entry else "rebuild",
            max_abs_err={p: v[0] for p, v in worst.items()},
            max_share_of_bar={p: v[1] for p, v in worst.items()},
            bars={p: {"atol": a, "rtol": r} for p, (a, r) in TAIL_BARS[entry].items()})
    amplify_exact(dev, tl, [(e, pw, "f32", "f32", False) for e in ("riesz_amplify_fused",
                                                                  "riesz_amplify_mxu")
                            for pw in (False, True)], SEED + 10)
    return errs


def amplify_exact(dev, tl, arms, seed):
    """The amplify kernel against its plain version bit for bit at every shape
    of tail.amplify13_shapes(): max |kernel - plain| 0 and NaN where the plain
    version has NaN (a zero-amplitude patch wider than the blur makes some;
    another patch takes the planes down to subnormal values).
    ``arms``: (entry point, preweighted, amplitude/change dtype,
    lowpass/Riesz dtype, bf16 operands)."""
    import torch

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(seed)
    shapes = tl.amplify13_shapes()
    nans = 0
    for shape in shapes:
        six = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
               for _ in range(6)]
        six[0] = six[0].abs()
        if min(shape) > 20:
            six[0][3:18, 5:20] = 0.0
        if min(shape) > 40:  # subnormal operands (the bf16 arm's exact products)
            for x in six[:3]:
                x[20:34, 24:40] *= 1e-38
        for entry, pw, tb, te, bf16 in arms:
            planes = list(six)
            if pw:
                planes[1], planes[2] = planes[1] * planes[0], planes[2] * planes[0]
            ins = [x.to(dtypes[tb]) for x in planes[:3]] + [x.to(dtypes[te]) for x in planes[3:]]
            kw = {"bf16": True} if bf16 else {}
            got = getattr(tl, entry)(*ins, 50.0, 1.2, preweighted=pw, **kw)
            ref = tl.riesz_amplify_plain(*ins, 50.0, 1.2, preweighted=pw, bf16=bf16)
            torch.cuda.synchronize()
            nan_got, nan_ref = torch.isnan(got), torch.isnan(ref)
            both = ~(nan_got | nan_ref)
            err = float((got - ref).abs()[both].max()) if bool(both.any()) else 0.0
            nan_off = int((nan_got != nan_ref).sum())
            if err != 0.0 or nan_off:
                raise AssertionError(f"{entry} at {shape} (preweighted {pw}, {tb}/{te}, bf16 "
                                     f"{bf16}): max |kernel - plain| {err}, {nan_off} pixels "
                                     f"NaN in one only")
            nans += int(nan_ref.sum())
    log(phase="amplify13_exact", arms=[list(a) for a in arms], shapes=[list(s) for s in shapes],
        max_abs_err=0.0, nan_mismatches=0, nan_outputs=nans, tolerance="bit for bit")


def tail_kernel_time(dev, tl, sizes):
    """ms of each tail entry point (by events and by graph replay) and of its
    plain version at every active 4K level, with the bound from this run's
    shapes and, for the amplify kernel, its exactness floor."""
    rng = np.random.default_rng(SEED + 4)
    coeffs = tail_coeffs()
    rows = []
    for lvl, (h, w) in enumerate(sizes[:-1]):
        iters = 50 if lvl == 0 else 200
        for entry in TAIL_REPLACES:
            args, kw = tail_args(rng, entry, (h, w), False, dev, coeffs)
            kernel, plain = getattr(tl, entry), tail_plain(tl, entry)
            ms = cuda_ms(lambda: kernel(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), max(5, iters // 10), warmup=1)
            nbytes = TAIL_PLANES[entry] * h * w * 4
            ops = TAIL_OPS_PER_PIXEL[entry] * h * w
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
            rows.append(dict(kernel=entry, level=lvl, shape=[h, w], ms=ms,
                             graph_ms=graph_ms(lambda: kernel(*args, **kw), iters),
                             plain_ms=plain_ms, library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                             bound_share=max(bytes_ms, ops_ms) / ms,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             bytes=nbytes, operations=ops))
            if "amplify" in entry:
                rows[-1]["exact_floor_ms"] = exact_floor_ms(ops)
            log(phase="tail_kernel_time", **rows[-1])
    return rows


def profile_chain(torch, chain, frames, cfg):
    """Device time by kernel over a few steady chain frames (torch.profiler)."""
    return profile_run(torch, lambda: [chain.process(f, cfg) for f in frames], len(frames))


def profile_run(torch, run, n):
    """Device time by kernel of ``run()``, which processes ``n`` frames
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    dev_ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    stencils = [e for e in events if any(k in e.key for k in STENCIL_KERNELS)]
    tails = [e for e in events if any(k in e.key for k in TAIL_KERNELS)]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    device_ms = dev_ms(events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    return dict(frames=n, wall_ms=1e3 * wall, device_ms=device_ms,
                device_busy_share=device_ms / (1e3 * wall),
                stencil_kernels_ms=dev_ms(stencils), tail_kernels_ms=dev_ms(tails),
                copies_ms=dev_ms(copies),
                other_kernels_ms=device_ms - dev_ms(stencils) - dev_ms(tails) - dev_ms(copies),
                device_kernels_per_frame=sum(e.count for e in events if e not in copies) / n,
                kernels=[dict(name=e.key[:90], device_ms=e.self_device_time_total / 1e3,
                              calls=e.count) for e in (stencils + tails)],
                top=[dict(name=e.key[:90], device_ms=e.self_device_time_total / 1e3,
                          calls=e.count) for e in top])


def device_kernels_per_frame(torch, chain, frame, cfg):
    """Device kernels one chain frame launches, by the profiler (CUDA only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain.process(frame, cfg)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
               and not e.key.startswith(("Memcpy", "Memset", "Activity Buffer")))


def cfg_4k(levels=6):
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )

    return ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=50.0, co_wavelength=50.0,
        co_low=1.0, co_high=5.0, levels=levels, framerate=30.0))


def run_chain(torch, dev, frames, cfg, modules):
    """The frames through a fresh MagnificationChain, counts reset just
    before. Returns (outputs as a numpy stack, step seconds, launch counts,
    peak device memory, the chain)."""
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain

    gc.collect()  # the previous run's chain and state, if the caller let them go
    torch.cuda.empty_cache()
    chain = MagnificationChain(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(*modules)
    outs, step_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        processed, _ = chain.process(f, cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(processed)
    launches = launch_counts(*modules)
    peak = torch.cuda.max_memory_allocated(dev)
    return torch.stack(outs).cpu().numpy(), step_s, launches, peak, chain


def frames_4k(h=2160, w=3840, t=8):
    """The 4K slice's synthetic clip, [t, h, w, 3] u8 on the host."""
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    t0 = time.perf_counter()
    frames = moving_clip(t, h, w, seed=SEED)
    log(phase="slice_4k_frames", seconds=time.perf_counter() - t0, shape=list(frames.shape))
    return frames


def slice_4k(torch, dev, st, tl, frames):
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor

    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    levels = 6
    cfg = cfg_4k(levels)
    with flag_env({}):
        chain_out, step_s, launches, peak, chain = run_chain(torch, dev, frames, cfg, (st, tl))
        expected = expected_counts(t, {}, st, tl)
        if launches != expected:
            raise AssertionError(f"4K chain launches {launches} != expected {expected}")
        # the chain's launches by device kernel (conv9 and lp9_decimate are
        # both stencil9_kernel), none of the tail's
        by_kernel = {"stencil9_kernel": launches["conv9"] + launches["lp9_decimate"],
                     "band5_kernel": launches["band5"], "inject9_kernel": launches["lp9_inject"],
                     "build_level_kernel": launches["riesz_build_level"],
                     "blur13_kernel": launches["blur13"], **{k: 0 for k in TAIL_KERNELS}}
        launches = {k: launches[k] for k in PER_FRAME}
        if not np.array_equal(chain_out[0], frames[0]):
            raise AssertionError("4K frame 0 is not the passthrough of the input")
        moved = [int(np.count_nonzero(chain_out[i] != frames[i])) for i in range(1, t)]
        if min(moved) == 0:
            raise AssertionError(f"4K frames after the first left unchanged: {moved}")

        # the same frames through the clip processor, device-resident input
        proc = ClipProcessor(cfg, h, w, 3, device=dev)
        tchw = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        processed, _ = proc.process_chunk(tchw)  # returns host arrays: synchronizes
        clip_s = time.perf_counter() - t0
        clip_out = processed.transpose(0, 2, 3, 1)
        if not np.array_equal(clip_out, chain_out):
            raise AssertionError("4K ClipProcessor output differs from the chain's")
        # its frames after the first replay the step's CUDA graph, whose
        # kernels the host counters never see: count a replayed chunk's from
        # the device trace
        prof = profile_run(torch, lambda: proc.process_chunk(tchw), t)
        replayed = {k: sum(r["calls"] for r in prof["kernels"] if k in r["name"])
                    for k in by_kernel}
        if replayed != by_kernel:
            raise AssertionError(f"4K clip replayed kernels {replayed} != the chain's {by_kernel}")
        del proc

        steady = step_s[2:]
        steady_ms = 1e3 * sum(steady) / len(steady)
        log(phase="slice_4k", card=torch.cuda.get_device_name(dev), shape=[h, w],
            levels=levels, frames=t,
            chain_step_ms=[1e3 * s for s in step_s], chain_steady_ms_per_frame=steady_ms,
            chain_steady_fps=1e3 / steady_ms, clip_ms_per_frame_with_readback=1e3 * clip_s / t,
            clip_fps=t / clip_s, peak_memory_bytes=peak, launches=launches,
            launches_per_frame={k: v // t for k, v in launches.items()},
            clip_replayed_kernels=replayed, clip_replayed_kernels_per_frame=(
                prof["device_kernels_per_frame"]),
            changed_pixels_after_frame0=moved, chain_equals_clip=True)

        # where the device time goes, over two steady frames of the chain
        prof = profile_chain(torch, chain, frames[:2], cfg)
        log(phase="profile_4k", card=torch.cuda.get_device_name(dev), **prof)
    return launches, frames, chain_out, steady_ms


def frame_stats(out, ref):
    """Per frame (PSNR dB, max |diff| in u8 LSB) of two u8 stacks."""
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8

    return ([psnr_u8(out[i], ref[i]) for i in range(len(out))],
            [int(np.abs(out[i].astype(np.int16) - ref[i].astype(np.int16)).max())
             for i in range(len(out))])


def slice_4k_tails(torch, dev, st, tl, frames, jnp_out):
    """The 4K slice under every other configuration, each against the jnp
    configuration's frames (fast against the f32 mxu frames). Returns the
    launch counts of each run."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor

    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    cfg = cfg_4k()
    runs, kept = {}, {}
    for name, (flags, per_frame) in CONFIGS.items():
        if name == "jnp":
            continue  # slice_4k's run
        with flag_env(flags):
            out, step_s, launches, peak, chain = run_chain(torch, dev, frames, cfg, (st, tl))
            expected = expected_counts(t, per_frame, st, tl)
            if launches != expected:
                raise AssertionError(f"4K {name} launches {launches} != expected {expected}")
            against = "mxu" if name == "fast" else "jnp"
            dbs, lsb = frame_stats(out, kept["mxu"] if name == "fast" else jnp_out)
            if name == "fast" and min(dbs[1:]) < 40.0:
                raise AssertionError(f"4K fast: frames against f32 mxu at {dbs} dB")
            if name != "fast" and max(lsb) > 1:
                raise AssertionError(f"4K {name}: frames off the jnp tail's by {lsb} LSB")
            kernels = device_kernels_per_frame(torch, chain, frames[2], cfg)
            extra = {}
            if name in ("level", "fast"):
                proc = ClipProcessor(cfg, h, w, 3, device=dev)
                tchw = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
                processed, _ = proc.process_chunk(tchw.to(dev))
                if not np.array_equal(processed.transpose(0, 2, 3, 1), out):
                    raise AssertionError(f"4K {name}: ClipProcessor output differs from the chain's")
                extra["chain_equals_clip"] = True
                extra["carried_band_dtype"] = str(proc.state.old[0].lowpass.dtype)
                del proc, tchw, processed
            steady_ms = 1e3 * sum(step_s[2:]) / len(step_s[2:])
            runs[name] = launches
            log(phase="slice_4k_tail", config=name, flags=flags,
                card=torch.cuda.get_device_name(dev), shape=[h, w], levels=6, frames=t,
                chain_step_ms=[1e3 * s for s in step_s], chain_steady_ms_per_frame=steady_ms,
                chain_steady_fps=1e3 / steady_ms, peak_memory_bytes=peak,
                launches_per_frame={k: v // t for k, v in launches.items() if v},
                device_kernels_per_frame=kernels, frames_against=against, psnr_db=dbs,
                **{f"max_lsb_vs_{against}": lsb}, **extra)
            if name == "level":
                prof = profile_chain(torch, chain, frames[:2], cfg)
                log(phase="profile_4k_tail", config=name,
                    card=torch.cuda.get_device_name(dev), **prof)
            if name == "mxu":
                kept["mxu"] = out
            del chain, out  # nothing of this run stays alive into the next

    # The step is host-bound and its time drifts within a call, so every
    # configuration is timed a second time, in the reverse order.
    for name in reversed(list(CONFIGS)):
        with flag_env(CONFIGS[name][0]):
            step_s, peak = run_chain(torch, dev, frames, cfg, (st, tl))[1:4:2]
        steady_ms = 1e3 * sum(step_s[2:]) / len(step_s[2:])
        log(phase="slice_4k_tail_repeat", config=name,
            card=torch.cuda.get_device_name(dev), chain_step_ms=[1e3 * s for s in step_s],
            chain_steady_ms_per_frame=steady_ms, chain_steady_fps=1e3 / steady_ms,
            peak_memory_bytes=peak)
    return runs


def bench_expected(call, steps, *modules):
    """Every launch count of the modules for one bench loop ``call`` (mode,
    h, w, levels, flags, parallel): four runs of ``steps`` frames; the fast
    flags at 4K as the 4K slice's fast run, else the default path's stencils
    (``tp_expected``: phase's f32 stencils a frame and blur13 a frame, or a
    run of the time-parallel loop, which blurs its frames as one batch;
    motion and colour none)."""
    frames = 4 * steps
    if call["flags"] == {**FLAG_DEFAULTS, **FAST_ENV}:
        if (call["h"], call["w"], call["levels"]) != (2160, 3840, 6):
            raise AssertionError(f"port bench: a fast run at {call} has no derived count")
        return expected_counts(frames, CONFIGS["fast"][1], *modules)
    if call["flags"] != FLAG_DEFAULTS:
        raise AssertionError(f"port bench: a loop ran under {call['flags']}")
    return tp_expected(call["mode"], frames, call["h"], call["w"], call["levels"], *modules,
                       batches=4 if call["parallel"] else frames)


def port_bench(torch, dev, st, tl, hl, jnp_ms, steps=BENCH_STEPS):
    """The port's bench through its CLI in this process: the 4K headline
    (``fast_mode_fps`` beside it), then ``--matrix`` into a temporary file.
    Each of its loops and sharded calls runs with the counts set to 0 just
    before it and read just after. Returns the launches of each call."""
    import io
    import re
    import tempfile

    from live_video_magnification_tpu_torch import bench, cli
    from live_video_magnification_tpu_torch.engine.gl_present import gl_available
    from live_video_magnification_tpu_torch.models import riesz
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import make_plan

    modules = (st, tl, hl)
    calls = []

    def counted(fn, kind):
        def run(*args, **kw):
            reset_counts(*modules)
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            calls.append(dict(kind=kind, args=args,
                              kwargs={k: v for k, v in kw.items() if k != "device"},
                              flags={k: os.environ.get(k) for k in FLAG_DEFAULTS},
                              launches=launch_counts(*modules)))
            return r
        return run

    class Lines(io.TextIOBase):
        """The bench's standard output: each JSON line logged as it comes."""

        def __init__(self, name, out):
            self.name, self.out, self.buf, self.lines = name, out, "", []

        def write(self, text):
            self.buf += text
            while "\n" in self.buf:
                line, self.buf = self.buf.split("\n", 1)
                if line.startswith("{"):
                    self.lines.append(json.loads(line))
                    with contextlib.redirect_stdout(self.out):
                        log(phase="port_bench", run=self.name, **self.lines[-1])
            return len(text)

    def run_cli(name, argv):
        out, err = Lines(name, sys.stdout), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["bench", *argv])
        lines = out.lines
        if rc != 0:
            raise AssertionError(f"port bench {name}: exit {rc}; stderr {err.getvalue()[-2000:]}")
        return lines, err.getvalue()

    saved = {k: getattr(bench, k) for k in ("bench_mode_scan", "bench_time_parallel",
                                             "bench_sharded_step")}
    for k, fn in saved.items():
        setattr(bench, k, counted(fn, k))
    try:
        with flag_env({}):
            t0 = time.perf_counter()
            (headline,), err = run_cli("headline", ["--steps", str(steps)])
            headline_s = time.perf_counter() - t0
            head_calls = list(calls)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                matrix, _ = run_cli("matrix", ["--matrix", "--steps", str(steps), "--out",
                                               os.path.join(tmp, "matrix.json")])
            matrix_s = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(bench, k, fn)

    failed = [e for e in matrix if "error" in e]
    if failed or "fast_mode_fps" not in headline:
        raise AssertionError(f"port bench: failed entries {failed}, headline {headline}")
    gl = next(e for e in matrix if e["metric"] == "display_present_gl_1080p")
    if ("skipped" in gl) == gl_available():
        raise AssertionError(f"port bench: the GL entry {gl} with gl_available() "
                             f"{gl_available()}")

    # every loop's and sharded call's launches, against their derivation
    per_call = []
    for call in calls:
        launches = call["launches"]
        if call["kind"] == "bench_sharded_step":
            h, w, levels, n = call["args"][:4]
            frames = 4 * n
            plan = make_plan(h, w, levels, 1, force_sharded=call["kwargs"].get("force_halo", False))
            want = len(halo_exchanges(plan, FLAG_DEFAULTS["LVMT_TAIL"])) * frames
            got = launches["halo_exchange_cols_rdma"]
            if got != want:
                raise AssertionError(f"port bench sharded {call['kwargs']}: K10 {got}, derived {want}")
        else:
            mode, h, w, levels = call["args"][:4]
            n = call["kwargs"]["t_chunk"] if call["kind"] == "bench_time_parallel" else call["args"][4]
            frames = 4 * n
            want = bench_expected(dict(mode=mode, h=h, w=w, levels=levels, flags=call["flags"],
                                       parallel=call["kind"] == "bench_time_parallel"),
                                  n, *modules)
            if launches != want:
                raise AssertionError(f"port bench {call['kind']} {call['args']} under "
                                     f"{call['flags']}: launches {launches} != {want}")
        per_call.append(dict(kind=call["kind"], kwargs=call["kwargs"],
                             args=[a for a in call["args"] if not isinstance(a, torch.device)],
                             fast=call["flags"]["LVMT_TAIL"] == FAST_ENV["LVMT_TAIL"],
                             launches_per_frame={k: v / frames for k, v in launches.items() if v}))
    kinds = [c["kind"] for c in calls]
    if kinds.count("bench_sharded_step") != 2 or len(head_calls) != 2:
        raise AssertionError(f"port bench: calls {kinds}, headline {len(head_calls)}")
    k5 = [c for c in calls if c["kind"] == "bench_mode_scan"
          and c["args"][:3] == ("phase", 1080, 1920)]
    if len(k5) != 1 or k5[0]["launches"]["riesz_build_level"] != 4 * steps:
        raise AssertionError(f"port bench: K5 in the 1080p phase entry {k5}")

    # the headline's warm checksum against a plain loop of the step
    m = re.search(r"checksums=\((\d+), (\d+)\)", err)
    ms = re.search(r"steady=([0-9.]+)ms/frame", err)
    if m is None or ms is None:
        raise AssertionError(f"port bench: no checksums or ms/frame in {err!r}")
    h, w = 2160, 3840
    gen = np.random.default_rng(0)
    base = torch.from_numpy(gen.integers(0, 255, (3, h, w + 64), dtype=np.uint8)).to(dev)
    state, dyn, total = riesz.init_state(h, w, 6, device=dev), sharded_dyn(), 0
    for t in range(steps):
        state, out = riesz.step(state, base[:, :, t % 64:t % 64 + w].contiguous(), dyn, levels=6)
        total += int(out[:, ::64, ::64].to(torch.int64).sum().item())
    del state, out, base
    if int(m.group(1)) != total:
        raise AssertionError(f"port bench: warm checksum {m.group(1)} != the plain loop's {total}")
    log(phase="port_bench_check", card=torch.cuda.get_device_name(dev),
        headline_ms_per_frame=float(ms.group(1)), slice_4k_jnp_steady_ms_per_frame=jnp_ms,
        headline_fps=headline["value"], fast_mode_fps=headline["fast_mode_fps"],
        warm_checksum=total, checksums=[int(m.group(1)), int(m.group(2))],
        headline_seconds=headline_s, matrix_seconds=matrix_s,
        gl=gl.get("skipped", "ran"), calls=per_call)
    return calls


def slice_card_vs_cpu(torch, dev, st, tl, name="jnp", h=1080, w=1920, t=4):
    """The 1080p flagship (levels=6) on the card against the port's CPU path
    under CONFIGS[name]'s flags. Under the default build K5 runs once a
    frame, at level 4 (68x120, the one level from 16 to 95). Returns the
    card's launch counts."""
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )
    from live_video_magnification_tpu_torch.ops import riesz as ops_riesz
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    levels = 6
    flags = CONFIGS[name][0]
    k5_shapes = []  # the shapes the card's K5 launches took
    real_k5 = ops_riesz.riesz_build_level

    def k5_seen(x, *args, **kw):
        if x.is_cuda:
            k5_shapes.append(tuple(x.shape))
        return real_k5(x, *args, **kw)

    cfg = ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=50.0, co_wavelength=50.0,
        co_low=1.0, co_high=5.0, levels=levels, framerate=30.0))
    frames = moving_clip(t, h, w, seed=SEED + 2)
    a_frames, b_frames = [], []
    t0 = time.perf_counter()
    with flag_env(flags):
        gpu, cpu = MagnificationChain(device=dev), MagnificationChain(device="cpu")
        reset_counts(st, tl)
        ops_riesz.riesz_build_level = k5_seen
        try:
            for f in frames:
                a_frames.append(gpu.process(f, cfg)[0].cpu().numpy())
        finally:
            ops_riesz.riesz_build_level = real_k5
        torch.cuda.synchronize()
        launches = launch_counts(st, tl)
        for f in frames:
            b_frames.append(cpu.process(f, cfg)[0].numpy())
        key = gpu._key
    dbs, lsbs = frame_stats(a_frames, b_frames)
    if min(dbs) < 40.0:
        raise AssertionError(f"1080p {name}: card vs CPU {dbs} dB, some under 40")
    if (key.tail, key.build, key.mxu_dtype, key.pyr_io, key.tail_io) != (
            flags.get("LVMT_TAIL", "jnp"), flags.get("LVMT_BUILD", "auto"),
            flags.get("LVMT_MXU_DTYPE", "f32"), flags.get("LVMT_PYR_IO", "f32"),
            flags.get("LVMT_TAIL_IO", "f32")):
        raise AssertionError(f"1080p chain ran the key {key}, not the flags {flags}")
    if launches["riesz_build_level"] != t or set(k5_shapes) != {(68, 120)}:
        raise AssertionError(f"1080p {name}: K5 launched {launches['riesz_build_level']} "
                             f"times in {t} frames at {set(k5_shapes)}, not once a frame "
                             "at level 4 (68x120)")
    log(phase="slice_1080p_card_vs_cpu", config=name, flags=flags,
        card=torch.cuda.get_device_name(dev), shape=[h, w], levels=levels, frames=t,
        psnr_db=dbs, max_lsb=lsbs,
        launches_per_frame={k: v / t for k, v in launches.items() if v},
        seconds=time.perf_counter() - t0)
    return launches


MODES_4K = ("laplace", "color")  # the phases' order in the first pass; reversed in the second


def mode_cfg(mode, levels=None, fps=None):
    """The chain configuration of ``defaults_for(mode)`` (the CLI's defaults),
    with its depth or capture rate replaced where given."""
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        ProcessorConfig,
        defaults_for,
        to_params,
    )

    ui = defaults_for(MagnificationMode(mode))
    if levels is not None:
        ui.levels = levels
    if fps is not None:
        ui.capture_fps = fps
    return ProcessorConfig(magnification=to_params(ui))


def assert_ieee_f32(torch):
    """cuBLAS and cuDNN in IEEE f32 (device.pin_ieee_f32): the colour
    bandpass and the resizes are matmuls."""
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    precision = getattr(torch.backends.cuda.matmul, "fp32_precision", "ieee")
    if any(flags.values()) or precision != "ieee":
        raise AssertionError(f"f32 is not IEEE: {flags}, matmul.fp32_precision={precision}")
    return {**flags, "cuda.matmul.fp32_precision": precision}


def window_shift_ms(torch, dev, cfg, h, w):
    """Device time of colour mode's window shift (models/color.py: one copy
    of the [W, C, hs, ws] window a frame once it is full), by CUDA events."""
    from live_video_magnification_tpu_torch.models import color as color_mode

    p = cfg.magnification
    state = color_mode.init_state(h, w, 3, p.levels, p.framerate, device=dev)
    small = state.window[0].clone()
    ms = cuda_ms(lambda: torch.cat([state.window[1:], small[None]]), iters=20)
    return ms, list(state.window.shape), state.window.numel() * 4


def slice_4k_modes(torch, dev, st, tl, hl, frames):
    """Motion and colour at 2160x3840 through the per-chunk calls of
    ``cli.py magnify``: ``ClipProcessor.process_chunk`` of host frames one at a
    time, then ``compose(..., LEFT_RIGHT, overlay=False)``; each mode at its
    defaults (motion: levels 4; colour: levels 3, 30 fps). Two passes, the
    second in reverse order. Asserts the frames equal
    ``MagnificationChain.process``'s and that none of K1-K10 is launched."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.export.exporter import compose
    from live_video_magnification_tpu_torch.export.types import SplitMode
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain

    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    tchw = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    for n_pass, order in enumerate((MODES_4K, MODES_4K[::-1]), start=1):
        for mode in order:
            cfg = mode_cfg(mode)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts(st, tl, hl)
            proc = ClipProcessor(cfg, h, w, 3, device=dev)
            outs, step_s = [], []
            for i in range(t):
                t0 = time.perf_counter()
                processed, original = proc.process_chunk(tchw[i:i + 1])
                pane = compose(original[0].transpose(1, 2, 0), processed[0].transpose(1, 2, 0),
                               SplitMode.LEFT_RIGHT, False)
                step_s.append(time.perf_counter() - t0)
                outs.append(processed[0])
            peak = torch.cuda.max_memory_allocated(dev)
            launched = {k: v for k, v in launch_counts(st, tl, hl).items() if v}
            if launched:
                raise AssertionError(f"4K {mode} launched kernels of the phase path: {launched}")
            if pane.shape != (h, 2 * w, 3) or not np.array_equal(pane[:, w:], outs[-1].transpose(1, 2, 0)):
                raise AssertionError(f"4K {mode}: the composed frame is not the processed pane")
            moved = [int(np.count_nonzero(outs[i] != tchw[i])) for i in range(t)]
            if min(moved[2:]) == 0:
                raise AssertionError(f"4K {mode}: frames left unchanged: {moved}")
            chain = MagnificationChain(device=dev)
            chain_s = []
            for i in range(t):  # the step alone: host frame in, output on the card
                t0 = time.perf_counter()
                got = chain.process(frames[i], cfg)[0]
                torch.cuda.synchronize()
                chain_s.append(time.perf_counter() - t0)
                if not np.array_equal(got.cpu().numpy().transpose(2, 0, 1), outs[i]):
                    raise AssertionError(f"4K {mode} frame {i}: ClipProcessor differs from the chain")
            kernels = device_kernels_per_frame(torch, chain, frames[2], cfg)
            name = f"4k_{'motion' if mode == 'laplace' else 'color'}"
            if n_pass == 1:
                log(phase=f"profile_{name}", card=torch.cuda.get_device_name(dev),
                    **profile_chain(torch, chain, frames[3:5], cfg))
            steady_ms = 1e3 * sum(step_s[2:]) / len(step_s[2:])
            chain_ms = 1e3 * sum(chain_s[2:]) / len(chain_s[2:])
            extra = {}
            if mode == "color":
                shift_ms, shape, nbytes = window_shift_ms(torch, dev, cfg, h, w)
                extra = dict(window_shape=shape, window_bytes=nbytes, window_shift_ms=shift_ms)
            p = cfg.magnification
            log(phase=f"slice_{name}", run=n_pass,
                card=torch.cuda.get_device_name(dev), shape=[h, w], levels=proc.key.levels,
                framerate=p.framerate, frames=t,
                per_frame="process_chunk of one host frame + compose(LEFT_RIGHT)",
                step_ms=[1e3 * s for s in step_s], steady_ms_per_frame=steady_ms,
                steady_fps=1e3 / steady_ms, chain_step_ms=[1e3 * s for s in chain_s],
                chain_steady_ms_per_frame=chain_ms, peak_memory_bytes=peak,
                device_kernels_per_frame=kernels, phase_kernel_launches=0,
                changed_pixels=moved, clip_equals_chain=True, **extra)
            del proc, chain, outs


def slice_card_vs_cpu_modes(torch, dev, st, tl, hl, h=1080, w=1920):
    """Motion (4 frames, levels 4) and colour (20 frames at capture_fps 8, so
    its 16-frame window fills and rolls; levels 3) at 1080x1920 on the card
    against the port's CPU path: motion within 1 LSB, colour >= 45 dB with
    the warm-up frame passed through. Then one steady step of each on the
    card under torch.cuda.set_sync_debug_mode("error"), frame and state
    already there: a host sync in the step raises."""
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    clip = moving_clip(21, h, w, seed=SEED + 4)
    for mode, t, fps in (("laplace", 4, None), ("color", 20, 8.0)):
        cfg = mode_cfg(mode, fps=fps)
        t0 = time.perf_counter()
        gpu, cpu = MagnificationChain(device=dev), MagnificationChain(device="cpu")
        reset_counts(st, tl, hl)
        a_frames = [gpu.process(f, cfg)[0].cpu().numpy() for f in clip[:t]]
        launched = {k: v for k, v in launch_counts(st, tl, hl).items() if v}
        b_frames = [cpu.process(f, cfg)[0].numpy() for f in clip[:t]]
        dbs, lsbs = frame_stats(a_frames, b_frames)
        name = "motion" if mode == "laplace" else "color"
        if launched:
            raise AssertionError(f"1080p {name} launched kernels of the phase path: {launched}")
        if mode == "laplace" and max(lsbs) > 1:
            raise AssertionError(f"1080p motion: card vs CPU {lsbs} LSB, over 1")
        if mode == "color" and (min(dbs) < 45.0 or not np.array_equal(a_frames[0], clip[0])):
            raise AssertionError(f"1080p color: card vs CPU {dbs} dB (bar 45), or the "
                                 "warm-up frame is not the input")
        log(phase="slice_1080p_card_vs_cpu", config=name, card=torch.cuda.get_device_name(dev),
            shape=[h, w], levels=gpu._key.levels, framerate=cfg.magnification.framerate,
            window=gpu._state.window.shape[0] if mode == "color" else None, frames=t,
            psnr_db=dbs, min_psnr_db=min(dbs), max_lsb=lsbs, max_lsb_all=max(lsbs),
            phase_kernel_launches=0, seconds=time.perf_counter() - t0)

        # the sync check: a steady step (colour: the window full and rolling)
        frame = torch.from_numpy(clip[t]).to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = gpu.process(frame, cfg)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref = cpu.process(clip[t], cfg)[0].numpy()
        db, lsb = frame_stats([out.cpu().numpy()], [ref])
        log(phase="sync_check", config=name, card=torch.cuda.get_device_name(dev),
            shape=[h, w], count_before=t, sync_debug_mode="error", raised=False,
            psnr_db=db[0], max_lsb=lsb[0])
        del gpu, cpu


TP_CHUNK = 32  # cli.py magnify's default --chunk; phase's peak fits the card (PERF.md)
TP_MODES = ("phase", "laplace", "color")  # the first pass's order; reversed in the second
TP_NAMES = {"phase": "phase", "laplace": "motion", "color": "color"}


def tp_cfg(mode, fps=None):
    """The time-parallel cells' configurations: phase as the 4K phase slice
    (levels 6), motion and colour at their defaults (colour at ``fps``
    where given)."""
    return cfg_4k(6) if mode == "phase" else mode_cfg(mode, fps=fps)


def tp_expected(mode, frames, h, w, levels, *modules, batches=1):
    """Every launch count of the modules for ``frames`` frames of ``mode``'s
    time-parallel path: phase's f32 stencils a frame and its blur13 a batch
    of frames (``batches``: the chunks times the shards; a sequential loop's
    frames), nothing else."""
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    want = {k: 0 for k in launch_counts(*modules)}
    if mode == "phase":
        want.update({k: v * frames for k, v in stencil_launches(h, w, levels).items()})
        want["blur13"] = blur_launches(h, w, levels) * batches
    return want


def tp_frames_check(name, got, ref, phase):
    """The time-parallel bars against ``ref``: phase >= 40 dB a frame, motion
    and colour within 1 LSB. Returns the frame statistics."""
    dbs, lsbs = frame_stats(got, ref)
    over = float(np.mean(np.abs(got.astype(np.int16) - ref.astype(np.int16)) > 1))
    if (phase and min(dbs) < 40.0) or (not phase and max(lsbs) > 1):
        raise AssertionError(f"{name}: {dbs} dB, {lsbs} LSB")
    return dict(min_psnr_db=min(dbs), max_lsb=max(lsbs), share_over_1_lsb=over)


def run_clip(torch, dev, proc, chunks, modules):
    """``proc.process_chunk`` of each host chunk, counts reset and the peak
    reset just before. Returns (outputs, seconds, launch counts, peak)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(*modules)
    outs = []
    t0 = time.perf_counter()
    for chunk in chunks:
        outs.append(proc.process_chunk(chunk)[0])  # host arrays: synchronizes
    seconds = time.perf_counter() - t0
    return (np.concatenate(outs), seconds, launch_counts(*modules),
            torch.cuda.max_memory_allocated(dev))


def host_copies_ms(torch, dev, tchw):
    """ms a frame of pageable host copies of a [T, 3, H, W] u8 chunk: the
    chunk to the card (process_chunk's H2D), and two u8 stacks of its size
    back to pageable host memory (process_chunk reads its panes back into
    pinned memory on a copy stream instead), by the host clock."""
    t = tchw.shape[0]
    host = torch.from_numpy(tchw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = host.to(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = [on_card.cpu().numpy() for _ in range(2)]
    t2 = time.perf_counter()
    del on_card, back
    return 1e3 * (t1 - t0) / t, 1e3 * (t2 - t1) / t


def tp_scan_time(torch, dev, t, h, w):
    """Device ms of the time-parallel scans alone, by CUDA events, on
    standard-normal inputs at the 4K cells' shapes: phase's
    df2_dual_filter_parallel with warm inits on every active level of
    levels 6, twice (cos and sin); motion's two EMA scans on every level of
    levels 4, 3 channels. Returns {mode: ms a frame}."""
    from live_video_magnification_tpu_torch.models.motion import _ema_combine
    from live_video_magnification_tpu_torch.ops.pyramid import pyramid_sizes
    from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes
    from live_video_magnification_tpu_torch.ops.temporal import (
        associative_scan,
        df2_dual_filter_parallel,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    coeffs = [tuple(float(x) for x in c) for c in tail_coeffs()]
    phase = 0.0
    for lh, lw in riesz_level_sizes(h, w, 6)[:-1]:
        diff, inits = normal(t, lh, lw), [normal(lh, lw) for _ in range(5)]
        phase += 2 * cuda_ms(lambda: df2_dual_filter_parallel(
            diff, *coeffs, acc_init=inits[0], lo_init=inits[1:3], hi_init=inits[3:]), 3, 1)
        del diff, inits
    motion = 0.0
    for lh, lw in [(h, w)] + pyramid_sizes(h, w, 4)[:3]:
        a = torch.full((t, 1, 1, 1), 0.5, device=dev)
        b = normal(t, 3, lh, lw)
        motion += 2 * cuda_ms(lambda: associative_scan(_ema_combine, (a, b)), 3, 1)
        del a, b
    torch.cuda.empty_cache()
    return {"phase": phase / t, "laplace": motion / t}


def slice_4k_time_parallel(torch, dev, st, tl, hl, frames):
    """The time-parallel path at 2160x3840 in all three modes against the
    sequential ClipProcessor on the same TP_CHUNK host frames, in two passes
    (the second in reverse order). Asserts the launches (phase: its f32
    stencils, 25 a frame; no tail kernel; motion and colour none), the frames
    against the sequential ones, and, in the first pass, two chunks against
    one."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor

    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    tchw = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    modules = (st, tl, hl)
    card = torch.cuda.get_device_name(dev)
    h2d, d2h = host_copies_ms(torch, dev, tchw)
    scans = tp_scan_time(torch, dev, t, h, w)
    log(phase="tp_host_copies", card=card, shape=[t, 3, h, w], h2d_ms_per_frame=h2d,
        d2h_two_stacks_ms_per_frame=d2h, what="pageable copies alone: the u8 chunk to the "
        "card (process_chunk's H2D), and two u8 stacks of its size back",
        scan_device_ms_per_frame={"phase": scans["phase"], "motion": scans["laplace"]})
    for n_pass, order in enumerate((TP_MODES, TP_MODES[::-1]), start=1):
        for mode in order:
            cfg = tp_cfg(mode)
            name = TP_NAMES[mode]
            row = dict(phase="slice_4k_time_parallel", mode=name, run=n_pass, card=card,
                       shape=[h, w], frames=t, chunk=t,
                       per_chunk="process_chunk of TP_CHUNK host frames, readback included")
            with flag_env({}):
                runs = {}
                for path, parallel in (("time_parallel", True), ("sequential", False)):
                    proc = ClipProcessor(cfg, h, w, 3, time_parallel=parallel, device=dev)
                    out, sec, launched, peak = run_clip(torch, dev, proc, [tchw], modules)
                    want = tp_expected(mode, t, h, w, proc.key.levels, *modules)  # one chunk
                    if parallel and launched != want:
                        raise AssertionError(f"4K time-parallel {name}: launches {launched} "
                                             f"!= expected {want}")
                    runs[path] = out
                    row[path] = dict(ms_per_frame=1e3 * sec / t, fps=t / sec,
                                     peak_memory_bytes=peak,
                                     launches={k: v for k, v in launched.items() if v})
                    row["levels"] = proc.key.levels
                    del proc
                moved = [int(np.count_nonzero(runs["time_parallel"][i] != tchw[i]))
                         for i in range(t)]
                if min(moved[1:]) == 0:
                    raise AssertionError(f"4K time-parallel {name}: frames left unchanged")
                row["against_sequential"] = tp_frames_check(
                    f"4K time-parallel {name} against sequential", runs["time_parallel"],
                    runs["sequential"], mode == "phase")
                if n_pass == 1:
                    proc = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=dev)
                    prof = profile_run(torch, lambda: proc.process_chunk(tchw), t)
                    log(phase="profile_4k_time_parallel", mode=name, card=card,
                        scan_device_ms_per_frame=scans.get(mode), **prof)
                    proc = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=dev)
                    two = run_clip(torch, dev, proc, [tchw[:t // 2], tchw[t // 2:]], modules)
                    row["two_chunks_against_one"] = tp_frames_check(
                        f"4K time-parallel {name} in two chunks", two[0],
                        runs["time_parallel"], mode == "phase")
                    row["two_chunks_ms_per_frame"] = 1e3 * two[1] / t
                    del proc, two
                row["speed_time_parallel_over_sequential"] = (
                    row["sequential"]["ms_per_frame"] / row["time_parallel"]["ms_per_frame"])
                log(**row)
                del runs


def slice_card_vs_cpu_time_parallel(torch, dev, st, tl, hl, h=1080, w=1920):
    """The time-parallel path at 1080x1920 on the card against the port's CPU
    path, each in two chunks: phase (levels 6) and motion 4 frames, colour 20
    frames at 8 fps so its 16-frame window fills and rolls across the chunk
    boundary. Phase >= 40 dB a frame with its f32 stencils launched (K5 once
    a frame, at level 4), motion within 1 LSB, colour >= 45 dB with the
    warm-up frame the input."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    clip = moving_clip(20, h, w, seed=SEED + 5)
    tchw = np.ascontiguousarray(clip.transpose(0, 3, 1, 2))
    modules = (st, tl, hl)
    for mode, t, fps in (("phase", 4, None), ("laplace", 4, None), ("color", 20, 8.0)):
        cfg, name = tp_cfg(mode, fps), TP_NAMES[mode]
        t0 = time.perf_counter()
        chunks = [tchw[:t // 2], tchw[t // 2:t]]
        with flag_env({}):
            gpu = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=dev)
            a, _, launched, _ = run_clip(torch, dev, gpu, chunks, modules)
            cpu = ClipProcessor(cfg, h, w, 3, time_parallel=True, device="cpu")
            b = np.concatenate([cpu.process_chunk(c)[0] for c in chunks])
        want = tp_expected(mode, t, h, w, gpu.key.levels, *modules, batches=len(chunks))
        if launched != want:
            raise AssertionError(f"1080p time-parallel {name}: launches {launched} != {want}")
        dbs, lsbs = frame_stats(a, b)
        if ((mode == "phase" and min(dbs) < 40.0) or (mode == "laplace" and max(lsbs) > 1)
                or (mode == "color" and (min(dbs) < 45.0
                                         or not np.array_equal(a[0], tchw[0])))):
            raise AssertionError(f"1080p time-parallel {name}: card vs CPU {dbs} dB, "
                                 f"{lsbs} LSB")
        log(phase="slice_1080p_card_vs_cpu", config=f"time_parallel_{name}", card=torch.cuda.get_device_name(dev),
            shape=[h, w], levels=gpu.key.levels, framerate=cfg.magnification.framerate,
            frames=t, chunks=[len(c) for c in chunks], psnr_db=dbs, min_psnr_db=min(dbs),
            max_lsb=lsbs, max_lsb_all=max(lsbs),
            launches_per_frame={k: v / t for k, v in launched.items() if v},
            seconds=time.perf_counter() - t0)
        del gpu, cpu


TM_SHARDS = 4  # virtual shards of one card on the 4K time mesh
TM_TAIL = 2    # frames after the chunk: a partial chunk, run unsharded


def tm_boundary_ms(torch, dev, t, h, w, shards):
    """Device ms per chunk of the time mesh's boundary step alone, by CUDA
    events on standard-normal inputs at the 4K cells' shapes: what splitting
    a chunk of ``t`` frames into ``shards`` adds to the time-parallel path.
    Phase (levels 6): per band level and component, the fold of the shard
    totals (shards - 1 carries of a last row of the 5 states) and the
    carry-in of every later shard's t/shards rows of both DF-II outputs;
    motion (levels 4): per level and EMA, the same for the EMA's 3-channel
    planes; colour (levels 3): the concatenation of the shards' pyramid
    tops. Returns {mode: ms per chunk}."""
    from live_video_magnification_tpu_torch.ops.pyramid import pyramid_sizes
    from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes
    from live_video_magnification_tpu_torch.ops.temporal import (
        df2_dual_carry,
        df2_dual_carry_outputs,
        ema_carry,
    )

    per = t // shards
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    coeffs = [tuple(float(x) for x in c) for c in tail_coeffs()]
    out = {"phase": 0.0, "laplace": 0.0}
    for lh, lw in riesz_level_sizes(h, w, 6)[:-1]:
        ys, s_in = [normal(per, lh, lw) for _ in range(2)], [normal(lh, lw) for _ in range(5)]

        def phase_boundary():
            s = s_in
            for _ in range(shards - 1):
                s = df2_dual_carry(s_in, s, *coeffs, at=per - 1)
            for _ in range(shards - 1):
                df2_dual_carry_outputs(*ys, s_in, *coeffs)

        out["phase"] += 2 * cuda_ms(phase_boundary, 3, 1)
        del ys, s_in
    for lh, lw in [(h, w)] + pyramid_sizes(h, w, 4)[:3]:
        local, carry = normal(per, 3, lh, lw), normal(3, lh, lw)

        def motion_boundary():
            s = carry
            for _ in range(shards - 1):
                s = ema_carry(local[-1], s, 0.5, at=per - 1)
            for _ in range(shards - 1):
                ema_carry(local, carry, 0.5)

        out["laplace"] += 2 * cuda_ms(motion_boundary, 3, 1)
        del local, carry
    th, tw = pyramid_sizes(h, w, 3)[2]
    tops = [normal(per, 3 * th * tw) for _ in range(shards)]
    out["color"] = cuda_ms(lambda: torch.cat(tops), 3, 1)
    torch.cuda.empty_cache()
    return out


def tm_exporter(cfg, h, w, devices):
    """DistributedClipExporter on a ("time",) mesh of ``devices``."""
    from live_video_magnification_tpu_torch.parallel.batch_export import (
        DistributedClipExporter,
    )
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh

    return DistributedClipExporter(cfg, h, w, 3, mesh=make_mesh((len(devices),), ("time",),
                                                               devices))


def run_time_mesh(torch, devices, cfg, chunks, modules, fetch_original=True):
    """The host chunks through DistributedClipExporter on a ("time",) mesh of
    ``devices`` (one process: every shard's rows), counts reset just before.
    Returns (outputs of each chunk, seconds of each chunk, the first chunk's
    launch counts, peak memory over the devices, the exporter)."""
    gc.collect()
    torch.cuda.empty_cache()
    exp = tm_exporter(cfg, *chunks[0].shape[2:], devices)
    cards = list(dict.fromkeys(devices))
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    reset_counts(*modules)
    outs, secs, launched = [], [], None
    for chunk in chunks:
        t0 = time.perf_counter()
        outs.append(exp.process_chunk(chunk, len(chunk), fetch_original=fetch_original)[0])
        secs.append(time.perf_counter() - t0)  # host arrays: synchronizes
        launched = launched or launch_counts(*modules)
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
    return outs, secs, launched, peak, exp


def tm_check(name, got, ref, phase):
    """tp_frames_check's bars, with the count of pixels over 1 LSB."""
    row = tp_frames_check(name, got, ref, phase)
    row["pixels_over_1_lsb"] = int(np.count_nonzero(
        np.abs(got.astype(np.int16) - ref.astype(np.int16)) > 1))
    return row


def slice_4k_time_mesh(torch, dev, st, tl, hl, frames):
    """The time mesh at 2160x3840 in all three modes: one chunk of TP_CHUNK
    host frames on TM_SHARDS virtual shards of ``dev``
    (``DistributedClipExporter``), with and without the original stack's
    readback, against ``ClipProcessor(time_parallel=True)`` on the same
    frames, in two passes (the second in reverse order). Asserts the
    launches (phase: its 25 f32 stencils a frame summed over the shards, no
    tail or halo kernel; motion and colour none of K1-K10) and the frames
    (phase >= 40 dB a frame, motion and colour within 1 LSB); in the first
    pass, a partial tail of TM_TAIL frames after the chunk runs unsharded
    and is held to the same bars. Returns {mode: (the unsharded frames,
    the mesh's ms/frame)} of the second pass."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor

    h, w = frames.shape[1], frames.shape[2]
    tchw = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    full, tail = tchw[:TP_CHUNK], tchw[TP_CHUNK:TP_CHUNK + TM_TAIL]
    t = len(full)
    modules = (st, tl, hl)
    card = torch.cuda.get_device_name(dev)
    devices = [dev] * TM_SHARDS
    boundary = tm_boundary_ms(torch, dev, t, h, w, TM_SHARDS)
    log(phase="tm_boundary", card=card, shape=[t, 3, h, w], shards=TM_SHARDS,
        boundary_device_ms_per_chunk={TP_NAMES[k]: v for k, v in boundary.items()},
        what="the fold of the shard totals and the carry-in of the later shards alone "
             "(phase, motion), the concatenation of the tops (colour)")
    second = {}
    for n_pass, order in enumerate((TP_MODES, TP_MODES[::-1]), start=1):
        for mode in order:
            cfg, name = tp_cfg(mode), TP_NAMES[mode]
            row = dict(phase="slice_4k_time_mesh", mode=name, run=n_pass, card=card,
                       shape=[h, w], frames=t, chunk=t, shards=TM_SHARDS,
                       devices=[str(d) for d in devices],
                       boundary_device_ms_per_chunk=boundary[mode],
                       per_chunk="process_chunk of TP_CHUNK host frames, readback included")
            with flag_env({}):
                proc = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=dev)
                ref, sec, _, peak = run_clip(torch, dev, proc, [full], modules)
                row["unsharded"] = dict(ms_per_frame=1e3 * sec / t, peak_memory_bytes=peak)
                row["levels"] = proc.key.levels
                want = tp_expected(mode, t, h, w, proc.key.levels, *modules, batches=TM_SHARDS)
                chunks = [full, tail] if n_pass == 1 else [full]
                outs, secs, launched, peak, exp = run_time_mesh(torch, devices, cfg, chunks,
                                                                modules)
                if launched != want:
                    raise AssertionError(f"4K time mesh {name}: launches {launched} != {want}")
                row["mesh"] = dict(ms_per_frame=1e3 * secs[0] / t, peak_memory_bytes=peak,
                                   launches_per_frame={k: v / t for k, v in launched.items()
                                                       if v})
                row["against_unsharded"] = tm_check(f"4K time mesh {name}", outs[0], ref,
                                                    mode == "phase")
                if n_pass == 1:
                    ref_tail = proc.process_chunk(tail)[0]
                    if exp.cursor != t + len(tail):
                        raise AssertionError(f"4K time mesh {name}: cursor {exp.cursor}")
                    row["partial_tail"] = dict(frames=len(tail), unsharded=True, **tm_check(
                        f"4K time mesh {name} tail", outs[1], ref_tail, mode == "phase"))
                    exp = tm_exporter(cfg, h, w, devices)
                    prof = profile_run(torch, lambda: exp.process_chunk(full, t), t)
                    log(phase="profile_4k_time_mesh", mode=name, card=card, shards=TM_SHARDS,
                        **prof)
                mesh_out = outs[0]
                del proc, exp, outs
                outs, secs, _, peak, _ = run_time_mesh(torch, devices, cfg, [full], modules,
                                                       fetch_original=False)
                row["mesh_without_original"] = dict(ms_per_frame=1e3 * secs[0] / t,
                                                    peak_memory_bytes=peak)
                if not np.array_equal(outs[0], mesh_out):
                    raise AssertionError(f"4K time mesh {name}: frames without the original's "
                                         "readback differ")
                row["mesh_over_unsharded"] = row["mesh"]["ms_per_frame"] / \
                    row["unsharded"]["ms_per_frame"]
                log(**row)
                if n_pass == 2:
                    second[mode] = (ref, row["mesh"]["ms_per_frame"])
                del outs, ref, mesh_out
    return second


def slice_time_mesh_multi_gpu(torch, st, tl, hl, frames, virtual):
    """The time mesh over the real cards (2 to 4, one shard each) in each
    mode, against the unsharded frames of ``slice_4k_time_mesh``'s second
    pass (``virtual``: {mode: (frames, virtual-shard ms/frame)}), with
    ``over_one_card``: its ms/frame over the virtual shards'. Logs
    "skipped" on one card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(phase="slice_time_mesh_multi_gpu", skipped="one CUDA device")
        return
    devices = [torch.device("cuda", i) for i in range(min(cards, 4))]
    tchw = np.ascontiguousarray(frames[:TP_CHUNK].transpose(0, 3, 1, 2))
    t, h, w = tchw.shape[0], tchw.shape[2], tchw.shape[3]
    modules = (st, tl, hl)
    for mode in TP_MODES:
        cfg, name = tp_cfg(mode), TP_NAMES[mode]
        ref, virtual_ms = virtual[mode]
        with flag_env({}):
            outs, secs, launched, peak, exp = run_time_mesh(torch, devices, cfg, [tchw],
                                                            modules)
        want = tp_expected(mode, t, h, w, exp.proc.key.levels, *modules,
                           batches=len(devices))
        if launched != want:
            raise AssertionError(f"time mesh on {len(devices)} cards {name}: launches "
                                 f"{launched} != {want}")
        ms = 1e3 * secs[0] / t
        log(phase="slice_time_mesh_multi_gpu", mode=name, devices=[str(d) for d in devices],
            card=torch.cuda.get_device_name(devices[0]), shape=[h, w], frames=t,
            ms_per_frame=ms, virtual_shards_ms_per_frame=virtual_ms,
            over_one_card=ms / virtual_ms, peak_memory_bytes_max_card=peak,
            against_unsharded=tm_check(f"time mesh on cards {name}", outs[0], ref,
                                       mode == "phase"))
        del outs, exp


DR_SHAPE = (1080, 1920)
DR_CHUNKS = [(0, 8), (8, 16), (16, 18)]  # two full chunks of 8 shards, a partial tail


def dr_exporter(torch, devices, ranks, shape):
    """DistributedClipExporter for the two-rank phase: phase, levels 6, at
    ``shape``, on a ("time",) mesh of ``devices`` owned by ``ranks``."""
    from live_video_magnification_tpu_torch.parallel.batch_export import (
        DistributedClipExporter,
    )
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((len(devices),), ("time",), devices, ranks=ranks)
    return DistributedClipExporter(cfg_4k(6), *shape, 3, mesh=mesh)


def dr_frames(shape):
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    clip = moving_clip(DR_CHUNKS[-1][1], *shape, seed=SEED + 13)
    return np.ascontiguousarray(clip.transpose(0, 3, 1, 2))


def dr_chunks(exp, tchw):
    """The processed frames of this process's rows of each chunk."""
    outs = []
    for a, b in DR_CHUNKS:
        clen = b - a
        if clen % exp.n_shards:
            local = tchw[a:b]
        else:
            local = np.concatenate([tchw[a + r0:a + r1] for _k, r0, r1 in exp.local_rows(clen)])
        outs.append(exp.process_chunk(local, clen, fetch_original=False)[0])
    return outs


def rank_worker(argv) -> int:
    """One rank of ``distributed_2rank``
    (``chip_smoke.py --rank R PORT DIR DEVICE H W``): join the two-rank group
    on DEVICE's layout, hold 4 of the 8 shards, process the chunks of H x W
    frames and save this rank's frames under DIR."""
    import torch
    import torch.distributed as dist

    from live_video_magnification_tpu_torch.parallel import distributed

    rank, port, out_dir, device = int(argv[0]), int(argv[1]), argv[2], argv[3]
    shape = (int(argv[4]), int(argv[5]))
    t0 = time.perf_counter()
    if not distributed.initialize(f"127.0.0.1:{port}", 2, rank, device=device):
        raise AssertionError("expected a two-process group")
    lay = distributed.layout()
    mine = [str(lay.devices[j % len(lay.devices)]) for j in range(4)]
    every = [None, None]
    dist.all_gather_object(every, mine)
    exp = dr_exporter(torch, [torch.device(d) for ds in every for d in ds], [0] * 4 + [1] * 4,
                      shape)
    outs = dr_chunks(exp, dr_frames(shape))
    for (a, _b), out in zip(DR_CHUNKS, outs):
        np.save(os.path.join(out_dir, f"rank{rank}_c{a}.npy"), out)
    print(json.dumps(dict(rank=rank, backend=exp.backend, staged=exp.shards.staged,
                          devices=mine, seconds=time.perf_counter() - t0)), flush=True)
    dist.destroy_process_group()
    return 0


def distributed_2rank(torch, dev):
    """Two ranks started here (``rank_worker``), 4 shards each, at 1080p
    phase (chunks of 8, then a partial tail of 2 run unsharded on both):
    NCCL on two cards where there are two, else gloo on one card, its CUDA
    exchanges staged through host memory. Their frames must equal, bit for
    bit, those of one process's 8 virtual shards on ``dev``."""
    import socket
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "LVMT_DISTRIBUTED")}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   str(port), out_dir, dev.type, *map(str, DR_SHAPE)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for r in (0, 1)]
        reports = []
        try:
            for r, p in enumerate(procs):
                stdout, stderr = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"distributed_2rank: rank {r} exited {p.returncode}:\n"
                                         f"{stderr[-3000:]}")
                reports.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        got = [[np.load(os.path.join(out_dir, f"rank{r}_c{a}.npy")) for a, _b in DR_CHUNKS]
               for r in (0, 1)]
    exp = dr_exporter(torch, [dev] * 8, None, DR_SHAPE)
    ref = dr_chunks(exp, dr_frames(DR_SHAPE))
    equal = []
    for i, (a, b) in enumerate(DR_CHUNKS):
        if (b - a) % 8:  # the tail: both ranks ran all of it
            equal += [np.array_equal(got[0][i], ref[i]), np.array_equal(got[1][i], ref[i])]
        else:
            equal.append(np.array_equal(np.concatenate([got[0][i], got[1][i]]), ref[i]))
    backends = {rep["backend"] for rep in reports}
    want = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= 2 else "gloo"
    row = dict(phase="distributed_2rank", card=torch.cuda.get_device_name(dev),
               shape=list(DR_SHAPE), levels=6, chunks=[b - a for a, b in DR_CHUNKS],
               shards=8, backend=sorted(backends), expected_backend=want, ranks=reports,
               bit_equal_to_one_process=all(equal), ranks_seconds=ranks_s)
    log(**row)
    if backends != {want}:
        raise AssertionError(f"distributed_2rank: backend {backends}, expected {want}")
    if not all(equal):
        raise AssertionError(f"distributed_2rank: frames differ from one process's: {equal}")


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0):
    """(bound ms, what bounds it) on the published H100 SXM peaks: ``ops`` on
    f32 operands at the f32 rate, ``bf16_ops`` on bf16 operands at the bf16
    tensor rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (ops / PEAK_F32_OPS_PER_S + bf16_ops / PEAK_BF16_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def build_kernel_check(dev, st, sizes):
    """K5 against its plain version on the card, both output dtypes, at odd
    shapes, 1080p's level 4, every 4K band level and every shape of
    st.build_level_shapes() (the edges of its tiles): every output
    bit-equal to the plain version's and to K1+K2+K3's, the sign of a zero
    included, and max |kernel - plain|."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        LOWPASS_2X,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )

    rng = np.random.default_rng(SEED + 5)
    shapes = [(16, 16), (33, 257), (97, 201), (135, 241), (68, 120)] + list(sizes[:-1])
    shapes += [s for s in st.build_level_shapes() if s not in shapes]
    worst = 0.0
    for shape in shapes:
        x = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100.0).to(dev)
        x[: shape[0] // 3] = 0.0  # signed zeros in every output
        hp = st.conv9(x, RIESZ_HIGHPASS_9x9)
        three = (hp, *st.band5(hp, RIESZ_BAND_KERNEL), st.lp9_decimate(x, LOWPASS_2X))
        for od in ("f32", "bf16"):
            got = st.riesz_build_level(x, out_dtype=od)
            ref = st.riesz_build_level_plain(x, od)
            torch.cuda.synchronize()
            for g, k in zip(got, three):
                if not same_bits(g, k.to(g.dtype)):
                    raise AssertionError(f"riesz_build_level at {shape} ({od}): not bit-equal "
                                         "to K1+K2+K3")
            for g, r in zip(got, ref):
                if g.shape != r.shape or g.dtype != r.dtype:
                    raise AssertionError(f"riesz_build_level at {shape}: {g.shape} {g.dtype} "
                                         f"vs {r.shape} {r.dtype}")
                err = float((g.float() - r.float()).abs().max())
                bar = 1e-6 * max(1.0, float(r.float().abs().max()))
                if not err <= bar:
                    raise AssertionError(f"riesz_build_level at {shape} ({od}): max |kernel - "
                                         f"plain| {err} > {bar}")
                worst = max(worst, err)
                if not same_bits(g, r):
                    raise AssertionError(f"riesz_build_level at {shape} ({od}): not bit-equal "
                                         "to its plain version")
    log(phase="build_kernel_check", kernel="riesz_build_level", shapes=[list(s) for s in shapes],
        out_dtypes=["f32", "bf16"], max_abs_err=worst, bit_equal=True,
        bit_equal_to_k1_k2_k3=True, tolerance="1e-06 x max(1, max|plain|); bit for bit")
    return worst


def build_kernel_time(dev, st, sizes):
    """ms of K5 (f32 outputs, the fused route) and of its plain version at
    1080p's level 4 and every 4K band level, beside K1+K2+K3 at the same
    shape by events (``k1_k2_k3_ms``) and by graph replay
    (``k1_k2_k3_graph_ms``), with the bound and the exactness floor from
    this run's shapes."""
    from live_video_magnification_tpu_torch.ops.kernels import (
        LOWPASS_2X,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )
    import torch

    rng = np.random.default_rng(SEED + 6)
    nnz = lambda k: int(np.count_nonzero(k))
    rows = []
    for lvl, (h, w) in [(4, (68, 120))] + list(enumerate(sizes[:-1])):
        x = torch.from_numpy(rng.random((h, w), dtype=np.float32) * 100.0).to(dev)
        hp = st.conv9(x, RIESZ_HIGHPASS_9x9)
        iters = 50 if h * w > 4e6 else 200
        ms = cuda_ms(lambda: st.riesz_build_level(x), iters)
        build_graph_ms = graph_ms(lambda: st.riesz_build_level(x), iters)
        plain_ms = cuda_ms(lambda: st.riesz_build_level_plain(x), max(5, iters // 10), warmup=1)
        calls = {"conv9": lambda: st.conv9(x, RIESZ_HIGHPASS_9x9),
                 "band5": lambda: st.band5(hp, RIESZ_BAND_KERNEL),
                 "lp9_decimate": lambda: st.lp9_decimate(x, LOWPASS_2X)}
        three = {k: cuda_ms(f, iters) for k, f in calls.items()}
        three_graph = {k: graph_ms(f, iters) for k, f in calls.items()}
        oh, ow = (h + 1) // 2, (w + 1) // 2
        nbytes = (h * w + 3 * h * w + oh * ow) * 4  # 1 read, 3 writes, 1/4 write
        ops = (2 * nnz(RIESZ_HIGHPASS_9x9) * h * w + 2 * 2 * nnz(RIESZ_BAND_KERNEL) * h * w
               + 2 * nnz(LOWPASS_2X) * oh * ow)
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append(dict(kernel="riesz_build_level", level=lvl, shape=[h, w],
                         grid="1080p" if (h, w) == (68, 120) else "4K", ms=ms,
                         graph_ms=build_graph_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_share=bound_ms / ms, bound_by=bound_by, bytes=nbytes,
                         operations=ops, exact_floor_ms=exact_floor_ms(ops), k1_k2_k3_ms=three,
                         k1_k2_k3_sum_ms=sum(three.values()), k1_k2_k3_graph_ms=three_graph,
                         k1_k2_k3_graph_sum_ms=sum(three_graph.values())))
        log(phase="build_kernel_time", **rows[-1])
    return rows


def bf16_cases(st, tl, rng, dev, shape, small=None):
    """(arm name, kernel call, plain call) of every bf16 arm at one shape, on
    the fast pairing's dtypes: conv9 f32 -> bf16 (the build) and f32 -> f32
    (the collapse), band5 bf16 -> bf16, lp9_decimate and lp9_inject f32, K6
    on six bf16 planes, both preweighted arms."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        LOWPASS_2X,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )

    h, w = shape
    plane = lambda hw, scale=100.0: torch.from_numpy(
        rng.standard_normal(hw, dtype=np.float32) * scale).to(dev)
    x = plane(shape)
    hp = plane(shape).to(torch.bfloat16)
    sm = plane(small or ((h + 1) // 2, (w + 1) // 2))
    six = [plane(shape, 1.0) for _ in range(6)]
    six[0] = six[0].abs()
    b6 = [p.to(torch.bfloat16) for p in six]
    b6w = b6[:1] + [(p.float() * six[0]).to(torch.bfloat16) for p in six[1:3]] + b6[3:]
    k9, t5 = RIESZ_HIGHPASS_9x9, RIESZ_BAND_KERNEL
    return [
        ("conv9[bf16]", lambda: st.conv9(x, k9, bf16=True, out_dtype="bf16"),
         lambda: st.conv9_plain(x, k9, True, "bf16")),
        ("conv9[bf16]", lambda: st.conv9(x, k9, bf16=True),
         lambda: st.conv9_plain(x, k9, True)),
        ("band5[bf16]", lambda: st.band5(hp, t5, bf16=True, out_dtype="bf16"),
         lambda: st.band5_plain(hp, t5, True, "bf16")),
        ("lp9_decimate[bf16]", lambda: st.lp9_decimate(x, LOWPASS_2X, bf16=True),
         lambda: st.lp9_decimate_plain(x, LOWPASS_2X, True)),
        ("lp9_inject[bf16]", lambda: st.lp9_inject(sm, LOWPASS_2X, shape, bf16=True),
         lambda: st.lp9_inject_plain(sm, LOWPASS_2X, shape, True)),
        ("riesz_amplify_mxu[bf16]", lambda: tl.riesz_amplify_mxu(*b6, 50.0, 1.2, bf16=True),
         lambda: tl.riesz_amplify_plain(*b6, 50.0, 1.2, bf16=True)),
        ("riesz_amplify_mxu[bf16]",
         lambda: tl.riesz_amplify_mxu(*b6w, 50.0, 1.2, preweighted=True, bf16=True),
         lambda: tl.riesz_amplify_plain(*b6w, 50.0, 1.2, preweighted=True, bf16=True)),
    ]


def bf16_kernel_check(dev, st, tl, sizes):
    """Every bf16 arm against its plain version on the card at odd shapes and
    every 4K level (the collapse's inject onto each level from the next)."""
    import torch

    rng = np.random.default_rng(SEED + 7)
    shapes = [(16, 16), (33, 257), (97, 201), (135, 241)] + list(sizes[:-1])
    smalls = [None] * 4 + list(sizes[1:])
    # the 9x9 arms also at every edge of their tiles
    s9_only = ("conv9[bf16]", "lp9_decimate[bf16]")
    runs = [(s, sm, None) for s, sm in zip(shapes, smalls)]
    runs += [(s, None, s9_only) for s in stencil9_shapes()]
    worst = {k: 0.0 for k in BF16_REPLACES}
    for shape, small, only in runs:
        for name, kernel, plain in bf16_cases(st, tl, rng, dev, shape, small):
            if only and name not in only:
                continue
            got, ref = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g.shape != r.shape or g.dtype != r.dtype:
                    raise AssertionError(f"{name} at {shape}: {g.shape} {g.dtype} vs "
                                         f"{r.shape} {r.dtype}")
                err = float((g.float() - r.float()).abs().max())
                bar = 1e-6 * max(1.0, float(r.float().abs().max()))
                if not err <= bar:
                    raise AssertionError(f"{name} at {shape}: max |kernel - plain| {err} > {bar}")
                worst[name] = max(worst[name], err)
    for name, err in worst.items():
        checked = shapes + [s for s, _, only in runs if only and name in only]
        log(phase="bf16_kernel_check", kernel=name, shapes=[list(s) for s in checked],
            max_abs_err=err, tolerance="1e-06 x max(1, max|plain|)")
    amplify_exact(dev, tl, [("riesz_amplify_mxu", pw, tb, te, b) for pw in (False, True)
                            for tb in ("f32", "bf16") for te in ("f32", "bf16")
                            for b in (False, True) if (tb, te, b) != ("f32", "f32", False)],
                  SEED + 11)
    return worst


def bf16_kernel_time(dev, st, tl, sizes):
    """ms of each bf16 arm on the fast pairing's dtypes, of its plain version
    and of a cuDNN bf16 conv2d where one computes the same function, at every
    4K level; bound from this run's shapes at those dtypes."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
        LOWPASS_2X,
        RIESZ_BAND_KERNEL,
        RIESZ_HIGHPASS_9x9,
    )

    rng = np.random.default_rng(SEED + 8)
    nnz = lambda k: int(np.count_nonzero(k))

    def conv_bf16(k, out=1, stride=1):
        m = torch.nn.Conv2d(1, out, k.shape[-1], stride=stride, padding=k.shape[-1] // 2,
                            padding_mode="reflect", bias=False)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(np.ascontiguousarray(k, np.float32)).reshape(m.weight.shape))
        return m.to(dev, torch.bfloat16)

    band_w = np.zeros((2, 1, 5, 5), np.float32)
    band_w[0, 0, 2, :] = RIESZ_BAND_KERNEL
    band_w[1, 0, :, 2] = RIESZ_BAND_KERNEL
    # cuDNN's bf16 conv2d rounds every tap and its output to bf16: the arms
    # differ from it only there, band5 in its i taps (rounded after the f32
    # sum in the arm), lp9_decimate in its output (f32 in the arm)
    lib = {"conv9[bf16]": conv_bf16(RIESZ_HIGHPASS_9x9), "band5[bf16]": conv_bf16(band_w, 2),
           "lp9_decimate[bf16]": conv_bf16(LOWPASS_2X, stride=2)}
    lib_note = {
        "conv9[bf16]": "cuDNN conv2d, bf16",
        "band5[bf16]": "cuDNN conv2d, bf16 (rounds the i taps; the arm rounds the i sum)",
        "lp9_decimate[bf16]": "cuDNN conv2d stride 2, bf16 (rounds its output; the arm writes f32)",
        "lp9_inject[bf16]": "none: no PyTorch call has reflect-101 on the injected array",
        "riesz_amplify_mxu[bf16]": "none: no PyTorch call computes it",
    }
    rows = []
    for lvl in range(len(sizes) - 1):
        (h, w), small = sizes[lvl], sizes[lvl + 1]
        hw, shw = h * w, small[0] * small[1]
        oh, ow = (h + 1) // 2, (w + 1) // 2
        # one case per arm (the first of each name): the fast build's conv9
        # (f32 -> bf16) and K6 not preweighted
        cases = {n: (k, p) for n, k, p in reversed(bf16_cases(st, tl, rng, dev, (h, w), small))}
        k6_ops = TAIL_OPS_PER_PIXEL["riesz_amplify_mxu"] * hw
        k6_bf16 = TAIL_BLUR_OPS_PER_PIXEL * hw
        spec = {  # bytes at the fast pairing's dtypes, f32-operand and bf16-operand operations
            "conv9[bf16]": ((4 + 2) * hw, 0, 2 * nnz(RIESZ_HIGHPASS_9x9) * hw),
            "band5[bf16]": ((2 + 2 * 2) * hw, 0, 2 * 2 * nnz(RIESZ_BAND_KERNEL) * hw),
            "lp9_decimate[bf16]": (4 * (hw + oh * ow), 0, 2 * 81 * oh * ow),
            "lp9_inject[bf16]": (4 * (shw + hw), 0, 2 * 81 * hw // 4),
            "riesz_amplify_mxu[bf16]": ((6 * 2 + 4) * hw, k6_ops - k6_bf16, k6_bf16),
        }
        floors = {"conv9[bf16]": 2 * nnz(RIESZ_HIGHPASS_9x9) * hw,
                  "lp9_decimate[bf16]": 2 * 81 * oh * ow,
                  "lp9_inject[bf16]": 2 * 81 * hw // 4,
                  "riesz_amplify_mxu[bf16]": k6_ops - k6_bf16 + TAIL_BF16_BLUR_INSTRUCTIONS * hw}
        iters = 50 if lvl == 0 else 200
        for name in BF16_REPLACES:
            kernel, plain = cases[name]
            ms = cuda_ms(kernel, iters)
            plain_ms = cuda_ms(plain, max(5, iters // 10), warmup=1)
            lib_ms = None
            if name in lib:
                inp = torch.from_numpy(rng.standard_normal((1, 1, h, w), dtype=np.float32)).to(
                    dev, torch.bfloat16)
                with torch.no_grad():
                    lib_ms = cuda_ms(lambda: lib[name](inp), iters)
            nbytes, ops, bf16_ops = spec[name]
            bound_ms, bound_by = bound(nbytes, ops, bf16_ops)
            rows.append(dict(kernel=name, level=lvl, shape=[h, w], ms=ms,
                             graph_ms=graph_ms(kernel, iters), plain_ms=plain_ms,
                             library_ms=lib_ms, library=lib_note[name],
                             bound_ms=bound_ms, bound_share=bound_ms / ms, bound_by=bound_by,
                             bytes=nbytes, operations=ops, bf16_operations=bf16_ops))
            if name in floors:
                rows[-1]["exact_floor_ms"] = exact_floor_ms(floors[name])
            log(phase="bf16_kernel_time", **rows[-1])
    return rows


def halo_exchanges(plan, tail):
    """(shard shape, halo, right mode) of every column exchange one frame of
    the lane-sharded step makes, in its order, derived from the plan: one
    halo-6 exchange per sharded build level; halo 2 for a sharded last band;
    per sharded active level one halo-6 exchange of the 6-plane stack where
    a tail kernel takes the haloed strip (both sides >= 16), else three of
    single planes; and in the collapse halo 2 (symmetric, the small image)
    and halo 4 per level whose coarser level is sharded too, halo 4 alone
    where it is replicated."""
    from live_video_magnification_tpu_torch.ops.hopper.tail import MIN_SIDE

    local = lambda l: (plan.sizes[l][0], plan.sizes[l][1] // plan.n)
    last = plan.levels - 1
    calls = [(local(l), 6, "reflect") for l in range(last) if plan.sharded[l]]
    if plan.sharded[last]:
        calls.append((local(last), 2, "reflect"))
    for l in range(last):
        if plan.sharded[l]:
            h, wl = local(l)
            if tail != "jnp" and min(h, wl + 12) >= MIN_SIDE:
                calls.append(((6, h, wl), 6, "reflect"))
            else:
                calls += [((h, wl), 6, "reflect")] * 3
    for l in range(last - 1, -1, -1):
        if plan.sharded[l] and plan.sharded[l + 1]:
            calls += [(local(l + 1), 2, "symmetric"), (local(l), 4, "reflect")]
        elif plan.sharded[l]:
            calls.append((local(l), 4, "reflect"))
    return calls


def halo_shards(rng, devices, shape):
    import torch

    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(d)
            for d in devices]


def halo_kernel_check(dev, hl, plan4k):
    """K10 against its plain version on the card, bit for bit: 1, 2, 4 and 8
    virtual shards, halos 2, 4, 6, both right modes, leading dims () and
    (6,), odd rows and widths; and every exchange of the 4K frame on its
    4-way mesh. Returns the largest |kernel - plain| (0 expected)."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    cases = [(n, (*lead, rows, wl), halo, mode)
             for n in (1, 2, 4, 8) for rows, wl in ((33, 13), (97, 31), (135, 61))
             for lead in ((), (6,)) for halo in (2, 4, 6) for mode in ("reflect", "symmetric")]
    cases += [(plan4k.n, shape, halo, mode)
              for shape, halo, mode in dict.fromkeys(halo_exchanges(plan4k, SHARDED_TAIL))]
    worst = 0.0
    for n, shape, halo, mode in cases:
        xs = halo_shards(rng, [dev] * n, shape)
        before = hl.LAUNCHES["halo_exchange_cols_rdma"]
        got = hl.halo_exchange_cols_rdma(xs, halo, mode)
        ref = hl.halo_exchange_cols_rdma_plain(xs, halo, mode)
        torch.cuda.synchronize()
        if hl.LAUNCHES["halo_exchange_cols_rdma"] != before + 1:
            raise AssertionError(f"K10 at {n} x {shape}: not one launch for one device")
        for g, r in zip(got, ref):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"K10 at {n} x {shape}, halo {halo}, {mode}: max "
                                     f"|kernel - plain| {float((g - r).abs().max())}")
            worst = max(worst, float((g - r).abs().max()))
    log(phase="halo_kernel_check", kernel="halo_exchange_cols_rdma", cases=len(cases),
        shards=[1, 2, 4, 8], halos=[2, 4, 6], right_modes=["reflect", "symmetric"],
        shapes_4k=[[list(s), h, m] for s, h, m in dict.fromkeys(halo_exchanges(plan4k, SHARDED_TAIL))],
        max_abs_err=worst, tolerance="bit-equal (a copy)")
    return worst


def halo_kernel_time(dev, hl, plan4k):
    """ms of K10 (by events, the wrapper's host cost included, and by CUDA
    graph replay, the kernel alone) and of its plain version on 4 virtual
    shards of the 4K frame at each exchange shape of its frame, with the
    bound from this run's
    shapes: each input read once (n * rows * w_l values), each output
    written once (n * rows * (w_l + 2h)). Returns (rows, the per-frame sums)."""
    rng = np.random.default_rng(SEED + 10)
    n = plan4k.n
    calls = halo_exchanges(plan4k, SHARDED_TAIL)
    rows, per_call = [], {}
    for shape, halo, mode in dict.fromkeys(calls):
        xs = halo_shards(rng, [dev] * n, shape)
        ms = cuda_ms(lambda: hl.halo_exchange_cols_rdma(xs, halo, mode), 50)
        graph = graph_ms(lambda: hl.halo_exchange_cols_rdma(xs, halo, mode), 50)
        plain_ms = cuda_ms(lambda: hl.halo_exchange_cols_rdma_plain(xs, halo, mode), 20)
        elems = int(np.prod(shape[:-1])) * n
        nbytes = 4 * elems * (2 * shape[-1] + 2 * halo)
        bound_ms, bound_by = bound(nbytes, 0)
        row = dict(kernel="halo_exchange_cols_rdma", shards=n, shape=list(shape), halo=halo,
                   right_mode=mode, ms=ms, graph_ms=graph, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_share=bound_ms / ms,
                   graph_bound_share=bound_ms / graph, bound_by=bound_by,
                   bytes=nbytes, per_frame=calls.count((shape, halo, mode)))
        rows.append(row)
        per_call[(shape, halo, mode)] = row
        log(phase="halo_kernel_time", **row)
    frame = {k: sum(per_call[c][k] for c in calls)
             for k in ("ms", "graph_ms", "plain_ms", "bound_ms")}
    log(phase="halo_kernel_time_per_frame", shards=n, exchanges=len(calls), **frame,
        bound_share=frame["bound_ms"] / frame["ms"],
        graph_bound_share=frame["bound_ms"] / frame["graph_ms"],
        library="none: no PyTorch call takes the shards and returns their haloed strips "
                "(F.pad of the gathered frame gives one padded array, after a gather)")
    return rows, frame


def sharded_dyn():
    from live_video_magnification_tpu_torch.models.riesz import RieszDynParams

    b_lo, a_lo, b_hi, a_hi = (tuple(float(x) for x in c) for c in tail_coeffs())
    return RieszDynParams(50.0, float(np.float32(50.0 * np.pi / 100.0)), b_lo, a_lo, b_hi,
                          a_hi, False, False)


def run_unsharded(torch, dev, frames, levels, tail):
    """The port's unsharded step over [T,3,H,W] u8 frames on ``dev``."""
    from live_video_magnification_tpu_torch.models import riesz

    dyn = sharded_dyn()
    state = riesz.init_state(frames.shape[2], frames.shape[3], levels, device=dev)
    outs = []
    for f in frames:
        state, out = riesz.step(state, f.to(dev), dyn, levels=levels, tail=tail)
        outs.append(out.cpu().numpy())
    return np.stack(outs)


def run_sharded(torch, devices, frames, levels, modules, **kw):
    """The frames through build_sharded_riesz_step on a (1, len(devices))
    mesh, counts reset just before. Returns (outputs, step seconds, launch
    counts, peak memory of the first device, plan)."""
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
        build_sharded_riesz_step,
        make_plan,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t, _, h, w = frames.shape
    mesh = make_mesh((1, len(devices)), devices=devices)
    step, state = build_sharded_riesz_step(mesh, 1, h, w, levels, **kw)
    dyn = sharded_dyn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(devices[0])
    reset_counts(*modules)
    outs, step_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        state, out = step(state, f[None], dyn)
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        step_s.append(time.perf_counter() - t0)
        outs.append(out[0])
    launches = launch_counts(*modules)
    peak = torch.cuda.max_memory_allocated(devices[0])
    plan = make_plan(h, w, levels, len(devices), force_sharded=kw.get("force_sharded", False))
    return torch.stack(outs).cpu().numpy(), step_s, launches, peak, plan


def sharded_runs(torch, frames, levels, ref, modules, hl, configs, phase, baseline=None):
    """Each (name, devices, kwargs) of ``configs`` through run_sharded;
    frames against ``ref`` (the unsharded step's under the same tail), K10
    launches against the count derived from the plan (one a distinct device
    and exchange). ``baseline``: a steady ms/frame logged beside each run's
    (the mesh of 1's). Returns each run's launch counts and steady ms/frame."""
    runs = {}
    for name, devices, kw in configs:
        out, step_s, launches, peak, plan = run_sharded(torch, devices, frames, levels, modules,
                                                        tail=SHARDED_TAIL, **kw)
        t = len(frames)
        lsb = [int(np.abs(out[i].astype(np.int16) - ref[i].astype(np.int16)).max())
               for i in range(t)]
        exact = len(devices) == 1
        if max(lsb) > (0 if exact else 1):
            raise AssertionError(f"{phase} {name}: frames off the unsharded step's by {lsb} LSB")
        if not np.array_equal(out[0], frames[0].numpy()):
            raise AssertionError(f"{phase} {name}: frame 0 is not the passthrough of the input")
        exchanges = halo_exchanges(plan, SHARDED_TAIL)
        want = len(exchanges) * len(set(devices))
        got = launches["halo_exchange_cols_rdma"]
        if got != want * t:
            raise AssertionError(f"{phase} {name}: K10 launched {got} times in {t} frames, "
                                 f"derived {want} a frame")
        steady = 1e3 * sum(step_s[2:]) / len(step_s[2:])
        runs[name] = dict(launches=launches, steady_ms_per_frame=steady)
        extra = {} if baseline is None else dict(
            mesh_1x1_steady_ms_per_frame=baseline, over_mesh_1x1=steady / baseline)
        log(phase=phase, config=name, devices=[str(d) for d in devices],
            card=torch.cuda.get_device_name(devices[0]), shape=list(frames.shape[2:]),
            levels=levels, frames=t, tail=SHARDED_TAIL, plan_sharded=list(plan.sharded),
            step_ms=[1e3 * x for x in step_s], steady_ms_per_frame=steady, **extra,
            peak_memory_bytes_first_device=peak, max_lsb_vs_unsharded=lsb,
            exchanges_per_frame=len(exchanges), k10_launches_per_frame=got / t,
            k10_launches_derived_per_frame=want,
            launches_per_frame={k: v / t for k, v in launches.items() if v})
    return runs


def slice_4k_sharded(torch, dev, st, tl, hl, frames_4k):
    """The lane-sharded step at 4K, levels=6, on virtual shards of one card,
    then on real cards when there are two or more; ``frames_4k``: the first
    SHARDED_FRAMES frames of the 4K clip, [T, H, W, 3] u8."""
    levels = 6
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    frames = torch.from_numpy(np.ascontiguousarray(frames_4k.transpose(0, 3, 1, 2)))
    t = len(frames)
    t0 = time.perf_counter()
    ref = run_unsharded(torch, dev, frames, levels, SHARDED_TAIL)
    log(phase="slice_4k_sharded_reference", tail=SHARDED_TAIL, frames=t,
        seconds=time.perf_counter() - t0)
    modules = (st, tl, hl)
    runs = sharded_runs(torch, frames, levels, ref, modules, hl, [
        ("virtual_1x4", [dev] * 4, {}),
        ("mesh_1x1", [dev], {}),
        ("mesh_1x1_force_sharded", [dev], dict(force_sharded=True)),
    ], "slice_4k_sharded")
    cards = torch.cuda.device_count()
    if cards >= 2:
        devices = [torch.device("cuda", i) for i in range(min(cards, 4))]
        sharded_runs(torch, frames, levels, ref, modules, hl,
                     [(f"cards_1x{len(devices)}", devices, {})], "slice_sharded_multi_gpu",
                     baseline=runs["mesh_1x1"]["steady_ms_per_frame"])
    else:
        log(phase="slice_sharded_multi_gpu", skipped="one CUDA device")
    return runs


# ---------------------------------------------------------------- the row-sharded steps

ROW_CELLS = (  # (name, mode, h, w, levels, meshes as (name, shape, batch))
    ("motion_4k", "laplace", 2160, 3840, None, (("virtual_2x2", (2, 2), 2),
                                                 ("virtual_1x4", (1, 4), 1))),
    ("color_4k", "color", 2160, 3840, None, (("virtual_2x2", (2, 2), 2),
                                              ("virtual_1x4", (1, 4), 1))),
    ("phase_768x1366", "phase", 768, 1366, 6, (("virtual_1x4", (1, 4), 1),)),
)
ROW_FRAMES = 6


def row_streams(frames, batch):
    """``batch`` streams of [T, 3, H, W] u8 from one host clip [T, H, W, 3]:
    stream b starts b frames later and wraps, so no two streams show the
    same frame at a step."""
    import torch

    tchw = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    t = len(tchw)
    return [torch.from_numpy(tchw[[(i + b) % t for i in range(t)]]) for b in range(batch)]


def row_run(torch, devices, cfg, streams, modules, mesh_shape=None):
    """The streams through the unsharded step of ``cfg``'s mode on
    devices[0] (mesh_shape None; one stream after another a frame, as the
    batch runs) or through build_sharded_step on a mesh of ``devices``,
    counts reset just before. Returns (outputs [T, B, 3, H, W], step
    seconds, launch counts, peak bytes on devices[0], plan or None)."""
    from live_video_magnification_tpu_torch.models import color, motion, riesz
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import MagnificationMode
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.sharding import (
        build_sharded_step,
        sharded_plan,
    )

    t, _, h, w = streams[0].shape
    batch, dev = len(streams), devices[0]
    chain = MagnificationChain(device=dev)
    key = chain.static_key(cfg, h, w, 3)
    dyn, levels, fps = chain._dyn_params(cfg, key), key.levels, cfg.magnification.framerate
    mode = key.mode
    gc.collect()
    torch.cuda.empty_cache()
    plan = None
    if mesh_shape is None:
        single = {MagnificationMode.PHASE: (lambda: riesz.init_state(h, w, levels, device=dev),
                                            lambda s, f: riesz.step(s, f, dyn, levels=levels)),
                  MagnificationMode.LAPLACE: (
                      lambda: motion.init_state(h, w, 3, levels, device=dev),
                      lambda s, f: motion.step(s, f, dyn, levels=levels)),
                  MagnificationMode.COLOR: (
                      lambda: color.init_state(h, w, 3, levels, fps, device=dev),
                      lambda s, f: color.step(s, f, dyn, levels=levels, framerate=fps))}[mode]
        states = [single[0]() for _ in streams]

        def step(i):
            outs = []
            for b, x in enumerate(streams):
                states[b], out = single[1](states[b], x[i].to(dev))
                outs.append(out)
            return torch.stack(outs)
    else:
        mesh = make_mesh(mesh_shape, devices=devices)
        plan = sharded_plan(mesh, mode, h, w, levels)
        sharded, state = build_sharded_step(mesh, mode, batch, h, w, levels, fps)
        box = [state]

        def step(i):
            box[0], out = sharded(box[0], torch.stack([x[i] for x in streams]), dyn)
            return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(*modules)
    outs, step_s = [], []
    for i in range(t):
        t0 = time.perf_counter()
        out = step(i)
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        step_s.append(time.perf_counter() - t0)
        outs.append(out.cpu().numpy())
    return (np.stack(outs), step_s, launch_counts(*modules),
            torch.cuda.max_memory_allocated(dev), plan)


def row_cell(torch, name, mode, frames, levels, meshes, modules, dev, phase_name, cards=None):
    """One row-sharded cell: per mesh, the sharded step against the
    unsharded step on the same streams, two passes (the second in reverse
    order), each run's ms/frame beside the unsharded step's of its pass.
    Asserts the frames (phase and motion bit for bit, colour within one
    LSB), the first frame's passthrough and the launches (phase:
    ``row_stencil_launches(plan)`` a frame and stream, no K10 and no tail
    kernel; motion and colour: none of K1-K10). ``cards``: real devices in
    place of virtual shards of ``dev`` (the ratio is then
    ``over_mesh_1x1``, the unsharded step on one card)."""
    from live_video_magnification_tpu_torch.parallel.row_sharded import row_stencil_launches

    cfg = mode_cfg(mode, levels=levels)
    exact = mode != "color"
    batch = max(b for _, _, b in meshes)
    streams = row_streams(frames, batch)
    runs = [("unsharded", None, batch)] + list(meshes)
    ref, lines = None, []
    for n_pass, order in enumerate((runs, runs[::-1]), start=1):
        for run_name, shape, b in order:
            devices = ([dev] if shape is None else
                       cards if cards is not None else [dev] * int(np.prod(shape)))
            out, step_s, launches, peak, plan = row_run(torch, devices, cfg, streams[:b],
                                                        modules, shape)
            t = len(step_s)
            steady = 1e3 * sum(step_s[2:]) / len(step_s[2:])
            line = dict(phase=phase_name, cell=name, run=n_pass, config=run_name,
                        card=torch.cuda.get_device_name(dev), mode=mode,
                        shape=list(frames.shape[1:3]), levels=cfg.magnification.levels,
                        framerate=cfg.magnification.framerate, frames=t, streams=b,
                        devices=[str(d) for d in devices], step_ms=[1e3 * x for x in step_s],
                        steady_ms_per_step=steady, steady_ms_per_frame=steady / b,
                        peak_memory_bytes_first_device=peak,
                        launches_per_frame={k: v / (t * b) for k, v in launches.items() if v})
            lines.append(line)
            if shape is None:
                ref = out if ref is None else ref
                continue
            diff = np.abs(out.astype(np.int16) - ref[:, :b].astype(np.int16))
            lsb = [int(diff[i].max()) for i in range(t)]
            if max(lsb) > (0 if exact else 1):
                raise AssertionError(f"{phase_name} {name} {run_name}: frames off the unsharded "
                                     f"step's by {lsb} LSB")
            if not np.array_equal(out[0], np.stack([x[0].numpy() for x in streams[:b]])):
                raise AssertionError(f"{phase_name} {name} {run_name}: frame 0 is not the input")
            per_frame = row_stencil_launches(plan) if mode == "phase" else {}
            want = {k: v * t * b for k, v in per_frame.items() if v}
            got = {k: v for k, v in launches.items() if v}
            if got != want:
                raise AssertionError(f"{phase_name} {name} {run_name}: launched {got} in {t} "
                                     f"frames of {b} streams, derived {want}")
            line.update(plan_sharded=list(plan.sharded), plan_axis=plan.axis,
                        max_lsb_vs_unsharded=lsb,
                        pixels_differing_vs_unsharded=[int(np.count_nonzero(diff[i].max(axis=1)))
                                                       for i in range(t)],
                        derived_stencil_launches_per_frame=per_frame,
                        k10_launches=launches["halo_exchange_cols_rdma"])
    ratio = "over_mesh_1x1" if cards is not None else "over_unsharded"
    for line in lines:
        base = next(x for x in lines if x["run"] == line["run"] and x["config"] == "unsharded")
        if line is not base:
            line["unsharded_steady_ms_per_frame"] = base["steady_ms_per_frame"]
            line[ratio] = line["steady_ms_per_frame"] / base["steady_ms_per_frame"]
        log(**line)


def slice_row_sharded(torch, dev, st, tl, hl, frames_4k):
    """The row-sharded steps (parallel/row_sharded.py) on virtual shards of
    one card: motion and colour at 2160x3840 at their defaults (motion
    levels 4; colour levels 3, 30 fps), two streams on a (2,2) mesh and one
    on (1,4); phase at 768x1366 levels 6 on (1,4) (1366 does not lane-shard
    4-way: the fallback; its rows shard at levels 0-3). ROW_FRAMES frames
    each; then the same over the real cards when there are two or more."""
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    modules = (st, tl, hl)
    small = moving_clip(ROW_FRAMES, 768, 1366, seed=SEED + 12)
    clips = {"motion_4k": frames_4k[:ROW_FRAMES], "color_4k": frames_4k[:ROW_FRAMES],
             "phase_768x1366": small}
    for name, mode, h, w, levels, meshes in ROW_CELLS:
        row_cell(torch, name, mode, clips[name], levels, meshes, modules, dev,
                 "slice_row_sharded")
    cards = torch.cuda.device_count()
    if cards < 2:
        log(phase="slice_row_sharded_multi_gpu", skipped="one CUDA device")
        return
    devices = [torch.device("cuda", i) for i in range(min(cards, 4))]
    for name, mode, h, w, levels, _ in ROW_CELLS:
        row_cell(torch, name, mode, clips[name], levels,
                 ((f"cards_1x{len(devices)}", (1, len(devices)), 1),), modules, dev,
                 "slice_row_sharded_multi_gpu", cards=devices)


# ---------------------------------------------------------------- the live engine

LIVE_S = 8.0       # seconds of the live_4k30 and live_1080p60 runs
LIVE_ROI_S = 6.0   # seconds of each config-4 run
CONSUMER_FRAMES = 16
RECORD_S = 2.0


def live_params(levels, fps):
    """Phase at the 4K cell's parameters (``cfg_4k``) at ``fps``."""
    import dataclasses

    return dataclasses.replace(cfg_4k(levels).magnification, framerate=fps)


def config4_params(fps):
    """BASELINE config 4's magnification as ``bench.py:233-238`` sets it, in phase."""
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
    )

    return MagnificationParams(mode=MagnificationMode.PHASE, amplification=20, co_low=1.0,
                               co_high=5.0, levels=4, framerate=fps)


def render_ms(h, w, fps):
    """ms a frame of ``SyntheticSource``'s render and the copy into a pooled
    buffer, alone: over the first shift period (each distinct table looked up
    once) and over the next 10 frames (cached tables, a strided copy)."""
    from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
    from live_video_magnification_tpu_torch.engine.pool import FramePool
    from live_video_magnification_tpu_torch.engine.queue import BoundedQueue
    from live_video_magnification_tpu_torch.engine.source import SyntheticSource

    src = SyntheticSource(FramePool(2), BoundedQueue(2), Instrumentation(), h, w, fps)
    buf = np.empty((h, w, 3), np.uint8)

    def run(lo, hi):
        t0 = time.perf_counter()
        for i in range(lo, hi):
            np.copyto(buf, src._render(i))
        return 1e3 * (time.perf_counter() - t0) / (hi - lo)

    period = int(round(fps))
    return dict(render_ms_first_period=run(0, period), render_ms=run(period, period + 10),
                render_tables=len(src._looked_up))


def consumer_copies_ms(torch, dev, h, w, oh, ow, reps=5):
    """The consumer's copies a frame by CUDA events: the pooled (pageable) u8
    frame to the card, and both panes back (two pageable D2H copies of the
    processed size, as ``engine/processing.py::hwc_result``)."""
    host = np.zeros((h, w, 3), np.uint8)
    pane = torch.zeros((oh, ow, 3), dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        fn()
        total = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            total += start.elapsed_time(stop)
        return total / reps

    h2d = timed(lambda: torch.from_numpy(host).to(dev))
    d2h = timed(lambda: [pane.to("cpu", copy=True) for _ in range(2)])
    return dict(h2d_ms=h2d, d2h_ms=d2h, h2d_bytes=host.nbytes, d2h_bytes=2 * pane.numel())


def live_expected(st, tl, hl, h, w, levels, processed):
    """Exactly the f32 stencils of ``stencil_launches`` and the blur13 of
    ``blur_launches`` a processed frame; every other count (bf16 arms, tail,
    halo) 0."""
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    want = {k: 0 for k in launch_counts(st, tl, hl)}
    want.update({k: v * processed for k, v in stencil_launches(h, w, levels).items()})
    want["blur13"] = blur_launches(h, w, levels) * processed
    return want


def recording_mailbox(keep=True):
    """A LatestFrameMailbox that stamps every publish and, with ``keep``,
    holds every published pair (the consumer check)."""
    from live_video_magnification_tpu_torch.engine.mailbox import LatestFrameMailbox

    class Recording(LatestFrameMailbox):
        def __init__(self):
            super().__init__()
            self.pairs, self.times = [], []

        def publish(self, frame):
            if keep:
                self.pairs.append(frame)
            self.times.append(time.perf_counter())
            super().publish(frame)

    return Recording()


def consumer_pass(dev, cfg, inputs, mailbox):
    """The frames, pooled, on a Block queue that holds them all, through one
    ``ProcessingChain`` until every frame is published. Returns (seconds,
    the instrumentation snapshot, the clamped levels)."""
    from live_video_magnification_tpu_torch.engine.config import AtomicConfig
    from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
    from live_video_magnification_tpu_torch.engine.pool import FramePool
    from live_video_magnification_tpu_torch.engine.processing import ProcessingChain
    from live_video_magnification_tpu_torch.engine.queue import BoundedQueue, OverflowPolicy

    n = len(inputs)
    h, w = inputs[0].shape[:2]
    pool = FramePool(n)
    queue = BoundedQueue(n, OverflowPolicy.BLOCK)
    for i, x in enumerate(inputs):
        f = pool.acquire(h, w, 3)
        np.copyto(f.data, x)
        f.seq = i
        queue.push(f)
    instr = Instrumentation()
    proc = ProcessingChain(queue, mailbox, AtomicConfig(cfg), instr, dev)
    t0 = time.perf_counter()
    proc.start()
    try:
        deadline = time.monotonic() + 120.0
        while len(mailbox.times) < n and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        queue.stop()
        proc.stop()
    return time.perf_counter() - t0, instr.snapshot(), proc._chain._key.levels


def engine_consumer_4k(torch, dev, st, tl, hl, h=2160, w=3840):
    """``ProcessingChain`` alone on a Block ``BoundedQueue`` that holds
    CONSUMER_FRAMES pooled 2160x3840 synthetic frames, twice: a timed pass
    (the mailbox keeps the latest pair only) and a checked one, every
    published pair bit for bit ``MagnificationChain.process`` of the same
    frame (``hwc_result`` of both panes); launches in each; then a profile
    of 4 frames of the consumer's work (the chain and both readbacks)."""
    from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
    from live_video_magnification_tpu_torch.engine.pool import FramePool
    from live_video_magnification_tpu_torch.engine.processing import hwc_result
    from live_video_magnification_tpu_torch.engine.queue import BoundedQueue
    from live_video_magnification_tpu_torch.engine.source import SyntheticSource
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import ProcessorConfig

    n = CONSUMER_FRAMES
    cfg = ProcessorConfig(magnification=live_params(6, 30.0))
    t0 = time.perf_counter()
    src = SyntheticSource(FramePool(2), BoundedQueue(2), Instrumentation(), h, w, 30.0)
    inputs = [np.array(src._render(i)) for i in range(n)]
    render_s = time.perf_counter() - t0
    del src
    passes = []
    for keep in (False, True):
        mailbox = recording_mailbox(keep)
        reset_counts(st, tl, hl)
        wall, s, levels = consumer_pass(dev, cfg, inputs, mailbox)
        launched = launch_counts(st, tl, hl)
        if len(mailbox.times) != n or s.proc_errors or s.processed != n:
            raise AssertionError(f"engine_consumer_4k: {len(mailbox.times)} of {n} published, "
                                 f"{s.proc_errors} processing errors")
        want = live_expected(st, tl, hl, h, w, levels, n)
        if launched != want:
            raise AssertionError(f"engine_consumer_4k launches {launched}, expected {want}")
        passes.append(dict(pairs_held=keep, ms_per_frame=1e3 * wall / n,
                           steady_ms_per_frame=1e3 * (mailbox.times[-1] - mailbox.times[1])
                           / (n - 2)))
    chain = MagnificationChain(device=dev)
    for i, (pair, x) in enumerate(zip(mailbox.pairs, inputs)):
        p, o = (hwc_result(t) for t in chain.process(x, cfg))
        if pair.processed.seq != i or not (np.array_equal(pair.processed.data, p)
                                           and np.array_equal(pair.original.data, o)):
            raise AssertionError(f"engine_consumer_4k: pair {i} is not the chain's frame")
        if i > 0 and np.array_equal(p, x):
            raise AssertionError(f"engine_consumer_4k: frame {i} not magnified")
    del mailbox, pair
    prof = profile_run(torch, lambda: [hwc_result(t) for x in inputs[:4]
                                       for t in chain.process(x, cfg)], 4)
    row = dict(phase="engine_consumer_4k", card=torch.cuda.get_device_name(dev), shape=[h, w],
               levels=levels, frames=n, ms_per_frame=passes[0]["ms_per_frame"],
               steady_ms_per_frame=passes[0]["steady_ms_per_frame"], passes=passes,
               render_s=render_s,
               stencil_launches_per_frame={k: v // n for k, v in launched.items() if v},
               bit_equal_to_chain=True, proc_errors=0,
               **consumer_copies_ms(torch, dev, h, w, h, w))
    log(**row)
    log(phase="profile_engine_consumer_4k", card=row["card"], **prof)
    return row


def live_run(torch, dev, st, tl, hl, name, h, w, fps, seconds, mag, as_camera, roi=False,
             native=False, present=None, host_costs=True):
    """One PlaybackController run of a paced synthetic source, as bench.py's
    bench_streaming drives it (stats polled at 4 Hz, steady fps over the
    second half), with a DisplayLoop polling the mailbox at 120 Hz. With
    ``present`` (``gui_present``), the loop composes the view side by side
    and hands it to the GUI's canvas present; the row gets its times. With
    ``host_costs``, the source's render and the consumer's copies are timed
    alone after the run."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.engine.display import DisplayLoop, ViewMode
    from live_video_magnification_tpu_torch.engine.native import NativeFramePoolAdapter
    from live_video_magnification_tpu_torch.engine.pool import FramePool
    from live_video_magnification_tpu_torch.models.chain import preprocess_geometry

    saved = os.environ.get("LVMT_NATIVE")
    os.environ["LVMT_NATIVE"] = "1" if native else "0"
    try:
        ctrl = PlaybackController(device=dev)
    finally:
        if saved is None:
            os.environ.pop("LVMT_NATIVE")
        else:
            os.environ["LVMT_NATIVE"] = saved
    want_pool = NativeFramePoolAdapter if native else FramePool
    if not isinstance(ctrl._pool, want_pool):
        raise AssertionError(f"{name}: transport {type(ctrl._pool).__name__}, "
                             f"expected {want_pool.__name__}")
    ctrl.set_magnification(mag)
    if roi:
        ctrl.set_downscale(2)
    if present is None:
        display = DisplayLoop(ctrl.mailbox, ctrl.instr, poll_hz=120.0)
    else:
        display = present.attach(DisplayLoop(ctrl.mailbox, ctrl.instr, render=present.render,
                                             poll_hz=120.0, view_mode=ViewMode.SIDE_BY_SIDE))
    try:
        if not ctrl.open_synthetic(h=h, w=w, fps=fps, as_camera=as_camera):
            raise AssertionError(f"{name}: the synthetic source did not open")
        if roi:
            ctrl.set_roi(0.25, 0.25, 0.5, 0.5)
        proc = ctrl._chain
        reset_counts(st, tl, hl)
        ctrl.play()
        display.start()
        t0 = time.monotonic()
        mid, depths, sampled, not_magnified = None, [], 0, []
        while time.monotonic() - t0 < seconds:
            time.sleep(0.25)
            s = ctrl.stats()
            depths.append(s.queue_depth)
            if mid is None and time.monotonic() - t0 >= seconds / 2:
                mid = (s.processed, time.monotonic())
            pair = ctrl.mailbox.latest()
            if pair is not None and pair.processed.seq > 0:
                sampled += 1
                if np.array_equal(pair.processed.data, pair.original.data):
                    not_magnified.append(pair.processed.seq)
        s = ctrl.stats()
        t_end = time.monotonic()
    finally:
        display.stop()
        ctrl.close()
    final = ctrl.instr.snapshot()  # after the teardown: the in-flight frame included
    key = proc._chain._key
    oh, ow = preprocess_geometry(ctrl.config_snapshot().preprocess, h, w)[4:]
    launched = launch_counts(st, tl, hl)
    want = live_expected(st, tl, hl, oh, ow, key.levels, final.processed)
    row = dict(phase=name, card=torch.cuda.get_device_name(dev), source=[h, w], fps=fps,
               processed_shape=[oh, ow], levels=key.levels, camera_semantics=as_camera,
               transport=type(ctrl._pool).__name__, seconds=seconds,
               steady_fps=(s.processed - mid[0]) / (t_end - mid[1]), fps_ema=s.process_fps,
               latency_ms_mean=s.latency_ms_mean, latency_ms_p95=s.latency_ms_p95,
               captured=final.captured, processed=final.processed, source_drops=s.source_drops,
               displayed=final.displayed, display_skipped=final.display_skipped,
               queue_depth_mean=float(np.mean(depths)), queue_depth_max=max(depths),
               proc_errors=final.proc_errors, read_errors=final.read_errors,
               sampled_frames=sampled, not_magnified=not_magnified,
               stencil_launches_per_frame={k: v / max(final.processed, 1)
                                           for k, v in launched.items() if v})
    if present is not None:
        row.update(present.stats())
    if host_costs:
        row.update(**render_ms(h, w, fps), **consumer_copies_ms(torch, dev, h, w, oh, ow))
    log(**row)
    if final.proc_errors or final.read_errors:
        raise AssertionError(f"{name}: {final.proc_errors} processing and "
                             f"{final.read_errors} read errors")
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, expected {want}")
    if final.processed < 2 or not sampled or not_magnified:
        raise AssertionError(f"{name}: {final.processed} processed, {sampled} sampled, "
                             f"frames not magnified {not_magnified}")
    return row


def live_4k30_runs(torch, dev, st, tl, hl):
    """live_4k30 and live_4k30_gui (the GUI's canvas present on the display
    loop) alternately, twice; the first run also times the host's costs."""
    return [live_run(torch, dev, st, tl, hl, "live_4k30_gui" if gui else "live_4k30",
                     2160, 3840, 30.0, LIVE_S, live_params(6, 30.0), as_camera=True,
                     present=gui_present() if gui else None, host_costs=run == 0 and not gui)
            for run in range(2) for gui in (False, True)]


def live_phases(torch, dev, st, tl, hl):
    """The live_4k30 runs, live_1080p60, config 4 on both transports."""
    rows = live_4k30_runs(torch, dev, st, tl, hl)
    rows.append(live_run(torch, dev, st, tl, hl, "live_1080p60", 1080, 1920, 60.0, LIVE_S,
                         live_params(6, 60.0), as_camera=True))
    for native in (False, True):
        rows.append(live_run(torch, dev, st, tl, hl, "live_1080p60_roi", 1080, 1920, 60.0,
                             LIVE_ROI_S, config4_params(60.0), as_camera=False, roi=True,
                             native=native))
    return rows


@contextlib.contextmanager
def memory_writer(written):
    """``exporter.open_writer`` replaced by a writer that keeps each canvas
    (the card's machine has no cv2)."""
    import live_video_magnification_tpu_torch.export.exporter as exporter

    class Memory:
        def write(self, canvas):
            written.append(canvas.copy())

        def release(self):
            pass

    saved = exporter.open_writer
    exporter.open_writer = lambda fmt, path, fps, size_wh: (Memory(), path, "memory")
    try:
        yield
    finally:
        exporter.open_writer = saved


def record_export_1080p(torch, dev, st, tl, hl, h=1080, w=1920):
    """About RECORD_S of a synthetic camera at 1080x1920 recorded through
    ``start_recording`` / ``stop_recording``, then exported by ``Exporter``
    (split left-right) into an in-memory writer; every written frame bit
    for bit a fresh chain's frames composed by ``compose``."""
    import live_video_magnification_tpu_torch.export.exporter as exporter
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.engine.processing import hwc_result
    from live_video_magnification_tpu_torch.export.sources import BufferExportFrameSource
    from live_video_magnification_tpu_torch.export.types import (
        ExportPhase,
        ExportRequest,
        SplitMode,
    )
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain

    fps = 30.0
    ctrl = PlaybackController(device=dev)
    try:
        ctrl.set_magnification(live_params(6, fps))
        if not ctrl.open_synthetic(h=h, w=w, fps=fps, as_camera=True):
            raise AssertionError("record_export_1080p: the synthetic camera did not open")
        ctrl.play()
        buf = ctrl.start_recording()
        time.sleep(RECORD_S)
        frames = ctrl.stop_recording()
        cfg = ctrl.config_snapshot()
    finally:
        ctrl.close()
    stats = ctrl.instr.snapshot()
    if not frames or stats.proc_errors or stats.read_errors or buf.limit_reached:
        raise AssertionError(f"record_export_1080p: {len(frames)} frames recorded, "
                             f"{stats.proc_errors} processing / {stats.read_errors} read errors")

    written = []
    with memory_writer(written):
        reset_counts(st, tl, hl)
        exp = exporter.Exporter(device=dev)
        t0 = time.perf_counter()
        exp.start(BufferExportFrameSource(frames), ExportRequest(
            config=cfg, output_path="record_export_1080p.avi", split=SplitMode.LEFT_RIGHT))
        exp.join(timeout=300.0)
        seconds = time.perf_counter() - t0
    p = exp.progress()
    launched = launch_counts(st, tl, hl)
    if p.phase is not ExportPhase.DONE or not p.frames_done == len(written) == len(frames):
        raise AssertionError(f"record_export_1080p: export {p.phase.value} ({p.error}), "
                             f"{p.frames_done} of {len(frames)}")
    chain = MagnificationChain(device=dev)
    for i, f in enumerate(frames):
        processed, original = (hwc_result(t) for t in chain.process(f, cfg))
        if i == 0:
            want = live_expected(st, tl, hl, h, w, chain._key.levels, len(frames))
            if launched != want:
                raise AssertionError(f"record_export_1080p: launches {launched}, "
                                     f"expected {want}")
        ref = exporter.compose(original, processed, SplitMode.LEFT_RIGHT, False)
        if not np.array_equal(written[i], ref):
            raise AssertionError(f"record_export_1080p: written frame {i} is not the chain's")
    row = dict(phase="record_export_1080p", card=torch.cuda.get_device_name(dev), shape=[h, w],
               record_seconds=RECORD_S, frames=len(frames), export_seconds=seconds,
               export_fps=len(frames) / seconds, canvas=list(written[0].shape),
               bit_equal_to_chain=True, proc_errors=0, read_errors=0,
               stencil_launches_per_frame={k: v / len(frames) for k, v in launched.items() if v})
    log(**row)
    return row


# ---------------------------------------------------------------- the desktop front ends

GUI_CANVAS = (1280, 720)   # the canvas the GUI's present fits the view into
GUI_RECORD_S = 1.5         # seconds recorded in gui_flow_1080p
GL_S = 4.0                 # seconds of the gl_present run


def card_name(torch, dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class gui_present:
    """The GUI's canvas present, ``gui.py::MainWindow._poll_display``, on a
    ``DisplayLoop`` thread: ``attach`` times the loop's ``poll_once`` (the
    mailbox read and ``compose_view``), ``render`` the rest of the body,
    ``fit_view`` into ``canvas`` (``display_fit`` and the nearest-neighbour
    index resize) and ``PhotoCodec.ppm``. tk's PhotoImage and canvas calls
    are left out (no display there). Host clock."""

    def __init__(self, canvas=GUI_CANVAS):
        from live_video_magnification_tpu_torch.gui import PhotoCodec

        self.canvas, self.codec, self.nbytes = canvas, PhotoCodec(), 0
        self.ms = {"compose": [], "fit": [], "ppm": []}

    def attach(self, display):
        poll = display.poll_once

        def timed_poll():
            t0 = time.perf_counter()
            view = poll()
            if view is not None:
                self.ms["compose"].append(1e3 * (time.perf_counter() - t0))
            return view

        display.poll_once = timed_poll
        return display

    def render(self, view):
        from live_video_magnification_tpu_torch.gui import fit_view

        t0 = time.perf_counter()
        fitted, _geom = fit_view(view, *self.canvas)
        t1 = time.perf_counter()
        self.nbytes = len(self.codec.ppm(fitted))
        t2 = time.perf_counter()
        self.ms["fit"].append(1e3 * (t1 - t0))
        self.ms["ppm"].append(1e3 * (t2 - t1))

    def stats(self):
        n = min(len(v) for v in self.ms.values())
        parts = {k: np.asarray(v[:n] or [np.nan]) for k, v in self.ms.items()}
        total = parts["compose"] + parts["fit"] + parts["ppm"]
        return dict(present_canvas=list(self.canvas), presented=len(self.ms["ppm"]),
                    present_ms_mean=float(total.mean()),
                    present_ms_p95=float(np.percentile(total, 95)),
                    present_ms_max=float(total.max()),
                    **{f"{k}_ms_mean": float(v.mean()) for k, v in parts.items()},
                    present_ppm_bytes=self.nbytes)


def gui_params(mode, fps=30.0, **edits):
    """``MainWindow.on_mode_change`` then ``push_params`` (gui.py), headless:
    the mode's defaults as the panel's variables hold them, ``edits`` made
    on the panel's sliders (UI units), the Capture FPS slider at ``fps``,
    the Nyquist clamp, and the band slider's clamp, snap and gap on
    [0.05, fps/2]; returns the MagnificationParams the controller gets."""
    import dataclasses

    from live_video_magnification_tpu_torch.gui import slider_enforce_gap, slider_snap
    from live_video_magnification_tpu_torch.models.params import (
        clamp_band_to_nyquist,
        defaults_for,
        to_params,
    )

    panel = dataclasses.replace(defaults_for(mode), **edits)
    ui = defaults_for(mode)
    ui.amplification = int(panel.amplification)
    ui.wavelength = float(panel.wavelength)
    ui.low, ui.high = float(panel.low), float(panel.high)
    ui.chroma = int(panel.chroma)
    ui.levels = int(panel.levels)
    ui.capture_fps = float(fps)
    clamp_band_to_nyquist(ui)
    top = max(0.1, ui.capture_fps / 2.0)
    low, high = (slider_snap(min(max(v, 0.05), top), 0.05) for v in (ui.low, ui.high))
    if high < low:
        low, high = high, low
    ui.low, ui.high = slider_enforce_gap(low, high, 0.05, 0.05, top, "low")
    return to_params(ui)


def gui_record_flow(torch, dev, h, w, fps=30.0, seconds=GUI_RECORD_S, levels=6, modules=()):
    """The GUI's record -> export flow, headless, through its own functions:
    the panel switched to phase (``gui_params``, levels ``levels``) on a
    synthetic camera, REC through ``record_start_guard``, polled by
    ``record_poll_transition`` every ``ExportProgressDialog.POLL_MS`` until
    ``seconds`` pass, stopped (the guard's "stop") and sent to the settings by
    ``record_stop_decision``; the export's config by ``build_export_config``
    from the raw live state with the amplification edited away from it,
    split side by side without labels; playback paused as the GUI does; the
    ``Exporter`` over ``BufferExportFrameSource`` into an in-memory writer,
    polled by ``export_poll_transition`` to "finish". Every written frame
    must equal bit for bit a fresh chain's frames under the export's config
    composed by ``compose``; with ``modules``, the export's launches must be
    exactly ``stencil_launches`` and ``blur_launches`` a frame. Returns the
    numbers."""
    import live_video_magnification_tpu_torch.export.exporter as exporter
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.engine.processing import hwc_result
    from live_video_magnification_tpu_torch.export.sources import BufferExportFrameSource
    from live_video_magnification_tpu_torch.export.types import (
        ExportFormat,
        ExportRequest,
        SplitMode,
        validate_request,
    )
    from live_video_magnification_tpu_torch.gui import (
        ExportProgressDialog,
        build_export_config,
        export_poll_transition,
        record_poll_transition,
        record_start_guard,
        record_stop_decision,
    )
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import MagnificationMode, to_ui
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    poll_s = ExportProgressDialog.POLL_MS / 1e3
    written = []
    ctrl = PlaybackController(device=dev)
    try:
        ctrl.set_magnification(gui_params(MagnificationMode.PHASE, fps, levels=levels))
        if not ctrl.open_synthetic(h=h, w=w, fps=fps, as_camera=True):
            raise AssertionError("gui_flow: the synthetic camera did not open")
        ctrl.play()
        if record_start_guard(False, False) != "begin":
            raise AssertionError("gui_flow: record_start_guard refused to begin")
        buf = ctrl.start_recording()
        t0, polls = time.monotonic(), 0
        while record_poll_transition(buf.limit_reached) == "continue" \
                and time.monotonic() - t0 < seconds:
            time.sleep(poll_s)
            polls += 1
        if record_start_guard(True, False) != "stop":
            raise AssertionError("gui_flow: record_start_guard did not stop")
        frames = ctrl.stop_recording()
        if record_stop_decision(len(frames)) != "open_settings":
            raise AssertionError("gui_flow: nothing recorded")
        live = ctrl.config_snapshot(raw_mode=True)
        ui = to_ui(live.magnification)
        ui.amplification += 30
        cfg = build_export_config(live, ui, downscale=live.preprocess.downscale,
                                  use_roi=live.preprocess.roi_enabled,
                                  grayscale=live.grayscale)
        if cfg.magnification == live.magnification or cfg.magnification.levels != levels:
            raise AssertionError(f"gui_flow: export config {cfg.magnification} against the "
                                 f"live {live.magnification}")
        req = ExportRequest(config=cfg, output_path=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "gui_flow.avi"),
            file_fps=ctrl.reported_fps() or 30.0, split=SplitMode.LEFT_RIGHT,
            text_overlay=False, format=ExportFormat.AVI_MJPG)
        problems = validate_request(req, len(frames))
        if problems:
            raise AssertionError(f"gui_flow: request refused: {problems}")
        ctrl.pause()  # the GUI pauses the camera while it exports
        # the consumer drains its queue, so no live frame's launch counts as the export's
        settled, deadline = -1, time.monotonic() + 10.0
        while (settled != (s := ctrl.stats()).processed + s.proc_errors or s.queue_depth) \
                and time.monotonic() < deadline:
            settled = s.processed + s.proc_errors
            time.sleep(3 * poll_s)
        reset_counts(*modules)
        with memory_writer(written):
            exp = exporter.Exporter(device=ctrl.device)
            t1 = time.perf_counter()
            exp.start(BufferExportFrameSource(frames), req, ctrl.mailbox)
            deadline = time.monotonic() + 300.0
            while True:
                p = exp.progress()
                action, text = export_poll_transition(p.phase, p.frames_done, p.frames_total,
                                                      p.error)
                if action == "finish" or time.monotonic() > deadline:
                    break
                time.sleep(poll_s)
            export_s = time.perf_counter() - t1
            exp.join(timeout=5.0)
        launched = launch_counts(*modules)
    finally:
        ctrl.close()
    if text != f"Done — {len(frames)} frames written" or len(written) != len(frames):
        raise AssertionError(f"gui_flow: export finished with {text!r}, "
                             f"{len(written)} of {len(frames)} written")
    chain = MagnificationChain(device=dev)
    for i, f in enumerate(frames):
        processed, original = (hwc_result(t) for t in chain.process(f, cfg))
        ref = exporter.compose(original, processed, SplitMode.LEFT_RIGHT, False)
        if not np.array_equal(written[i], ref):
            raise AssertionError(f"gui_flow: written frame {i} is not the fresh chain's")
        if i > 0 and np.array_equal(processed, original):
            raise AssertionError(f"gui_flow: frame {i} not magnified")
    levels_run = chain._key.levels
    if modules:
        want = {k: 0 for k in launched}
        want.update({k: v * len(frames) for k, v in stencil_launches(h, w, levels_run).items()})
        want["blur13"] = blur_launches(h, w, levels_run) * len(frames)
        if launched != want:
            raise AssertionError(f"gui_flow: launches {launched}, expected {want}")
    return dict(shape=[h, w], levels=levels_run, record_seconds=seconds, record_polls=polls,
                frames=len(frames), export_seconds=export_s, export_fps=len(frames) / export_s,
                live_amplification=live.magnification.amplification,
                export_amplification=cfg.magnification.amplification,
                canvas=list(written[0].shape), bit_equal_to_chain=True,
                stencil_launches_per_frame={k: v / len(frames)
                                            for k, v in launched.items() if v})


def gui_flow_1080p(torch, dev, st, tl, hl, h=1080, w=1920):
    row = gui_record_flow(torch, dev, h, w, modules=(st, tl, hl))
    log(phase="gui_flow_1080p", card=card_name(torch, dev), **row)
    return row


def gl_present(torch, dev, st, tl, hl, h=1080, w=1920, fps=60.0, seconds=GL_S,
               canvas=GUI_CANVAS):
    """``GLDisplayLoop`` on a ``HeadlessGLContext`` of ``canvas`` against a
    live ``PlaybackController`` stream (phase, levels 6, a synthetic camera),
    where GL exists: skipped, with the error, when PyOpenGL does not import
    or EGL makes no context; any later failure fails. Upload ms a frame
    (``glTexImage2D`` / ``glTexSubImage2D`` by the host clock), paint ms,
    frames displayed and skipped; the framebuffer (``read_pixels``) must hold
    the last uploaded frame letterboxed, its mean colour within 3 levels."""
    try:
        import OpenGL  # noqa: F401

        from live_video_magnification_tpu_torch.engine import gl_present as glp

        ctx = glp.HeadlessGLContext(*canvas)
    except Exception as e:  # noqa: BLE001 - no GL on this machine: reported, not hidden
        row = dict(phase="gl_present", skipped=f"{type(e).__name__}: {e}")
        log(**row)
        return row
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController

    timed = dict(upload=[], paint=[], last=None)

    class TimedPresenter(glp.GLPresenter):
        def _upload(self, img, tex):
            t0 = time.perf_counter()
            super()._upload(img, tex)
            timed["upload"].append(1e3 * (time.perf_counter() - t0))
            timed["last"] = img

        def paint(self, pair, fb_w, fb_h):
            t0 = time.perf_counter()
            fresh = super().paint(pair, fb_w, fb_h)
            if fresh:
                timed["paint"].append(1e3 * (time.perf_counter() - t0))
            return fresh

    saved = glp.GLPresenter
    glp.GLPresenter = TimedPresenter
    try:
        ctx.release_current()  # the loop's thread takes the context
        ctrl = PlaybackController(device=dev)
        try:
            ctrl.set_magnification(live_params(6, fps))
            loop = glp.GLDisplayLoop(ctrl.mailbox, ctrl.instr, ctx, poll_hz=120.0)
            if not ctrl.open_synthetic(h=h, w=w, fps=fps, as_camera=True):
                raise AssertionError("gl_present: the synthetic camera did not open")
            ctrl.play()
            loop.start()
            try:
                time.sleep(seconds)
            finally:
                loop.stop()
        finally:
            ctrl.close()
        s = ctrl.instr.snapshot()
        ctx.make_current()
        out = ctx.read_pixels()
    finally:
        glp.GLPresenter = saved
        ctx.make_current()
        ctx.destroy()
    last = timed["last"]
    if s.displayed < 2 or last is None or s.proc_errors:
        raise AssertionError(f"gl_present: {s.displayed} displayed, {s.proc_errors} errors")
    x, y, vw, vh = glp.letterbox(last.shape[1], last.shape[0], 0, 0, *canvas)
    inside = out[y:y + vh, x:x + vw].reshape(-1, 3).mean(0)
    want = last.reshape(-1, 3)[:, ::-1].mean(0)  # BGR -> RGB
    bars = np.concatenate([out[:y].reshape(-1, 3), out[y + vh:].reshape(-1, 3),
                           out[:, :x].reshape(-1, 3), out[:, x + vw:].reshape(-1, 3)])
    if np.abs(inside - want).max() > 3.0 or (bars.size and bars.max() != 0):
        raise AssertionError(f"gl_present: framebuffer mean {inside} against the frame's "
                             f"{want}, bars max {bars.max() if bars.size else 0}")
    up, paint = np.asarray(timed["upload"]), np.asarray(timed["paint"])
    row = dict(phase="gl_present", card=card_name(torch, dev), source=[h, w], fps=fps,
               canvas=list(canvas), seconds=seconds, processed=s.processed,
               displayed=s.displayed, display_skipped=s.display_skipped, uploads=len(up),
               upload_ms_mean=float(up.mean()), upload_ms_p95=float(np.percentile(up, 95)),
               paint_ms_mean=float(paint.mean()), viewport=[x, y, vw, vh],
               framebuffer_mean_rgb=inside.tolist(), frame_mean_rgb=want.tolist())
    log(**row)
    return row


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        return rank_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import halo as hl
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl
    from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import make_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device("cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is not disabled")
    name = torch.cuda.get_device_name(0)
    log(phase="device", name=name, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])

    fresh = not all(_build.library_path(n).exists() for n in _build.SOURCES)

    def build():
        t0 = time.perf_counter()
        return _build.build(), time.perf_counter() - t0

    # nvcc runs in processes of its own: the host makes the 4K clip meanwhile
    # (TP_CHUNK frames for the time-parallel cells; the first 8 for the others)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        frames_tp = frames_4k(t=TP_CHUNK + TM_TAIL)
        paths, build_s = building.result()
    frames = frames_tp[:8]
    ptxas = [ln.strip() for p in paths.values() for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(phase="build", seconds=build_s, compiled_now=fresh, libraries=[p.name for p in paths.values()], ptxas=ptxas)

    sizes = riesz_level_sizes(2160, 3840, 6)
    errs = kernel_phase(dev, st, sizes)
    band5_exact(dev, st)
    blur13_exact(dev, st)
    times = time_phase(dev, st, sizes)
    tail_errs = tail_kernel_check(dev, tl, sizes)
    tail_times = tail_kernel_time(dev, tl, sizes)
    build_err = build_kernel_check(dev, st, sizes)
    build_times = build_kernel_time(dev, st, sizes)
    bf16_errs = bf16_kernel_check(dev, st, tl, sizes)
    bf16_times = bf16_kernel_time(dev, st, tl, sizes)
    plan4k = make_plan(2160, 3840, 6, 4)
    halo_err = halo_kernel_check(dev, hl, plan4k)
    halo_times, halo_frame = halo_kernel_time(dev, hl, plan4k)
    launches, frames, jnp_out, jnp_ms = slice_4k(torch, dev, st, tl, frames)
    runs = slice_4k_tails(torch, dev, st, tl, frames, jnp_out)
    bench_calls = port_bench(torch, dev, st, tl, hl, jnp_ms)
    log(phase="ieee_f32", **assert_ieee_f32(torch))
    slice_4k_modes(torch, dev, st, tl, hl, frames)
    del frames, jnp_out
    slice_4k_time_parallel(torch, dev, st, tl, hl, frames_tp[:TP_CHUNK])
    virtual = slice_4k_time_mesh(torch, dev, st, tl, hl, frames_tp)
    slice_time_mesh_multi_gpu(torch, st, tl, hl, frames_tp, virtual)
    del virtual
    slice_row_sharded(torch, dev, st, tl, hl, frames_tp[:ROW_FRAMES])
    frames_sharded = frames_tp[:SHARDED_FRAMES].copy()
    del frames_tp
    distributed_2rank(torch, dev)
    flagship = slice_card_vs_cpu(torch, dev, st, tl, "jnp")
    slice_card_vs_cpu(torch, dev, st, tl, "level")
    slice_card_vs_cpu(torch, dev, st, tl, "fast")
    slice_card_vs_cpu_modes(torch, dev, st, tl, hl)
    slice_card_vs_cpu_time_parallel(torch, dev, st, tl, hl)
    sharded = slice_4k_sharded(torch, dev, st, tl, hl, frames_sharded)
    del frames_sharded
    engine_consumer_4k(torch, dev, st, tl, hl)
    live_phases(torch, dev, st, tl, hl)
    record_export_1080p(torch, dev, st, tl, hl)
    gui_flow_1080p(torch, dev, st, tl, hl)
    gl_present(torch, dev, st, tl, hl)

    path = lambda name: " ".join(f"{k}={v}" for k, v in CONFIGS[name][0].items()) or "defaults"
    level0 = lambda rows, k: next(r for r in rows if r["kernel"] == k and r["level"] == 0
                                  and r.get("grid", "4K") == "4K")
    floor = lambda row: {k: row[k] for k in ("exact_floor_ms",) if k in row}
    kernels = []
    for k in PER_FRAME:
        top = level0(times, k)
        kernels.append(dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                            launches=launches[k], path=path("jnp"), max_abs_err=errs[k],
                            ms=top["ms"], graph_ms=top["graph_ms"],
                            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                            bound_by=top["bound_by"], library_ms=top["library_ms"],
                            shape=top["shape"], **floor(top)))
    for k in TAIL_REPLACES:
        top = level0(tail_times, k)
        launched = runs[TAIL_MAIN_PATH[k]][k]
        if launched == 0:
            raise AssertionError(f"{k} was not launched on its path")
        kernels.append(dict(name=k, route="cuda", source=TAIL_SOURCE, replaces=TAIL_REPLACES[k],
                            launches=launched, path=path(TAIL_MAIN_PATH[k]),
                            max_abs_err=tail_errs[k], ms=top["ms"], graph_ms=top["graph_ms"],
                            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                            bound_by=top["bound_by"], library_ms=None, shape=top["shape"],
                            **floor(top)))
    # K5's numbers at 68x120, the shape of the 1080p default path whose
    # launches are shown; the 4K fused route's level 0 beside them
    top = next(r for r in build_times if r["grid"] == "1080p")
    top4k = level0(build_times, "riesz_build_level")
    if flagship["riesz_build_level"] == 0 or runs["fused"]["riesz_build_level"] == 0:
        raise AssertionError("riesz_build_level was not launched on its paths")
    kernels.append(dict(name="riesz_build_level", route="cuda", source=SOURCE,
                        replaces=BUILD_REPLACES, launches=flagship["riesz_build_level"],
                        path="1080p levels=6, defaults (level 4, 68x120)",
                        max_abs_err=build_err, ms=top["ms"], graph_ms=top["graph_ms"],
                        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                        bound_by=top["bound_by"], library_ms=None,
                        shape=top["shape"], k1_k2_k3_sum_ms=top["k1_k2_k3_sum_ms"],
                        k1_k2_k3_graph_sum_ms=top["k1_k2_k3_graph_sum_ms"], **floor(top),
                        fused_4k=dict(path=path("fused"),
                                      launches=runs["fused"]["riesz_build_level"],
                                      shape=top4k["shape"], ms=top4k["ms"],
                                      graph_ms=top4k["graph_ms"], plain_ms=top4k["plain_ms"],
                                      bound_ms=top4k["bound_ms"], bound_by=top4k["bound_by"],
                                      exact_floor_ms=top4k["exact_floor_ms"],
                                      k1_k2_k3_sum_ms=top4k["k1_k2_k3_sum_ms"],
                                      k1_k2_k3_graph_sum_ms=top4k["k1_k2_k3_graph_sum_ms"])))
    for k, replaces in BF16_REPLACES.items():
        top = level0(bf16_times, k)
        launched = runs["fast"][k]
        if launched == 0:
            raise AssertionError(f"{k} was not launched on its path")
        kernels.append(dict(name=k, route="cuda",
                            source=TAIL_SOURCE if k.startswith("riesz") else SOURCE,
                            replaces=replaces, launches=launched, path=path("fast"),
                            max_abs_err=bf16_errs[k], ms=top["ms"],
                            graph_ms=top["graph_ms"], plain_ms=top["plain_ms"],
                            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                            library_ms=top["library_ms"], shape=top["shape"],
                            **floor(top)))
    # K10 at the largest exchange of the 4K sharded frame (the tail's 6-plane
    # stack at level 0, halo 6) with its frame's sums beside it
    top = max(halo_times, key=lambda r: r["bytes"])
    launched = sharded["virtual_1x4"]["launches"]["halo_exchange_cols_rdma"]
    if launched == 0:
        raise AssertionError("halo_exchange_cols_rdma was not launched on its path")
    kernels.append(dict(name="halo_exchange_cols_rdma", route="cuda", source=HALO_SOURCE,
                        replaces=HALO_REPLACES, launches=launched,
                        path=f"2160x3840 levels=6, sharded step, (1,4) mesh of one card, "
                             f"tail={SHARDED_TAIL}",
                        max_abs_err=halo_err, ms=top["ms"], graph_ms=top["graph_ms"],
                        plain_ms=top["plain_ms"],
                        bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=None,
                        shape=top["shape"], shards=top["shards"], halo=top["halo"],
                        per_frame=halo_frame))
    for k in kernels:  # the port bench's launches of each kernel, all its runs summed
        k["bench_launches"] = sum(c["launches"].get(k["name"], 0) for c in bench_calls)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
