"""Colour magnification: Gaussian pyramid + ideal FFT bandpass over a rolling window.

The counterpart of the reference package's ``models/color.py``
(MagnifyCore.hpp:163-206):

  u8 -> f32 (no /255) -> Gaussian pyramid, take the smallest level -> push it
  as the newest row of a rolling window of optimal_buffer_size(fps) frames ->
  ideal bandpass over the time axis, min-max normalized over the active
  window -> x amplification -> reconstruct row min(1, L-1) by pyrUps and a
  resize -> out = input + colour image -> u8 rescaled by the output's own min
  and max.

The window is a device-resident [W, C, hs, ws] f32 tensor, oldest row first.
``count`` is a host int, so whether the window is full, which row is
written, the active length L and the warm-up passthrough (L < 2, the input
frame returned as it is) are host decisions; the shift, the row write, the
bandpass, the min and max stay on the device and nothing is read back. The
bandpass operator for (L, cutoffs, framerate) is built on the device once
and reused (``ops/temporal.py::ideal_bandpass_operator``). ``step`` is
functional: it returns a new state and leaves the given one untouched.
``process_clip_parallel`` is the time-parallel form of a clip: each frame's
window gathered from the chunk, with the same carried state.

``step`` opens three spans of the port's recorder (``engine/profiling.py``;
inert while it is off), each timed by CUDA events on a card:
``color.pyramid`` (the Gaussian pyramid), ``color.bandpass`` (the window
push, the operator applied, the min-max normalization and the
amplification) and ``color.reconstruct`` (the pyrUps, the resize, the add
and the rescale to u8). ``process_clip_parallel`` opens none of the three.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.ops.color import to_u8
from live_video_magnification_tpu_torch.ops.pyramid import (
    build_gauss_pyr,
    pyramid_sizes,
    reconstruct_from_gauss_level,
)
from live_video_magnification_tpu_torch.ops.temporal import (
    ideal_bandpass_apply,
    ideal_bandpass_operator,
    minmax_bounds,
    minmax_normalize,
    optimal_buffer_size,
)
from live_video_magnification_tpu_torch.parallel.time_shard import TimeShards, all_rows


class ColorDynParams(NamedTuple):
    """Per-frame parameters, host values already rounded to f32."""

    amplification: float
    co_low: float   # Hz
    co_high: float  # Hz


class ColorState(NamedTuple):
    count: int            # frames pushed so far, saturating at the window size
    window: torch.Tensor  # [W, C, hs, ws] f32, rows 0..L-1 active, oldest first


def window_size(framerate: float) -> int:
    return optimal_buffer_size(int(framerate))


def init_state(h: int, w: int, channels: int, levels: int, framerate: float,
               device=None) -> ColorState:
    """Zero state for (h, w) frames of ``channels``. ``device`` defaults to
    CUDA and raises without a card; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    hs, ws = pyramid_sizes(h, w, levels)[levels - 1]
    win = torch.zeros((window_size(framerate), channels, hs, ws), dtype=torch.float32,
                      device=dev)
    return ColorState(0, win)


def step(state: ColorState, frame_u8: torch.Tensor, dyn: ColorDynParams, *,
         levels: int, framerate: float) -> Tuple[ColorState, torch.Tensor]:
    """One frame [C, H, W] uint8 -> (new state, [C, H, W] uint8)."""
    # imported here: importing the engine package imports the models
    from live_video_magnification_tpu_torch.engine.profiling import span

    channels, h, w = frame_u8.shape
    w_static = state.window.shape[0]
    dev = frame_u8.device

    with span("color.pyramid", device=dev):
        inp = frame_u8.to(torch.float32)  # convertTo(CV_32F): stays in [0, 255]
        small = build_gauss_pyr(inp, levels)[levels - 1]

    with span("color.bandpass", device=dev):
        # img2tempMat (SpatialFilter.cpp:63-84): append the newest; once full,
        # drop the oldest. Full: one shift of the window with the new row last.
        if state.count >= w_static:
            window = torch.cat([state.window[1:], small[None]])
        else:
            window = state.window.clone()
            window[state.count] = small
        length = min(state.count + 1, w_static)  # active rows
        new_state = ColorState(length, window)
        if length < 2:  # warm-up: the raw frame passes through (MagnifyCore.hpp:180)
            return new_state, frame_u8

        filtered = ideal_bandpass_apply(window.reshape(w_static, -1), length, dyn.co_low,
                                        dyn.co_high, framerate)
        # normalize(0, 1, MINMAX) over the active rows, all channels jointly; an
        # empty band gives a constant window, which OpenCV maps to zeros
        filtered = minmax_normalize(filtered, valid_rows=length)
        filtered = filtered * float(np.float32(dyn.amplification))

    with span("color.reconstruct", device=dev):
        # the reconstructed row is min(1, L-1): row 1 once warm (MagnifyCore.hpp:186-192)
        small_filtered = filtered[min(1, length - 1)].reshape(small.shape)
        output = inp + reconstruct_from_gauss_level(small_filtered, levels, (h, w))

        # rescale by the output's own min and max over all channels (MagnifyCore.hpp:199-203)
        return new_state, rescale_u8(output, output.min(), output.max())


def rescale_u8(output: torch.Tensor, omn: torch.Tensor, omx: torch.Tensor) -> torch.Tensor:
    """u8 of ``output`` rescaled so that [omn, omx] maps onto [0, 255]."""
    span = omx - omn
    return to_u8(output, span.new_full((), 255.0) / span, -omn * 255.0 / span)


def process_clip(frames_u8: torch.Tensor, dyn: ColorDynParams, *, levels: int,
                 framerate: float, state: Optional[ColorState] = None, device=None
                 ) -> Tuple[ColorState, torch.Tensor]:
    """[T, C, H, W] uint8 through ``step`` in order; returns (state, outs).
    Without ``state`` it starts from zero on ``device`` (CUDA by default)."""
    t, c, h, w = frames_u8.shape
    if state is None:
        state = init_state(h, w, c, levels, framerate, device=device)
    frames_u8 = frames_u8.to(state.window.device)
    outs = []
    for i in range(t):
        state, out = step(state, frames_u8[i], dyn, levels=levels, framerate=framerate)
        outs.append(out)
    return state, torch.stack(outs)


def process_clip_parallel(frames_u8, dyn: ColorDynParams, *, levels: int,
                          framerate: float, state: Optional[ColorState] = None, device=None,
                          shards=None):
    """The time-parallel form of ``process_clip`` (the reference's
    ``models/color.py::process_clip_parallel``): [T, C, H, W] uint8 in,
    (state, outs) out, the state laid out as ``step``'s.

    Frame t's window is the last min(count + t + 1, N) pyramid tops, oldest
    first: the carried window's active rows, rolled so its newest row lands
    at index N - 1, go before the chunk's tops, and a [T, N, P] gather takes
    each frame's rows (rows past its length L are ignored by the operator).
    The bandpass runs once per distinct L, batched over the run of frames
    that have it: a steady chunk (every L = N) is one product. Each frame is normalized by the min
    and max of its active rows; only the reconstructed row min(1, L-1) is
    scaled. The lengths and the warm-up passthrough (L < 2) are host ints,
    as ``count`` is.

    ``shards`` (``parallel/time_shard.py::TimeShards``) splits the time axis:
    ``frames_u8`` is then a sequence of [T_k, C, H, W] chunks, one for each
    shard this process holds, on its device, and ``outs`` a list of the
    same. A shard's lengths count the chunk's frames before it; its windows
    read the carried window, the earlier shards' tops (``all_rows``) and its
    own; the final window is the whole chunk's."""
    n_win = window_size(framerate)
    split = shards is not None
    if not split:
        _, channels, h, w = frames_u8.shape
        if state is None:
            state = init_state(h, w, channels, levels, framerate, device=device)
        shards = TimeShards.single(state.window.device)
        frames = [frames_u8.to(shards.home)]
    else:
        frames = list(frames_u8)
        channels, h, w = frames[0].shape[1:]
        if state is None:
            state = init_state(h, w, channels, levels, framerate, device=shards.home)
    per = frames[0].shape[0]  # frames a shard
    t_total = per * shards.count

    inputs, smalls = [], []
    for f in frames:
        inputs.append(f.to(torch.float32))  # convertTo(CV_32F): stays in [0, 255]
        smalls.append(build_gauss_pyr(inputs[-1], levels)[levels - 1])
    flat = all_rows(shards, [sm.reshape(sm.shape[0], -1) for sm in smalls])  # [T, P]

    count = min(state.count, n_win)  # active carried rows
    carried = torch.roll(state.window.reshape(n_win, -1), n_win - count, dims=0)
    combined = torch.cat([carried, flat])  # [N + T, P], newest carried row at N - 1
    del flat, carried
    amp = float(np.float32(dyn.amplification))
    outs = []
    for j, f in enumerate(frames):
        dev = f.device
        g0 = shards.index(j) * per  # the chunk's frames before this shard
        t = f.shape[0]
        lengths = [min(count + g0 + i + 1, n_win) for i in range(t)]
        last = n_win + g0 + t - 1  # this shard's newest top
        base = torch.tensor([n_win + g0 + i + 1 - n for i, n in enumerate(lengths)], device=dev)
        idx = torch.clamp(base[:, None] + torch.arange(n_win, device=dev)[None, :], max=last)
        windows = combined.to(dev)[idx]  # [T, N, P]
        rows = torch.zeros((t, combined.shape[1]), dtype=combined.dtype, device=dev)
        for length in sorted(set(lengths) - {1}):
            # the lengths never decrease: the frames of one length are a run
            i0 = lengths.index(length)
            i1 = i0 + lengths.count(length)
            op = ideal_bandpass_operator(n_win, length, float(dyn.co_low), float(dyn.co_high),
                                         float(framerate), dev)
            filtered = torch.matmul(op, windows[i0:i1])  # [g, N, P]
            mn, inv = minmax_bounds(filtered[:, :length], dims=(1, 2))
            rows[i0:i1] = (filtered[:, min(1, length - 1)] - mn[:, 0]) * inv[:, 0] * amp
            del filtered
        del windows
        color_img = reconstruct_from_gauss_level(rows.reshape(smalls[j].shape), levels, (h, w))
        output = inputs[j] + color_img
        inputs[j] = smalls[j] = None
        del rows, color_img
        # rescale each frame by its own min and max over all channels
        out = rescale_u8(output, output.amin(dim=(1, 2, 3), keepdim=True),
                         output.amax(dim=(1, 2, 3), keepdim=True))
        del output
        for i, n in enumerate(lengths):
            if n < 2:  # warm-up: the raw frame passes through
                out[i] = f[i]
        outs.append(out)

    # the final window: the last L rows of the combined sequence, oldest first,
    # rows past L zeroed
    dev = shards.home
    l_final = min(count + t_total, n_win)
    last = n_win + t_total - 1
    fidx = torch.clamp(n_win + t_total - l_final + torch.arange(n_win, device=dev), max=last)
    final = combined[fidx]
    final[l_final:] = 0.0
    new_state = ColorState(l_final, final.reshape(state.window.shape))
    return new_state, (outs if split else outs[0])
