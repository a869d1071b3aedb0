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
    minmax_normalize,
    optimal_buffer_size,
)


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
    channels, h, w = frame_u8.shape
    w_static = state.window.shape[0]

    inp = frame_u8.to(torch.float32)  # convertTo(CV_32F): stays in [0, 255]
    small = build_gauss_pyr(inp, levels)[levels - 1]

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

    # the reconstructed row is min(1, L-1): row 1 once warm (MagnifyCore.hpp:186-192)
    small_filtered = filtered[min(1, length - 1)].reshape(small.shape)
    output = inp + reconstruct_from_gauss_level(small_filtered, levels, (h, w))

    # rescale by the output's own min and max over all channels (MagnifyCore.hpp:199-203)
    omn, omx = output.min(), output.max()
    span = omx - omn
    out_u8 = to_u8(output, span.new_full((), 255.0) / span, -omn * 255.0 / span)
    return new_state, out_u8


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
