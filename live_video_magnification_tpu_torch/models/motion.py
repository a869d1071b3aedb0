"""Motion (Laplace) magnification: Laplacian pyramid + temporal IIR bandpass.

The counterpart of the reference package's ``models/motion.py``
(MagnifyCore.hpp:83-160):

  u8 -> f32/255 -> BGR->Lab (colour input) -> Laplacian pyramid (levels+1) ->
  per-level IIR bandpass against the carried EMA state -> spatial-wavelength
  amplification ladder (level 0 and the residual zeroed) -> collapse ->
  chroma attenuation -> out = input + motion -> Lab->BGR -> u8 (x255 + 1/255).

On the first frame the EMA state is seeded with the frame's own pyramid, so
the bandpass is exactly zero and the output equals the input
(MagnifyCore.hpp:98-103). ``count`` is a host int, so that seeding is a
Python branch and costs no device-to-host sync. The per-frame parameters are
host values taken as f32, and the ladder's gains are computed from them on
the host in f32, as the reference computes them on its f32 scalars. ``step``
is functional: it returns a new state and leaves the given one untouched.
``process_clip_parallel`` is the time-parallel form of a clip: the EMAs as
associative scans over the time axis, with the same carried state.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.ops.color import (
    bgr_to_lab,
    lab_to_bgr,
    to_u8,
    u8_to_unit_f32,
)
from live_video_magnification_tpu_torch.ops.pyramid import (
    build_laplace_pyr,
    collapse_laplace_pyr,
    pyramid_sizes,
)
from live_video_magnification_tpu_torch.ops.temporal import (
    associative_scan,
    ema_carry,
    iir_filter,
)
from live_video_magnification_tpu_torch.parallel.time_shard import TimeShards, fold_carries


class MotionDynParams(NamedTuple):
    """Per-frame parameters, host values already rounded to f32."""

    amplification: float      # alpha
    co_wavelength: float      # lambda_c analogue
    co_low: float             # IIR blend coefficient [0,1]
    co_high: float
    chrom_attenuation: float


class MotionState(NamedTuple):
    count: int                          # frames seen
    lowpass_hi: Tuple[torch.Tensor, ...]  # per level (levels+1), [C,h,w] f32
    lowpass_lo: Tuple[torch.Tensor, ...]


def init_state(h: int, w: int, channels: int, levels: int, device=None) -> MotionState:
    """Zero state for (h, w) frames of ``channels``. ``device`` defaults to
    CUDA and raises without a card; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    sizes = [(h, w)] + pyramid_sizes(h, w, levels)
    z = lambda lh, lw: torch.zeros((channels, lh, lw), dtype=torch.float32, device=dev)
    return MotionState(0, tuple(z(*s) for s in sizes), tuple(z(*s) for s in sizes))


def ladder_gains(dyn: MotionDynParams, h: int, w: int, levels: int) -> List[Optional[float]]:
    """Per level, the amplification ladder's gain (MagnifyCore.hpp:114-134),
    None where the level is zeroed (the residual and the finest level).

    The representative wavelength sqrt(w^2+h^2)/3 halves per level from the
    residual down; gain = min(alpha, (lambda/(8*delta) - 1)*2) with
    delta = lambda_c/(8*(1+alpha)), all in f32 as the reference's scalars."""
    alpha = np.float32(dyn.amplification)
    gains: List[Optional[float]] = [None] * (levels + 1)
    lam = math.sqrt(float(w * w + h * h)) / 3.0
    with np.errstate(all="ignore"):  # lambda_c = 0 gives an infinite gain, as in f32
        delta = np.float32(dyn.co_wavelength) / (np.float32(8.0) * (np.float32(1.0) + alpha))
        for lvl in range(levels, -1, -1):
            if lvl not in (levels, 0):
                curr = (np.float32(lam) / (delta * np.float32(8.0)) - np.float32(1.0)) \
                    * np.float32(2.0)
                gains[lvl] = float(np.minimum(alpha, curr))
            lam /= 2.0
    return gains


def step(state: MotionState, frame_u8: torch.Tensor, dyn: MotionDynParams, *,
         levels: int) -> Tuple[MotionState, torch.Tensor]:
    """One frame [C, H, W] uint8 -> (new state, [C, H, W] uint8)."""
    channels, h, w = frame_u8.shape
    color = channels >= 3

    x = u8_to_unit_f32(frame_u8)
    inp = bgr_to_lab(x) if color else x
    pyr = build_laplace_pyr(inp, levels)

    first = state.count == 0
    lp_hi = pyr if first else state.lowpass_hi
    lp_lo = pyr if first else state.lowpass_lo

    motion, new_hi, new_lo = [], [], []
    for lvl in range(levels):
        dst, nh, nl = iir_filter(pyr[lvl], lp_hi[lvl], lp_lo[lvl], dyn.co_low, dyn.co_high)
        motion.append(dst)
        new_hi.append(nh)
        new_lo.append(nl)
    motion.append(pyr[levels])  # the residual; zeroed by the ladder
    new_hi.append(lp_hi[levels])
    new_lo.append(lp_lo[levels])

    gains = ladder_gains(dyn, h, w, levels)
    amplified = [m * (0.0 if g is None else g) for m, g in zip(motion, gains)]
    motion_img = collapse_laplace_pyr(amplified)

    if color:  # chroma attenuation of a and b; L is scaled by 1, which is exact
        motion_img = torch.cat([motion_img[:1],
                                motion_img[1:] * float(np.float32(dyn.chrom_attenuation))])

    output = inp + motion_img
    out_u8 = to_u8(lab_to_bgr(output) if color else output, 255.0, 1.0 / 255.0)
    return MotionState(state.count + 1, tuple(new_hi), tuple(new_lo)), out_u8


def steady(count: int, dyn: MotionDynParams) -> bool:
    """Whether ``step`` issues the ops of every other frame this admits, so a
    graph may replay it: past the first frame, the step's one host branch."""
    return count > 0


def process_clip(frames_u8: torch.Tensor, dyn: MotionDynParams, *, levels: int,
                 state: Optional[MotionState] = None, device=None
                 ) -> Tuple[MotionState, torch.Tensor]:
    """[T, C, H, W] uint8 through ``step`` in order; returns (state, outs).
    Without ``state`` it starts from zero on ``device`` (CUDA by default)."""
    t, c, h, w = frames_u8.shape
    if state is None:
        state = init_state(h, w, c, levels, device=device)
    frames_u8 = frames_u8.to(state.lowpass_hi[0].device)
    outs = []
    for i in range(t):
        state, out = step(state, frames_u8[i], dyn, levels=levels)
        outs.append(out)
    return state, torch.stack(outs)


def _ema_combine(lhs, rhs):
    """(a1, b1) then (a2, b2) of l -> a*l + b: (a1*a2, a2*b1 + b2)."""
    (a1, b1), (a2, b2) = lhs, rhs
    return a1 * a2, a2 * b1 + b2


def process_clip_parallel(frames_u8, dyn: MotionDynParams, *, levels: int,
                          state: Optional[MotionState] = None, device=None, shards=None):
    """The time-parallel form of ``process_clip`` (the reference's
    ``models/motion.py::process_clip_parallel``): [T, C, H, W] uint8 in,
    (state, outs) out, the state laid out as ``step``'s.

    Each EMA l_t = (1-c) l_{t-1} + c x_t is an affine scan over the time axis
    in O(log T) depth. Its t = 0 element folds in the seed, the frame's own
    pyramid on the first frame of a clip and the carried EMA otherwise, with
    the arithmetic of ``step``. The residual's EMA slots are seeded on the
    first frame and then carried. Every other stage runs batched over T.

    ``shards`` (``parallel/time_shard.py::TimeShards``) splits the time axis:
    ``frames_u8`` is then a sequence of [T_k, C, H, W] chunks, one for each
    shard this process holds, on its device, and ``outs`` a list of the
    same. The seed is global shard 0's; a later shard scans each EMA from a
    zero state and takes what enters it, folded from the earlier shards'
    totals, as l_t = (1-c)^(t+1) carry + local_t (``ema_carry``)."""
    split = shards is not None
    if not split:
        t, c, h, w = frames_u8.shape
        if state is None:
            state = init_state(h, w, c, levels, device=device)
        shards = TimeShards.single(state.lowpass_hi[0].device)
        frames = [frames_u8.to(shards.home)]
    else:
        frames = list(frames_u8)
        c, h, w = frames[0].shape[1:]
        if state is None:
            state = init_state(h, w, c, levels, device=shards.home)
    color = c >= 3
    first = state.count == 0
    ids = [shards.index(j) for j in range(len(frames))]
    span = frames[0].shape[0]

    inputs, pyrs = [], []
    for f in frames:
        x = u8_to_unit_f32(f)
        inputs.append(bgr_to_lab(x) if color else x)
        pyrs.append(build_laplace_pyr(inputs[-1], levels))  # per level [T, C, h, w]
        del x

    co_low = np.float32(dyn.co_low)
    if co_low == 0.0:
        co_low = np.float32(0.01)

    def ema_scan(xs, cutoff, carry, k):
        t = xs.shape[0]
        keep, cut = float(np.float32(1.0) - cutoff), float(cutoff)
        a = torch.full((t,) + (1,) * (xs.ndim - 1), keep, dtype=xs.dtype, device=xs.device)
        if k > 0:  # from a zero state
            return associative_scan(_ema_combine, (a, cut * xs))[1]
        seed = xs[0] if first else carry
        b = torch.cat([(keep * seed + cut * xs[0])[None], cut * xs[1:]])
        a[0] = 1.0
        return associative_scan(_ema_combine, (a, b))[1]

    def ema(lvl, cutoff, carried):
        """Each shard's EMA of level ``lvl``, and the chunk's last."""
        keep = np.float32(1.0) - cutoff
        scans = [ema_scan(pyrs[j][lvl], cutoff, carried, k) for j, k in enumerate(ids)]
        ins, (fin,) = fold_carries(shards.gather([[s[-1]] for s in scans]),
                                   lambda local, s: (ema_carry(local[0], s[0], keep,
                                                               at=span - 1),))
        return [s if k == 0 else ema_carry(s, ins[k][0], keep)
                for s, k in zip(scans, ids)], fin.to(shards.home).clone()

    motion = [[] for _ in frames]
    new_hi, new_lo = [], []
    for lvl in range(levels):
        l_his, fin_hi = ema(lvl, np.float32(dyn.co_high), state.lowpass_hi[lvl])
        l_los, fin_lo = ema(lvl, co_low, state.lowpass_lo[lvl])
        for j in range(len(frames)):
            motion[j].append(l_his[j] - l_los[j])
        new_hi.append(fin_hi)
        new_lo.append(fin_lo)
        del l_his, l_los
    for j in range(len(frames)):
        motion[j].append(pyrs[j][levels])  # the residual, zeroed by the ladder
    if first:  # the residual's slots are seeded with global frame 0's
        seed = shards.gather([[p[levels][0]] for p in pyrs])[0][0].to(shards.home)
        new_hi.append(seed.clone())
        new_lo.append(seed.clone())
    else:
        new_hi.append(state.lowpass_hi[levels])
        new_lo.append(state.lowpass_lo[levels])
    del pyrs

    gains = ladder_gains(dyn, h, w, levels)
    outs = []
    for j in range(len(frames)):
        amplified = [m * (0.0 if g is None else g) for m, g in zip(motion[j], gains)]
        motion[j] = None
        motion_img = collapse_laplace_pyr(amplified)
        del amplified
        if color:  # chroma attenuation of a and b
            motion_img = torch.cat([motion_img[:, :1],
                                    motion_img[:, 1:] * float(np.float32(dyn.chrom_attenuation))],
                                   dim=1)
        output = inputs[j] + motion_img
        inputs[j] = None
        outs.append(to_u8(lab_to_bgr(output) if color else output, 255.0, 1.0 / 255.0))
        del motion_img, output
    new_state = MotionState(state.count + span * shards.count, tuple(new_hi), tuple(new_lo))
    return new_state, (outs if split else outs[0])
