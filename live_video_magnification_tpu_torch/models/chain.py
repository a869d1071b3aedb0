"""The processing chain: preprocess -> grayscale -> magnification.

The counterpart of the reference package's ``models/chain.py``
(ChainBuilder.cpp:11-29). One step per structural configuration computes both
the "original" tap (after the geometry, before magnification) and the
processed frame; live use (``MagnificationChain``) and clip processing
(``export/batch.py``) call the same step; ``parallel_clip_fn`` gives a
mode's time-parallel whole-clip form, which ``export/batch.py`` runs after
the same stateless stages.

This module owns how a step runs: its kernel flags come from
``models/riesz.py::KernelFlags`` into the static key, and the step carries
its mode's ``steady`` rule, the frames a ``StepGraph`` may replay (phase
and Laplace past the first frame; never colour or the identity). A caller
decides only where a graph may run at all.

Host side: structural tracking and temporal-state reset, level clamping to
calculateMaxLevels (MagnificationProcessor.cpp:31-34), the Butterworth
coefficients with the cutoff-change reset and the NaN-degenerate re-init of
phase mode (MagnifyCore.hpp:226-254). Device side: every per-pixel stage, in
planar [C, H, W] uint8/f32.

Modes: LAPLACE (motion), COLOR, PHASE and the identity (NONE, too-small
frames, phase on gray). Their per-frame parameters are host values taken as
f32, so a step reads nothing back from the card.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.convert import tree_leaves, tree_unflatten
from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.models import color as color_mode
from live_video_magnification_tpu_torch.models import motion as motion_mode
from live_video_magnification_tpu_torch.models import riesz as riesz_mode
from live_video_magnification_tpu_torch.models.params import (
    MagnificationMode,
    PreprocessParams,
    ProcessorConfig,
)
from live_video_magnification_tpu_torch.models.structural import StructuralTracker
from live_video_magnification_tpu_torch.ops.color import bgr_to_gray_u8
from live_video_magnification_tpu_torch.ops.pyramid import calculate_max_levels
from live_video_magnification_tpu_torch.ops.resize import resize_area
from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs


def preprocess_geometry(p: PreprocessParams, h: int, w: int) -> Tuple[int, int, int, int, int, int]:
    """Static crop rect + output size per PreprocessProcessor.cpp:14-43.

    Returns (y, x, ch, cw, oh, ow): crop offset/size and post-downscale size.
    """
    divisor = min(max(p.downscale, 1), 8)
    x, y, cw, ch = 0, 0, w, h
    if p.roi_enabled:
        x = int(round(float(p.roi_x) * w))
        y = int(round(float(p.roi_y) * h))
        rw = int(round(float(p.roi_w) * w))
        rh = int(round(float(p.roi_h) * h))
        x = min(max(x, 0), w - 1)
        y = min(max(y, 0), h - 1)
        cw = min(max(rw, 1), w - x)
        ch = min(max(rh, 1), h - y)
    if divisor > 1:
        ow = max(1, cw // divisor)
        oh = max(1, ch // divisor)
    else:
        oh, ow = ch, cw
    return y, x, ch, cw, oh, ow


_FLAGS = riesz_mode.KernelFlags()  # the defaults


class _StaticKey(NamedTuple):
    mode: MagnificationMode
    levels: int          # clamped
    channels: int        # channels entering magnification (after grayscale)
    in_channels: int
    h: int               # source frame h/w
    w: int
    grayscale: bool
    geometry: Tuple[int, int, int, int, int, int]
    framerate: float
    # The kernel flags (models/riesz.py::KernelFlags, with its defaults),
    # read from the environment once per frame into the key, so changing a
    # flag builds a new step (and a new state: pyr_io is the carried
    # pyramid's dtype) instead of reusing a stale one. Full value strings, as
    # the reference's key.
    phase_fused: bool = _FLAGS.phase_fused
    tail: str = _FLAGS.tail
    build: str = _FLAGS.build
    mxu_dtype: str = _FLAGS.mxu_dtype
    pyr_io: str = _FLAGS.pyr_io
    tail_io: str = _FLAGS.tail_io


class ChainStep(NamedTuple):
    """A chain step for one static key + its state constructor."""

    fn: Callable       # (state, frame_hwc_u8, dyn) -> (state, processed_hwc, original_hwc)
    raw_fn: Callable   # (state, frame_chw_u8, dyn) -> (state, processed_chw, original_chw)
    init_state: Callable  # () -> state
    key: _StaticKey
    # (count, dyn) -> whether a StepGraph may replay the frame (the mode's
    # ``steady``); None where none may. The caller holds ``dyn`` fixed.
    steady: Optional[Callable]


def _build_pre_stages(key: _StaticKey):
    """The stateless stages (crop/downscale + grayscale) for a key, on
    [..., C, H, W] u8 (one frame, or a chunk of them). The crop and
    downscale halves are separate so the HWC entry point can crop before the
    planar transpose."""
    y0, x0, ch_crop, cw_crop, oh, ow = key.geometry

    def downscale(frame_u8):
        if (oh, ow) != (ch_crop, cw_crop):
            # INTER_AREA on u8 computed in f32 and rounded (OpenCV's fixed
            # point differs at half-ULP ties only).
            area = resize_area(frame_u8.to(torch.float32), (oh, ow))
            return torch.clamp(torch.round(area), 0, 255).to(torch.uint8)
        return frame_u8

    def preprocess(frame_u8):
        out = frame_u8
        if (y0, x0, ch_crop, cw_crop) != (0, 0, key.h, key.w):
            out = out[..., y0 : y0 + ch_crop, x0 : x0 + cw_crop]
        return downscale(out)

    def gray_stage(frame_u8):
        if key.grayscale and key.in_channels >= 3:
            return bgr_to_gray_u8(frame_u8)
        return frame_u8

    return preprocess, downscale, gray_stage


def _build_step(key: _StaticKey, device: torch.device) -> ChainStep:
    y0, x0, ch_crop, cw_crop, oh, ow = key.geometry
    mode, levels = key.mode, key.levels
    preprocess, downscale, gray_stage = _build_pre_stages(key)

    steady = None
    if mode is MagnificationMode.LAPLACE:
        steady = motion_mode.steady

        def model_step(state, frame, dyn):
            return motion_mode.step(state, frame, dyn, levels=levels)

        def init():
            return motion_mode.init_state(oh, ow, key.channels, levels, device=device)
    elif mode is MagnificationMode.COLOR:
        def model_step(state, frame, dyn):
            return color_mode.step(state, frame, dyn, levels=levels, framerate=key.framerate)

        def init():
            return color_mode.init_state(oh, ow, key.channels, levels, key.framerate,
                                         device=device)
    elif mode is MagnificationMode.PHASE and key.channels >= 3:
        steady = riesz_mode.steady
        flags = {f: getattr(key, f) for f in riesz_mode.KernelFlags._fields}

        def model_step(state, frame, dyn):
            return riesz_mode.step(state, frame, dyn, levels=levels, **flags)

        def init():
            return riesz_mode.init_state(oh, ow, levels, device=device, pyr_io=key.pyr_io)
    else:  # NONE, too-small frames (levels < 1), or phase on gray: identity
        model_step = None

        def init():
            return torch.zeros((), dtype=torch.int32, device=device)

    def _core(state, pre, dyn):
        magin = gray_stage(pre)
        if model_step is None:
            return state, magin, pre
        new_state, out = model_step(state, magin.contiguous(), dyn)
        return new_state, out, pre

    def step(state, frame_u8, dyn):
        return _core(state, preprocess(frame_u8), dyn)

    def step_hwc(state, frame_hwc_u8, dyn):
        """The same step with HWC u8 I/O; the ROI crop happens in HWC layout
        so only the ROI is made planar."""
        crop = frame_hwc_u8
        if (y0, x0, ch_crop, cw_crop) != (0, 0, key.h, key.w):
            crop = crop[y0 : y0 + ch_crop, x0 : x0 + cw_crop]
        pre = downscale(crop.permute(2, 0, 1))
        new_state, out, original = _core(state, pre, dyn)
        return new_state, out.permute(1, 2, 0), original.permute(1, 2, 0)

    return ChainStep(step_hwc, step, init, key, steady)


def _tensors(state) -> List[torch.Tensor]:
    return [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]


class StepGraph:
    """A step (``raw_fn``) captured as a CUDA graph from ``state``, ``frame``
    and ``dyn``, and called as ``raw_fn`` is, less ``dyn``, for the frames
    that its ``ChainStep.steady`` admits.

    The graph reads the carried state from static buffers (``state``, with
    the host-int ``count``; a state that is not theirs, as a checkpoint's, is
    copied into them before a replay) and the frame from a static [C, H, W]
    u8 one, and ends by copying each new state leaf into its buffer (a leaf
    that passes its input through, as motion's residual, is that buffer
    already). ``dyn`` is baked in. The capture runs nothing; a warm-up call
    on a side stream before it sets up what the step sets up on its first
    call, as ``torch.cuda.graphs`` requires."""

    def __init__(self, raw_fn, state, frame: torch.Tensor, dyn):
        device = frame.device
        self.state = tree_unflatten(state, [x.clone() if isinstance(x, torch.Tensor) else x
                                            for x in tree_leaves(state)])
        self._leaves = _tensors(self.state)
        self._frame = frame.clone()
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                raw_fn(self.state, self._frame, dyn)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                new, self._out, self._orig = raw_fn(self.state, self._frame, dyn)
                # one multi-tensor copy: a graph runs each copy_'s memcpy
                # node as a kernel of its own, 68 a 4K phase frame
                pairs = [(d, s) for d, s in zip(self._leaves, _tensors(new)) if s is not d]
                torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])

    def __call__(self, state, frame: torch.Tensor):
        """(state, processed, original) of ``frame``, as ``raw_fn`` gives them:
        the state is the static buffers', the panes are new tensors (the
        processed pane a copy out of the graph's pool, which the next replay
        overwrites; the original ``frame`` itself where the step passes its
        input through)."""
        with torch.cuda.device(frame.device):
            held = _tensors(state)
            if any(a is not b for a, b in zip(held, self._leaves)):
                torch._foreach_copy_(self._leaves, held)
            self._frame.copy_(frame)
            self.graph.replay()
            out = self._out.clone()
            orig = frame if self._orig is self._frame else self._orig.clone()
        return self.state._replace(count=state.count + 1), out, orig


def parallel_clip_fn(key: _StaticKey) -> Optional[Callable]:
    """The mode's time-parallel whole-clip function for a static key, or None
    for the identity path (NONE, too-small frames, phase on gray):
    fn(frames_tchw_u8, dyn, state=state) -> (state, outs), or with
    ``shards=`` (``parallel/time_shard.py::TimeShards``) over one chunk for
    each time shard this process holds. Phase takes only ``levels``, as the
    reference's: its time-parallel path is f32 whatever the kernel flags."""
    if key.mode is MagnificationMode.LAPLACE:
        return functools.partial(motion_mode.process_clip_parallel, levels=key.levels)
    if key.mode is MagnificationMode.COLOR:
        return functools.partial(color_mode.process_clip_parallel, levels=key.levels,
                                 framerate=key.framerate)
    if key.mode is MagnificationMode.PHASE and key.channels >= 3:
        return functools.partial(riesz_mode.process_clip_parallel, levels=key.levels)
    return None


def _f32(v: float) -> float:
    return float(np.float32(v))


class MagnificationChain:
    """Host-side stateful wrapper: the reference's [Preprocess, Grayscale,
    Magnification] chain with its StructuralTracker and per-mode temporal
    state. ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tracker = StructuralTracker()
        self._steps: dict = {}
        self._state = None
        self._key: Optional[_StaticKey] = None
        # phase-mode host-side filter bookkeeping
        self._riesz_cutoffs: Optional[Tuple[float, float, float]] = None
        self._riesz_coeffs = None

    def reset(self) -> None:
        """Drop all temporal state (IProcessor::reset crash-recovery semantics)."""
        self._tracker.reset()
        self._state = None
        self._key = None
        self._riesz_cutoffs = None
        self._riesz_coeffs = None

    def _dyn_params(self, cfg: ProcessorConfig, key: _StaticKey):
        """Per-frame parameters; phase mode tracks its cutoffs here. A cutoff
        change recomputes the coefficients and sets ``reset_filters``
        (MagnifyCore.hpp:243-254); NaN coefficients set ``force_init``
        (:226). The identity path takes no parameters (None)."""
        p = cfg.magnification
        if key.mode is MagnificationMode.LAPLACE:
            return motion_mode.MotionDynParams(
                _f32(p.amplification), _f32(p.co_wavelength), _f32(p.co_low),
                _f32(p.co_high), _f32(p.chrom_attenuation))
        if key.mode is MagnificationMode.COLOR:
            return color_mode.ColorDynParams(
                _f32(p.amplification), _f32(p.co_low), _f32(p.co_high))
        if not (key.mode is MagnificationMode.PHASE and key.channels >= 3):
            return None
        cutoffs = (p.co_low, p.co_high, p.framerate)
        reset_filters = self._riesz_cutoffs is not None and cutoffs != self._riesz_cutoffs
        if self._riesz_cutoffs is None or reset_filters:
            self._riesz_coeffs = (
                butterworth_bandpass_coeffs(p.co_low, p.framerate),
                butterworth_bandpass_coeffs(p.co_high, p.framerate),
            )
            self._riesz_cutoffs = cutoffs
        (b_lo, a_lo), (b_hi, a_hi) = self._riesz_coeffs
        force_init = bool(np.isnan(a_lo[0]) or np.isnan(a_hi[0]))
        c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
        return riesz_mode.RieszDynParams(
            _f32(p.amplification),
            _f32(p.co_wavelength * math.pi / 100.0),
            c3(b_lo), c3(a_lo), c3(b_hi), c3(a_hi),
            reset_filters,
            force_init,
        )

    def static_key(self, cfg: ProcessorConfig, h: int, w: int, channels: int) -> _StaticKey:
        geometry = preprocess_geometry(cfg.preprocess, h, w)
        oh, ow = geometry[4], geometry[5]
        mag_channels = 1 if (cfg.grayscale and channels >= 3) else channels
        mode = cfg.magnification.mode
        max_levels = calculate_max_levels((oh, ow))
        if mode is not MagnificationMode.NONE and max_levels < 1:
            mode = MagnificationMode.NONE  # too small to magnify -> identity
        levels = min(max(cfg.magnification.levels, 1), max(max_levels, 1))
        return _StaticKey(
            mode, levels, mag_channels, channels, h, w, bool(cfg.grayscale), geometry,
            float(cfg.magnification.framerate), **riesz_mode.env_flags()._asdict(),
        )

    def process(self, frame_u8_hwc, cfg: ProcessorConfig):
        """Run the chain once. frame_u8_hwc: [H, W, C] or [H, W] uint8 (numpy
        or torch), the decode layout.

        Returns (processed_u8, original_u8) tensors on the chain's device,
        both [H', W', C']."""
        frame = torch.as_tensor(frame_u8_hwc)
        if frame.ndim == 2:
            frame = frame[..., None]
        h, w, c = frame.shape
        key = self.static_key(cfg, h, w, c)

        if key not in self._steps:
            self._steps[key] = _build_step(key, self.device)
        step = self._steps[key]

        structural = self._tracker.update(
            cfg, key.levels, key.channels, (key.geometry[4], key.geometry[5])
        ) or key != self._key
        if structural or self._state is None:
            self._state = step.init_state()
            self._key = key
            self._riesz_cutoffs = None
            self._riesz_coeffs = None

        dyn = self._dyn_params(cfg, key)
        self._state, processed, original = step.fn(
            self._state, frame.to(self.device), dyn
        )
        return processed, original
