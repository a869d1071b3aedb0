"""The row-sharded steps: motion, colour and phase with the frame's H axis
split over the 'tile' mesh axis.

The port's form of the reference package's GSPMD path
(``parallel/sharding.py``): its motion and colour steps, and its phase step
for widths that do not lane-shard. The reference annotates shardings and
lets XLA's SPMD partitioner place halo collective-permutes around its
stencils and all-reduces around its global min and max. PyTorch has no such
partitioner, so this module writes the row decomposition out, as
``riesz_sharded.py`` writes the column one:

  * every stencil runs on a haloed row strip (``parallel/halo.py::
    halo_exchange_rows``: the neighbours' rows at interior boundaries,
    reflect-101 at the global top and bottom, symmetric at the bottom for
    an upsample) and the valid interior is cropped: the op's own border
    handling then only touches discarded rows, and every kept value is the
    same sequence of f32 roundings as on the whole level;
  * colour's two global reductions (the min and max of the active window,
    and of the output) are per-shard values combined on the tile row's
    first device: min and max are exact, so the result is the whole
    frame's;
  * element-wise work stays on the shard.

The plan (``make_row_plan``) is the lane plan's rule on H. A level whose
rows do not split into even strips (odd strips at the last level) at least
2*halo + 2 rows high, and every level after it, is gathered onto the tile
row's first device and computed whole; the collapse hands each shard its
strip of the first sharded level. A plan with no sharded level is the
unsharded step on the first device, which is how the reference's GSPMD path
takes a frame no split fits.

Phase runs the lane-sharded step's local step (``riesz_sharded.
_riesz_step_local``) with row ops: the f32 stencil kernels K1–K4 on the
strips of the sharded levels and the plain tail, which is what the
reference's fallback computes (``riesz_mode.step(use_pallas=False)``); K5
builds a gathered level of 16–95 px, as the unsharded step does. The row
exchanges are copies, so K10 never runs here. Motion and colour are plain
PyTorch, as their unsharded steps.

One host thread issues every shard's work, batch elements one after
another, as in the lane-sharded step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import ClassVar, List, Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.models import color as color_mode
from live_video_magnification_tpu_torch.models import motion as motion_mode
from live_video_magnification_tpu_torch.models import riesz as riesz_mode
from live_video_magnification_tpu_torch.models.params import MagnificationMode
from live_video_magnification_tpu_torch.ops.color import (
    bgr_to_lab,
    lab_to_bgr,
    to_u8,
    u8_to_unit_f32,
)
from live_video_magnification_tpu_torch.ops.pyramid import (
    pyr_down,
    pyr_up,
    reconstruct_from_gauss_level,
)
from live_video_magnification_tpu_torch.ops.resize import resize_linear
from live_video_magnification_tpu_torch.ops.riesz import fused_level, riesz_level_sizes
from live_video_magnification_tpu_torch.ops.temporal import (
    ideal_bandpass_apply,
    iir_filter,
    minmax_scale,
)
from live_video_magnification_tpu_torch.parallel.halo import halo_exchange_rows
from live_video_magnification_tpu_torch.parallel.mesh import Mesh
from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
    _BAND_HALO,
    _BLUR_HALO,
    Shards,
    _Ops,
    _Row,
    _riesz_step_local,
    _unzip,
    place_row,
    state_levels,
    tile_rows,
)

_PYR_HALO = 2  # pyrDown's 5-tap reach
_UP_HALO = 1   # pyrUp reads one row of the small image on each side


# --------------------------------------------------------------------------- plan


@dataclasses.dataclass(frozen=True)
class RowShardPlan:
    """Per-level H-axis sharding decisions for an n-way 'tile' mesh axis;
    ``sizes`` from the frame (level 0) down, each ceil-halved. Unsharded
    levels live on the tile row's first device."""

    axis: ClassVar[int] = -2
    gather_to_first: ClassVar[bool] = True

    n: int
    levels: int
    sizes: Tuple[Tuple[int, int], ...]   # full (h, w) per level
    sharded: Tuple[bool, ...]            # prefix-monotone


def make_row_plan(h: int, w: int, levels: int, n: int, halo: int = _BLUR_HALO,
                  last_halo: int = _BAND_HALO) -> RowShardPlan:
    """H-axis plan over ``levels`` pyramid levels (the frame first): a level
    is sharded while its rows divide by n into strips of at least 2*halo + 2
    rows (2*last_halo + 2 at the last level), even ones but at the last
    level, so that each strip starts on an even global row and a decimation
    keeps the unsharded sites. The defaults are the phase step's reaches
    (the 13x13 blur, the band pair); a mesh of 1 shards nothing."""
    sizes = tuple(tuple(s) for s in riesz_level_sizes(h, w, levels))
    flags: List[bool] = []
    ok = n > 1
    for l, (lh, _) in enumerate(sizes):
        last = l == levels - 1
        local = lh // n
        ok = (ok and lh % n == 0 and local >= 2 * (last_halo if last else halo) + 2
              and (last or local % 2 == 0))
        flags.append(ok)
    return RowShardPlan(n, levels, sizes, tuple(flags))


def mode_row_plan(mode: MagnificationMode, h: int, w: int, levels: int, n: int) -> RowShardPlan:
    """The row plan of a mode's step: phase over its ``levels`` Riesz levels;
    motion over the levels+1 of its Laplace pyramid and colour over the
    frame and its ``levels`` pyrDowns, with pyrDown's and pyrUp's reaches."""
    if mode is MagnificationMode.PHASE:
        return make_row_plan(h, w, levels, n)
    if mode in (MagnificationMode.LAPLACE, MagnificationMode.COLOR):
        return make_row_plan(h, w, levels + 1, n, _PYR_HALO, _UP_HALO)
    raise ValueError(f"no sharded step for mode {mode}")


def state_layout(mode: MagnificationMode, plan: RowShardPlan):
    """The mode's state tree with each leaf's plan level (-1 for the count)."""
    if mode is MagnificationMode.PHASE:
        return state_levels(plan.levels)
    if mode is MagnificationMode.LAPLACE:
        levels = tuple(range(plan.levels))
        return motion_mode.MotionState(-1, levels, levels)
    if mode is MagnificationMode.COLOR:
        return color_mode.ColorState(-1, plan.levels - 1)
    raise ValueError(f"no sharded step for mode {mode}")


def row_stencil_launches(plan: RowShardPlan) -> dict:
    """Stencil launches of one phase frame of one batch element on a row
    plan, by entry point of ops/hopper/stencils.py: per band level the build
    (K5 where the level's short side is 16 to 95, else conv9, band5 and
    lp9_decimate), on every shard where the level is sharded and once
    where it is not; band5 per shard of a sharded last level (the plain
    ops where it is not); in the collapse, conv9 on every shard of a
    sharded level, and lp9_inject on every shard where the coarser level
    is sharded too, once where it is not; the plain tail's three blur13 a
    band level, on every shard where it is sharded and once where it is not.
    No tail kernel and no K10."""
    want = {"conv9": 0, "band5": 0, "lp9_decimate": 0, "lp9_inject": 0,
            "riesz_build_level": 0, "blur13": 0}
    last = plan.levels - 1
    on = lambda l: plan.n if plan.sharded[l] else 1
    for l in range(last):
        if fused_level(min(plan.sizes[l])):
            want["riesz_build_level"] += on(l)
        else:
            for k in ("conv9", "band5", "lp9_decimate"):
                want[k] += on(l)
        want["lp9_inject"] += on(l + 1)
        want["conv9"] += on(l)
        want["blur13"] += 3 * on(l)
    if plan.sharded[last]:
        want["band5"] += plan.n
    return want


# --------------------------------------------------------------------------- row ops


class _RowOps(_Ops):
    """The lane-sharded step's level ops on rows: every exchange a row copy
    (``bottom_mode`` for the lane's ``right_mode``), K5 chosen by the level
    as the unsharded build chooses, and the plain tail (the reference's
    fallback runs its step with use_pallas=False)."""

    axis = -2
    fused_by_level = True

    def __init__(self):
        super().__init__(tail="jnp")

    def exchange(self, shards: Sequence[torch.Tensor], halo: int,
                 right_mode: str = "reflect") -> Shards:
        return halo_exchange_rows(shards, halo, bottom_mode=right_mode, dim=-2)


def _down(row: _Row, x: Shards, sharded: bool, sharded_next: bool) -> Shards:
    """pyr_down of a level: on strips haloed by 2 rows where it is sharded
    (gathered onto the first device where the next level is not), whole
    otherwise. A strip starts on an even row, so strip row 2 (global row s)
    lands at decimated row 1."""
    if not sharded:
        return row.once(pyr_down, x)
    rows = x[0].shape[-2] // 2
    out = [pyr_down(xh).narrow(-2, 1, rows).contiguous()
           for xh in halo_exchange_rows(x, _PYR_HALO, dim=-2)]
    return out if sharded_next else row.gather(out)


def _up(row: _Row, x: Shards, sharded: bool, sharded_fine: bool, fine_hw) -> Shards:
    """pyr_up of a level to the finer level's (h, w). Where the small level
    is sharded, on strips haloed by one row (pyr_up pads its top reflect-101
    and its bottom symmetric, so the global bottom takes a symmetric halo)
    upsampled exactly 2x, cropping 2 rows each side; where it is not, whole
    on the first device, and then each shard's strip where the finer level
    is sharded."""
    if sharded:
        return [pyr_up(xh, (2 * xh.shape[-2], fine_hw[1])).narrow(-2, 2, 2 * x[0].shape[-2])
                .contiguous()
                for xh in halo_exchange_rows(x, _UP_HALO, bottom_mode="symmetric", dim=-2)]
    full = row.once(lambda s: pyr_up(s, tuple(fine_hw)), x)
    return row.scatter(full) if sharded_fine else full


def _bounds(row: _Row, sharded: bool, xs: Shards) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(min, max) over the whole level, per shard on its device: the
    shards' own min and max combined on the first device (the reference's
    all-reduces), exact whatever the split."""
    if not sharded:
        return row.once(lambda x: (x.min(), x.max()), xs)
    home = row.devices[0]
    mn = torch.stack([x.min().to(home) for x in xs]).min()
    mx = torch.stack([x.max().to(home) for x in xs]).max()
    return [(mn.to(d), mx.to(d)) for d in row.devices]


# --------------------------------------------------------------------------- the local steps


def _motion_step_local(states: Sequence[motion_mode.MotionState], frames_u8: Shards,
                       dyn: motion_mode.MotionDynParams, *, plan: RowShardPlan, row: _Row,
                       h: int, w: int) -> Tuple[List[motion_mode.MotionState], Shards]:
    """One motion step (models/motion.py::step) on the row strips of one
    tile row. The ladder's wavelength is the whole frame's, from (h, w)."""
    sh, levels = plan.sharded, plan.levels - 1
    color = frames_u8[0].shape[0] >= 3
    inp = row.on(sh[0])(lambda f: bgr_to_lab(u8_to_unit_f32(f)) if color
                        else u8_to_unit_f32(f), frames_u8)

    # Laplacian pyramid (SpatialFilter.cpp:25-38)
    pyr, cur = [], inp
    for l in range(levels):
        down = _down(row, cur, sh[l], sh[l + 1])
        pyr.append(row.on(sh[l])(torch.sub, cur, _up(row, down, sh[l + 1], sh[l], plan.sizes[l])))
        cur = down
    pyr.append(cur)

    first = states[0].count == 0
    lp_hi = pyr if first else [[s.lowpass_hi[l] for s in states] for l in range(levels + 1)]
    lp_lo = pyr if first else [[s.lowpass_lo[l] for s in states] for l in range(levels + 1)]
    motion, new_hi, new_lo = [], [], []
    for l in range(levels):
        dst, nh, nl = _unzip(row.on(sh[l])(
            lambda p, a, b: iir_filter(p, a, b, dyn.co_low, dyn.co_high), pyr[l], lp_hi[l],
            lp_lo[l]))
        motion.append(dst)
        new_hi.append(nh)
        new_lo.append(nl)
    motion.append(pyr[levels])
    new_hi.append(lp_hi[levels])
    new_lo.append(lp_lo[levels])

    gains = motion_mode.ladder_gains(dyn, h, w, levels)
    amplified = [row.on(sh[l])(lambda m, g=g: m * (0.0 if g is None else g), motion[l])
                 for l, g in enumerate(gains)]
    cur = amplified[levels]
    for l in range(levels - 1, -1, -1):  # collapse (SpatialFilter.cpp:52-61)
        cur = row.on(sh[l])(torch.add, _up(row, cur, sh[l + 1], sh[l], plan.sizes[l]),
                            amplified[l])

    chroma = float(np.float32(dyn.chrom_attenuation))

    def finish(m, x):
        if color:
            m = torch.cat([m[:1], m[1:] * chroma])
        output = x + m
        return to_u8(lab_to_bgr(output) if color else output, 255.0, 1.0 / 255.0)

    outs = row.on(sh[0])(finish, cur, inp)
    new_states = [motion_mode.MotionState(states[k].count + 1,
                                          tuple(x[k] for x in new_hi),
                                          tuple(x[k] for x in new_lo))
                  for k in range(len(states))]
    return new_states, outs


def _reconstruct(row: _Row, plan: RowShardPlan, small: Shards, hw) -> Shards:
    """reconstruct_from_gauss_level on the row strips: where the window's
    level is sharded, every level is, the strips are exact halves and 2^L
    times a small strip's rows is a frame strip's, so the pyrUps run on
    haloed strips and the resize keeps the rows (an identity in H, as on
    the whole frame). Otherwise whole on the first device, then each
    shard's strip where the frame is sharded."""
    levels = plan.levels - 1
    if not plan.sharded[levels]:
        full = row.once(lambda s: reconstruct_from_gauss_level(s, levels, tuple(hw)), small)
        return row.scatter(full) if plan.sharded[0] else full
    cur = small
    for _ in range(levels):
        rows = cur[0].shape[-2]
        cur = [pyr_up(xh).narrow(-2, 2, 2 * rows).contiguous()
               for xh in halo_exchange_rows(cur, _UP_HALO, bottom_mode="symmetric", dim=-2)]
    return [resize_linear(x, (x.shape[-2], hw[1])) for x in cur]


def _color_step_local(states: Sequence[color_mode.ColorState], frames_u8: Shards,
                      dyn: color_mode.ColorDynParams, *, plan: RowShardPlan, row: _Row,
                      h: int, w: int, framerate: float
                      ) -> Tuple[List[color_mode.ColorState], Shards]:
    """One colour step (models/color.py::step) on the row strips of one tile
    row: the window holds each shard's rows of the smallest level where
    that level is sharded; the normalize and the output rescale use the
    min and max over all shards; the warm-up passes the frame through."""
    sh, levels = plan.sharded, plan.levels - 1
    inp = row.on(sh[0])(lambda f: f.to(torch.float32), frames_u8)
    small = inp
    for l in range(levels):
        small = _down(row, small, sh[l], sh[l + 1])

    count = states[0].count
    w_static = states[0].window.shape[0]

    def push(window, s):  # img2tempMat (SpatialFilter.cpp:63-84)
        if count >= w_static:
            return torch.cat([window[1:], s[None]])
        window = window.clone()
        window[count] = s
        return window

    on_window = row.on(sh[levels])
    windows = on_window(push, [s.window for s in states], small)
    length = min(count + 1, w_static)
    new_states = [color_mode.ColorState(length, x) for x in windows]
    if length < 2:  # warm-up: the raw frame passes through (MagnifyCore.hpp:180)
        return new_states, list(frames_u8)

    filtered = on_window(lambda x: ideal_bandpass_apply(x.reshape(w_static, -1), length,
                                                        dyn.co_low, dyn.co_high, framerate),
                         windows)
    bounds = _bounds(row, sh[levels], [f[:length] for f in filtered])
    amp = float(np.float32(dyn.amplification))
    pick = min(1, length - 1)  # the reconstructed row (MagnifyCore.hpp:186-192)
    rows = on_window(lambda f, b, s: ((f[pick] - b[0]) * minmax_scale(*b) * amp).reshape(s.shape),
                     filtered, bounds, small)
    output = row.on(sh[0])(torch.add, inp, _reconstruct(row, plan, rows, (h, w)))
    return new_states, row.on(sh[0])(lambda o, b: color_mode.rescale_u8(o, *b), output,
                                      _bounds(row, sh[0], output))


# --------------------------------------------------------------------------- layout + step


def build_row_sharded_step(mesh: Mesh, mode: MagnificationMode, batch: int, h: int, w: int,
                           levels: int, framerate: float = 30.0, channels: int = 3):
    """(step, initial state) of the row-sharded step of ``mode``.

    step(state, frames_u8 [B,C,H,W], dyn) -> (state, outs [B,C,H,W]) with the
    frames gathered on the mesh's first device. B shards over 'batch' in
    contiguous blocks, H over 'tile'. The state is, per batch element, the
    tuple of its tile row's per-shard mode states (sharded levels as the
    shard's rows, the others whole on the row's first device). Phase takes
    three channels; motion takes ``channels`` (1 is gray); colour
    ``framerate``. Frames, dyn and the state's values are the unsharded
    step's, whose state a ``place_row`` of it is."""
    n = mesh.shape["tile"]
    rows = tile_rows(mesh, batch)
    plan = mode_row_plan(mode, h, w, levels, n)
    if mode is MagnificationMode.PHASE:
        channels = 3
        local_step = partial(_riesz_step_local, ops=_RowOps())
        init = lambda d: riesz_mode.init_state(h, w, levels, device=d)
    elif mode is MagnificationMode.LAPLACE:
        local_step = partial(_motion_step_local, h=h, w=w)
        init = lambda d: motion_mode.init_state(h, w, channels, levels, device=d)
    else:
        local_step = partial(_color_step_local, h=h, w=w, framerate=framerate)
        init = lambda d: color_mode.init_state(h, w, channels, levels, framerate, device=d)
    row_objs = [_Row(r, plan) for r in rows]
    first_device = mesh.devices.flat[0]
    hl = h // n

    def step(state, frames_u8: torch.Tensor, dyn):
        if tuple(frames_u8.shape) != (batch, channels, h, w) or frames_u8.dtype != torch.uint8:
            raise ValueError(f"expected uint8 frames of shape {(batch, channels, h, w)}, got "
                             f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
        new_state, outs = [], []
        for b, row in enumerate(row_objs):
            f = frames_u8[b]
            if plan.sharded[0]:
                local = [f.narrow(-2, k * hl, hl).contiguous().to(d)
                         for k, d in enumerate(row.devices)]
            else:
                local = row.once(f.to, row.devices)
            st, out = local_step(state[b], local, dyn, plan=plan, row=row)
            new_state.append(tuple(st))
            outs.append(torch.cat([o.to(first_device) for o in out], dim=-2) if plan.sharded[0]
                        else out[0].to(first_device))
        return tuple(new_state), torch.stack(outs)

    layout = state_layout(mode, plan)
    return step, tuple(place_row(layout, init(r[0]), r, plan) for r in rows)
