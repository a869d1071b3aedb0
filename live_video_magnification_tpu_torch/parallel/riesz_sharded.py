"""The lane-sharded phase step: the Riesz step with the frame's W axis split
over the 'tile' mesh axis.

The counterpart of the reference package's ``parallel/riesz_sharded.py``.
Every 9x9 / 1x5 / 13x13 stencil runs the port's kernels (ops/hopper/) on
halo-exchanged local strips, and everything element-wise stays local. W is
chosen over H because 4K's W = 3840 = 2^8*15 keeps every pyramid level
divisible across 8 devices while H = 2160 = 2^4*135 stops at level 1.

Halo trick: each kernel reflect-101-pads its input itself, so a local strip
exchanged by the kernel's reach (conv9: 4, band5: 2, blur13: 6, the small
image of an inject: 2) goes to the UNMODIFIED kernel and the valid interior
is sliced from its output: the kernel's own padding only touches the
discarded halo columns, and the global-edge shards get reflect-101 halos from
the exchange itself. Every kernel reads the same taps in the same order on a
strip as on the whole level, so the sharded frames equal the unsharded
step's bit for bit in f32.

The reference runs one program per device under shard_map, and its halo
exchanges and gathers are collectives. Here one process drives the shards
of a tile row in lock step: each stage runs for every shard, and each
exchange takes the whole list of shards. Shards may share a device (n
virtual shards on one card, or ``["cpu"] * n`` in the tests), or sit on n
cards. Batch elements are independent and run one after another. One host
thread issues every shard's launches, so the step's host time grows with
the number of shards wherever they sit: on the meshes measured so far it is
slower than the unsharded step (PERF.md, the 4K sharded cell).

Levels whose W does not divide the mesh (or whose local strip would be
thinner than the halo) are replicated: every device runs the whole (small)
level, once per distinct device, its result shared by that device's shards.
The gather at the sharded -> replicated boundary replaces the reference's
all_gather, and each shard slices its strip of the replicated upsample at
the collapse. The plan is prefix-monotone.

Reference numerics: RieszPyramid.cpp (build :215-238, collapse :304-325,
normalize/amplify :114-144), MagnifyCore.hpp:209-279 (step semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, List, Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.models.riesz import (
    RegPair,
    RieszDynParams,
    RieszState,
    env_flag,
    init_state,
    resolve_tail,
)
from live_video_magnification_tpu_torch.ops.color import (
    bgr_to_lab,
    lab_to_bgr,
    to_u8,
    u8_to_unit_f32,
)
from live_video_magnification_tpu_torch.ops.conv import correlate_cols, correlate_rows
from live_video_magnification_tpu_torch.ops.hopper import halo as kernel_halo
from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.hopper import tail as kernel_tails
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
)
from live_video_magnification_tpu_torch.ops.riesz import (
    MIN_FUSED_SIDE,
    MIN_MXU_SIDE,
    RieszLevel,
    amplify_level,
    amplitude_blur,
    normalize_phase,
    phase_difference_and_amplitude,
    riesz_level_sizes,
)
from live_video_magnification_tpu_torch.ops.temporal import CompExp, riesz_df2_step

from live_video_magnification_tpu_torch.parallel.mesh import Mesh

_BLUR_HALO = 6   # 13x13 Gaussian reach
_CONV9_HALO = 4
_BAND_HALO = 2

Shards = List[torch.Tensor]  # one tensor per shard of a tile row, in mesh order


# --------------------------------------------------------------------------- plan


@dataclasses.dataclass(frozen=True)
class RieszShardPlan:
    """Per-level W-axis sharding decisions for an n-way 'tile' mesh axis.
    ``axis``: the sharded dim of a plane; ``gather_to_first``: whether an
    unsharded level lives on the tile row's first device alone (False:
    once on every device of the row)."""

    axis: ClassVar[int] = -1
    gather_to_first: ClassVar[bool] = False

    n: int
    levels: int
    sizes: Tuple[Tuple[int, int], ...]   # full (h, w) per level
    sharded: Tuple[bool, ...]            # prefix-monotone

    @property
    def fully_sharded(self) -> bool:
        return all(self.sharded)


def make_plan(h: int, w: int, levels: int, n: int,
              force_sharded: bool = False) -> RieszShardPlan:
    """W-axis sharding plan. A mesh of 1 has no neighbours: every level is
    'replicated' (plain local compute through the same sharded step, no halo
    machinery), so the step degenerates to the unsharded kernels exactly.
    force_sharded=True keeps the halo path at n == 1."""
    sizes = tuple(tuple(s) for s in riesz_level_sizes(h, w, levels))
    if n == 1 and not force_sharded:
        return RieszShardPlan(n, levels, sizes, (False,) * levels)
    flags: List[bool] = []
    ok = True
    for l, (lh, lw) in enumerate(sizes):
        last = l == levels - 1
        if ok and lw % n == 0:
            local = lw // n
            if last:
                ok = local >= 2 * _BAND_HALO + 2          # band5 + inject-small halos
            else:
                ok = local % 2 == 0 and local >= 2 * _BLUR_HALO + 2
        else:
            ok = False
        flags.append(ok)
    return RieszShardPlan(n, levels, sizes, tuple(flags))


# --------------------------------------------------------------------------- kernel dispatch


class _Ops:
    """The tail and the halo exchange of the sharded step.

    Every exchange is K10 (ops/hopper/halo.py), whose wrapper runs its plain
    version on CPU tensors. ``tail``: the port's tail names; None reads the
    tail flag (``models/riesz.py::env_flag``) once, here, at build time;
    'level' (K9) has no sharded form and maps to 'mxu', the closest sharded
    analogue, as in the reference.
    ``band_parallel``: replicated levels' tails run on one owner device.
    The stencils dispatch on the tensor's device themselves.

    ``axis`` is the sharded dim of a plane (W here; the row-sharded step's
    ops, parallel/row_sharded.py, shard H with the same level ops), and
    ``fused_by_level`` whether a sharded level's build takes K5 by the
    level's shape (True) or by the haloed strip's (False, this step's rule)."""

    axis = -1
    fused_by_level = False

    def __init__(self, tail: str | None = None, band_parallel: bool = False):
        if tail is None:
            tail = env_flag("tail")
        self.tail = {"level": "mxu"}.get(resolve_tail(tail), tail)
        self.band_parallel = band_parallel

    def exchange(self, shards: Sequence[torch.Tensor], halo: int,
                 right_mode: str = "reflect") -> Shards:
        """[..., w_local] shards of one tile row -> [..., w_local + 2*halo]
        each: the neighbours' columns at interior boundaries, reflect-101 at
        the global edges (the pad the kernels would apply to the unsharded
        array). right_mode='symmetric' is the zero-injection quirk:
        reflect-101 of a 2x zero-injected array maps to reflect-101 (leading)
        / SYMMETRIC (trailing) padding of the small image."""
        return kernel_halo.halo_exchange_cols_rdma(shards, halo, right_mode)

    def take(self, x: torch.Tensor, start: int, length: int) -> torch.Tensor:
        """[start, start + length) of x's sharded dim, contiguous."""
        return x.narrow(self.axis, start, length).contiguous()

    def tail_kernel(self, h: int, w: int) -> Callable | None:
        """The amplify kernel of the tail on an [h, w] plane, or None for the
        plain tail: the kernels run where both sides are >= 16, as in the
        unsharded step."""
        if self.tail == "jnp" or min(h, w) < kernel_tails.MIN_SIDE:
            return None
        if self.tail == "mxu":
            return kernel_tails.riesz_amplify_mxu
        return kernel_tails.riesz_amplify_fused


def _fused_build_ok(h: int, w: int) -> bool:
    """The unsharded default build's rule: one pass (K5) where the short side
    is 16 to 95."""
    return MIN_FUSED_SIDE <= min(h, w) < MIN_MXU_SIDE


def _build_level(octave: torch.Tensor):
    """(hp, r, i, decimated octave) of a whole level, as the unsharded f32
    build computes it."""
    if _fused_build_ok(*octave.shape):
        return stencils.riesz_build_level(octave)
    hp = stencils.conv9(octave, RIESZ_HIGHPASS_9x9)
    r, i = stencils.band5(hp, RIESZ_BAND_KERNEL)
    return hp, r, i, stencils.lp9_decimate(octave, LOWPASS_2X)


# --------------------------------------------------------------------------- sharded level ops


def _sharded_build_level(ops: _Ops, octave: Shards):
    """Full build of one sharded level (hp, band pair, decimated lowpass) from
    ONE halo-6 exchange. Per shard (hp, r, i, sub).

    The exchanged strip covers global cols [s-6, s+wl+6). conv9 (reach 4) is
    then valid on [s-2, s+wl+2), exactly the 2-col apron band5 needs, and the
    even-site decimation (reach 4) is valid from decimated col 2 on, with
    global col s landing at decimated col 3 (strips start on even cols).
    Where a strip side is a global edge, its halo is dropped again: the
    unsharded band5 mirrors hp there, while the halo would give it conv9 of
    the mirrored octave, the same value summed in another order; without
    the halo each kernel mirrors at that edge as on the whole level. The
    strip takes K5 (one pass) where its short side (or the level's, under
    ``ops.fused_by_level``) is 16 to 95, conv9, band5 and lp9_decimate
    otherwise, as the unsharded build picks by the level; K5 equals the
    three bit for bit. Columns here are ``ops.axis`` (rows on a row plan)."""
    n, ax = len(octave), ops.axis
    wl = octave[0].shape[ax]
    level = list(octave[0].shape)
    level[ax] = n * wl
    out = []
    for k, xh in enumerate(ops.exchange(octave, _BLUR_HALO)):
        lo = _BLUR_HALO if k == 0 else 0
        hi = xh.shape[ax] - (_BLUR_HALO if k == n - 1 else 0)
        strip = ops.take(xh, lo, hi - lo)
        first = _BLUR_HALO - lo  # the strip column of the shard's first column
        if _fused_build_ok(*(level if ops.fused_by_level else strip.shape)):
            hp, r, i, sub = stencils.riesz_build_level(strip)
            start = first
        else:
            apron = max(first - _BAND_HALO, 0)
            hp = stencils.conv9(strip, RIESZ_HIGHPASS_9x9)
            hp = ops.take(hp, apron, min(first + wl + _BAND_HALO, hp.shape[ax]) - apron)
            r, i = stencils.band5(hp, RIESZ_BAND_KERNEL)
            sub = stencils.lp9_decimate(strip, LOWPASS_2X)
            start = first - apron
        # sub col j' <- strip col 2j'; the shard's first column is even
        out.append((*(ops.take(x, start, wl) for x in (hp, r, i)),
                    ops.take(sub, first // 2, wl // 2)))
    return out


def _sharded_conv9(ops: _Ops, x: Shards) -> Shards:
    wl = x[0].shape[ops.axis]
    return [ops.take(stencils.conv9(xh, RIESZ_HIGHPASS_9x9), _CONV9_HALO, wl)
            for xh in ops.exchange(x, _CONV9_HALO)]


def _sharded_band5(ops: _Ops, hp: Shards):
    wl = hp[0].shape[ops.axis]
    out = []
    for hph in ops.exchange(hp, _BAND_HALO):
        r, i = stencils.band5(hph, RIESZ_BAND_KERNEL)
        out.append((ops.take(r, _BAND_HALO, wl), ops.take(i, _BAND_HALO, wl)))
    return out


def _sharded_inject(ops: _Ops, small: Shards, out_local: Sequence[int]) -> Shards:
    """A 2-col small halo gives 4 injected halo columns, exactly conv9's
    reach. The trailing global edge pads SYMMETRIC (zero-injection quirk).
    ``out_local``: the (h, w) of one shard's strip of the finer level."""
    sw = small[0].shape[ops.axis]
    out = []
    for sm in ops.exchange(small, _BAND_HALO, right_mode="symmetric"):
        out_hw = list(out_local)
        out_hw[ops.axis] = 2 * sm.shape[ops.axis]
        out.append(ops.take(stencils.lp9_inject(sm, LOWPASS_2X, tuple(out_hw)),
                            2 * _BAND_HALO, 2 * sw))
    return out


def _sharded_tail(ops: _Ops, level: Sequence[RieszLevel], amplitude: Shards, wc: Shards,
                  ws: Shards, alpha: float, threshold: float) -> Shards:
    """normalize_phase + amplify_level on W shards: the three 13x13 blurs need
    a 6-col halo; everything else is element-wise. wc/ws are the raw (hi-lo)
    cos/sin difference. A tail kernel takes the six planes, stacked, from one
    exchange; the plain tail exchanges its three blur inputs one by one."""
    haloed = list(level[0].lowpass.shape)
    wl = haloed[ops.axis]
    haloed[ops.axis] += 2 * _BLUR_HALO
    kern = ops.tail_kernel(*haloed)
    if kern is not None:
        stacks = [torch.stack([a, c, s, lv.lowpass, lv.riesz.cos, lv.riesz.sin])
                  for a, c, s, lv in zip(amplitude, wc, ws, level)]
        return [ops.take(kern(*sh.unbind(0), alpha, threshold), _BLUR_HALO, wl)
                for sh in ops.exchange(stacks, _BLUR_HALO)]

    def blurred(planes: Shards) -> Shards:
        return [ops.take(amplitude_blur(x), _BLUR_HALO, wl)
                for x in ops.exchange(planes, _BLUR_HALO)]

    amp_blur = blurred(amplitude)
    nc = blurred([c * a for c, a in zip(wc, amplitude)])
    ns = blurred([s * a for s, a in zip(ws, amplitude)])
    return [amplify_level(lv, CompExp(c / ab, s / ab), alpha, threshold)
            for lv, c, s, ab in zip(level, nc, ns, amp_blur)]


# --------------------------------------------------------------------------- the local step


def _zeros_pair(c: CompExp) -> CompExp:
    return CompExp(torch.zeros_like(c.cos), torch.zeros_like(c.sin))


def _front(cur: RieszLevel, old: RieszLevel, acc: CompExp, lo: RegPair, hi: RegPair,
           rebuild: bool, dyn: RieszDynParams, compute_blur: bool):
    """Phase front and the two DF-II filters on the shared accumulator.
    Returns (phase result, lo result, hi result, acc', lo', hi')."""
    if rebuild:  # the filters restart from zero with the prior pyramid
        acc = _zeros_pair(acc)
        lo = RegPair(_zeros_pair(lo.reg0), _zeros_pair(lo.reg1))
        hi = RegPair(_zeros_pair(hi.reg0), _zeros_pair(hi.reg1))
    pr = phase_difference_and_amplitude(cur, old, compute_blur=compute_blur)
    lo_res, phase, lo_r0, lo_r1 = riesz_df2_step(acc, lo.reg0, lo.reg1, pr.phase_diff,
                                                 dyn.b_lo, dyn.a_lo)
    hi_res, _, hi_r0, hi_r1 = riesz_df2_step(acc, hi.reg0, hi.reg1, pr.phase_diff,
                                             dyn.b_hi, dyn.a_hi)
    return pr, lo_res, hi_res, phase, RegPair(lo_r0, lo_r1), RegPair(hi_r0, hi_r1)


def _replicated_tail(ops: _Ops, cur: RieszLevel, old: RieszLevel, acc, lo, hi,
                     rebuild: bool, dyn: RieszDynParams):
    """The whole-level tail, as the unsharded f32 step computes it: a tail
    kernel where both sides are >= 16, the plain tail below. Returns
    (amplified lowpass, acc', lo', hi')."""
    kern = ops.tail_kernel(*cur.lowpass.shape)
    pr, lo_res, hi_res, phase, lo2, hi2 = _front(cur, old, acc, lo, hi, rebuild, dyn,
                                                 compute_blur=kern is None)
    if kern is not None:
        change = hi_res - lo_res
        out = kern(pr.amplitude, change.cos, change.sin, cur.lowpass, cur.riesz.cos,
                   cur.riesz.sin, dyn.amplification, dyn.threshold)
    else:
        normalized = normalize_phase(hi_res, lo_res, pr.amplitude, pr.amplitude_blurred)
        out = amplify_level(cur, normalized, dyn.amplification, dyn.threshold)
    return out, phase, lo2, hi2


class _Row:
    """The devices of one tile row and the two ways a stage runs on them:
    ``each`` once per shard (sharded values), ``once`` once per home
    (unsharded values), shared by the shards of that home. A shard's home
    is the first shard on its device, or shard 0 for every shard under the
    plan's ``gather_to_first``; ``axis`` is the plan's sharded dim."""

    def __init__(self, devices: Sequence[torch.device], plan):
        self.devices = list(devices)
        self.axis = plan.axis
        first = {}
        self.home = [0 if plan.gather_to_first else first.setdefault(d, k)
                     for k, d in enumerate(self.devices)]
        self.homes = list(dict.fromkeys(self.home))

    def each(self, fn, *per_shard):
        return [fn(*args) for args in zip(*per_shard)]

    def once(self, fn, *per_shard):
        done = {h: fn(*(v[h] for v in per_shard)) for h in self.homes}
        return [done[h] for h in self.home]

    def on(self, sharded: bool):
        return self.each if sharded else self.once

    def gather(self, shards: Shards) -> Shards:
        """The full array, once per home (the reference's tiled all_gather)."""
        full = {h: torch.cat([s.to(self.devices[h]) for s in shards], dim=self.axis)
                for h in self.homes}
        return [full[h] for h in self.home]

    def scatter(self, full: Shards) -> Shards:
        """Each shard's strip of an unsharded array, on the shard's device."""
        n = len(self.devices)
        length = full[0].shape[self.axis] // n
        return [x.narrow(self.axis, k * length, length).contiguous().to(d)
                for k, (x, d) in enumerate(zip(full, self.devices))]

    def broadcast(self, value):
        """A value (a tree of tensors) on every home of the row."""
        done = {h: _tree_map(lambda x: x.to(self.devices[h]), value) for h in self.homes}
        return [done[h] for h in self.home]


def _tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (nested tuples and NamedTuples) and the
    matching leaves of the trees in ``rest``."""
    if isinstance(tree, tuple):
        mapped = [_tree_map(fn, *children) for children in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return fn(tree, *rest)


def _unzip(per_shard):
    """A list over shards of tuples -> a tuple of lists over shards."""
    return tuple(list(x) for x in zip(*per_shard))


def _riesz_step_local(
    states: Sequence[RieszState],
    frames_u8: Shards,   # [3, H, W_local] per shard, or the full frame on a replicated plan
    dyn: RieszDynParams,
    *,
    plan: RieszShardPlan,
    ops: _Ops,
    row: _Row,
) -> Tuple[List[RieszState], Shards]:
    """One phase-mode step on the W shards of one tile row, in lock step.
    Mirrors models/riesz.step (MagnifyCore.hpp:209-279) with plan-aware halo
    exchange / replication."""
    levels = plan.levels
    lab = row.on(plan.sharded[0])(lambda f: bgr_to_lab(u8_to_unit_f32(f)), frames_u8)

    # ---- build pyramid (RieszPyramid.cpp:215-238) ----
    cur: List[List[RieszLevel]] = []   # per level, per shard
    octave = [x[0] for x in lab]       # sharded iff plan.sharded[0]
    for l in range(levels - 1):
        if plan.sharded[l]:
            hp, r, i, sub = _unzip(_sharded_build_level(ops, octave))
            if not plan.sharded[l + 1]:
                sub = row.gather(sub)
        else:
            hp, r, i, sub = _unzip(row.once(_build_level, octave))
        cur.append([RieszLevel(a, CompExp(b, c)) for a, b, c in zip(hp, r, i)])
        octave = sub
    if plan.sharded[levels - 1]:
        r, i = _unzip(_sharded_band5(ops, octave))
    else:
        r, i = _unzip(row.once(lambda x: (correlate_rows(x, RIESZ_BAND_KERNEL),
                                          correlate_cols(x, RIESZ_BAND_KERNEL)), octave))
    cur.append([RieszLevel(a, CompExp(b, c)) for a, b, c in zip(octave, r, i)])

    # ---- temporal state plumbing (MagnifyCore.hpp:226-254) ----
    first = states[0].count == 0
    rebuild = first or dyn.reset_filters or dyn.force_init
    olds = [cur[l] if rebuild else [s.old[l] for s in states] for l in range(levels)]

    new_acc, new_lo, new_hi, lowpasses = [], [], [], []
    for lvl in range(levels - 1):
        acc = [s.acc[lvl] for s in states]
        lo = [s.lo[lvl] for s in states]
        hi = [s.hi[lvl] for s in states]
        if not plan.sharded[lvl]:
            tail = lambda c, o, a, l_, h_: _replicated_tail(ops, c, o, a, l_, h_, rebuild, dyn)
            if ops.band_parallel and plan.n > 1:
                # band parallelism: this replicated level's whole tail runs only
                # on its owner shard's device; the result is copied to the
                # others (the reference's lax.cond on the owner + psum)
                owner = lvl % plan.n
                res = tail(cur[lvl][owner], olds[lvl][owner], acc[owner], lo[owner], hi[owner])
                res = row.broadcast(res)
            else:
                res = row.once(tail, cur[lvl], olds[lvl], acc, lo, hi)
            out, a2, l2, h2 = _unzip(res)
        else:
            fronts = row.each(
                lambda c, o, a, l_, h_: _front(c, o, a, l_, h_, rebuild, dyn, compute_blur=False),
                cur[lvl], olds[lvl], acc, lo, hi)
            pr, lo_res, hi_res, a2, l2, h2 = _unzip(fronts)
            change = [h_ - l_ for h_, l_ in zip(hi_res, lo_res)]
            out = _sharded_tail(ops, cur[lvl], [p.amplitude for p in pr],
                                [c.cos for c in change], [c.sin for c in change],
                                dyn.amplification, dyn.threshold)
        new_acc.append(a2)
        new_lo.append(l2)
        new_hi.append(h2)
        lowpasses.append(out)
    lowpasses.append([c.lowpass for c in cur[levels - 1]])  # untouched residual octave

    # ---- collapse (RieszPyramid.cpp:304-325) ----
    result = lowpasses[-1]
    for lvl in range(levels - 2, -1, -1):
        octave = lowpasses[lvl]
        if plan.sharded[lvl] and plan.sharded[lvl + 1]:
            lp = _sharded_inject(ops, result, octave[0].shape)
            hp = _sharded_conv9(ops, octave)
        elif plan.sharded[lvl]:
            # small is unsharded: each home computes the full (cheap)
            # upsample term once and each shard takes its own strip
            lp = row.scatter(row.once(
                lambda s: stencils.lp9_inject(s, LOWPASS_2X, plan.sizes[lvl]), result))
            hp = _sharded_conv9(ops, octave)
        else:
            lp = row.once(lambda s, o: stencils.lp9_inject(s, LOWPASS_2X, tuple(o.shape)),
                          result, octave)
            hp = row.once(lambda o: stencils.conv9(o, RIESZ_HIGHPASS_9x9), octave)
        result = [a + b for a, b in zip(lp, hp)]

    def finish(res, lab_k, frame):
        if first or dyn.force_init:  # passthrough (MagnifyCore.hpp:226-239)
            return frame.clone()
        merged = torch.stack([res, lab_k[1], lab_k[2]])
        return to_u8(lab_to_bgr(merged), 255.0, 1.0 / 255.0)

    outs = row.on(plan.sharded[0])(finish, result, lab, frames_u8)
    new_states = [
        RieszState(states[k].count + 1,
                   tuple(cur[l][k] for l in range(levels)),
                   tuple(a[k] for a in new_acc),
                   tuple(x[k] for x in new_lo),
                   tuple(x[k] for x in new_hi))
        for k in range(len(states))
    ]
    return new_states, outs


# --------------------------------------------------------------------------- layout + step


def state_levels(levels: int) -> RieszState:
    """A RieszState whose leaves are their pyramid level (the count: -1); a
    leaf is W-sharded iff ``plan.sharded[level]``. The counterpart of the
    reference's state_specs."""
    lv = lambda l: RieszLevel(l, CompExp(l, l))
    rp = lambda l: RegPair(CompExp(l, l), CompExp(l, l))
    active = range(levels - 1)
    return RieszState(-1, tuple(lv(l) for l in range(levels)),
                      tuple(CompExp(l, l) for l in active),
                      tuple(rp(l) for l in active), tuple(rp(l) for l in active))


def tile_rows(mesh: Mesh, batch: int) -> List[List[torch.device]]:
    """The devices of each batch element's tile row: B shards over 'batch'
    in contiguous blocks, W over 'tile'."""
    names = tuple(mesh.axis_names)
    if names not in (("batch", "tile"), ("tile",)):
        raise ValueError(f"mesh axes {names}: expected ('batch', 'tile') or ('tile',)")
    grid = mesh.devices.reshape(-1, mesh.shape["tile"])
    nb = grid.shape[0]
    if batch % nb:
        raise ValueError(f"batch {batch} not divisible by batch axis {nb}")
    per_row = batch // nb
    return [list(grid[b // per_row]) for b in range(batch)]


def place_row(layout, state, devices: Sequence[torch.device], plan) -> tuple:
    """One batch element's whole state as its tile row's per-shard states.

    ``layout`` is the mode's state tree with each leaf's pyramid level (-1
    for the count; ``state_levels`` for phase), ``state`` the element's
    state in the same tree, its planes tensors or numpy arrays. A sharded
    level's planes become each shard's strip along ``plan.axis``, on the
    shard's device; the others lie whole on each home's device (one copy a
    home, shared by its shards); the count becomes a host int."""
    row = _Row(devices, plan)
    homes = {}

    def place(k, level, x):
        if level < 0:
            return int(x)
        t = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
             ).to(torch.float32)
        if plan.sharded[level]:
            length = t.shape[plan.axis] // plan.n
            return t.narrow(plan.axis, k * length, length).to(devices[k], copy=True).contiguous()
        h = row.home[k]
        if (id(x), h) not in homes:
            homes[id(x), h] = t.to(devices[h], copy=True)
        return homes[id(x), h]

    return tuple(_tree_map(lambda l, x, k=k: place(k, l, x), layout, state)
                 for k in range(len(devices)))


def build_sharded_riesz_step(
    mesh: Mesh,
    batch: int,
    h: int,
    w: int,
    levels: int,
    repeat_steps: int = 0,
    tail: str | None = None,
    band_parallel: bool = False,
    force_sharded: bool = False,
):
    """(step, initial state) of the lane-sharded phase step.

    step(state, frames_u8 [B,3,H,W], dyn) -> (state, outs [B,3,H,W]) with the
    frames gathered on the mesh's first device. B shards over 'batch', W over
    'tile'. The state is, per batch element, the tuple of its tile row's
    per-shard RieszStates, each on its shard's device (replicated levels
    whole, sharded levels as the shard's strip). Requires
    make_plan(...).sharded[0] for a mesh wider than 1.

    f32 only: the bf16 flags of the unsharded step (mxu_dtype, pyr_io,
    tail_io) have no sharded form yet.

    repeat_steps > 0 is the benchmark form: one call runs that many steps
    over the frames, varied per step (frames + t % 3, so no step repeats the
    last), and returns (state, checksum): the int sum over all steps of
    out[:, :, ::64, ::64]."""
    n = mesh.shape["tile"]
    rows = tile_rows(mesh, batch)
    plan = make_plan(h, w, levels, n, force_sharded=force_sharded)
    if n > 1 and not plan.sharded[0]:
        raise ValueError(
            f"W={w} cannot be lane-sharded {n}-way at level 0; use "
            "parallel/sharding.py::build_sharded_step (the row-sharded step)")
    ops = _Ops(tail=tail, band_parallel=band_parallel)
    row_objs = [_Row(r, plan) for r in rows]
    first_device = mesh.devices.flat[0]
    wl = w // n

    def step(state, frames_u8: torch.Tensor, dyn: RieszDynParams):
        if tuple(frames_u8.shape) != (batch, 3, h, w) or frames_u8.dtype != torch.uint8:
            raise ValueError(f"expected uint8 frames of shape {(batch, 3, h, w)}, got "
                             f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
        new_state, outs = [], []
        for b, row in enumerate(row_objs):
            f = frames_u8[b]
            if plan.sharded[0]:
                local = [f.narrow(-1, k * wl, wl).contiguous().to(d)
                         for k, d in enumerate(row.devices)]
            else:
                local = row.once(f.to, row.devices)
            st, out = _riesz_step_local(state[b], local, dyn, plan=plan, ops=ops, row=row)
            new_state.append(tuple(st))
            full = (torch.cat([o.to(first_device) for o in out], dim=-1) if plan.sharded[0]
                    else out[0].to(first_device))
            outs.append(full)
        return tuple(new_state), torch.stack(outs)

    run = step
    if repeat_steps:
        def run(state, frames_u8, dyn):  # noqa: F811
            total = torch.zeros((), dtype=torch.int64, device=first_device)
            for t in range(repeat_steps):
                state, out = step(state, frames_u8 + (t % 3), dyn)
                total = total + out[:, :, ::64, ::64].to(torch.int32).sum()
            return state, total

    layout = state_levels(levels)
    state0 = tuple(place_row(layout, init_state(h, w, levels, device=r[0]), r, plan)
                   for r in rows)
    return run, state0
