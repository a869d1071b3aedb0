"""Phase (Riesz) magnification: Riesz pyramid + Butterworth phase bandpass.

The counterpart of the reference package's ``models/riesz.py``
(MagnifyCore.hpp:209-279):

  u8 -> f32/255 -> BGR->Lab, take L -> Riesz pyramid -> quaternionic phase
  difference against the prior frame's pyramid -> per-level lo/hi Butterworth
  DF-II on the accumulated phase -> amplitude-normalized phase change -> phase
  rotation of the band (truncated at the threshold) -> collapse -> merge L
  back into Lab -> BGR u8.

State is a NamedTuple of tensors laid out as the reference's, so checkpoints
and ``convert.py`` map leaf for leaf. Under ``pyr_io="bf16"`` the carried
prior pyramid's band levels are bfloat16, as the reference's; the residual
octave and every filter plane stay f32. ``count`` is a host int: the first-frame
test then costs no device-to-host sync. The per-frame flags are host bools,
so rebuilding the prior pyramid and zeroing the filters select tensors instead
of masking them. ``step`` is functional: it returns a new state and leaves the
given one untouched. ``process_clip_parallel`` is the time-parallel form of a
clip: the phase accumulation and both DF-II filters as one associative scan
over the time axis, with the same carried state.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.ops.color import (
    bgr_to_lab,
    lab_to_bgr,
    to_u8,
    u8_to_unit_f32,
)
from live_video_magnification_tpu_torch.ops.hopper import tail as kernel_tails
from live_video_magnification_tpu_torch.ops.hopper.stencils import resolve_dtype
from live_video_magnification_tpu_torch.ops.riesz import (
    MIN_MXU_SIDE,
    RieszLevel,
    _choice,
    amplify_level,
    amplitude_blur,
    build_riesz_pyramid,
    collapse_riesz_pyramid,
    level_f32,
    normalize_phase,
    phase_difference_and_amplitude,
    resolve_build,
    resolve_mxu_dtype,
    riesz_level_sizes,
)
from live_video_magnification_tpu_torch.ops.temporal import (
    CompExp,
    df2_dual_carry,
    df2_dual_carry_outputs,
    df2_dual_filter_parallel,
    riesz_df2_step,
)
from live_video_magnification_tpu_torch.parallel.time_shard import (
    TimeShards,
    fold_carries,
    last_frames,
)

Coeffs = Tuple[float, float, float]

# The per-level tails, named as the reference package's LVMT_TAIL values.
TAILS = ("jnp", "pallas", "mxu", "level")


class RieszDynParams(NamedTuple):
    """Per-frame parameters, host values already rounded to f32."""

    amplification: float
    threshold: float     # co_wavelength * pi / 100 (MagnifyCore.hpp:214,269)
    b_lo: Coeffs         # low-cutoff Butterworth numerator
    a_lo: Coeffs         # denominator (a[0] == 1)
    b_hi: Coeffs
    a_hi: Coeffs
    reset_filters: bool  # a cutoff changed this frame
    force_init: bool     # degenerate coefficients -> re-init + passthrough


class RegPair(NamedTuple):
    """DF-II register pair of one Butterworth filter (TemporalFilter.cpp:340-351)."""

    reg0: CompExp
    reg1: CompExp


class RieszState(NamedTuple):
    """Ten state planes per active level: the lo and hi filters accumulate the
    same phase difference and are reset together, so ``acc`` carries their
    shared accumulator once."""

    count: int
    old: Tuple[RieszLevel, ...]    # prior pyramid, all `levels` levels
    acc: Tuple[CompExp, ...]       # shared accumulated phase, per active level
    lo: Tuple[RegPair, ...]        # per active level (levels-1 entries)
    hi: Tuple[RegPair, ...]


def _zeros_like_pair(c: CompExp) -> CompExp:
    return CompExp(torch.zeros_like(c.cos), torch.zeros_like(c.sin))


def init_state(h: int, w: int, levels: int, device=None, pyr_io: str = "f32") -> RieszState:
    """Zero state for (h, w) frames. ``device`` defaults to CUDA and raises
    without a card; pass ``device="cpu"`` for the CPU. ``pyr_io`` is the
    dtype of the carried band levels ("f32" or "bf16")."""
    dev = resolve_device(device)
    band = resolve_dtype(pyr_io)
    sizes = riesz_level_sizes(h, w, levels)
    z = lambda lh, lw, dt=torch.float32: torch.zeros((lh, lw), dtype=dt, device=dev)
    old = tuple(
        RieszLevel(z(lh, lw, dt), CompExp(z(lh, lw, dt), z(lh, lw, dt)))
        for lvl, (lh, lw) in enumerate(sizes)
        for dt in [band if lvl < levels - 1 else torch.float32]
    )
    active = sizes[: levels - 1]
    acc = tuple(CompExp(z(lh, lw), z(lh, lw)) for lh, lw in active)
    regs = lambda: tuple(
        RegPair(CompExp(z(lh, lw), z(lh, lw)), CompExp(z(lh, lw), z(lh, lw)))
        for lh, lw in active
    )
    return RieszState(0, old, acc, regs(), regs())


def resolve_tail(tail: str) -> str:
    """``tail`` if it names one of TAILS; raises otherwise."""
    return _choice("tail", tail, TAILS)


class KernelFlags(NamedTuple):
    """``step``'s kernel flags at their defaults (the f32 path), one table:
    ``FLAG_ENV`` names the variable that sets each, as the reference package
    names it, and ``_FLAG_CHECK`` raises on a value the port does not
    implement. Callers read the environment through ``env_flags``."""

    phase_fused: bool = False  # K8 for the phase front and DF-II; on at "1"
    tail: str = "jnp"          # the per-level tail, one of TAILS
    build: str = "auto"        # the pyramid build, one of ops/riesz.py::BUILDS
    mxu_dtype: str = "f32"     # the operands of build and collapse, ops/riesz.py::MXU_DTYPES
    pyr_io: str = "f32"        # the pyramid planes' dtype, f32 or bf16 (resolve_dtype)
    tail_io: str = "f32"       # K6's amplitude and change planes' dtype


FLAG_ENV = KernelFlags("LVMT_PHASE_FUSED", "LVMT_TAIL", "LVMT_BUILD", "LVMT_MXU_DTYPE",
                       "LVMT_PYR_IO", "LVMT_TAIL_IO")
_FLAG_CHECK = KernelFlags(bool, resolve_tail, resolve_build, resolve_mxu_dtype, resolve_dtype,
                          resolve_dtype)


def resolve_flags(**flags) -> KernelFlags:
    """``flags`` over the defaults; raises on an unknown flag or value."""
    resolved = KernelFlags(**flags)
    for check, value in zip(_FLAG_CHECK, resolved):
        check(value)
    return resolved


def env_flag(name: str):
    """Flag ``name`` as the environment sets it; raises on an unknown value."""
    default = KernelFlags._field_defaults[name]
    value = os.environ.get(getattr(FLAG_ENV, name))
    if value is None:
        return default
    if isinstance(default, bool):
        return value == "1"
    getattr(_FLAG_CHECK, name)(value)
    return value


def env_flags() -> KernelFlags:
    """Every flag as the environment sets it (``env_flag``)."""
    return KernelFlags(*map(env_flag, KernelFlags._fields))


def _unflat(regs) -> RegPair:
    """(r0_c, r0_s, r1_c, r1_s) as a RegPair."""
    return RegPair(CompExp(regs[0], regs[1]), CompExp(regs[2], regs[3]))


def _flat(rp: RegPair) -> Tuple[torch.Tensor, ...]:
    return (rp.reg0.cos, rp.reg0.sin, rp.reg1.cos, rp.reg1.sin)


def blur_launches(h: int, w: int, levels: int, tail: str = "jnp",
                  phase_fused: bool = False) -> int:
    """blur13 launches (ops/hopper/stencils.py) of one ``step`` at (h, w):
    three a band level whose plain tail blurs (the amplitude and
    normalize_phase's two; phase_fused's plain branch the same three), none
    where a tail kernel blurs: a level of both sides >= kernel_tails.MIN_SIDE
    under pallas, mxu or level, or under phase_fused with pallas. Also one
    ``process_clip_parallel`` chunk's, which blurs its frames as one batch."""
    kernel_blurs = ("pallas",) if phase_fused else ("pallas", "mxu", "level")
    resolve_tail(tail)
    return sum(0 if min(s) >= kernel_tails.MIN_SIDE and tail in kernel_blurs else 3
               for s in riesz_level_sizes(h, w, levels)[:-1])


def step(state: RieszState, frame_u8: torch.Tensor, dyn: RieszDynParams, *,
         levels: int, **flags) -> Tuple[RieszState, torch.Tensor]:
    """One frame: [3, H, W] uint8 BGR in, (new state, [3, H, W] uint8) out.

    ``flags`` are fields of ``KernelFlags``, each at its default where not
    given; the four of ``--fast`` are mxu_dtype="bf16", tail="mxu",
    tail_io="bf16", pyr_io="bf16". ``tail`` and ``phase_fused`` select the
    per-level tail as the reference package's flags do. On every
    active level whose sides are both at least ``ops/hopper/tail.py::MIN_SIDE``
    (16), in the reference's order of precedence:

      1. phase_fused: K8 (riesz_phase_df2_fused), then K7 preweighted
         (riesz_amplify_fused) if tail == "pallas", else the plain blurs and
         amplify_level;
      2. tail == "level": K9 (riesz_level_mxu), the whole tail in one kernel;
      3. tail == "mxu": the plain front and DF-II, then K6 (riesz_amplify_mxu);
         with its fast arms (tail_io planes, pyr_io planes, bf16 operands
         under mxu_dtype == "bf16") only where the short side is at least
         MIN_MXU_SIDE, the levels the reference gives its kernel; below
         that K6's f32 arm on f32 copies, the function of the reference's
         plain tail there;
      4. tail == "pallas": the plain front and DF-II, then K7;
      5. tail == "jnp": the plain tail throughout.

    Smaller levels take the plain tail. bf16 pyramid planes reach the front,
    K7, K8 and K9 as f32 copies. On a CPU tensor every kernel entry point
    runs its plain version."""
    flags = resolve_flags(**flags)
    tail, phase_fused, mxu_dtype = flags.tail, flags.phase_fused, flags.mxu_dtype
    lab = bgr_to_lab(u8_to_unit_f32(frame_u8))
    cur = build_riesz_pyramid(lab[0], levels, build=flags.build, mxu_dtype=mxu_dtype,
                              pyr_io=flags.pyr_io)

    first = state.count == 0
    rebuild_old = first or dyn.reset_filters or dyn.force_init
    old = tuple(cur) if rebuild_old else state.old
    coeffs = (dyn.b_lo, dyn.a_lo, dyn.b_hi, dyn.a_hi)

    new_acc: List[CompExp] = []
    new_lo: List[RegPair] = []
    new_hi: List[RegPair] = []
    lowpasses: List[torch.Tensor] = []
    for lvl in range(levels - 1):
        stored = cur[lvl]
        c = level_f32(stored)
        kernel_tail = min(c.lowpass.shape) >= kernel_tails.MIN_SIDE
        acc, lo, hi = state.acc[lvl], state.lo[lvl], state.hi[lvl]
        if kernel_tail and (phase_fused or tail == "level"):
            # the kernels take the raw prior pyramid and state and apply the
            # rebuild selection themselves
            o = level_f32(state.old[lvl])
            raw = (c.lowpass, c.riesz.cos, c.riesz.sin, o.lowpass, o.riesz.cos, o.riesz.sin)
            if phase_fused:
                # the kernel's per-filter 6-plane layout; the shared acc is
                # fed to both filters, which accumulate it identically
                amplitude, wc, ws, lo6, hi6 = kernel_tails.riesz_phase_df2_fused(
                    *raw, (*acc, *_flat(lo)), (*acc, *_flat(hi)), *coeffs, rebuild_old)
                new_acc.append(CompExp(lo6[0], lo6[1]))
                new_lo.append(_unflat(lo6[2:]))
                new_hi.append(_unflat(hi6[2:]))
                if tail == "pallas":
                    lowpasses.append(kernel_tails.riesz_amplify_fused(
                        amplitude, wc, ws, c.lowpass, c.riesz.cos, c.riesz.sin,
                        dyn.amplification, dyn.threshold, preweighted=True))
                else:  # wc/ws carry the amplitude weight already
                    ab = amplitude_blur(amplitude)
                    normalized = CompExp(amplitude_blur(wc) / ab, amplitude_blur(ws) / ab)
                    lowpasses.append(amplify_level(c, normalized, dyn.amplification,
                                                   dyn.threshold))
            else:
                out, acc2, lo2, hi2 = kernel_tails.riesz_level_mxu(
                    *raw, acc, _flat(lo), _flat(hi), *coeffs, rebuild_old,
                    dyn.amplification, dyn.threshold)
                new_acc.append(CompExp(*acc2))
                new_lo.append(_unflat(lo2))
                new_hi.append(_unflat(hi2))
                lowpasses.append(out)
            continue

        if rebuild_old:  # the filters restart from zero with the prior pyramid
            acc = _zeros_like_pair(acc)
            lo = RegPair(_zeros_like_pair(lo.reg0), _zeros_like_pair(lo.reg1))
            hi = RegPair(_zeros_like_pair(hi.reg0), _zeros_like_pair(hi.reg1))
        amplify_kernel = None
        if kernel_tail and tail == "mxu":
            amplify_kernel = kernel_tails.riesz_amplify_mxu
        elif kernel_tail and tail == "pallas":
            amplify_kernel = kernel_tails.riesz_amplify_fused
        pr = phase_difference_and_amplitude(c, level_f32(old[lvl]),
                                            compute_blur=amplify_kernel is None)
        # both filters read the same shared accumulator
        lo_res, phase, lo_r0, lo_r1 = riesz_df2_step(
            acc, lo.reg0, lo.reg1, pr.phase_diff, dyn.b_lo, dyn.a_lo)
        hi_res, _, hi_r0, hi_r1 = riesz_df2_step(
            acc, hi.reg0, hi.reg1, pr.phase_diff, dyn.b_hi, dyn.a_hi)
        new_acc.append(phase)
        new_lo.append(RegPair(lo_r0, lo_r1))
        new_hi.append(RegPair(hi_r0, hi_r1))
        if amplify_kernel is not None:
            change = hi_res - lo_res
            planes = (pr.amplitude, change.cos, change.sin, c.lowpass, c.riesz.cos,
                      c.riesz.sin)
            fast = {}
            if tail == "mxu" and min(c.lowpass.shape) >= MIN_MXU_SIDE:
                tio = resolve_dtype(flags.tail_io)
                planes = (*(x.to(tio) for x in planes[:3]), stored.lowpass,
                          stored.riesz.cos, stored.riesz.sin)
                fast = {"bf16": mxu_dtype == "bf16"}
            lowpasses.append(amplify_kernel(*planes, dyn.amplification, dyn.threshold,
                                            **fast))
            continue
        normalized = normalize_phase(hi_res, lo_res, pr.amplitude, pr.amplitude_blurred)
        lowpasses.append(amplify_level(c, normalized, dyn.amplification, dyn.threshold))
    lowpasses.append(cur[levels - 1].lowpass)  # untouched residual octave

    magnified = collapse_riesz_pyramid(lowpasses, mxu_dtype=mxu_dtype)
    merged = torch.stack([magnified, lab[1], lab[2]])
    out_u8 = to_u8(lab_to_bgr(merged), 255.0, 1.0 / 255.0)

    # The first frame and degenerate-coefficient frames emit the raw input
    # unchanged (MagnifyCore.hpp:226-239).
    if first or dyn.force_init:
        out_u8 = frame_u8.clone()

    # "*st.old = *st.cur": the prior pyramid becomes this frame's, in the
    # carried state's dtypes (bf16 band levels under pyr_io).
    new_old = tuple(
        RieszLevel(n.lowpass.to(o.lowpass.dtype),
                   CompExp(n.riesz.cos.to(o.riesz.cos.dtype), n.riesz.sin.to(o.riesz.sin.dtype)))
        for n, o in zip(cur, state.old))
    new_state = RieszState(state.count + 1, new_old, tuple(new_acc),
                           tuple(new_lo), tuple(new_hi))
    return new_state, out_u8


def steady(count: int, dyn: RieszDynParams) -> bool:
    """Whether ``step`` issues the ops of every other frame this admits, so a
    graph may replay it: past the first frame, and no filter reset or re-init."""
    return count > 0 and not (dyn.reset_filters or dyn.force_init)


def process_clip(frames_u8: torch.Tensor, dyn: RieszDynParams, *, levels: int,
                 state: Optional[RieszState] = None, device=None, **flags
                 ) -> Tuple[RieszState, torch.Tensor]:
    """[T, 3, H, W] uint8 through ``step`` in order, under the given flags;
    returns (state, outs). Without ``state`` it starts from zero on
    ``device`` (CUDA by default), with ``pyr_io`` band levels."""
    t, _, h, w = frames_u8.shape
    if state is None:
        state = init_state(h, w, levels, device=device, pyr_io=resolve_flags(**flags).pyr_io)
    frames_u8 = frames_u8.to(state.old[0].lowpass.device)
    outs = []
    for i in range(t):
        state, out = step(state, frames_u8[i], dyn, levels=levels, **flags)
        outs.append(out)
    return state, torch.stack(outs)


def _batched_level(levels: List[RieszLevel]) -> RieszLevel:
    """One pyramid level of each frame, stacked over T."""
    return RieszLevel(torch.stack([p.lowpass for p in levels]),
                      CompExp(torch.stack([p.riesz.cos for p in levels]),
                              torch.stack([p.riesz.sin for p in levels])))


def process_clip_parallel(frames_u8, dyn: RieszDynParams, *, levels: int,
                          state: Optional[RieszState] = None, device=None, shards=None):
    """The time-parallel form of ``process_clip`` (the reference's
    ``models/riesz.py::process_clip_parallel``): [T, 3, H, W] uint8 in,
    (state, outs) out, the state laid out as ``step``'s.

    Lab runs batched over T, then the Riesz pyramid of each frame. The prior
    of frame t is frame t-1's pyramid; frame 0's is the carried one, or its
    own on the first frame of a clip. The phase difference, the normalize
    and the amplify run batched over T; the phase accumulation and both
    DF-II filters are one associative scan per component and level
    (``df2_dual_filter_parallel``), its inits zeroed on the first frame.
    Then the collapse of each frame and Lab -> BGR u8 batched.

    The path is the reference's f32 one whatever the chain's flags: the
    build and collapse at their f32 defaults (on a CUDA tensor, the stencil
    kernels, one [H, W] plane a launch, so T launches a stencil and level)
    and the plain tail. The cutoffs are the clip's: ``reset_filters`` is a
    streaming event and is not read; ``force_init`` passes every frame
    through, as the first frame of a clip is. The carried prior pyramid
    keeps the state's dtypes (bf16 band levels under ``pyr_io``).

    ``shards`` (``parallel/time_shard.py::TimeShards``) splits the time axis,
    as the reference's T-sharded call does: ``frames_u8`` is then a sequence
    of [T_k, 3, H, W] chunks, one for each shard this process holds, on its
    device, and ``outs`` a list of the same. The first-frame rules hold for
    global shard 0 alone; frame 0 of a later shard takes the last pyramid of
    the shard before it as its prior, and scans from a zero state that the
    fold of the shard totals then carries in (``df2_dual_carry``,
    ``df2_dual_carry_outputs``). Every process ends with the whole chunk's
    state on its first shard's device, where the carried state lies (global
    shard 0 is the first of its process).

    The stages open device spans of the port's recorder
    (``engine/profiling.py``; inert while it is off), each timed by CUDA
    events on the first shard's device and taking its id from the enclosing
    span (the clip export's ``export.step``: the chunk's cursor):
    ``phase_tp.build`` (Lab, the T pyramids batched by level, the one-frame
    halo), for each band level ``phase_tp.difference`` (the shifted priors,
    the phase difference and the amplitude blur), ``phase_tp.scan`` (both
    components' DF-II dual-filter scans and their carries) and
    ``phase_tp.amplify`` (normalize and amplify), then ``phase_tp.collapse``
    (the carried pyramid, the T collapses, Lab -> BGR u8, the passthrough
    rules)."""
    # imported here: importing the engine package imports the models
    from live_video_magnification_tpu_torch.engine.profiling import span

    split = shards is not None
    if not split:
        t, _, h, w = frames_u8.shape
        if state is None:
            state = init_state(h, w, levels, device=device)
        shards = TimeShards.single(state.old[0].lowpass.device)
        frames = [frames_u8.to(shards.home)]
    else:
        frames = list(frames_u8)
        h, w = frames[0].shape[2:]
        if state is None:
            state = init_state(h, w, levels, device=shards.home)
    first = state.count == 0
    ids = [shards.index(j) for j in range(len(frames))]
    coeffs = (dyn.b_lo, dyn.a_lo, dyn.b_hi, dyn.a_hi)
    per_shard = frames[0].shape[0]  # every shard holds as many frames
    dev = shards.home

    def init(x):  # the filters start from zero on the first frame
        return torch.zeros_like(x) if first else x

    labs, pyrs = [], []
    with span("phase_tp.build", device=dev):
        for f in frames:
            lab = bgr_to_lab(u8_to_unit_f32(f))  # [T, 3, H, W]
            per_frame = [build_riesz_pyramid(lab[i, 0], levels) for i in range(f.shape[0])]
            pyrs.append([_batched_level([p[lvl] for p in per_frame]) for lvl in range(levels)])
            labs.append(lab)
            del per_frame
        # the one-frame halo: each shard's last pyramid, for the next shard's
        # prior and (the last shard's) the new state's
        priors, last = last_frames(shards, [
            [x for p in pyr for x in (p.lowpass[-1], p.riesz.cos[-1], p.riesz.sin[-1])]
            for pyr in pyrs])

    new_acc: List[CompExp] = []
    new_lo: List[RegPair] = []
    new_hi: List[RegPair] = []
    lowpasses: List[List[torch.Tensor]] = [[] for _ in frames]
    for lvl in range(levels - 1):
        results = []
        with span("phase_tp.difference", device=dev):
            for j, k in enumerate(ids):
                cur = pyrs[j][lvl]
                # prior[t] = cur[t-1]; prior[0] = the carried pyramid, or cur[0]
                # on the first frame, or the last pyramid of the shard before
                if k > 0:
                    seed = RieszLevel(priors[j][3 * lvl],
                                      CompExp(*priors[j][3 * lvl + 1:3 * lvl + 3]))
                elif first:
                    seed = RieszLevel(cur.lowpass[0], CompExp(cur.riesz.cos[0], cur.riesz.sin[0]))
                else:
                    seed = level_f32(state.old[lvl])
                shift = lambda x, s: torch.cat([s[None], x[:-1]])
                prior = RieszLevel(shift(cur.lowpass, seed.lowpass),
                                   CompExp(shift(cur.riesz.cos, seed.riesz.cos),
                                           shift(cur.riesz.sin, seed.riesz.sin)))
                results.append(phase_difference_and_amplitude(cur, prior))
                del prior
        acc, lo, hi = state.acc[lvl], state.lo[lvl], state.hi[lvl]

        def dual(comp):  # one component at a time: the scan's planes are large
            sel = lambda ce: getattr(ce, comp)
            ys, finals = [], []
            for j, k in enumerate(ids):
                diff = getattr(results[j].phase_diff, comp)
                if k == 0:  # scans from the carried state
                    y_lo, y_hi, _, fin = df2_dual_filter_parallel(
                        diff, *coeffs, acc_init=init(sel(acc)),
                        lo_init=(init(sel(lo.reg0)), init(sel(lo.reg1))),
                        hi_init=(init(sel(hi.reg0)), init(sel(hi.reg1))))
                else:  # from a zero state; what enters it is carried in below
                    y_lo, y_hi, _, fin = df2_dual_filter_parallel(diff, *coeffs)
                ys.append((y_lo, y_hi))
                finals.append(list(fin))
            ins, fin = fold_carries(
                shards.gather(finals),
                lambda local, s: df2_dual_carry(local, s, *coeffs, at=per_shard - 1))
            for j, k in enumerate(ids):
                if k > 0:
                    ys[j] = df2_dual_carry_outputs(*ys[j], ins[k], *coeffs)
            return ys, tuple(v.to(shards.home) for v in fin)

        with span("phase_tp.scan", device=dev):
            (ys_c, fc), (ys_s, fs) = dual("cos"), dual("sin")
        new_acc.append(CompExp(fc[0], fs[0]))
        new_lo.append(RegPair(CompExp(fc[1], fs[1]), CompExp(fc[2], fs[2])))
        new_hi.append(RegPair(CompExp(fc[3], fs[3]), CompExp(fc[4], fs[4])))
        with span("phase_tp.amplify", device=dev):
            for j in range(len(frames)):
                (lo_c, hi_c), (lo_s, hi_s) = ys_c[j], ys_s[j]
                ys_c[j] = ys_s[j] = None
                pr = results[j]
                results[j] = None
                normalized = normalize_phase(CompExp(hi_c, hi_s), CompExp(lo_c, lo_s),
                                             pr.amplitude, pr.amplitude_blurred)
                del lo_c, hi_c, lo_s, hi_s, pr
                lowpasses[j].append(amplify_level(pyrs[j][lvl], normalized, dyn.amplification,
                                                  dyn.threshold))
                del normalized
    for j in range(len(frames)):
        lowpasses[j].append(pyrs[j][levels - 1].lowpass)  # untouched residual octave

    outs = []
    with span("phase_tp.collapse", device=dev):
        # "*st.old = *st.cur": the chunk's last pyramid, in the carried dtypes
        new_old = tuple(
            RieszLevel(last[3 * lvl].to(o.lowpass.dtype, copy=True),
                       CompExp(last[3 * lvl + 1].to(o.riesz.cos.dtype, copy=True),
                               last[3 * lvl + 2].to(o.riesz.sin.dtype, copy=True)))
            for lvl, o in enumerate(state.old))
        del pyrs, last, priors
        for j, k in enumerate(ids):
            t = frames[j].shape[0]
            magnified = torch.stack([collapse_riesz_pyramid([lp[i] for lp in lowpasses[j]])
                                     for i in range(t)])
            lowpasses[j] = None
            merged = torch.stack([magnified, labs[j][:, 1], labs[j][:, 2]], dim=1)
            labs[j] = None
            out = to_u8(lab_to_bgr(merged), 255.0, 1.0 / 255.0)
            del magnified, merged
            # the first frame of a clip, and every frame under degenerate
            # coefficients, pass the raw input through (MagnifyCore.hpp:226-239)
            if dyn.force_init:
                out = frames[j].clone()
            elif first and k == 0:
                out[0] = frames[j][0]
            outs.append(out)
    new_state = RieszState(state.count + per_shard * shards.count, new_old, tuple(new_acc),
                           tuple(new_lo), tuple(new_hi))
    return new_state, (outs if split else outs[0])
