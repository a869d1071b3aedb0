#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against their
plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it needs one;
without it, or without the port's package beside it, it exits non-zero and
prints no result). It builds the port's CUDA kernels from the sources in the
checkout, then:

  1. kernels: each stencil kernel (ops/hopper/stencils.py) against its plain
     PyTorch version on the card, at odd shapes and at every level shape of a
     2160x3840 levels=6 frame; times by CUDA events (kernel, plain version,
     one PyTorch library call where one computes the same function) and the
     bound from published H100 SXM peaks;
  2. tail kernels (ops/hopper/tail.py): each entry point against its plain
     version on standard-normal inputs at odd shapes and at every active
     level of the 4K frame, both preweighted and both rebuild arms, within
     the stated bars; times, bounds and shares at each active level;
  3. slice at 4K: 2160x3840, levels=6, phase mode, jnp tail, through
     MagnificationChain.process (HWC u8) and ClipProcessor.process_chunk on the
     same frames; outputs bit-equal, launch counts per frame as expected,
     frames magnified after the first; steady ms/frame, fps, peak memory and a
     profiler breakdown of device time;
  4. the same slice under every other tail configuration (LVMT_TAIL pallas,
     mxu, level; LVMT_PHASE_FUSED=1 alone and with pallas): launch counts per
     frame as expected, frames within 1 LSB of the jnp tail's, steady
     ms/frame, peak memory, device kernels per frame; for level also
     ClipProcessor against the chain and a profiler breakdown; then every
     configuration, jnp included, timed again in the reverse order;
  5. slice on the card against the CPU: 1080x1920, levels=6, >= 40 dB a
     frame, under the jnp and the level tails.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero.
"""

from __future__ import annotations

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
SEED = 20261016
REPLACES = {
    "conv9": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:287",
    "band5": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:482",
    "lp9_decimate": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:656",
    "lp9_inject": "live_video_magnification_tpu/ops/pallas/conv9_mxu.py:376",
}
SOURCE = "live_video_magnification_tpu_torch/ops/hopper/csrc/stencils.cu"
PER_FRAME = {"conv9": 10, "band5": 5, "lp9_decimate": 5, "lp9_inject": 5}  # levels=6
STENCIL_KERNELS = ("stencil9_kernel", "band5_kernel", "inject9_kernel")  # in the CUDA source

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
# planes read + written, each once (rebuild off: the prior pyramid and state are read)
TAIL_PLANES = {"riesz_phase_df2_fused": 18 + 15, "riesz_amplify_fused": 6 + 1,
               "riesz_amplify_mxu": 6 + 1, "riesz_level_mxu": 16 + 11}
# The reference suite's kernel-against-jnp bars (atol, rtol).
TAIL_BARS = {"riesz_phase_df2_fused": {"out": (1e-5, 1e-5)},
             "riesz_amplify_fused": {"out": (2e-4, 1e-4)},
             "riesz_amplify_mxu": {"out": (2e-4, 1e-4)},
             "riesz_level_mxu": {"out": (5e-4, 1e-3), "state": (1e-4, 1e-4)}}
# (LVMT_TAIL, LVMT_PHASE_FUSED) -> tail launches per frame at 4K levels=6
# (five active levels, all >= 16 px)
TAIL_CONFIGS = {
    ("jnp", False): {},
    ("pallas", False): {"riesz_amplify_fused": 5},
    ("mxu", False): {"riesz_amplify_mxu": 5},
    ("level", False): {"riesz_level_mxu": 5},
    ("jnp", True): {"riesz_phase_df2_fused": 5},
    ("pallas", True): {"riesz_phase_df2_fused": 5, "riesz_amplify_fused": 5},
}
# the configuration whose run supplies each tail kernel's launch count
TAIL_MAIN_PATH = {"riesz_phase_df2_fused": ("jnp", True), "riesz_amplify_fused": ("pallas", False),
                  "riesz_amplify_mxu": ("mxu", False), "riesz_level_mxu": ("level", False)}


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


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

    cases = {
        "conv9": [(lambda x: st.conv9(x, RIESZ_HIGHPASS_9x9),
                   lambda x: st.conv9_plain(x, RIESZ_HIGHPASS_9x9), s) for s in build_shapes],
        "band5": [(lambda x: st.band5(x, RIESZ_BAND_KERNEL),
                   lambda x: st.band5_plain(x, RIESZ_BAND_KERNEL), s) for s in build_shapes],
        "lp9_decimate": [(lambda x: st.lp9_decimate(x, LOWPASS_2X),
                          lambda x: st.lp9_decimate_plain(x, LOWPASS_2X), s)
                         for s in build_shapes],
        "lp9_inject": [(lambda x, o=o: st.lp9_inject(x, LOWPASS_2X, o),
                        lambda x, o=o: st.lp9_inject_plain(x, LOWPASS_2X, o), s)
                       for s, o in inject_pairs],
    }
    # The kernels keep every product and sum apart in the plain version's
    # order, so they should agree exactly; the stated tolerance leaves room
    # for nothing but a last-bit difference.
    tol_rel = 1e-6
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
                worst = max(worst, err)
        errs[name] = worst
        log(phase="kernel_check", kernel=name, shapes=len(runs), max_abs_err=worst,
            tolerance=f"{tol_rel} x max(1, max|plain|)")
    return errs


def time_phase(dev, st, sizes):
    """ms of kernel, plain version and library call at each level shape."""
    import torch
    from live_video_magnification_tpu_torch.ops.kernels import (
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
    lib = {
        "conv9": conv_module(RIESZ_HIGHPASS_9x9),
        "band5": conv_module(band_w, out=2),
        "lp9_decimate": conv_module(LOWPASS_2X, stride=2),
        "lp9_inject": None,  # no PyTorch call has reflect-101 on the injected array
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
        }
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
            rows.append(dict(kernel=name, level=lvl, shape=[h, w], ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
                             bound_share=max(bytes_ms, ops_ms) / ms,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             bytes=nbytes, operations=ops))
            log(phase="kernel_time", **rows[-1])
    return rows


@contextlib.contextmanager
def tail_env(tail: str, phase_fused: bool):
    """LVMT_TAIL / LVMT_PHASE_FUSED as the chain reads them, restored after."""
    saved = {k: os.environ.get(k) for k in ("LVMT_TAIL", "LVMT_PHASE_FUSED")}
    os.environ["LVMT_TAIL"] = tail
    os.environ["LVMT_PHASE_FUSED"] = "1" if phase_fused else "0"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def config_name(tail: str, phase_fused: bool) -> str:
    if not phase_fused:
        return tail
    return "phase_fused" if tail == "jnp" else f"phase_fused+{tail}"


def reset_counts(*modules) -> None:
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


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
    return errs


def tail_kernel_time(dev, tl, sizes):
    """ms of each tail entry point and of its plain version at every active
    4K level, with the bound from this run's shapes."""
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
            rows.append(dict(kernel=entry, level=lvl, shape=[h, w], ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                             bound_share=max(bytes_ms, ops_ms) / ms,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             bytes=nbytes, operations=ops))
            log(phase="tail_kernel_time", **rows[-1])
    return rows


def profile_chain(torch, chain, frames, cfg):
    """Device time by kernel over a few steady chain frames (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            chain.process(f, cfg)
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
    n = len(frames)
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
    launches = {k: v for m in modules for k, v in m.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    return torch.stack(outs).cpu().numpy(), step_s, launches, peak, chain


def slice_4k(torch, dev, st, tl, h=2160, w=3840, t=8):
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    levels = 6
    cfg = cfg_4k(levels)
    t0 = time.perf_counter()
    frames = moving_clip(t, h, w, seed=SEED)
    log(phase="slice_4k_frames", seconds=time.perf_counter() - t0, shape=list(frames.shape))

    with tail_env("jnp", False):
        chain_out, step_s, launches, peak, chain = run_chain(torch, dev, frames, cfg, (st, tl))
        expected = {k: v * t for k, v in PER_FRAME.items()}
        expected.update({k: 0 for k in tl.LAUNCHES})
        if launches != expected:
            raise AssertionError(f"4K chain launches {launches} != expected {expected}")
        launches = {k: launches[k] for k in PER_FRAME}
        if not np.array_equal(chain_out[0], frames[0]):
            raise AssertionError("4K frame 0 is not the passthrough of the input")
        moved = [int(np.count_nonzero(chain_out[i] != frames[i])) for i in range(1, t)]
        if min(moved) == 0:
            raise AssertionError(f"4K frames after the first left unchanged: {moved}")

        # the same frames through the clip processor, device-resident input
        proc = ClipProcessor(cfg, h, w, 3, device=dev)
        tchw = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(dev)
        reset_counts(st, tl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        processed, _ = proc.process_chunk(tchw)  # returns host arrays: synchronizes
        clip_s = time.perf_counter() - t0
        clip_launches = dict(st.LAUNCHES)
        if clip_launches != launches:
            raise AssertionError(f"4K clip launches {clip_launches} != expected {launches}")
        clip_out = processed.transpose(0, 2, 3, 1)
        if not np.array_equal(clip_out, chain_out):
            raise AssertionError("4K ClipProcessor output differs from the chain's")

        steady = step_s[2:]
        steady_ms = 1e3 * sum(steady) / len(steady)
        log(phase="slice_4k", card=torch.cuda.get_device_name(dev), shape=[h, w],
            levels=levels, frames=t,
            chain_step_ms=[1e3 * s for s in step_s], chain_steady_ms_per_frame=steady_ms,
            chain_steady_fps=1e3 / steady_ms, clip_ms_per_frame_with_readback=1e3 * clip_s / t,
            clip_fps=t / clip_s, peak_memory_bytes=peak, launches=launches,
            launches_per_frame={k: v // t for k, v in launches.items()},
            changed_pixels_after_frame0=moved, chain_equals_clip=True)

        # where the device time goes, over two steady frames of the chain
        prof = profile_chain(torch, chain, frames[:2], cfg)
        log(phase="profile_4k", card=torch.cuda.get_device_name(dev), **prof)
    return launches, frames, chain_out


def slice_4k_tails(torch, dev, st, tl, frames, jnp_out):
    """The 4K slice under every kernel-tail configuration, each against the
    jnp configuration's frames. Returns the launch counts of each run."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor

    t, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    cfg = cfg_4k()
    runs = {}
    for (tail, phase_fused), tail_per_frame in TAIL_CONFIGS.items():
        if (tail, phase_fused) == ("jnp", False):
            continue  # slice_4k's run
        name = config_name(tail, phase_fused)
        with tail_env(tail, phase_fused):
            out, step_s, launches, peak, chain = run_chain(torch, dev, frames, cfg, (st, tl))
            expected = {k: v * t for k, v in PER_FRAME.items()}
            expected.update({k: tail_per_frame.get(k, 0) * t for k in tl.LAUNCHES})
            if launches != expected:
                raise AssertionError(f"4K {name} launches {launches} != expected {expected}")
            lsb = [int(np.abs(out[i].astype(np.int16) - jnp_out[i].astype(np.int16)).max())
                   for i in range(t)]
            if max(lsb) > 1:
                raise AssertionError(f"4K {name}: frames off the jnp tail's by {lsb} LSB")
            kernels = device_kernels_per_frame(torch, chain, frames[2], cfg)
            extra = {}
            if tail == "level" and not phase_fused:
                proc = ClipProcessor(cfg, h, w, 3, device=dev)
                tchw = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
                processed, _ = proc.process_chunk(tchw.to(dev))
                if not np.array_equal(processed.transpose(0, 2, 3, 1), out):
                    raise AssertionError("4K level: ClipProcessor output differs from the chain's")
                extra["chain_equals_clip"] = True
                del proc, tchw, processed
            steady_ms = 1e3 * sum(step_s[2:]) / len(step_s[2:])
            runs[(tail, phase_fused)] = launches
            log(phase="slice_4k_tail", config=name, lvmt_tail=tail,
                lvmt_phase_fused=phase_fused, card=torch.cuda.get_device_name(dev),
                shape=[h, w], levels=6, frames=t, chain_step_ms=[1e3 * s for s in step_s],
                chain_steady_ms_per_frame=steady_ms, chain_steady_fps=1e3 / steady_ms,
                peak_memory_bytes=peak,
                launches_per_frame={k: v // t for k, v in launches.items() if v},
                device_kernels_per_frame=kernels, max_lsb_vs_jnp=lsb, **extra)
            if tail == "level" and not phase_fused:
                prof = profile_chain(torch, chain, frames[:2], cfg)
                log(phase="profile_4k_tail", config=name,
                    card=torch.cuda.get_device_name(dev), **prof)
            del chain, out  # nothing of this run stays alive into the next

    # The step is host-bound and its time drifts within a call, so every
    # configuration is timed a second time, in the reverse order.
    for tail, phase_fused in reversed(list(TAIL_CONFIGS)):
        with tail_env(tail, phase_fused):
            step_s, peak = run_chain(torch, dev, frames, cfg, (st, tl))[1:4:2]
        steady_ms = 1e3 * sum(step_s[2:]) / len(step_s[2:])
        log(phase="slice_4k_tail_repeat", config=config_name(tail, phase_fused),
            card=torch.cuda.get_device_name(dev), chain_step_ms=[1e3 * s for s in step_s],
            chain_steady_ms_per_frame=steady_ms, chain_steady_fps=1e3 / steady_ms,
            peak_memory_bytes=peak)
    return runs


def slice_card_vs_cpu(torch, dev, h=1080, w=1920, t=4, tail="jnp"):
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    levels = 6
    cfg = ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=50.0, co_wavelength=50.0,
        co_low=1.0, co_high=5.0, levels=levels, framerate=30.0))
    frames = moving_clip(t, h, w, seed=SEED + 2)
    dbs, lsbs = [], []
    t0 = time.perf_counter()
    with tail_env(tail, False):
        gpu, cpu = MagnificationChain(device=dev), MagnificationChain(device="cpu")
        for i, f in enumerate(frames):
            a = gpu.process(f, cfg)[0].cpu().numpy()
            b = cpu.process(f, cfg)[0].numpy()
            dbs.append(psnr_u8(a, b))
            lsbs.append(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()))
            if dbs[-1] < 40.0:
                raise AssertionError(f"1080p {tail} frame {i}: card vs CPU {dbs[-1]:.2f} dB < 40")
        if gpu._key.tail != tail:
            raise AssertionError(f"1080p chain ran tail {gpu._key.tail}, not {tail}")
    log(phase="slice_1080p_card_vs_cpu", tail=tail, card=torch.cuda.get_device_name(dev),
        shape=[h, w], levels=levels, frames=t, psnr_db=dbs, max_lsb=lsbs,
        seconds=time.perf_counter() - t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
    from live_video_magnification_tpu_torch.ops.hopper import tail as tl
    from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes

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
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in paths.values() for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log(phase="build", seconds=build_s, compiled_now=fresh, libraries=[p.name for p in paths.values()], ptxas=ptxas)

    sizes = riesz_level_sizes(2160, 3840, 6)
    errs = kernel_phase(dev, st, sizes)
    times = time_phase(dev, st, sizes)
    tail_errs = tail_kernel_check(dev, tl, sizes)
    tail_times = tail_kernel_time(dev, tl, sizes)
    launches, frames, jnp_out = slice_4k(torch, dev, st, tl)
    tail_runs = slice_4k_tails(torch, dev, st, tl, frames, jnp_out)
    del frames, jnp_out
    slice_card_vs_cpu(torch, dev)
    slice_card_vs_cpu(torch, dev, tail="level")

    kernels = []
    for k in PER_FRAME:
        top = next(r for r in times if r["kernel"] == k and r["level"] == 0)
        kernels.append(dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                            launches=launches[k], max_abs_err=errs[k], ms=top["ms"],
                            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                            bound_by=top["bound_by"], library_ms=top["library_ms"],
                            shape=top["shape"]))
    for k in TAIL_REPLACES:
        top = next(r for r in tail_times if r["kernel"] == k and r["level"] == 0)
        launched = tail_runs[TAIL_MAIN_PATH[k]][k]
        if launched == 0:
            raise AssertionError(f"{k} was not launched on its path")
        kernels.append(dict(name=k, route="cuda", source=TAIL_SOURCE, replaces=TAIL_REPLACES[k],
                            launches=launched,
                            path="LVMT_TAIL=" + TAIL_MAIN_PATH[k][0]
                            + (" LVMT_PHASE_FUSED=1" if TAIL_MAIN_PATH[k][1] else ""),
                            max_abs_err=tail_errs[k], ms=top["ms"], plain_ms=top["plain_ms"],
                            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                            library_ms=None, shape=top["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
