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
  2. slice at 4K: 2160x3840, levels=6, phase mode, through
     MagnificationChain.process (HWC u8) and ClipProcessor.process_chunk on the
     same frames; outputs bit-equal, launch counts per frame as expected,
     frames magnified after the first; steady ms/frame, fps, peak memory and a
     profiler breakdown of device time;
  3. slice on the card against the CPU: 1080x1920, levels=6, >= 40 dB a frame.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero.
"""

from __future__ import annotations

import json
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


def slice_4k(torch, dev, st, h=2160, w=3840, t=8):
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    levels = 6
    cfg = ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=50.0, co_wavelength=50.0,
        co_low=1.0, co_high=5.0, levels=levels, framerate=30.0))
    t0 = time.perf_counter()
    frames = moving_clip(t, h, w, seed=SEED)
    log(phase="slice_4k_frames", seconds=time.perf_counter() - t0, shape=list(frames.shape))

    chain = MagnificationChain(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    outs, step_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        processed, _ = chain.process(f, cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        outs.append(processed)
    launches = dict(st.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {k: v * t for k, v in PER_FRAME.items()}
    if launches != expected:
        raise AssertionError(f"4K chain launches {launches} != expected {expected}")
    chain_out = torch.stack(outs).cpu().numpy()
    if not np.array_equal(chain_out[0], frames[0]):
        raise AssertionError("4K frame 0 is not the passthrough of the input")
    moved = [int(np.count_nonzero(chain_out[i] != frames[i])) for i in range(1, t)]
    if min(moved) == 0:
        raise AssertionError(f"4K frames after the first left unchanged: {moved}")

    # the same frames through the clip processor, device-resident input
    proc = ClipProcessor(cfg, h, w, 3, device=dev)
    tchw = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(dev)
    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    processed, _ = proc.process_chunk(tchw)  # returns host arrays: synchronizes
    clip_s = time.perf_counter() - t0
    clip_launches = dict(st.LAUNCHES)
    if clip_launches != expected:
        raise AssertionError(f"4K clip launches {clip_launches} != expected {expected}")
    clip_out = processed.transpose(0, 2, 3, 1)
    if not np.array_equal(clip_out, chain_out):
        raise AssertionError("4K ClipProcessor output differs from the chain's")

    steady = step_s[2:]
    steady_ms = 1e3 * sum(steady) / len(steady)
    log(phase="slice_4k", card=torch.cuda.get_device_name(dev), shape=[h, w], levels=levels,
        frames=t,
        chain_step_ms=[1e3 * s for s in step_s], chain_steady_ms_per_frame=steady_ms,
        chain_steady_fps=1e3 / steady_ms, clip_ms_per_frame_with_readback=1e3 * clip_s / t,
        clip_fps=t / clip_s, peak_memory_bytes=peak, launches=launches,
        launches_per_frame={k: v // t for k, v in launches.items()},
        changed_pixels_after_frame0=moved, chain_equals_clip=True)

    # where the device time goes, over two steady frames of the chain
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[:2]:
            chain.process(f, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    dev_ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    ours = [e for e in events if any(k in e.key for k in STENCIL_KERNELS)]
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    device_ms = dev_ms(events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    log(phase="profile_4k", card=torch.cuda.get_device_name(dev), frames=2, wall_ms=1e3 * wall,
        device_ms=device_ms, device_busy_share=device_ms / (1e3 * wall),
        stencil_kernels_ms=dev_ms(ours), copies_ms=dev_ms(copies),
        other_kernels_ms=device_ms - dev_ms(ours) - dev_ms(copies),
        stencils=[dict(name=e.key[:90], device_ms=e.self_device_time_total / 1e3,
                       calls=e.count) for e in ours],
        top=[dict(name=e.key[:90], device_ms=e.self_device_time_total / 1e3,
                  calls=e.count) for e in top])
    return launches


def slice_card_vs_cpu(torch, dev, h=1080, w=1920, t=4):
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
    gpu, cpu = MagnificationChain(device=dev), MagnificationChain(device="cpu")
    dbs, lsbs = [], []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        a = gpu.process(f, cfg)[0].cpu().numpy()
        b = cpu.process(f, cfg)[0].numpy()
        dbs.append(psnr_u8(a, b))
        lsbs.append(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()))
        if dbs[-1] < 40.0:
            raise AssertionError(f"1080p frame {i}: card vs CPU {dbs[-1]:.2f} dB < 40")
    log(phase="slice_1080p_card_vs_cpu", card=torch.cuda.get_device_name(dev), shape=[h, w], levels=levels, frames=t,
        psnr_db=dbs, max_lsb=lsbs, seconds=time.perf_counter() - t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.ops.hopper import _build
    from live_video_magnification_tpu_torch.ops.hopper import stencils as st
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
    launches = slice_4k(torch, dev, st)
    slice_card_vs_cpu(torch, dev)

    kernels = []
    for k in PER_FRAME:
        top = next(r for r in times if r["kernel"] == k and r["level"] == 0)
        kernels.append(dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                            launches=launches[k], max_abs_err=errs[k], ms=top["ms"],
                            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                            bound_by=top["bound_by"], library_ms=top["library_ms"],
                            shape=top["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
