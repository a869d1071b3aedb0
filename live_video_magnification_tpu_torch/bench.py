"""Benchmarks of the port. Default: the headline 4K phase throughput.

    python -m live_video_magnification_tpu_torch.bench [flags]
    python -m live_video_magnification_tpu_torch.cli bench [flags]

Prints ONE JSON line:
  {"metric": "phase_4k_fps_per_chip", "value": N, "unit": "fps", "vs_baseline": N/60}

The counterpart of the reference package's root ``bench.py``, with its flags,
metric names and JSON keys. ``vs_baseline`` is fps over the 60 fps goal at
4K, levels=6, phase (``BASELINE.md``). The headline also measures the
``--fast`` pairing (``fast_mode_fps``).

Measurement: a first warm run of ``--steps`` steps (``compile_s``: the
kernels' load and the first steps), then three timed runs of as many steps,
continuing the state, keeping the fastest with its own checksum. Each run is
one Python loop of the mode's ``step`` over device frames varied every step
(frame t is a window of a seeded u8 base at column t % 64), a checksum of
every output (the int sum of out[:, ::64, ::64]) accumulated on the device
and read back once at the end: that read is the run's only sync, and it is
timed.

Phase mode reads its kernel flags (``models/riesz.py::KernelFlags``) from
the environment once per run, as the chain does, and passes them to the
step.

Flags:
  --small / --res HxW / --levels / --steps / --mode phase|laplace|color
  --device cuda|cpu  where the frames are processed (default cuda; no fallback)
  --matrix          run the BASELINE.md config matrix (configs 1-5, the
                    headline, time-parallel, the sharded step, streaming and
                    present) and write --out (default BENCH_MATRIX_TORCH.json);
                    exits 1 if any entry failed
  --sharded         bench the lane-sharded step (mesh of 1)
  --time-parallel   bench the sequence-parallel clip path instead of the loop
  --streaming       bench the real host streaming loop (source->chain->mailbox)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

from live_video_magnification_tpu_torch.cli import FAST_FLAGS
from live_video_magnification_tpu_torch.device import resolve_device

BASE_PAD = 64  # columns of the frame base beyond the width: frame t starts at t % 64


@contextlib.contextmanager
def environ(updates: dict):
    """``updates`` set in the environment; every variable restored after."""
    saved = {k: os.environ.get(k) for k in updates}
    os.environ.update(updates)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_dyn(fps_cfg: float):
    """Amplification 50, phase cutoff pi/2, Butterworth at 1 and 5 Hz."""
    from live_video_magnification_tpu_torch.models.riesz import RieszDynParams
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs

    f32 = lambda v: float(np.float32(v))
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(1.0, fps_cfg),
                                  butterworth_bandpass_coeffs(5.0, fps_cfg))
    return RieszDynParams(f32(50.0), f32(0.5 * math.pi), c3(b_lo), c3(a_lo), c3(b_hi),
                          c3(a_hi), False, False)


def _mode_setup(mode: str, h: int, w: int, levels: int, fps_cfg: float, device):
    """(state, dyn, step, clip_parallel) of ``mode`` on ``device``; phase's
    step and state under the kernel flags the environment sets now."""
    f32 = lambda v: float(np.float32(v))
    if mode == "phase":
        from live_video_magnification_tpu_torch.models import riesz as m

        flags = m.env_flags()
        dyn = phase_dyn(fps_cfg)
        state = m.init_state(h, w, levels, device=device, pyr_io=flags.pyr_io)
        step = partial(m.step, levels=levels, **flags._asdict())
        clip_parallel = partial(m.process_clip_parallel, levels=levels)
    elif mode == "laplace":
        from live_video_magnification_tpu_torch.models import motion as m
        from live_video_magnification_tpu_torch.models.params import motion_hz_to_blend

        dyn = m.MotionDynParams(f32(20.0), f32(500.0), f32(motion_hz_to_blend(1.0, fps_cfg)),
                                f32(motion_hz_to_blend(5.0, fps_cfg)), f32(0.3))
        state = m.init_state(h, w, 3, levels, device=device)
        step = partial(m.step, levels=levels)
        clip_parallel = partial(m.process_clip_parallel, levels=levels)
    else:
        from live_video_magnification_tpu_torch.models import color as m

        dyn = m.ColorDynParams(f32(100.0), f32(0.84), f32(1.43))
        state = m.init_state(h, w, 3, levels, fps_cfg, device=device)
        step = partial(m.step, levels=levels, framerate=fps_cfg)
        clip_parallel = partial(m.process_clip_parallel, levels=levels, framerate=fps_cfg)
    return state, dyn, step, clip_parallel


def frame_base(h: int, w: int, device) -> torch.Tensor:
    """The seeded u8 base (3, h, w + 64) the scan's frames are cut from."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 255, (3, h, w + BASE_PAD), dtype=np.uint8)).to(device)


def frame_at(base: torch.Tensor, t: int, w: int) -> torch.Tensor:
    """Frame t: the base's columns [t % 64, t % 64 + w), a view."""
    return base[:, :, t % BASE_PAD: t % BASE_PAD + w]


def checksum(out: torch.Tensor) -> torch.Tensor:
    """The int sum of every 64th pixel of every channel, on the device."""
    return out[..., ::64, ::64].to(torch.int64).sum()


def _warm_and_best(run, state, reps: int = 3):
    """The warm run, then ``reps`` timed runs continuing the state. Returns
    (warm seconds, warm checksum, best seconds, the best run's own checksum).
    ``run(state) -> (state, checksum tensor)``; reading the checksum is the
    sync, and it is timed."""
    t0 = time.monotonic()
    state, c = run(state)
    warm = int(c.item())
    compile_s = time.monotonic() - t0
    best, chk = float("inf"), 0
    for _ in range(reps):
        t0 = time.monotonic()
        state, c = run(state)
        cval = int(c.item())
        dt = max(1e-9, time.monotonic() - t0)
        if dt < best:
            best, chk = dt, cval
    return compile_s, warm, best, chk


def _result(n: int, compile_s: float, warm: int, dt: float, final: int) -> dict:
    return {"fps": n / dt, "compile_s": compile_s, "ms_per_frame": dt / n * 1e3,
            "checksums": (warm, final)}


def bench_mode_scan(mode: str, h: int, w: int, levels: int, steps: int,
                    fps_cfg: float = 30.0, device="cuda") -> dict:
    """``steps`` magnification steps in one loop; one checksum read."""
    dev = resolve_device(device)
    state, dyn, step, _ = _mode_setup(mode, h, w, levels, fps_cfg, dev)
    base = frame_base(h, w, dev)

    def run(state):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(steps):
            state, out = step(state, frame_at(base, t, w), dyn)
            total += checksum(out)
        return state, total

    return _result(steps, *_warm_and_best(run, state))


def bench_fast_mode(mode: str, h: int, w: int, levels: int, steps: int,
                    fps_cfg: float = 30.0, device="cuda") -> dict:
    """``bench_mode_scan`` under the four flags of ``--fast``, the
    environment restored after."""
    with environ(FAST_FLAGS):
        return bench_mode_scan(mode, h, w, levels, steps, fps_cfg=fps_cfg, device=device)


def bench_time_parallel(mode: str, h: int, w: int, levels: int, t_chunk: int,
                        fps_cfg: float = 30.0, device="cuda") -> dict:
    """The sequence-parallel clip path (process_clip_parallel), one call a run."""
    dev = resolve_device(device)
    state, dyn, _, clip_parallel = _mode_setup(mode, h, w, levels, fps_cfg, dev)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, (t_chunk, 3, h, w), dtype=np.uint8)).to(dev)

    def run(state):
        state, outs = clip_parallel(frames, dyn, state=state)
        return state, checksum(outs)

    return _result(t_chunk, *_warm_and_best(run, state))


def bench_sharded_step(h: int, w: int, levels: int, steps: int, fps_cfg: float = 30.0,
                       force_halo: bool = False, device="cuda") -> dict:
    """The lane-sharded phase step (``parallel/riesz_sharded.py``) on a mesh
    of 1: the multi-card code path at one card's speed. Its mesh-of-1 plan
    replicates every level (no neighbours, no exchange); ``force_halo``
    keeps the lane-sharded plan, every exchange a K10 launch: the cost the
    halo machinery adds on one card. One call runs ``steps`` steps
    (``repeat_steps``) and returns their checksum."""
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
        build_sharded_riesz_step,
    )

    dev = resolve_device(device)
    mesh = make_mesh((1, 1), ("batch", "tile"), devices=[dev])
    step, state = build_sharded_riesz_step(mesh, 1, h, w, levels, repeat_steps=steps,
                                           force_sharded=force_halo)
    dyn = phase_dyn(fps_cfg)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 255, (1, 3, h, w), dtype=np.uint8)).to(dev)
    return _result(steps, *_warm_and_best(lambda st: step(st, frame, dyn), state))


def bench_streaming(h: int = 1080, w: int = 1920, fps: float = 60.0,
                    duration: float = 10.0, mode: str = "none",
                    native: bool = False, device="cuda") -> dict:
    """The real host loop (BASELINE config 4): a synthetic 1080p60 source ->
    queue -> ProcessingChain on ``device`` (ROI + 1/2 downscale) -> mailbox,
    measured by the engine's instrumentation (fps, latency p95). ``native``:
    the C arena and queue (LVMT_NATIVE=1, restored after). Fails if the
    chain or the source reported an error."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
    )

    with environ({"LVMT_NATIVE": "1" if native else "0"}):
        ctrl = PlaybackController(device=device)
    try:
        ctrl.set_magnification(MagnificationParams(
            mode=MagnificationMode(mode), amplification=20, co_low=1.0, co_high=5.0,
            levels=4, framerate=fps,
        ))
        ctrl.set_downscale(2)
        if not ctrl.open_synthetic(h=h, w=w, fps=fps):
            raise RuntimeError("the synthetic source did not open")
        ctrl.set_roi(0.25, 0.25, 0.5, 0.5)
        ctrl.play()
        # Poll stats like the GUI's 4 Hz timer (the fps EMA advances per
        # snapshot); the fps is the steady half's processed frames.
        t0 = time.monotonic()
        mid_processed, mid_t = 0, t0
        while time.monotonic() - t0 < duration:
            time.sleep(0.25)
            s = ctrl.stats()
            if mid_processed == 0 and time.monotonic() - t0 >= duration / 2:
                mid_processed = s.processed
                mid_t = time.monotonic()
        s = ctrl.stats()
        steady_fps = (s.processed - mid_processed) / max(1e-9, time.monotonic() - mid_t)
    finally:
        ctrl.close()
    if s.proc_errors or s.read_errors:
        raise RuntimeError(f"streaming: {s.proc_errors} processing and {s.read_errors} "
                           "source errors")
    return {
        "fps": steady_fps, "fps_ema": s.process_fps,
        "latency_ms_mean": s.latency_ms_mean,
        "latency_ms_p95": s.latency_ms_p95, "captured": s.captured,
        "processed": s.processed, "target_fps": fps,
    }


def bench_display_present(h: int = 1080, w: int = 1920, n: int = 240) -> dict:
    """The display present path on the host: per new frame, ``poll_once``
    (mailbox read, seq check, ``compose_view``) and the PPM bytes the GUI's
    tk PhotoImage takes (``gui.py::PhotoCodec``; the blit itself needs a
    display). Also times the no-new-frame short-circuit a 120 Hz poll takes
    when the seq has not advanced (DisplayWidget.cpp:39-52)."""
    from live_video_magnification_tpu_torch.engine.display import DisplayLoop, ViewMode
    from live_video_magnification_tpu_torch.engine.frame import Frame
    from live_video_magnification_tpu_torch.engine.instrumentation import Instrumentation
    from live_video_magnification_tpu_torch.engine.mailbox import (
        DisplayFrame,
        LatestFrameMailbox,
    )
    from live_video_magnification_tpu_torch.gui import PhotoCodec

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(4)]
    mailbox = LatestFrameMailbox()
    loop = DisplayLoop(mailbox, Instrumentation(), view_mode=ViewMode.PROCESSED)
    ppm_bytes = PhotoCodec().ppm

    def publish(seq):
        img = imgs[seq % len(imgs)]
        mailbox.publish(DisplayFrame(Frame(seq=seq, data=img), Frame(seq=seq, data=img)))

    for seq in range(3):  # warm
        publish(seq)
        v = loop.poll_once()
        if v is None:
            raise RuntimeError("the display loop missed a new frame")
        ppm_bytes(v)

    t0 = time.monotonic()
    for i in range(n):
        publish(3 + i)
        ppm_bytes(loop.poll_once())
    dt = time.monotonic() - t0

    t1 = time.monotonic()
    for _ in range(n):
        if loop.poll_once() is not None:  # seq unchanged: the short-circuit
            raise RuntimeError("the display loop presented an old frame again")
    dt_idle = time.monotonic() - t1
    return {"fps": n / dt, "present_ms": 1e3 * dt / n, "idle_poll_us": 1e6 * dt_idle / n}


def bench_display_present_gl(h: int = 1080, w: int = 1920, n: int = 60) -> dict:
    """The GL present path (``engine/gl_present.py``) on a headless EGL
    context: upload on a new seq, a letterboxed textured quad and glFinish a
    present (DisplayWidget.cpp:133-236). ``idle_ms``: a repaint with an
    unchanged seq (no upload), the 120 Hz timer's cost when the pipeline is
    slower than the present clock."""
    from live_video_magnification_tpu_torch.engine.frame import Frame
    from live_video_magnification_tpu_torch.engine.gl_present import (
        GLPresenter,
        HeadlessGLContext,
    )
    from live_video_magnification_tpu_torch.engine.mailbox import DisplayFrame

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(4)]
    ctx = HeadlessGLContext(w, h)
    presenter = None
    try:
        presenter = GLPresenter()

        def pair(seq):
            img = imgs[seq % len(imgs)]
            return DisplayFrame(Frame(seq=seq, data=img), Frame(seq=seq, data=img))

        for seq in range(3):  # warm (shader compile, first raster)
            presenter.paint(pair(seq), w, h)
            ctx.swap()
        t0 = time.monotonic()
        for i in range(n):
            presenter.paint(pair(3 + i), w, h)
            ctx.swap()
        dt = time.monotonic() - t0

        last = pair(3 + n - 1)
        t1 = time.monotonic()
        for _ in range(n):
            presenter.paint(last, w, h)  # seq unchanged: no upload
            ctx.swap()
        dt_idle = time.monotonic() - t1
        uploads = presenter.uploads
    finally:
        if presenter is not None:
            presenter.destroy()
        ctx.destroy()
    return {"fps": n / dt, "present_ms": 1e3 * dt / n, "idle_ms": 1e3 * dt_idle / n,
            "uploads": uploads}


def _gl_unavailable():
    """Why no headless GL context can be made here, or None if one can."""
    try:
        from live_video_magnification_tpu_torch.engine.gl_present import HeadlessGLContext

        HeadlessGLContext(8, 8).destroy()
    except Exception as e:  # noqa: BLE001 - reported in the entry, not hidden
        return f"{type(e).__name__}: {e}"[:300]
    return None


def run_matrix(steps: int, device) -> list:
    """The BASELINE.md configurations, each one JSON line, in the reference
    bench's order. A failing entry is recorded as {"metric", "error"} and
    the rest still run; the GL entry is {"metric", "skipped"} where no GL
    context can be made."""
    dev = resolve_device(device)
    name = device_name(dev)
    results = []

    def emit(entry):
        results.append(entry)
        print(json.dumps(entry), flush=True)

    def attempt(metric, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - one failing entry must not hide the rest
            emit({"metric": metric, "error": f"{type(e).__name__}: {e}"[:300]})
            return None

    def add(metric, target, fn, note=""):
        r = attempt(metric, fn)
        if r is None:
            return
        entry = {
            "metric": metric, "value": round(r["fps"], 2), "unit": "fps",
            "target": target, "vs_baseline": round(r["fps"] / target, 3),
            "ms_per_frame": round(r.get("ms_per_frame", 0.0), 2),
            "device": name,
        }
        if note:
            entry["note"] = note
        emit(entry)

    # config 1: color 640x480 L4; target: real-time 30 fps capture
    add("color_640x480_fps_per_chip", 30.0,
        lambda: bench_mode_scan("color", 480, 640, 4, steps, device=dev))
    # config 2: laplace 720p L5 chroma
    add("laplace_720p_fps_per_chip", 30.0,
        lambda: bench_mode_scan("laplace", 720, 1280, 5, steps, device=dev))
    # config 3: phase 1080p L6
    add("phase_1080p_fps_per_chip", 60.0,
        lambda: bench_mode_scan("phase", 1080, 1920, 6, steps, device=dev))
    # headline: phase 4K L6
    add("phase_4k_fps_per_chip", 60.0,
        lambda: bench_mode_scan("phase", 2160, 3840, 6, steps, device=dev))
    add("phase_4k_bf16_fastmode_fps_per_chip", 60.0,
        lambda: bench_fast_mode("phase", 2160, 3840, 6, steps, device=dev),
        note=" + ".join(f"{k}={v}" for k, v in FAST_FLAGS.items())
        + " (the --fast pairing: the bf16 arms of the stencil kernels and the "
          "amplify kernel, bf16 transient and pyramid planes); default stays f32")
    # config 5 proxy (one card): a sequence-parallel export chunk
    add("phase_1080p_timeparallel_fps_per_chip", 60.0,
        lambda: bench_time_parallel("phase", 1080, 1920, 6, t_chunk=8, device=dev),
        note="process_clip_parallel, one chunk of T=8 (config 5's one-card proxy)")
    add("phase_4k_shardedstep_fps_per_chip", 60.0,
        lambda: bench_sharded_step(2160, 3840, 6, steps, device=dev),
        note="the lane-sharded step on a mesh of 1, repeat_steps; its plan "
             "replicates every level (no neighbours, no exchange)")
    add("phase_4k_shardedstep_forcedhalo_fps_per_chip", 60.0,
        lambda: bench_sharded_step(2160, 3840, 6, steps, force_halo=True, device=dev),
        note="the same step with the lane-sharded plan forced at a mesh of 1: "
             "every exchange a K10 launch, the halo path's cost on one card")

    # config 4: the streaming host loop, the chain on the bench's device
    streaming_cfgs = [
        # (metric, kwargs, target fps, note prefix)
        ("streaming_1080p60_hostloop_fps", dict(native=False), 60.0, "mode=none, "),
        ("streaming_1080p60_hostloop_fps_native", dict(native=True), 60.0,
         "LVMT_NATIVE=1 C arena/queue transport; mode=none, "),
        # "magnify while streaming": 720p@30 laplace through the same loop
        ("streaming_720p30_laplace_hostloop_fps",
         dict(native=False, h=720, w=1280, fps=30.0, mode="laplace"), 30.0,
         "mode=laplace (magnification on in the loop); "),
    ]
    for metric, kwargs, target, note in streaming_cfgs:
        s = attempt(metric, lambda: bench_streaming(device=dev, **kwargs))
        if s is None:
            continue
        emit({
            "metric": metric, "value": round(s["fps"], 2), "unit": "fps",
            "target": target, "vs_baseline": round(s["fps"] / target, 3),
            "latency_ms_p95": round(s["latency_ms_p95"], 1), "device": name,
            "note": note + "real host loop (source->queue->chain->mailbox), ROI "
                           "0.5x0.5 + 1/2 downscale, synthetic source",
        })

    # the display present path on the host
    d = attempt("display_present_1080p", bench_display_present)
    if d is not None:
        emit({
            "metric": "display_present_1080p",
            "value": round(d["present_ms"], 2), "unit": "ms",
            "fps_equivalent": round(d["fps"], 1),
            "idle_poll_us": round(d["idle_poll_us"], 2),
            "device": "cpu-host",
            "note": "poll_once + compose_view + PPM byte assembly (the tk "
                    "PhotoImage input; the blit itself needs a display); "
                    "idle_poll_us = the seq-unchanged short-circuit",
        })

    # the GL present path, where a GL context can be made
    reason = _gl_unavailable()
    if reason is not None:
        emit({"metric": "display_present_gl_1080p", "skipped": reason})
        return results
    d = attempt("display_present_gl_1080p", bench_display_present_gl)
    if d is not None:
        emit({
            "metric": "display_present_gl_1080p",
            "value": round(d["present_ms"], 2), "unit": "ms",
            "fps_equivalent": round(d["fps"], 1),
            "idle_repaint_ms": round(d["idle_ms"], 2),
            "device": "host GL (headless EGL)",
            "note": "engine/gl_present.py end to end: upload on a new seq + "
                    "letterboxed textured quad + glFinish a present",
        })
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m live_video_magnification_tpu_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--small", action="store_true", help="720p instead of 4K")
    ap.add_argument("--res", default=None, help="HxW override, e.g. 480x640")
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mode", default="phase", choices=["phase", "laplace", "color"])
    ap.add_argument("--matrix", action="store_true", help="run BASELINE config matrix")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--time-parallel", action="store_true")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--out", default="BENCH_MATRIX_TORCH.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where frames are processed (default cuda; no fallback)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = nvidia_smi() if dev.type == "cuda" else None
    label = f"{device_name(dev)} ({card})" if card else device_name(dev)
    print(f"# device={label}", file=sys.stderr, flush=True)

    if args.matrix:
        results = run_matrix(args.steps, dev)
        with open(args.out, "w") as f:
            json.dump({"device": device_name(dev), "nvidia_smi": card, "results": results},
                      f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)
        failed = [r["metric"] for r in results if "error" in r]
        if failed:
            print(f"# failed: {', '.join(failed)}", file=sys.stderr)
        return 1 if failed else 0

    if args.streaming:
        s = bench_streaming(device=dev)
        print(json.dumps({"metric": "streaming_1080p60_hostloop_fps",
                          "value": round(s["fps"], 2), "unit": "fps",
                          "vs_baseline": round(s["fps"] / 60.0, 3)}))
        print(f"# p95={s['latency_ms_p95']:.1f}ms processed={s['processed']}",
              file=sys.stderr)
        return 0

    if args.res:
        h, w = (int(v) for v in args.res.split("x"))
        levels = args.levels or 4
        name_res = f"{h}x{w}"
    elif args.small:
        h, w, levels = 720, 1280, 5
        name_res = "720p"
    else:
        h, w, levels = 2160, 3840, 6
        name_res = "4k"
    if args.levels:
        levels = args.levels

    if args.sharded:
        r = bench_sharded_step(h, w, levels, args.steps, device=dev)
        metric = f"phase_{name_res}_shardedstep_fps_per_chip"
    elif args.time_parallel:
        r = bench_time_parallel(args.mode, h, w, levels, t_chunk=args.steps, device=dev)
        metric = f"{args.mode}_{name_res}_timeparallel_fps_per_chip"
    else:
        r = bench_mode_scan(args.mode, h, w, levels, args.steps, device=dev)
        metric = f"{args.mode}_{name_res}_fps_per_chip"

    entry = {
        "metric": metric,
        "value": round(r["fps"], 2),
        "unit": "fps",
        "vs_baseline": round(r["fps"] / 60.0, 3),
    }
    if metric == "phase_4k_fps_per_chip":
        # the --fast pairing beside the default path, in the same process
        rf = bench_fast_mode(args.mode, h, w, levels, args.steps, device=dev)
        entry["fast_mode_fps"] = round(rf["fps"], 2)
        entry["note"] = ("default path (the environment's flags; f32 unless set); "
                         "fast_mode_fps = " + " + ".join(f"{k}={v}" for k, v in FAST_FLAGS.items()))
    print(json.dumps(entry))
    print(f"# device={label} levels={levels} "
          f"compile+warm={r['compile_s']:.1f}s "
          f"steady={r['ms_per_frame']:.1f}ms/frame checksums={r['checksums']}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
