"""Command-line front end of the PyTorch port.

    python -m live_video_magnification_tpu_torch.cli info <video>
    python -m live_video_magnification_tpu_torch.cli magnify <in> <out> [params]
    python -m live_video_magnification_tpu_torch.cli live [--camera N | --video F] [params]
    python -m live_video_magnification_tpu_torch.cli record <out> [--camera N] [params]
    python -m live_video_magnification_tpu_torch.cli cameras
    python -m live_video_magnification_tpu_torch.cli bench [bench flags]

The counterpart of the reference package's ``cli.py``: ``info`` prints the
container's frame count, size, rate and the largest pyramid depth;
``magnify`` decodes a file, runs the frames through ``ClipProcessor`` in
chunks (motion, colour or phase; frame by frame, or each chunk at once under
``--time-parallel``) and encodes the result at constant host memory, with
checkpoints and resume. ``live`` runs the streaming engine
(``engine/controller.py::PlaybackController``: a camera, a file or, when
neither is given, a synthetic source -> queue -> chain -> mailbox) and prints
its stats line (with ``--gl``, also a glfw window that presents the mailbox
through ``engine/gl_present.py``'s ``GLPresenter`` in the ``--view`` layout;
without a display or GL it continues stats-only); ``record`` records a camera (or a synthetic camera) losslessly
into RAM and then exports it magnified through ``export/exporter.py::Exporter``;
``cameras`` lists the capture devices; ``bench`` runs the port's benchmarks
(``bench.py``; its flags, ``--device`` included, follow the command as they
are, an optional leading ``--`` dropped).

Parameters are taken in UI units (Hz bands, percent sliders) and mapped
through the single UI <-> algorithm mapping (``models/params.py``), as the
reference's panels do. ``--device`` (``cuda`` by default, or ``cpu``) picks
where the frames are processed: without a card, ``cuda`` fails rather than
falling back to the CPU. Decoding and encoding need OpenCV (cv2); so do file
and camera sources, while ``live`` and ``record`` on the synthetic source
need it only for the exported file.

``magnify --distributed`` shards each chunk's time axis over every device of
every process (``parallel/batch_export.py``); start one process per host or
card with COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID set
(``parallel/distributed.py``), or one process alone for its own devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import shutil
import sys
import time

FAST_FLAGS = {"LVMT_MXU_DTYPE": "bf16", "LVMT_TAIL": "mxu", "LVMT_TAIL_IO": "bf16",
              "LVMT_PYR_IO": "bf16"}


def _add_mag_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", default="laplace", choices=["laplace", "phase", "color", "none"])
    p.add_argument("--amplification", type=float, default=None, help="alpha (UI units)")
    p.add_argument("--wavelength", type=float, default=None, help="UI percent slider")
    p.add_argument("--low", type=float, default=None, help="band low (Hz)")
    p.add_argument("--high", type=float, default=None, help="band high (Hz)")
    p.add_argument("--chroma", type=int, default=None, help="chroma attenuation percent")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--fps", type=float, default=None, help="capture/algorithm framerate")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--downscale", type=int, default=1, choices=[1, 2, 4, 8])
    p.add_argument("--roi", type=float, nargs=4, metavar=("X", "Y", "W", "H"),
                   default=None, help="normalized ROI")
    p.add_argument("--fast", action="store_true",
                   help="phase mode's bf16 pairing: bf16 stencil operands, the mxu "
                        "tail, bf16 transient and pyramid planes (" +
                        " ".join(f"{k}={v}" for k, v in FAST_FLAGS.items()) + ")")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where frames are processed (default cuda; no fallback)")


def _apply_fast_mode(args) -> None:
    """--fast sets the four phase-mode flags before any chain is built (the
    chain reads them into its static key). An explicit environment setting
    of any of them wins."""
    if getattr(args, "fast", False):
        for var, value in FAST_FLAGS.items():
            os.environ.setdefault(var, value)


def _config_from_args(args, source_fps: float):
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        PreprocessParams,
        ProcessorConfig,
        clamp_band_to_nyquist,
        defaults_for,
        to_params,
    )

    ui = defaults_for(MagnificationMode(args.mode))
    ui.capture_fps = args.fps or source_fps
    if args.amplification is not None:
        ui.amplification = int(args.amplification)
    if args.wavelength is not None:
        ui.wavelength = args.wavelength
    if args.low is not None:
        ui.low = args.low
    if args.high is not None:
        ui.high = args.high
    if args.chroma is not None:
        ui.chroma = args.chroma
    if args.levels is not None:
        ui.levels = args.levels
    clamp_band_to_nyquist(ui)
    pre = PreprocessParams(downscale=args.downscale)
    if args.roi is not None:
        x, y, w, h = args.roi
        pre = dataclasses.replace(pre, roi_enabled=True, roi_x=x, roi_y=y, roi_w=w, roi_h=h)
    return ProcessorConfig(grayscale=args.grayscale, preprocess=pre, magnification=to_params(ui))


def cmd_info(args) -> int:
    from live_video_magnification_tpu_torch.io.video import video_info
    from live_video_magnification_tpu_torch.ops.pyramid import calculate_max_levels

    n, h, w, fps = video_info(args.video)
    print(f"frames={n} size={w}x{h} fps={fps:.3f} max_levels={calculate_max_levels((h, w))}")
    return 0


def cmd_magnify(args) -> int:
    """Streaming offline export: decode -> device chunk -> encode at constant
    host memory (a long 4K clip never materializes in RAM)."""
    _apply_fast_mode(args)

    from live_video_magnification_tpu_torch.device import resolve_device
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.export.exporter import clip_hwc, clip_tchw
    from live_video_magnification_tpu_torch.export.types import SplitMode
    from live_video_magnification_tpu_torch.io.video import (
        VideoWriterStream,
        iter_video,
        video_info,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (here: --device cpu)", file=sys.stderr)
        return 1
    split = SplitMode(args.split)

    total, h, w, fps = video_info(args.input)
    probe = next(iter_video(args.input, args.start, args.start + 1), None)
    if probe is None:
        print("no frames decoded", file=sys.stderr)
        return 1
    channels = 1 if probe.ndim == 2 else probe.shape[2]
    h, w = probe.shape[0], probe.shape[1]
    cfg = _config_from_args(args, fps)

    if args.distributed:
        return _magnify_distributed(args, cfg, device, split, total)

    proc = ClipProcessor(cfg, h, w, channels, time_parallel=args.time_parallel, device=device)
    start = args.start
    if args.checkpoint and os.path.exists(args.checkpoint + ".npz"):
        try:
            start = args.start + proc.load_checkpoint(args.checkpoint)
            print(f"resuming at frame {start}", file=sys.stderr)
        except ValueError as e:
            print(f"error: {e}\n(delete {args.checkpoint}.npz or pass a "
                  "different --checkpoint path to start fresh)", file=sys.stderr)
            return 1

    out_path = args.output
    if start > args.start and os.path.exists(args.output):
        # cv2.VideoWriter would truncate the partial file of the interrupted
        # run; a resumed run writes its continuation to a part file instead,
        # merged after the run
        base, ext = os.path.splitext(args.output)
        out_path = f"{base}.from{start}{ext}"
        print(f"{args.output} exists — writing resumed frames to {out_path}",
              file=sys.stderr)

    end = args.end if args.end is not None else (total or None)
    goal = (end - args.start) if end is not None else None
    writer = VideoWriterStream(out_path, args.file_fps or fps)
    t0 = time.monotonic()

    def flush(buf):
        processed, original = proc.process_chunk(clip_tchw(buf))
        writer.write_chunk(clip_hwc(processed, original, split, args.labels))
        done = proc.cursor
        print(f"\r{done}/{goal if goal is not None else '?'} frames",
              end="", file=sys.stderr)
        if args.checkpoint and args.checkpoint_every and (
                done % args.checkpoint_every) < args.chunk:
            proc.save_checkpoint(args.checkpoint)

    buf = []
    for frame in iter_video(args.input, start, end):
        buf.append(frame if frame.ndim == 3 else frame[..., None])
        if len(buf) == args.chunk:
            flush(buf)
            buf = []
    if buf:
        flush(buf)
    dt = time.monotonic() - t0
    path = writer.close()
    if writer.frames_written == 0:
        if start > args.start:
            print("\nnothing to do: checkpoint cursor is at/past the end "
                  "(export already complete)", file=sys.stderr)
            return 0
        print("\nnothing exported (empty range)", file=sys.stderr)
        return 1
    print(f"\nwrote {writer.frames_written} frames to {path} "
          f"({writer.frames_written / dt:.1f} fps processing, {device})", file=sys.stderr)
    if out_path != args.output:
        # record this run's part before merging: the merge only takes parts
        # the manifest lists, never a stale .fromN file of an older export
        _record_part(args.output, path, start)
        _concat_resumed_parts(args.output, fps=args.file_fps or fps)
    return 0


def _magnify_distributed(args, cfg, device, split, total) -> int:
    """``magnify --distributed``: the export over every device of every
    process (each process runs this with the same arguments)."""
    from live_video_magnification_tpu_torch.parallel import distributed
    from live_video_magnification_tpu_torch.parallel.batch_export import (
        export_video_distributed,
    )

    distributed.initialize(device=device)
    t0 = time.monotonic()
    stats: dict = {}
    final = export_video_distributed(
        args.input, args.output, cfg, chunk=args.chunk, file_fps=args.file_fps,
        start=args.start, end=args.end, split=split, labels=args.labels,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        stats=stats, device=device)
    dt = time.monotonic() - t0
    # frames through the processor, not the container's count (which can lie)
    n_frames = stats.get("frames", (args.end if args.end is not None else total) - args.start)
    print(f"\nwrote {n_frames} frames to {final} ({n_frames / dt:.1f} fps processing, "
          f"{stats['devices']} devices, {device})", file=sys.stderr)
    return 0


def _parts_manifest_path(output: str) -> str:
    base, _ext = os.path.splitext(output)
    return f"{base}.parts.json"


def _read_manifest(mpath: str) -> list:
    with open(mpath) as f:
        return json.load(f)["parts"]


def _record_part(output: str, part_path: str, start: int) -> None:
    """Append a resumed run's continuation file to the output's part manifest
    (ordered by resume frame). The manifest is the source of truth for the
    merge; unknown .fromN files on disk are warned about, never merged."""
    mpath = _parts_manifest_path(output)
    entries = []
    if os.path.exists(mpath):
        try:
            entries = _read_manifest(mpath)
        except (OSError, ValueError, KeyError):
            entries = []
    name = os.path.basename(part_path)
    if not any(e["path"] == name for e in entries):
        entries.append({"start": int(start), "path": name})
    entries.sort(key=lambda e: e["start"])
    with open(mpath, "w") as f:
        json.dump({"output": os.path.basename(output), "parts": entries}, f)


def _concat_resumed_parts(output: str, fps: float | None = None) -> None:
    """Merge ``output`` and its manifest-listed ``.fromN`` continuation files
    into one file (``io/video.py::concat_videos``: ffmpeg stream copy when
    ffmpeg is on PATH, else a cv2 re-encode). Part files on disk that the
    manifest does not list are warned about and left alone."""
    from live_video_magnification_tpu_torch.io.video import concat_videos, video_info

    base, _ext = os.path.splitext(output)
    out_dir = os.path.dirname(output) or "."
    mpath = _parts_manifest_path(output)

    part_re = re.compile(re.escape(os.path.basename(base)) + r"\.from(\d+)\.\w+$")
    on_disk = {os.path.basename(p) for p in glob.glob(f"{glob.escape(base)}.from*")
               if part_re.match(os.path.basename(p))}

    manifest = []
    if os.path.exists(mpath):
        try:
            manifest = _read_manifest(mpath)
        except (OSError, ValueError, KeyError) as e:
            print(f"unreadable part manifest {mpath} ({e}) — not merging", file=sys.stderr)
            return
    if not manifest:
        if on_disk:
            print(f"found {len(on_disk)} .from* part file(s) with no manifest "
                  f"({mpath}) — possibly from an older export; not merging",
                  file=sys.stderr)
        return

    listed = [e["path"] for e in manifest]
    stray = sorted(on_disk - set(listed))
    if stray:
        print(f"ignoring {len(stray)} unlisted part file(s): " + ", ".join(stray),
              file=sys.stderr)
    missing = [n for n in listed if not os.path.exists(os.path.join(out_dir, n))]
    if missing:
        print(f"manifest lists missing part(s) {missing} — keeping everything unmerged",
              file=sys.stderr)
        return
    parts = [os.path.join(out_dir, n) for n in listed]
    ordered = [output] + parts

    had_ffmpeg = shutil.which("ffmpeg") is not None
    if fps is None:
        try:  # only the cv2 re-encode uses fps
            fps = video_info(output)[3] or 30.0
        except (OSError, ImportError):
            fps = 30.0
    try:
        final = concat_videos(ordered, output, fps)
    except (OSError, ImportError) as e:
        print(f"concat failed ({e}) — kept {len(ordered)} part files; "
              "concatenate them with ffmpeg's concat demuxer", file=sys.stderr)
        return
    for p in parts:
        os.unlink(p)
    if final != output and os.path.exists(output):
        os.unlink(output)  # the re-encode switched containers: drop the old first segment
    os.unlink(mpath)
    if not had_ffmpeg:
        print("ffmpeg not found — re-encoded the parts with cv2 instead", file=sys.stderr)
    print(f"auto-concatenated {len(ordered)} parts into {final}", file=sys.stderr)


def _controller(args):
    """(a PlaybackController on ``--device`` set to the CLI's grayscale and
    magnification parameters, that configuration), or (None, None) after
    printing why not (no card)."""
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController

    try:
        ctrl = PlaybackController(device=args.device)
    except RuntimeError as e:
        print(f"error: {e} (here: --device cpu)", file=sys.stderr)
        return None, None
    cfg = _config_from_args(args, 30.0)
    ctrl.set_grayscale(cfg.grayscale)
    ctrl.set_magnification(cfg.magnification)
    return ctrl, cfg


def cmd_live(args) -> int:
    _apply_fast_mode(args)
    from live_video_magnification_tpu_torch.engine.instrumentation import (
        camera_health,
        file_health,
    )

    ctrl, _ = _controller(args)
    if ctrl is None:
        return 1
    gl_ctx = gl_presenter = None
    try:
        if args.camera is not None:
            ok = ctrl.open_camera(args.camera)
        elif args.video is not None:
            ok = ctrl.open_file(args.video)
        else:
            ok = ctrl.open_synthetic(h=args.size[0], w=args.size[1], fps=30.0)
        if not ok:
            print("failed to open source", file=sys.stderr)
            return 1
        if args.playback_fps is not None and not ctrl.is_camera:
            # file-source pacing override (reference StatusStrip.cpp:122-158)
            ctrl.set_playback_fps(args.playback_fps)

        # --gl: the GL-class present path (DisplayWidget.cpp semantics) in a
        # glfw window; runs on the MAIN thread (window-system requirement)
        # with stats interleaved. Without a usable display the run degrades
        # to stats-only; the chain stays on --device either way.
        if args.gl:
            try:
                from live_video_magnification_tpu_torch.engine.display import ViewMode
                from live_video_magnification_tpu_torch.engine.gl_present import (
                    GLPresenter,
                    WindowGLContext,
                )

                gl_ctx = WindowGLContext(960, 540, title="lvmt live")
                gl_presenter = GLPresenter(ctrl.instr, view_mode=ViewMode(args.view))
            except Exception as e:  # no display / no GL driver
                print(f"--gl unavailable ({e}); continuing stats-only", file=sys.stderr)
                if gl_ctx is not None:  # window opened but the GL init failed
                    gl_ctx.destroy()
                gl_ctx = gl_presenter = None

        ctrl.play()
        end = time.monotonic() + args.duration
        next_stat = 0.0
        while time.monotonic() < end:
            if gl_ctx is not None:
                if gl_ctx.should_close():
                    break
                gl_presenter.paint(ctrl.mailbox.latest(), gl_ctx.width, gl_ctx.height)
                gl_ctx.swap()  # vsync paces the present rate
            else:
                time.sleep(min(0.25, max(0.0, end - time.monotonic())))
            now = time.monotonic()
            if now < next_stat:
                continue
            next_stat = now + 0.25
            s = ctrl.stats()
            health = (
                camera_health(s.drop_fraction) if ctrl.is_camera
                else file_health(s.process_fps, ctrl.reported_fps())
            )
            print(
                f"\rfps={s.process_fps:6.1f} latency={s.latency_ms_mean:5.1f}ms "
                f"p95={s.latency_ms_p95:5.1f}ms q={s.queue_depth} drops={s.source_drops} "
                f"errors={s.proc_errors} [{health}]   ",
                end="", file=sys.stderr,
            )
    except KeyboardInterrupt:
        pass
    finally:
        print(file=sys.stderr)
        if gl_presenter is not None:
            gl_presenter.destroy()
        if gl_ctx is not None:
            gl_ctx.destroy()
        ctrl.close()
    return 0


def cmd_record(args) -> int:
    """Lossless camera recording -> offline magnified export
    (reference CameraSource.cpp:70-80 + MainWindow.cpp:576-585 flow)."""
    _apply_fast_mode(args)
    from live_video_magnification_tpu_torch.export.exporter import Exporter
    from live_video_magnification_tpu_torch.export.sources import BufferExportFrameSource
    from live_video_magnification_tpu_torch.export.types import (
        ExportFormat,
        ExportPhase,
        ExportRequest,
        SplitMode,
    )

    ctrl, cfg = _controller(args)
    if ctrl is None:
        return 1
    try:
        if args.camera is not None:
            ok = ctrl.open_camera(args.camera)
        else:
            ok = ctrl.open_synthetic(h=args.size[0], w=args.size[1], fps=30.0,
                                     as_camera=True)
        if not ok:
            print("failed to open source", file=sys.stderr)
            return 1
        ctrl.play()
        buf = ctrl.start_recording(max_bytes=args.max_bytes)
        if buf is None:
            print("recording unavailable (no camera-kind source)", file=sys.stderr)
            return 1
        end = time.monotonic() + args.duration
        try:
            while time.monotonic() < end and not buf.closed:
                time.sleep(0.1)
                print(f"\rREC {buf.frame_count} frames "
                      f"{buf.byte_count / 1e6:.1f} MB", end="", file=sys.stderr)
        except KeyboardInterrupt:
            pass
        if buf.limit_reached:
            print("\nbyte cap reached — recording auto-stopped", file=sys.stderr)
        frames = ctrl.stop_recording()
    finally:
        ctrl.close()
    print(f"\ncaptured {len(frames)} frames", file=sys.stderr)
    if not frames:
        print("nothing recorded", file=sys.stderr)
        return 1

    fmt = {"mp4": ExportFormat.MP4_H264, "avi": ExportFormat.AVI_MJPG,
           "mkv": ExportFormat.MKV_FFV1}[args.format]
    req = ExportRequest(config=cfg, output_path=args.output,
                        file_fps=args.file_fps or 30.0, split=SplitMode(args.split),
                        text_overlay=args.labels, format=fmt)
    exp = Exporter(device=ctrl.device)
    exp.start(BufferExportFrameSource(frames), req)
    while True:
        p = exp.progress()
        if p.phase in (ExportPhase.DONE, ExportPhase.FAILED, ExportPhase.ABORTED):
            break
        print(f"\rexporting {p.frames_done}/{p.frames_total}", end="", file=sys.stderr)
        time.sleep(0.2)
    exp.join(timeout=30.0)
    p = exp.progress()
    if p.phase is not ExportPhase.DONE:
        print(f"\nexport {p.phase.value}: {p.error}", file=sys.stderr)
        return 1
    print(f"\nwrote {p.frames_done} frames to {args.output}", file=sys.stderr)
    return 0


def cmd_bench(rest) -> int:
    """``bench.main`` on ``rest``; its exit status (``--help`` and argument
    errors included) is returned, not raised."""
    from live_video_magnification_tpu_torch import bench

    try:
        return bench.main(list(rest))
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)


def cmd_cameras(_args) -> int:
    from live_video_magnification_tpu_torch.engine.source import enumerate_cameras

    cams = enumerate_cameras()
    if not cams:
        print("no cameras found")
    for idx, name in cams:
        print(f"{idx}: {name}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # `bench` hands its whole tail to bench.py's own parser, before this
    # one: a sub-parser cannot pass on flags it does not know
    if argv[:1] == ["bench"]:
        rest = argv[1:]
        return cmd_bench(rest[1:] if rest[:1] == ["--"] else rest)

    ap = argparse.ArgumentParser(prog="python -m live_video_magnification_tpu_torch.cli",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="video info")
    p.add_argument("video")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("magnify", help="offline magnification export")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--file-fps", type=float, default=None)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--time-parallel", action="store_true",
                   help="sequence-parallel chunks (associative scans over T) instead of "
                        "the sequential per-frame step; output within 1 LSB of it")
    p.add_argument("--split", default="none", choices=["none", "left-right", "top-bottom"],
                   help="compose original|processed panes like the GUI export")
    p.add_argument("--labels", action="store_true", help="burn in pane labels")
    p.add_argument("--distributed", action="store_true",
                   help="shard each chunk's frame axis over every device of every process "
                        "(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; one process alone "
                        "uses its own devices)")
    _add_mag_args(p)
    p.set_defaults(fn=cmd_magnify)

    p = sub.add_parser("live", help="streaming pipeline with live stats")
    p.add_argument("--camera", type=int, default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640))
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--playback-fps", type=float, default=None,
                   help="override file-source playback pacing (ignored for cameras)")
    p.add_argument("--gl", action="store_true",
                   help="present in a GL window (glfw; falls back to "
                        "stats-only without a display)")
    p.add_argument("--view", default="processed",
                   choices=["processed", "original", "side-by-side", "top-bottom"],
                   help="--gl view mode (DisplayWidget pane layouts)")
    _add_mag_args(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("record", help="record (camera/synthetic) then export magnified")
    p.add_argument("output")
    p.add_argument("--camera", type=int, default=None)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640),
                   help="synthetic source size when no camera")
    p.add_argument("--duration", type=float, default=5.0, help="record seconds")
    p.add_argument("--max-bytes", type=int, default=None, help="RAM cap (default 8 GB)")
    p.add_argument("--file-fps", type=float, default=None)
    p.add_argument("--format", default="mp4", choices=["mp4", "avi", "mkv"])
    p.add_argument("--split", default="none", choices=["none", "left-right", "top-bottom"])
    p.add_argument("--labels", action="store_true")
    _add_mag_args(p)
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("cameras", help="enumerate capture devices")
    p.set_defaults(fn=cmd_cameras)

    sub.add_parser("bench", help="the port's benchmarks (bench.py; `bench --help`)")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
