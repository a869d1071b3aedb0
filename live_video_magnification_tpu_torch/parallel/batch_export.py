"""The N-process batch export: a chunk's time axis sharded over devices.

The counterpart of the reference package's ``parallel/batch_export.py``. The
export keeps the reference's semantics (a fixed configuration for the whole
file, frames in order in the output) while the time axis of each chunk is
split over every device of every process:

  per process:  decode only the rows of the chunk that its own shards hold
                (``local_rows``)                               [host CPU]
  all shards:   ``models/*.py::process_clip_parallel`` on each shard's
                frames, every stage batched over the shard, the temporal
                recurrences as local scans joined by the boundary step of
                ``parallel/time_shard.py`` (the scan carry, the prior's
                one-frame halo, colour's earlier tops)         [devices]
  per process:  encode its own shards' outputs into part files, one for
                each (chunk, shard)                             [host CPU]
  process 0:    concatenate the parts in (chunk, shard) order into one file.

The carried state crosses chunk boundaries as in ``ClipProcessor``, and every
process holds a copy of it, so a distributed export, a ``--time-parallel``
export and a sequential export resume each other's checkpoints. A final
partial chunk (fewer frames than the mesh is wide, or not a multiple of it)
runs unsharded on every process, which keeps the copies of the state equal;
process 0 alone writes it.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.models.params import ProcessorConfig
from live_video_magnification_tpu_torch.parallel import distributed
from live_video_magnification_tpu_torch.parallel.mesh import Mesh
from live_video_magnification_tpu_torch.parallel.time_shard import TimeShards


class DistributedClipExporter:
    """T-sharded chunk processor with carried state.

    ``mesh``: a 1-axis ("time",) mesh over the devices to shard the frame
    axis on; default every device of every process
    (``distributed.global_mesh``): every CUDA device, raising without a
    card, or the CPU where ``device="cpu"``. Each process holds the mesh
    entries of its rank, a contiguous run in shard order. ``backend`` is the
    torch.distributed backend chosen at ``initialize`` (None in one
    process)."""

    def __init__(self, cfg: ProcessorConfig, h: int, w: int, channels: int,
                 mesh: Optional[Mesh] = None, device=None):
        if mesh is None:
            mesh = distributed.global_mesh(("time",), device=device)
        if len(mesh.axis_names) != 1:
            raise ValueError("batch_export shards one (time) axis")
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size)
        lay = distributed.layout()
        self.rank = lay.rank if lay is not None else 0
        self.backend = lay.backend if lay is not None else None
        world = lay.world if lay is not None else 1
        owned = mesh.owned(self.rank)
        held = len(owned)
        if (held == 0 or held * world != self.n_shards
                or list(owned) != list(range(self.rank * held, (self.rank + 1) * held))):
            raise ValueError(f"rank {self.rank} holds mesh entries {list(owned)}: each of the "
                             f"{world} processes must hold an equal, contiguous run of the "
                             f"{self.n_shards} shards, in rank order")
        devices = tuple(resolve_device(d) for d in mesh.devices.reshape(-1)[owned])
        group = None
        if world > 1:
            import torch.distributed as dist

            group = dist.group.WORLD
        self.shards = TimeShards(devices, first=int(owned[0]), count=self.n_shards,
                                 group=group, staged=lay is not None and lay.staged)
        self.proc = ClipProcessor(cfg, h, w, channels, time_parallel=True, device=devices[0])
        self.state = self.proc.state
        self.cursor = 0

    # -- checkpoint / resume (interchangeable with ClipProcessor's) ----------------------------

    def save_checkpoint(self, path: str) -> None:
        """ClipProcessor's .npz format and config digest: a distributed
        checkpoint resumes a sequential or time-parallel export, and the
        other way round (the carried state is the same)."""
        self.proc.state = self.state
        self.proc.cursor = self.cursor
        self.proc.save_checkpoint(path)

    def load_checkpoint(self, path: str) -> int:
        cursor = self.proc.load_checkpoint(path)
        self.state = self.proc.state
        self.cursor = cursor
        return cursor

    # -- host-side shard bookkeeping -----------------------------------------------------------

    def local_rows(self, chunk_len: int) -> List[Tuple[int, int, int]]:
        """The (shard_index, row_start, row_end) triples of ``chunk_len``
        frames that this process's shards hold: the rows it decodes and the
        output segments it encodes. Rows are chunk-relative."""
        if chunk_len % self.n_shards:
            raise ValueError(
                f"local_rows needs a shard-divisible chunk (got {chunk_len} over "
                f"{self.n_shards} shards); partial tails run unsharded in process_chunk "
                "and export_video_distributed")
        per = chunk_len // self.n_shards
        return [(k, k * per, (k + 1) * per)
                for k in range(self.shards.first, self.shards.first + len(self.shards.devices))]

    # -- processing ----------------------------------------------------------------------------

    def _sync(self) -> None:
        for d in dict.fromkeys(self.shards.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def process_chunk(self, frames_u8_local, chunk_len: int,
                      timings: Optional[dict] = None, fetch_original: bool = True):
        """Process one global chunk of ``chunk_len`` frames.

        frames_u8_local: [T_local, C, H, W] u8, this process's rows
        (``local_rows`` order), or the whole chunk for a partial one.
        Returns (processed, original) numpy stacks of the same rows.

        ``timings``, if given, accumulates {"h2d_s", "process_s",
        "fetch_s"} seconds, split by a synchronize of every device of this
        process. ``fetch_original=False`` returns (processed, None) and
        skips the readback of the original stack: half the device-to-host
        bytes."""
        t0 = time.monotonic()
        host = (frames_u8_local if isinstance(frames_u8_local, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(frames_u8_local)))
        partial = chunk_len % self.n_shards != 0
        if partial:
            if host.shape[0] != chunk_len:
                raise ValueError(f"a partial chunk is processed whole on every process: "
                                 f"{host.shape[0]} of {chunk_len} frames given")
            frames = host.to(self.shards.home)
        else:
            per = chunk_len // self.n_shards
            if host.shape[0] != per * len(self.shards.devices):
                raise ValueError(f"{host.shape[0]} frames given; this process holds "
                                 f"{len(self.shards.devices)} shards of {per}")
            frames = [host[j * per:(j + 1) * per].to(d)
                      for j, d in enumerate(self.shards.devices)]
        if timings is not None:
            self._sync()
            t1 = time.monotonic()
            timings["h2d_s"] = timings.get("h2d_s", 0.0) + (t1 - t0)
            timings.setdefault("h2d_chunks", []).append(t1 - t0)
            t0 = t1
        if partial:
            self.state, (outs, pre) = self.proc._chunk_raw(self.state, frames)
            outs, pre = [outs], [pre]
        else:
            self.state, (outs, pre) = self.proc._chunk_raw(self.state, frames,
                                                           shards=self.shards)
        self.cursor += chunk_len
        if timings is not None:
            self._sync()
            t1 = time.monotonic()
            timings["process_s"] = timings.get("process_s", 0.0) + (t1 - t0)
            timings.setdefault("process_chunks", []).append(t1 - t0)
        processed = _fetch(outs)
        original = _fetch(pre) if fetch_original else None
        if timings is not None:
            timings["fetch_s"] = timings.get("fetch_s", 0.0) + (time.monotonic() - t1)
        return processed, original


def _fetch(parts) -> np.ndarray:
    """The shards' [T_k, ...] outputs as one host array, each copied from its
    device straight into its rows (no second host copy)."""
    out = np.empty((sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:]),
                   dtype=np.dtype(str(parts[0].dtype).removeprefix("torch.")))
    row = 0
    for p in parts:
        torch.from_numpy(out[row:row + p.shape[0]]).copy_(p)
        row += p.shape[0]
    return out


def export_video_distributed(
    input_path: str,
    output_path: str,
    cfg: ProcessorConfig,
    mesh: Optional[Mesh] = None,
    chunk: int = 32,
    file_fps: Optional[float] = None,
    start: int = 0,
    end: Optional[int] = None,
    keep_parts: bool = False,
    split=None,                 # SplitMode; None/NONE = processed only
    labels: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    stats: Optional[dict] = None,
    prefetch: bool = True,
    decode_workers: int = 2,
    device=None,
) -> str:
    """The distributed export, one entry point: every process calls it with
    the same arguments; process 0 returns the final path, the others their
    last part's.

    Decode -> shard -> process -> encode a chunk at a time; part files are
    named ``<out>.c<chunk>s<shard><ext>``, so the concatenation order
    (chunk, shard) is the frame order. ``chunk`` is rounded down to a
    multiple of the shards (at least one each).

    prefetch=True overlaps the host stages with the devices: a pool of
    ``decode_workers`` threads decodes the next chunks (each an independent
    decode at its own offset) and an encode thread writes finished chunks;
    chunks still reach the devices strictly in order. prefetch=False is the
    serial path (the same output).

    ``split`` / ``labels`` compose original|processed panes as the GUI
    export does. ``checkpoint_path`` enables resume in ClipProcessor's
    format; a checkpoint is written only once its chunks' parts are on disk,
    and once more at the end, so a rerun of a finished export returns the
    output. ``stats``, if given, gets {"frames": frames processed by this
    export, "devices": the shards of the mesh} and the stage seconds {"decode_s", "process_s", "fetch_s",
    "encode_s", "concat_s", "wall_s"}. ``device``: as for
    ``DistributedClipExporter`` when ``mesh`` is None."""
    from live_video_magnification_tpu_torch.export.exporter import clip_hwc, clip_tchw
    from live_video_magnification_tpu_torch.export.types import SplitMode
    from live_video_magnification_tpu_torch.io.video import (
        VideoWriterStream,
        concat_videos,
        iter_video,
        video_info,
    )

    split = split or SplitMode.NONE

    total, h, w, fps = video_info(input_path)
    probe = next(iter_video(input_path, start, start + 1), None)
    if probe is None:
        raise IOError(f"no frames decoded from {input_path}")
    channels = 1 if probe.ndim == 2 else probe.shape[2]
    h, w = probe.shape[0], probe.shape[1]
    end = end if end is not None else (total or None)
    if end is None:
        raise ValueError("distributed export needs a known frame count")

    exp = DistributedClipExporter(cfg, h, w, channels, mesh=mesh, device=device)
    n = exp.n_shards
    chunk = max(n, (chunk // n) * n)
    out_fps = file_fps or fps
    base, ext = os.path.splitext(output_path)
    rank = exp.rank

    resume_at = start
    if checkpoint_path and os.path.exists(checkpoint_path + ".npz"):
        resume_at = start + exp.load_checkpoint(checkpoint_path)

    import queue as _queue
    import threading

    t_wall0 = time.monotonic()
    timings: dict = {}

    # the chunk plan, built up front so the decode pool and the main loop
    # walk the same schedule: (ci, pos, clen, rows, partial)
    part_paths: List[Tuple[int, int, str]] = []  # (chunk_index, shard, path)
    expected: List[Tuple[int, int, str]] = []    # every part this run's output needs
    plan = []
    ci = 0
    pos = start
    while pos < end:
        clen = min(chunk, end - pos)
        partial = clen % n != 0
        if not partial:
            rows = exp.local_rows(clen)
            for sh in range(n):
                expected.append((ci, sh, f"{base}.c{ci:04d}s{sh:03d}{ext}"))
        else:  # the partial tail: every process decodes and processes all of it
            rows = [(0, 0, clen)]
            expected.append((ci, 0, f"{base}.c{ci:04d}s{0:03d}{ext}"))
        if pos + clen > resume_at:
            plan.append((ci, pos, clen, rows, partial))
        # else: finished before the checkpoint, whose parts are on disk
        # (checkpoints follow their parts): reused, neither decoded nor run
        pos += clen
        ci += 1

    t_lock = threading.Lock()

    def _acc(key: str, dt: float) -> None:
        with t_lock:  # decode runs in a pool
            timings[key] = timings.get(key, 0.0) + dt
            timings.setdefault(key[:-2] + "_chunks", []).append(dt)

    def decode_chunk(item) -> np.ndarray:
        _ci, cpos, _clen, rows, _partial = item
        t0 = time.monotonic()
        frames = []
        for _sh, a, b in rows:
            frames.extend(f if f.ndim == 3 else f[..., None]
                          for f in iter_video(input_path, cpos + a, cpos + b))
        want = sum(b - a for _sh, a, b in rows)
        if len(frames) != want:
            # containers misreport frame counts (video_info says so): fail
            # here with the cause, not as a shape mismatch in the shards
            raise IOError(
                f"decoder returned {len(frames)} of {want} frames for chunk {_ci} at "
                f"{cpos} — the container's frame count is wrong; pass an explicit end= "
                "within the decodable range")
        local = clip_tchw(frames)
        _acc("decode_s", time.monotonic() - t0)
        return local

    def encode_chunk(item, processed: np.ndarray, original: Optional[np.ndarray]):
        _ci, _cpos, _clen, rows, partial = item
        t0 = time.monotonic()
        off = 0
        for sh, a, b in rows:
            seg = processed[off:off + (b - a)]
            orig_seg = original[off:off + (b - a)] if original is not None else None
            off += b - a
            if partial and rank != 0:
                continue  # the tail chunk is written once
            wtr = VideoWriterStream(f"{base}.c{_ci:04d}s{sh:03d}{ext}", out_fps)
            wtr.write_chunk(clip_hwc(seg, orig_seg, split, labels))
            part_paths.append((_ci, sh, wtr.close()))
        _acc("encode_s", time.monotonic() - t0)

    def maybe_checkpoint(item, drain=None):
        _ci, _cpos, clen, _rows, _partial = item
        if (checkpoint_path and checkpoint_every and rank == 0
                and (exp.cursor % checkpoint_every) < clen):
            if drain is not None:
                drain()  # every checkpointed chunk's parts on disk first
            exp.save_checkpoint(checkpoint_path)

    need_orig = split is not SplitMode.NONE

    if not prefetch:
        for item in plan:
            local = decode_chunk(item)
            processed, original = exp.process_chunk(local, item[2], timings=timings,
                                                    fetch_original=need_orig)
            encode_chunk(item, processed, original)
            maybe_checkpoint(item)
    else:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        to_encode: _queue.Queue = _queue.Queue(maxsize=2)
        encode_err: List[BaseException] = []

        def encode_worker():
            while True:
                got = to_encode.get()
                try:
                    if got is None:
                        return
                    if not encode_err:  # stop writing after an error
                        encode_chunk(*got)
                except BaseException as e:
                    encode_err.append(e)
                finally:
                    to_encode.task_done()

        def drain_encode():
            to_encode.join()
            if encode_err:
                raise encode_err[0]

        enc_t = threading.Thread(target=encode_worker, daemon=True)
        enc_t.start()
        pool = ThreadPoolExecutor(max_workers=max(1, decode_workers),
                                  thread_name_prefix="lvmt-decode")
        try:
            inflight: deque = deque()
            pending = iter(plan)

            def top_up():
                # decoded chunks in memory: at most workers + 1
                while len(inflight) < max(2, decode_workers + 1):
                    item = next(pending, None)
                    if item is None:
                        return
                    inflight.append((item, pool.submit(decode_chunk, item)))

            top_up()
            while inflight:
                item, fut = inflight.popleft()
                local = fut.result()  # decode errors surface here, in order
                top_up()
                processed, original = exp.process_chunk(local, item[2], timings=timings,
                                                        fetch_original=need_orig)
                to_encode.put((item, processed, original))
                maybe_checkpoint(item, drain=drain_encode)
            drain_encode()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            to_encode.put(None)  # stop the encoder
            enc_t.join(timeout=60)

    if checkpoint_path and checkpoint_every and rank == 0 and plan:
        # the final save: a finished run's checkpoint reads cursor == end, so
        # a rerun returns the finished output below (the periodic save misses
        # a last chunk whose cursor % checkpoint_every lands inside it)
        exp.save_checkpoint(checkpoint_path)

    if exp.shards.group is not None:
        import torch.distributed as dist

        dist.barrier()  # every process's parts are on disk before the concat
    if stats is not None:
        stats["frames"] = exp.cursor
        stats["devices"] = n
        stats.update(timings)
        stats["wall_s"] = time.monotonic() - t_wall0
    if rank != 0:
        return part_paths[-1][2] if part_paths else output_path

    # process 0: concatenate exactly this run's expected parts, in (chunk,
    # shard) order, never a glob, so stale parts of an older run on the same
    # output path are not merged. Across hosts the parts live on shared
    # storage under the same names.
    if resume_at >= end and os.path.exists(output_path):
        # the checkpoint says every chunk finished: an earlier run already
        # concatenated (and by default deleted) the parts
        return output_path
    missing = [p for _c, _s, p in expected if not os.path.exists(p)]
    if missing:
        raise IOError(
            f"distributed export: {len(missing)} expected part file(s) missing (first: "
            f"{missing[0]}) — on several hosts, parts must land on storage shared with "
            "process 0")
    t_cc = time.monotonic()
    final = concat_videos([p for _c, _s, p in expected], output_path, out_fps)
    if not keep_parts:
        for _c, _s, p in expected:
            if os.path.abspath(p) != os.path.abspath(final):
                os.unlink(p)
    if stats is not None:
        stats["concat_s"] = time.monotonic() - t_cc
        stats["wall_s"] = time.monotonic() - t_wall0
    return final
