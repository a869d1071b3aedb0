"""The port's multi-process scaffolding and distributed export on the CPU
(tests/test_distributed.py's thirteen tests), against the reference JAX
package where that suite compares numbers: the port's
``DistributedClipExporter`` and ``export_video_distributed`` on a ("time",)
mesh of ``["cpu"] * 8`` against the reference's on its 8-device virtual mesh
and against the port's sequential ``ClipProcessor``. Besides: checkpoints
that move between the distributed exporter and ``ClipProcessor`` both ways,
the readback without the original stack, and no fallback without a card.

Bars (the reference suite's): the distributed core within 1 u8 LSB; through
the codec (parts encoded once, the concat re-encodes without ffmpeg) max 48,
mean < 4.
"""


import numpy as np
import pytest

import jax
import torch

from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.parallel.batch_export import (
    DistributedClipExporter as JDistributedClipExporter,
)
from live_video_magnification_tpu.parallel.batch_export import (
    export_video_distributed as jexport_video_distributed,
)
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.io import video as vio
from live_video_magnification_tpu_torch.io.video import read_video
from live_video_magnification_tpu_torch.models import params
from live_video_magnification_tpu_torch.parallel import distributed
from live_video_magnification_tpu_torch.parallel.batch_export import (
    DistributedClipExporter,
    export_video_distributed,
)
from live_video_magnification_tpu_torch.parallel.mesh import make_mesh

from test_distributed import _phase_cfg as _jax_phase_cfg
from test_distributed import _tiny_clip

torch.set_num_threads(2)

needs_jax_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                    reason="needs the 8-device virtual CPU mesh")


def _mesh():
    return make_mesh((8,), ("time",), ["cpu"] * 8)


def _phase_cfg(levels=2):
    return params.ProcessorConfig(
        preprocess=params.PreprocessParams(), grayscale=False,
        magnification=params.MagnificationParams(
            mode=params.MagnificationMode.PHASE, amplification=30.0, co_wavelength=40.0,
            co_low=0.5, co_high=3.0, levels=levels, framerate=30.0))


def _export(clip, out, cfg=None, **kw):
    return export_video_distributed(clip, out, cfg or _phase_cfg(), mesh=_mesh(), **kw)


def _tchw(clip_path):
    frames, fps = read_video(clip_path)
    return np.ascontiguousarray(np.moveaxis(frames, -1, 1)), fps


def _lsb(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _run_chunks(exp, tchw, bounds):
    """exp.process_chunk over [a, b) chunks, each process's rows of a full
    chunk (local_rows) or the whole of a partial one."""
    got = []
    for a, b in bounds:
        clen = b - a
        if clen % exp.n_shards == 0:
            local = np.concatenate([tchw[a + ra:a + rb] for _s, ra, rb in exp.local_rows(clen)])
        else:
            local = tchw[a:b]
        got.append(exp.process_chunk(local, clen)[0])
    return np.concatenate(got)


def test_initialize_is_noop_single_process(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "LVMT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.layout() is None


def test_global_mesh_shapes():
    mesh = distributed.global_mesh(("batch", "tile"), device="cpu")
    assert mesh.shape == {"batch": 1, "tile": 1}
    mesh = distributed.global_mesh(("batch", "tile"), tile_per_host=True, device="cpu")
    assert mesh.shape == {"batch": 1, "tile": 1}  # one process: one host
    mesh = distributed.global_mesh(("time",), device="cpu")
    assert mesh.shape == {"time": 1} and list(mesh.owned(0)) == [0]


def test_scaling_harness_runs_sharded_phase_step():
    from live_video_magnification_tpu_torch.models.riesz import RieszDynParams
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
        build_sharded_riesz_step,
    )

    h, w, levels = 64, 256, 2
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(hz, 30.0) for hz in (0.5, 3.0))
    dyn = RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo), c3(a_lo), c3(b_hi),
                         c3(a_hi), False, False)
    frames = torch.from_numpy(
        np.random.default_rng(3).integers(0, 255, (1, 3, h, w), dtype=np.uint8))

    def build(mesh):  # a mesh of 1 takes the unsharded plan: no row-sharded fallback
        return build_sharded_riesz_step(mesh, 1, h, w, levels)

    r = distributed.measure_scaling_efficiency(build, lambda mesh: (frames, dyn), steps=3,
                                               devices=["cpu"] * 8)
    assert r["devices"] == 8
    assert r["fps_1"] > 0 and r["fps_n"] > 0
    assert 0 < r["efficiency"]  # mechanics only: CPU numbers say nothing of a card


# --- the distributed export ---------------------------------------------------------------------


@needs_jax_mesh
def test_distributed_chunks_match_sequential_clip_processor(tmp_path):
    """The T-sharded core, the state carried across a full chunk of 8 and a
    partial tail of 6, against the reference's DistributedClipExporter and
    the port's sequential ClipProcessor chunked otherwise."""
    tchw, _ = _tchw(_tiny_clip(tmp_path, t=14))
    h, w = tchw.shape[2:]
    exp = DistributedClipExporter(_phase_cfg(), h, w, 3, mesh=_mesh())
    assert exp.n_shards == 8 and exp.backend is None
    got = _run_chunks(exp, tchw, [(0, 8), (8, 14)])
    jexp = JDistributedClipExporter(_jax_phase_cfg(), h, w, 3)
    assert jexp.n_shards == 8
    ref = _run_chunks(jexp, tchw, [(0, 8), (8, 14)])
    seq = ClipProcessor(_phase_cfg(), h, w, 3, device="cpu")
    want = np.concatenate([seq.process_chunk(tchw[a:b])[0] for a, b in [(0, 7), (7, 14)]])
    assert got.shape == want.shape == tchw.shape
    assert _lsb(got, ref) <= 1, f"{_lsb(got, ref)} LSB against the reference's exporter"
    assert _lsb(got, want) <= 1, f"{_lsb(got, want)} LSB against the sequential path"


@needs_jax_mesh
def test_export_video_distributed_end_to_end(tmp_path):
    """Decode per shard, T-sharded process, encode per shard, concat in
    order: one file with every frame, no parts left; the content against
    the sequential ClipProcessor through the same codec and against the
    reference's distributed export."""
    import cv2

    clip_path = _tiny_clip(tmp_path, t=14)
    out = str(tmp_path / "out.avi")
    final = _export(clip_path, out, chunk=8)
    assert final == out
    got, _ = read_video(final)
    assert got.shape[0] == 14
    assert not list(tmp_path.glob("out.c*s*.avi"))

    tchw, fps = _tchw(clip_path)
    p, _o = ClipProcessor(_phase_cfg(), tchw.shape[2], tchw.shape[3], 3,
                          device="cpu").process_chunk(tchw)
    ref_path = str(tmp_path / "ref.avi")
    wtr = cv2.VideoWriter(ref_path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                          (tchw.shape[3], tchw.shape[2]))
    for f in np.moveaxis(p, 1, -1):
        wtr.write(np.ascontiguousarray(f))
    wtr.release()
    jout = jexport_video_distributed(clip_path, str(tmp_path / "jax.avi"), _jax_phase_cfg(),
                                     chunk=8)
    for other in (read_video(ref_path)[0], read_video(jout)[0]):
        d = np.abs(got.astype(np.int16) - other.astype(np.int16))
        assert d.max() <= 48, f"max decoded diff {d.max()}"
        assert np.mean(d) < 4.0


def test_export_video_distributed_ignores_stale_parts(tmp_path):
    clip_path = _tiny_clip(tmp_path, t=8)
    out = str(tmp_path / "out.avi")
    stale = tmp_path / "out.c0099s000.avi"
    stale.write_bytes(b"STALE")
    got, _ = read_video(_export(clip_path, out, chunk=8))
    assert got.shape[0] == 8
    assert stale.read_bytes() == b"STALE"


def test_export_video_distributed_split_and_resume(tmp_path):
    """--split panes through the distributed program; a checkpointed run
    over [0, 8) with its parts kept, then a resume to the end."""
    from live_video_magnification_tpu_torch.export.types import SplitMode

    clip_path = _tiny_clip(tmp_path, t=16)
    final = _export(clip_path, str(tmp_path / "split.avi"), chunk=8,
                    split=SplitMode.LEFT_RIGHT, labels=True)
    got, _ = read_video(final)
    assert got.shape[0] == 16 and got.shape[2] == 160

    out_r = str(tmp_path / "resume.avi")
    ck = str(tmp_path / "ck")
    _export(clip_path, out_r, chunk=8, end=8, checkpoint_path=ck, checkpoint_every=8,
            keep_parts=True)
    assert (tmp_path / "ck.npz").exists()
    got, _ = read_video(_export(clip_path, out_r, chunk=8, checkpoint_path=ck))
    assert got.shape[0] == 16


def test_export_video_distributed_rerun_after_complete_returns_output(tmp_path):
    clip_path = _tiny_clip(tmp_path, t=8)
    out = str(tmp_path / "out.avi")
    ck = str(tmp_path / "ck")
    _export(clip_path, out, chunk=8, checkpoint_path=ck, checkpoint_every=8)
    before = read_video(out)[0]
    final = _export(clip_path, out, chunk=8, checkpoint_path=ck)
    assert final == out
    np.testing.assert_array_equal(read_video(final)[0], before)


def test_export_video_distributed_resume_with_deleted_parts_errors(tmp_path):
    clip_path = _tiny_clip(tmp_path, t=16)
    out = str(tmp_path / "out.avi")
    ck = str(tmp_path / "ck")
    _export(clip_path, out, chunk=8, end=8, checkpoint_path=ck, checkpoint_every=8)
    with pytest.raises(IOError, match="missing"):
        _export(clip_path, out, chunk=8, checkpoint_path=ck)


def test_export_prefetch_pipeline_matches_serial_and_reports_stages(tmp_path):
    clip_path = _tiny_clip(tmp_path, t=22)  # 2 full chunks and a 6-frame tail
    out_p, out_s = str(tmp_path / "pipelined.avi"), str(tmp_path / "serial.avi")
    st_p: dict = {}
    st_s: dict = {}
    _export(clip_path, out_p, chunk=8, stats=st_p)
    _export(clip_path, out_s, chunk=8, stats=st_s, prefetch=False)
    np.testing.assert_array_equal(read_video(out_p)[0], read_video(out_s)[0])
    for st in (st_p, st_s):
        assert st["frames"] == 22 and st["devices"] == 8
        for k in ("decode_s", "h2d_s", "process_s", "fetch_s", "encode_s", "concat_s",
                  "wall_s"):
            assert st[k] > 0, (k, st)


def test_local_rows_rejects_partial_chunk():
    exp = DistributedClipExporter(_phase_cfg(), 64, 80, 3, mesh=_mesh())
    with pytest.raises(ValueError, match="shard-divisible"):
        exp.local_rows(6)
    assert exp.local_rows(16) == [(k, 2 * k, 2 * k + 2) for k in range(8)]


@needs_jax_mesh
def test_export_video_distributed_grayscale_roi_laplace(tmp_path):
    """ROI crop, 1/2 downscale, grayscale and motion mode through the
    T-sharded core, against the reference's exporter and the sequential
    ClipProcessor."""
    tchw, _ = _tchw(_tiny_clip(tmp_path, t=8))
    h, w = tchw.shape[2:]

    def cfg(p):
        return p.ProcessorConfig(
            grayscale=True,
            preprocess=p.PreprocessParams(downscale=2, roi_enabled=True, roi_x=0.1,
                                          roi_y=0.1, roi_w=0.8, roi_h=0.8),
            magnification=p.MagnificationParams(
                mode=p.MagnificationMode.LAPLACE, amplification=15.0, co_wavelength=200.0,
                co_low=0.3, co_high=0.7, levels=2, framerate=30.0))

    exp = DistributedClipExporter(cfg(params), h, w, 3, mesh=_mesh())
    processed = _run_chunks(exp, tchw, [(0, 8)])
    ref = _run_chunks(JDistributedClipExporter(cfg(jparams), h, w, 3), tchw, [(0, 8)])
    want, _o = ClipProcessor(cfg(params), h, w, 3, device="cpu").process_chunk(tchw)
    assert processed.shape == want.shape == ref.shape  # ROI and downscale applied
    assert _lsb(processed, want) <= 1 and _lsb(processed, ref) <= 1


def test_export_short_decode_fails_with_cause(tmp_path, monkeypatch):
    """A container that claims more frames than it decodes fails with the
    decoder-shortfall IOError naming the chunk."""
    clip_path = _tiny_clip(tmp_path, t=8)
    real_iter = vio.iter_video

    def short_iter(path, start=0, end=None):
        yield from real_iter(path, start, min(end or 6, 6))

    monkeypatch.setattr(vio, "iter_video", short_iter)
    with pytest.raises(IOError, match="frame count is wrong"):
        _export(clip_path, str(tmp_path / "out.avi"), chunk=8, end=8)


# --- besides the reference suite ---------------------------------------------------------------------


@pytest.mark.parametrize("first", ["distributed", "clip_processor"])
def test_checkpoints_move_between_the_exporter_and_clip_processor(first, tmp_path):
    """A checkpoint of either resumes in the other, and the frames equal the
    uninterrupted distributed run within 1 LSB."""
    tchw, _ = _tchw(_tiny_clip(tmp_path, t=16))
    h, w = tchw.shape[2:]
    whole = _run_chunks(DistributedClipExporter(_phase_cfg(), h, w, 3, mesh=_mesh()), tchw,
                        [(0, 8), (8, 16)])
    ck = str(tmp_path / "ck")
    dist_exp = lambda: DistributedClipExporter(_phase_cfg(), h, w, 3, mesh=_mesh())
    seq = lambda: ClipProcessor(_phase_cfg(), h, w, 3, time_parallel=True, device="cpu")
    a, b = (dist_exp(), seq()) if first == "distributed" else (seq(), dist_exp())
    run = lambda p, lo, hi: (_run_chunks(p, tchw, [(lo, hi)]) if isinstance(p, DistributedClipExporter)
                             else p.process_chunk(tchw[lo:hi])[0])
    head = run(a, 0, 8)
    a.save_checkpoint(ck)
    assert b.load_checkpoint(ck) == 8
    tail = run(b, 8, 16)
    got = np.concatenate([head, tail])
    assert _lsb(got, whole) <= 1


def test_process_chunk_without_the_original_and_with_timings():
    tchw = np.random.default_rng(4).integers(0, 255, (8, 3, 32, 40), dtype=np.uint8)
    exp = DistributedClipExporter(_phase_cfg(), 32, 40, 3, mesh=_mesh())
    timings: dict = {}
    processed, original = exp.process_chunk(tchw, 8, timings=timings, fetch_original=False)
    assert original is None and processed.shape == tchw.shape and exp.cursor == 8
    assert set(timings) >= {"h2d_s", "process_s", "fetch_s"}
    _, original = exp.process_chunk(tchw, 8)
    np.testing.assert_array_equal(original, tchw)


def test_exporter_defaults_to_the_cards_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedClipExporter(_phase_cfg(), 32, 40, 3)
    exp = DistributedClipExporter(_phase_cfg(), 32, 40, 3, device="cpu")
    assert exp.n_shards == 1 and exp.shards.devices == (torch.device("cpu"),)
