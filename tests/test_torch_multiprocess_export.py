"""Two real processes running the port's distributed export
(tests/test_multiprocess_export.py's three tests): 2 ranks of 4 CPU shards
each over a gloo group on a local TCP address, against the port's export of
the same clip as 8 shards in this process. The decoded output is bit for bit
the same (the shards compute alike in either layout, and MJPG is
deterministic); the missing-parts error names shared storage; a checkpoint
written by one two-process run resumes in another.

The ranks run tests/torch_mp_export_worker.py, which imports the port only.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from live_video_magnification_tpu_torch.io.video import read_video
from live_video_magnification_tpu_torch.parallel.batch_export import export_video_distributed
from live_video_magnification_tpu_torch.parallel.mesh import make_mesh

from test_torch_distributed import _phase_cfg, _tiny_clip

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_export_worker.py")
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_ranks(args_per_rank):
    """Start both ranks, wait for both; [(returncode, last-line JSON, stderr)]
    in rank order. On a timeout only the processes started here are killed."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "LVMT_DISTRIBUTED")}
    procs = [subprocess.Popen([sys.executable, _WORKER, str(rank), *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for rank, args in enumerate(args_per_rank)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            payload = None
            for ln in reversed([ln for ln in stdout.splitlines() if ln.strip()]):
                try:
                    payload = json.loads(ln)
                    break
                except json.JSONDecodeError:
                    continue
            out.append((p.returncode, payload, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _single_process(clip, out):
    return export_video_distributed(clip, out, _phase_cfg(), chunk=8,
                                     mesh=make_mesh((8,), ("time",), ["cpu"] * 8))


def test_two_process_export_matches_single_process(tmp_path):
    """A full chunk (8 over 2x4 shards) and a 6-frame tail that both ranks run
    unsharded: the decoded output equals the 8-shard single-process export;
    the gloo backend is reported; rank 1 returns its last part."""
    clip = _tiny_clip(tmp_path, t=14)
    port = _free_port()
    out_mp = str(tmp_path / "mp.avi")
    results = _run_two_ranks([[port, clip, out_mp], [port, clip, out_mp]])
    for rank, (rc, payload, stderr) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{stderr[-3000:]}"
        assert payload is not None and payload["error"] is None, payload
        assert payload["backend"] == "gloo"
    assert results[0][1]["final"] == out_mp
    assert results[0][1]["frames"] == 14
    assert results[1][1]["final"] != out_mp

    out_sp = str(tmp_path / "sp.avi")
    _single_process(clip, out_sp)
    got, _ = read_video(out_mp)
    want, _ = read_video(out_sp)
    assert got.shape == want.shape == (14,) + want.shape[1:]
    np.testing.assert_array_equal(got, want)
    assert not list(tmp_path.glob("mp.c*s*.avi"))


def test_two_process_missing_parts_is_coordinator_error(tmp_path):
    """Storage that is not shared: rank 1 writes its parts where rank 0
    cannot see them. Rank 0 fails with the missing-parts IOError naming
    shared storage; rank 1 finishes."""
    clip = _tiny_clip(tmp_path, t=8)
    port = _free_port()
    shared, private = tmp_path / "shared", tmp_path / "private"
    shared.mkdir()
    private.mkdir()
    results = _run_two_ranks([[port, clip, str(shared / "out.avi")],
                              [port, clip, str(private / "out.avi")]])
    rc0, payload0, stderr0 = results[0]
    rc1, payload1, _ = results[1]
    assert rc0 == 1, f"rank 0 should have failed; stderr:\n{stderr0[-2000:]}"
    assert payload0 is not None and "missing" in payload0["error"]
    assert "shared" in payload0["error"]
    assert rc1 == 0 and payload1["error"] is None
    assert not (shared / "out.avi").exists()


def test_two_process_checkpoint_resume(tmp_path):
    """Run A exports [0, 8) with a checkpoint (parts kept); run B resumes to
    the end on both ranks, reusing chunk 0's parts. The file equals the
    uninterrupted single-process export."""
    clip = _tiny_clip(tmp_path, t=16)
    out = str(tmp_path / "mp.avi")
    ck = str(tmp_path / "ck")
    port = _free_port()
    results = _run_two_ranks([[port, clip, out, 8, ck, "keep"],
                              [port, clip, out, 8, ck, "keep"]])
    for rank, (rc, _payload, stderr) in enumerate(results):
        assert rc == 0, f"run A rank {rank} failed:\n{stderr[-2000:]}"
    assert (tmp_path / "ck.npz").exists()
    port = _free_port()
    results = _run_two_ranks([[port, clip, out, "-", ck], [port, clip, out, "-", ck]])
    for rank, (rc, _payload, stderr) in enumerate(results):
        assert rc == 0, f"run B rank {rank} failed:\n{stderr[-2000:]}"

    out_sp = str(tmp_path / "sp.avi")
    _single_process(clip, out_sp)
    got, _ = read_video(out)
    want, _ = read_video(out_sp)
    assert got.shape[0] == 16
    np.testing.assert_array_equal(got, want)
