"""The port's ctypes adapter to the native C++ transport (``engine/native.py``).

The cases of the reference suite's ``tests/test_native.py`` on the port's
adapter: the C pool, queue, mailbox and counters, the engine adapters
(``NativeFramePoolAdapter``, ``NativeQueueAdapter``) and a controller that
runs on them (``LVMT_NATIVE=1``). They skip only where the library neither
loads nor builds, as the reference's do. Also: the checked-in library is
loaded read-only, and a library that does not load is rebuilt from
``native/lvmt_core.cpp`` under ``build/``, never under ``native/``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch.engine import native
from live_video_magnification_tpu_torch.engine.queue import OverflowPolicy

torch.set_num_threads(2)

DEADLINE_S = 20.0


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("the native transport library neither loads nor builds here")
    return native.load()


def _meta(seq, idx):
    m = native.FrameMeta()
    m.seq = seq
    m.buffer_index = idx
    m.width = 4
    m.height = 4
    m.channels = 3
    return m


def test_pool_acquire_release_and_views(lib):
    pool = native.NativeFramePool(2, 4 * 4 * 3)
    a = pool.acquire()
    b = pool.acquire()
    assert a is not None and b is not None and a != b
    buf = pool.buffer(a, (4, 4, 3))
    buf[:] = 7
    assert pool.buffer(a, (4, 4, 3))[0, 0, 0] == 7  # same memory
    got = []
    t = threading.Thread(target=lambda: got.append(pool.acquire()))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # blocked: exhausted
    pool.release(a)
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive() and got == [a]
    pool.stop()
    assert pool.acquire() is None


def test_queue_block_and_drop(lib):
    pool = native.NativeFramePool(8, 16)
    q = native.NativeQueue(2, drop_policy=False, pool=pool)
    idxs = [pool.acquire() for _ in range(4)]
    assert q.push(_meta(0, idxs[0]))
    assert q.push(_meta(1, idxs[1]))
    pushed = []
    t = threading.Thread(target=lambda: pushed.append(q.push(_meta(2, idxs[2]))))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # BLOCK policy: full
    assert q.pop().seq == 0
    t.join(timeout=DEADLINE_S)
    assert pushed == [True]

    q2 = native.NativeQueue(2, drop_policy=True, pool=pool)
    q2.push(_meta(10, idxs[0]))
    q2.push(_meta(11, idxs[1]))
    q2.push(_meta(12, idxs[3]))  # evicts seq 10, recycles its buffer
    assert q2.drops == 1
    assert q2.pop().seq == 11
    assert q2.pop().seq == 12
    assert q2.pop(timeout_ms=10.0) is None


def test_queue_stop_unblocks(lib):
    pool = native.NativeFramePool(2, 16)
    q = native.NativeQueue(1, drop_policy=False, pool=pool)
    results = []
    t = threading.Thread(target=lambda: results.append(q.pop()))
    t.start()
    time.sleep(0.05)
    q.stop()
    t.join(timeout=DEADLINE_S)
    assert results == [None]


def test_mailbox_latest_wins(lib):
    mb = native.NativeMailbox()
    assert mb.latest() is None
    mb.publish(_meta(1, 0))
    mb.publish(_meta(2, 1))
    assert mb.latest().seq == 2
    mb.clear()
    assert mb.latest() is None


def test_stats_counters_and_histogram(lib):
    st = native.NativeInstrumentation()
    for _ in range(10):
        st.bump(native.PROCESSED)
    st.record_latency(0.003)   # bucket 0
    st.record_latency(0.012)   # bucket 2
    counts, mean_ms, p95_ms = st.read()
    assert counts[native.PROCESSED] == 10
    assert 3.0 < mean_ms < 12.0
    assert p95_ms >= 10.0


# ---------------------------------------------------------------- the engine adapters


def test_adapter_pool_and_queue_roundtrip(lib):
    pool = native.NativeFramePoolAdapter(4, 64 * 64 * 3)
    q = native.NativeQueueAdapter(2, pool)
    f = pool.acquire(8, 10, 3)
    assert f is not None and f.data.shape == (8, 10, 3)
    f.data[:] = 7
    f.seq, f.pts_us, f.capture_ts = 42, 1234, 1.5
    assert q.push(f)
    assert f._release is None  # ownership moved into the C queue
    g = q.pop(timeout=1.0)
    assert g is not None
    assert (g.seq, g.pts_us, g.capture_ts) == (42, 1234, 1.5)
    np.testing.assert_array_equal(g.data, np.full((8, 10, 3), 7, np.uint8))
    g.release()  # slot back to the arena
    frames = [pool.acquire(8, 10, 3) for _ in range(4)]  # all 4 slots again
    assert all(fr is not None for fr in frames)
    for fr in frames:
        fr.release()


def test_adapter_drop_policy_recycles_slots(lib):
    pool = native.NativeFramePoolAdapter(3, 16 * 16 * 3)
    q = native.NativeQueueAdapter(1, pool)
    q.set_policy(OverflowPolicy.DROP)
    for i in range(3):
        f = pool.acquire(4, 4, 3)
        assert f is not None  # dropped slots recycle C-side, the pool never starves
        f.seq = i
        assert q.push(f)
    assert q.drops == 2
    g = q.pop(timeout=1.0)
    assert g.seq == 2  # oldest evicted
    g.release()


def test_adapter_refuses_frames_over_the_slot(lib):
    pool = native.NativeFramePoolAdapter(2, 8 * 8 * 3)
    with pytest.raises(RuntimeError, match="LVMT_NATIVE_MAX_FRAME"):
        pool.acquire(9, 9, 3)
    gray = pool.acquire(8, 8, 1)
    assert gray.data.shape == (8, 8) and gray.channels == 1
    gray.release()


def test_native_transport_full_pipeline(lib, monkeypatch):
    """PlaybackController with LVMT_NATIVE=1: synthetic source -> C queue ->
    processing chain -> mailbox; frames processed, also after a stop and a
    rebuild."""
    monkeypatch.setenv("LVMT_NATIVE", "1")
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController

    ctrl = PlaybackController(device="cpu")
    try:
        assert isinstance(ctrl._pool, native.NativeFramePoolAdapter)
        assert isinstance(ctrl._queue, native.NativeQueueAdapter)
        assert ctrl.open_synthetic(h=32, w=40, fps=120.0, n_frames=40)
        ctrl.play()
        end = time.monotonic() + DEADLINE_S
        while time.monotonic() < end and ctrl.stats().processed < 10:
            time.sleep(0.02)
        s = ctrl.stats()
        assert s.processed >= 10, f"only {s.processed} processed"
        assert ctrl.mailbox.latest() is not None
        assert s.proc_errors == 0
        ctrl.stop()
        ctrl.play()
        end = time.monotonic() + DEADLINE_S
        while time.monotonic() < end and ctrl.stats().processed < 5:
            time.sleep(0.02)
        assert ctrl.stats().processed >= 5
    finally:
        ctrl.close()


def test_adapter_failed_push_releases_slot(lib):
    """A push refused by a stopped queue recycles the arena slot."""
    pool = native.NativeFramePoolAdapter(2, 8 * 8 * 3)
    q = native.NativeQueueAdapter(1, pool)
    q.stop()
    f = pool.acquire(4, 4, 3)
    assert f is not None
    assert not q.push(f)
    a = pool.acquire(4, 4, 3)
    b = pool.acquire(4, 4, 3)
    assert a is not None and b is not None
    a.release()
    b.release()


def test_python_transport_by_default(monkeypatch):
    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.engine.pool import FramePool

    monkeypatch.delenv("LVMT_NATIVE", raising=False)
    assert isinstance(PlaybackController(device="cpu")._pool, FramePool)


# ---------------------------------------------------------------- loading and building


def _native_files():
    d = native._REPO_ROOT / "native"
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in d.iterdir()}


def test_loads_the_checked_in_library_without_writing_native(monkeypatch):
    before = _native_files()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compile", lambda: pytest.fail("compiled a loadable library"))
    if native.load() is None:
        pytest.skip("the checked-in library does not load here")
    assert _native_files() == before


def test_a_library_that_does_not_load_is_built_under_build(monkeypatch, tmp_path):
    """A checked-in library that does not load (another platform) is rebuilt
    from the source with g++ into build/lvmt_native/ and loaded from there."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ here to build the native library")
    bogus = tmp_path / "liblvmt_core.so"
    bogus.write_bytes(b"not a shared library")
    before = _native_files()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", bogus)
    lib = native.load()
    assert lib is not None
    built = native.build_path()
    assert built.exists() and built.parent == native._REPO_ROOT / "build" / "lvmt_native"
    assert _native_files() == before
    monkeypatch.setattr(native, "_lib", lib)
    pool = native.NativeFramePoolAdapter(2, 4 * 4 * 3)
    f = pool.acquire(4, 4, 3)
    f.data[:] = 3
    f.release()
    assert os.path.samefile(built, lib._name)
