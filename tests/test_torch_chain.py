"""The port's phase slice end to end on the CPU against the reference package:
the step, the chain (first-frame passthrough, cutoff change, degenerate
cutoff, ROI + downscale + grayscale), state carried across from a JAX run,
clip processing and checkpoints, the rule that sends the clip export's
frames through its CUDA graph and the host inputs of the steps it captures,
the kernel flags' table and the checkpoint digest it feeds, and the device
rule of the entry points.

Bars: >= 40 dB PSNR per frame (the reference suite's oracle bar) and at most
1 u8 LSB anywhere; bit-equal where the port runs the same step twice.
"""

import contextlib
import dataclasses
import functools
import inspect
import math
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.models.chain import MagnificationChain as JChain
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.convert import (
    riesz_dyn_from_jax,
    riesz_state_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.export import batch
from live_video_magnification_tpu_torch.export.batch import (
    ClipProcessor,
    export_frames,
    replays,
    stages,
)
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.chain import MagnificationChain as TChain
from live_video_magnification_tpu_torch.models.chain import _build_step, _StaticKey
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

H, W, T = 64, 96, 6


@functools.lru_cache(maxsize=None)
def _clip(seed=1):
    return moving_clip(T, H, W, seed=seed)


def _jax_dyn(lo=0.5, hi=3.0, fps=30.0, alpha=30.0, wavelength=40.0):
    b_lo, a_lo = butterworth_bandpass_coeffs(lo, fps)
    b_hi, a_hi = butterworth_bandpass_coeffs(hi, fps)
    return jriesz.RieszDynParams(
        jnp.float32(alpha), jnp.float32(wavelength * math.pi / 100.0),
        jnp.asarray(b_lo, jnp.float32), jnp.asarray(a_lo, jnp.float32),
        jnp.asarray(b_hi, jnp.float32), jnp.asarray(a_hi, jnp.float32),
        jnp.asarray(False), jnp.asarray(False))


def _assert_frames_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    db = psnr_u8(got, ref)
    lsb = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
    assert db >= 40.0 and lsb <= 1, f"{what}: {db:.2f} dB, max {lsb} LSB"


@functools.lru_cache(maxsize=None)
def _jax_step(levels):
    return jax.jit(functools.partial(jriesz.step, levels=levels))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_step_matches_reference_step(levels):
    frames = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in _clip()]
    jdyn = _jax_dyn()
    tdyn = riesz_dyn_from_jax(jdyn)
    jstate = jriesz.init_state(H, W, levels)
    tstate = triesz.init_state(H, W, levels, device="cpu")
    moved = False
    for i, f in enumerate(frames):
        jstate, jout = _jax_step(levels)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels)
        _assert_frames_close(tout.numpy(), jout, f"levels={levels} frame {i}")
        if i == 0:
            np.testing.assert_array_equal(tout.numpy(), f)  # first-frame passthrough
        moved |= bool(np.any(tout.numpy() != f))
    assert moved or levels == 1
    jleaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    tleaves = state_to_numpy(tstate)
    assert len(jleaves) == len(tleaves) == 13 * levels - 9
    assert int(tleaves[0]) == int(jleaves[0]) == T
    n_old = 1 + 3 * levels
    for a, b in zip(tleaves[1:n_old], jleaves[1:n_old]):  # the prior pyramid
        np.testing.assert_allclose(a, b, atol=3e-4)
    # Filter planes: at a phase singularity (Riesz pair ~ 0) an ulp moves the
    # orientation by O(1), so a few isolated pixels may differ; the outputs
    # above hold the bar regardless.
    for a, b in zip(tleaves[n_old:], jleaves[n_old:]):
        off = ~np.isclose(a, b, atol=2e-3, rtol=1e-4, equal_nan=True)
        assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} filter-state values differ"


def _cfg_pair(**kw):
    """(JAX config, port config) with the same values."""
    pre = kw.pop("pre", {})
    gray = kw.pop("grayscale", False)
    mag = dict(amplification=30.0, co_wavelength=40.0, co_low=0.5, co_high=3.0,
               levels=3, framerate=30.0)
    mag.update(kw)
    out = []
    for mod in (jparams, tparams):
        out.append(mod.ProcessorConfig(
            grayscale=gray,
            preprocess=mod.PreprocessParams(**pre),
            magnification=mod.MagnificationParams(mode=mod.MagnificationMode.PHASE, **mag)))
    return out


DEGENERATE_HZ = 13.0


def _coeffs_with_a_degenerate_cutoff(hz, fps):
    """Butterworth design, except DEGENERATE_HZ gives NaN coefficients: the
    designer never returns a NaN a[0] itself, so this is how a test reaches
    the chain's force_init re-init protocol (MagnifyCore.hpp:226)."""
    if hz == DEGENERATE_HZ:
        return np.full(3, np.nan), np.full(3, np.nan)
    return butterworth_bandpass_coeffs(hz, fps)


SCENARIOS = {
    # name: per-frame config overrides
    "steady": [{}] * T,
    "cutoff_change": [{}] * 3 + [{"co_high": 5.0}] * 3,
    "degenerate_cutoff": [{}] * 2 + [{"co_high": DEGENERATE_HZ}] * 2 + [{}] * 2,
    "roi_downscale": [{"pre": dict(roi_enabled=True, roi_x=0.1, roi_y=0.05, roi_w=0.8,
                                   roi_h=0.9, downscale=2)}] * T,
    "roi_downscale_gray": [{"grayscale": True,
                            "pre": dict(roi_enabled=True, roi_x=0.25, roi_y=0.0,
                                        roi_w=0.5, roi_h=1.0, downscale=2)}] * T,
}
PASSTHROUGH = {"degenerate_cutoff": {0, 2, 3}}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chain_matches_reference_chain(name, monkeypatch):
    from live_video_magnification_tpu.models import chain as jchain_mod
    from live_video_magnification_tpu_torch.models import chain as tchain_mod

    for mod in (jchain_mod, tchain_mod):
        monkeypatch.setattr(mod, "butterworth_bandpass_coeffs", _coeffs_with_a_degenerate_cutoff)
    jc, tc = JChain(), TChain(device="cpu")
    for i, (f, over) in enumerate(zip(_clip(), SCENARIOS[name])):
        jcfg, tcfg = _cfg_pair(**dict(over))
        jp, jo = jc.process(f, jcfg)
        tp, to = tc.process(f, tcfg)
        # the downscale's box mean may round a half-LSB tie the other way
        _assert_frames_close(to.numpy(), jo, f"{name} original {i}")
        _assert_frames_close(tp.numpy(), jp, f"{name} frame {i}")
        if name == "roi_downscale_gray":  # phase on gray is the identity
            assert tc._key.channels == 1 and tp.shape[-1] == 1 and to.shape[-1] == 3
            continue
        same = np.array_equal(tp.numpy(), to.numpy())
        assert same == (i == 0 or i in PASSTHROUGH.get(name, ())), f"{name} frame {i}"
    if name == "degenerate_cutoff":
        assert tc._dyn_params(tcfg, tc._key).force_init is False


def test_step_force_init_and_reset_match_reference_step():
    levels = 3
    frames = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in _clip(seed=3)]
    flags = [(False, False), (False, False), (True, False), (False, True),
             (False, False), (False, False)]  # (reset_filters, force_init)
    jstate = jriesz.init_state(H, W, levels)
    tstate = triesz.init_state(H, W, levels, device="cpu")
    for i, (f, (reset, force)) in enumerate(zip(frames, flags)):
        jdyn = _jax_dyn()._replace(reset_filters=jnp.asarray(reset),
                                   force_init=jnp.asarray(force))
        jstate, jout = _jax_step(levels)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), riesz_dyn_from_jax(jdyn),
                                   levels=levels)
        _assert_frames_close(tout.numpy(), jout, f"frame {i}")
        assert np.array_equal(tout.numpy(), f) == (i in (0, 3)), f"frame {i}"


def test_state_carried_across_from_a_jax_run():
    levels, k = 3, 3
    frames = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in _clip(seed=2)]
    jdyn = _jax_dyn(lo=0.8, hi=4.0, alpha=40.0)
    jstate = jriesz.init_state(H, W, levels)
    for f in frames[:k]:
        jstate, _ = _jax_step(levels)(jstate, jnp.asarray(f), jdyn)
    leaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    tstate = riesz_state_from_jax(leaves, device="cpu")
    assert tstate.count == k
    tdyn = riesz_dyn_from_jax(jdyn)
    for i, f in enumerate(frames[k:]):
        jstate, jout = _jax_step(levels)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels)
        assert np.any(tout.numpy() != f)  # carried state: no passthrough
        _assert_frames_close(tout.numpy(), jout, f"carried frame {k + i}")


def test_clip_processor_equals_chain_and_resumes_from_checkpoint(tmp_path):
    _, tcfg = _cfg_pair()
    clip = _clip()
    tc = TChain(device="cpu")
    per_frame = np.stack([tc.process(f, tcfg)[0].numpy() for f in clip])
    tchw = np.ascontiguousarray(clip.transpose(0, 3, 1, 2))
    proc = ClipProcessor(tcfg, H, W, 3, device="cpu")
    processed, original = proc.process_chunk(tchw)
    np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), per_frame)
    np.testing.assert_array_equal(original, tchw)

    first = ClipProcessor(tcfg, H, W, 3, device="cpu")
    a, _ = first.process_chunk(tchw[:2])
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = ClipProcessor(tcfg, H, W, 3, device="cpu")
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 2
    b, _ = resumed.process_chunk(tchw[2:])
    np.testing.assert_array_equal(np.concatenate([a, b]), processed)

    ck = str(tmp_path / "export")
    chunks = list(export_frames(tchw[:4], tcfg, chunk_size=2, checkpoint_path=ck,
                                checkpoint_every=2, device="cpu"))
    resumed_export = list(export_frames(tchw, tcfg, chunk_size=2, checkpoint_path=ck,
                                        checkpoint_every=2, device="cpu"))
    np.testing.assert_array_equal(
        np.concatenate([c[0] for c in chunks + resumed_export]), processed)

    _, tother = _cfg_pair(levels=2)
    with pytest.raises(ValueError, match="different configuration"):
        ClipProcessor(tother, H, W, 3, device="cpu").load_checkpoint(str(tmp_path / "ck"))


@pytest.mark.parametrize("mode,gray,device,time_parallel,count,flags,replayed", [
    ("phase", False, "cpu", False, 3, {}, False),
    ("laplace", False, "cpu", False, 3, {}, False),
    ("phase", False, "cuda", True, 3, {}, False),
    ("laplace", False, "cuda", True, 3, {}, False),
    ("color", False, "cuda", False, 3, {}, False),
    ("none", False, "cuda", False, 3, {}, False),
    ("phase", True, "cuda", False, 3, {}, False),  # phase on gray: the identity
    ("phase", False, "cuda", False, 0, {}, False),
    ("laplace", False, "cuda", False, 0, {}, False),
    ("phase", False, "cuda", False, 3, {"reset_filters": True}, False),
    ("phase", False, "cuda", False, 3, {"force_init": True}, False),
    ("phase", False, "cuda", False, 3, {}, True),
    ("laplace", False, "cuda", False, 1, {}, True),
    ("laplace", True, "cuda", False, 3, {}, True),
], ids=["cpu-phase", "cpu-laplace", "time_parallel-phase", "time_parallel-laplace", "color",
        "identity", "phase-gray", "first-phase", "first-laplace", "reset_filters",
        "force_init", "steady-phase", "steady-laplace", "steady-laplace-gray"])
def test_the_clip_export_replays_its_step_graph_on_steady_phase_and_laplace_frames_only(
        mode, gray, device, time_parallel, count, flags, replayed):
    """The step's ``steady`` rule (``models/chain.py::ChainStep``) and
    ``export/batch.py::replays``, which sends a frame of the sequential clip
    export on a card through the captured step where that rule admits it:
    never on the CPU, time-parallel, in colour or the identity (no rule);
    eager on the first frame and on a phase frame that resets or re-inits
    its filters. On the CPU the export stays eager: no graph, frames the
    chain's."""
    ui = tparams.defaults_for(tparams.MagnificationMode(mode))
    ui.levels = 3
    cfg = tparams.ProcessorConfig(grayscale=gray, magnification=tparams.to_params(ui))
    tc = TChain(device="cpu")
    key = tc.static_key(cfg, H, W, 3)
    dyn = tc._dyn_params(cfg, key)
    if flags:
        dyn = dyn._replace(**flags)
    step = _build_step(key, torch.device("cpu"))
    assert (step.steady is None) == (mode in ("color", "none") or gray and mode == "phase")
    if step.steady is not None:
        assert step.steady(count, dyn) is (count > 0 and not flags)
    assert replays(step, torch.device(device), time_parallel, count, dyn) is replayed
    if device == "cpu":
        clip = _clip()[:3]
        proc = ClipProcessor(cfg, H, W, 3, device="cpu")
        processed, _ = proc.process_chunk(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)))
        assert proc._graph is None
        per_frame = np.stack([tc.process(f, cfg)[0].numpy() for f in clip])
        np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), per_frame)


@pytest.mark.parametrize("where", ["numpy", "cpu", "cuda"])
@pytest.mark.parametrize("time_parallel", [False, True], ids=["sequential", "time_parallel"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_clip_export_stages_a_host_chunk_on_the_sequential_path_on_a_card_only(
        device, time_parallel, where):
    """``export/batch.py::stages``: a chunk goes through the upload ring only
    on a CUDA device, on the sequential path, and from the host (a numpy
    array as ``process_chunk`` takes it in, or a CPU tensor). A chunk already
    on the card (stood in by its device: the rule reads only where the chunk
    lives), the time-parallel path and the CPU keep the whole-chunk copy."""
    chunk = np.zeros((2, 3, 4, 5), np.uint8)
    frames = {"numpy": lambda: torch.as_tensor(chunk), "cpu": lambda: torch.zeros(2, 3, 4, 5),
              "cuda": lambda: types.SimpleNamespace(device=torch.device("cuda", 0))}[where]()
    assert stages(torch.device(device), time_parallel, frames) is (
        device == "cuda" and not time_parallel and where != "cuda")


class _Logged:
    """A CUDA stream or event stood in on the CPU: it logs what the host asks
    of it."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_event(self, event):
        self.log.append(("wait", self.name, event.name))

    def record(self, stream=None):
        self.log.append(("record", self.name))

    def synchronize(self):
        self.log.append(("sync", self.name))


_UPLOAD_RING = batch._UploadRing  # the test below stands its own in


def _logged_ring(log, frame, device):
    """The processor's ``_UploadRing`` with CPU tensors for its pinned slots
    and device buffers and ``_Logged`` stand-ins for its stream and events:
    its own ``put`` runs."""
    ring = object.__new__(_UPLOAD_RING)
    ring.key, ring._next = (frame.shape, frame.dtype), 0
    ring.stream = _Logged(log, "upload")
    ring.pinned = [torch.empty_like(frame) for _ in range(batch.RING)]
    ring.frames = [torch.empty_like(frame) for _ in range(batch.RING)]
    ring.uploaded = [_Logged(log, f"uploaded{s}") for s in range(batch.RING)]
    ring.freed = [_Logged(log, f"freed{s}") for s in range(batch.RING)]
    return ring


@pytest.mark.parametrize("mode", ["phase", "laplace"])
def test_a_staged_chunk_is_uploaded_one_frame_ahead_of_its_steps(mode, monkeypatch):
    """``ClipProcessor._staged`` on the CPU, with the card's streams and
    events stood in by a log (``_logged_ring``): chunks of 1, ``RING``,
    ``RING`` + 1 and 11 distinct frames through the ring's slots give the
    unstaged processor's panes bit for bit, and the host's calls come in the
    ring's order: frame 0's upload before the loop; for each frame i, frame
    i+1's upload (the host waits for the slot's last upload before it
    rewrites the pinned slot, the upload stream waits for the event that
    freed the slot's device buffer, then the copy and its event), then the
    current stream's wait for frame i's upload, frame i's panes copied out,
    and only then frame i's slot marked free; the slots turn over across
    chunks. One ring a processor."""
    ui = tparams.defaults_for(tparams.MagnificationMode(mode))
    ui.levels = 3
    cfg = tparams.ProcessorConfig(magnification=tparams.to_params(ui))
    lengths = [1, batch.RING, batch.RING + 1, 11]
    tchw = np.ascontiguousarray(moving_clip(sum(lengths), H, W, seed=21).transpose(0, 3, 1, 2))
    cuts = np.cumsum([0] + lengths)
    chunks = [tchw[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    plain = ClipProcessor(cfg, H, W, 3, device="cpu")
    want = [plain.process_chunk(c) for c in chunks]

    log, rings = [], []

    def make_ring(frame, device):
        rings.append(_logged_ring(log, frame, device))
        return rings[-1]

    monkeypatch.setattr(batch, "stages", lambda *args: True)
    monkeypatch.setattr(batch, "_UploadRing", make_ring)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Logged(log, "compute"))
    proc = ClipProcessor(cfg, H, W, 3, device="cpu")
    d2h = proc._d2h
    monkeypatch.setattr(proc, "_d2h", lambda index, panes, hosts: (log.append(("d2h", index)),
                                                                  d2h(index, panes, hosts)))
    slot = 0
    for chunk, cursor, (processed, original) in zip(chunks, cuts, want):
        del log[:]
        got = proc.process_chunk(chunk)
        np.testing.assert_array_equal(got[0], processed)
        np.testing.assert_array_equal(got[1], original)
        slots = [(slot + i) % batch.RING for i in range(len(chunk))]

        def put(s):
            return [("sync", f"uploaded{s}"), ("wait", "upload", f"freed{s}"),
                    ("record", f"uploaded{s}")]

        expected = put(slots[0])
        for i, s in enumerate(slots):
            expected += put(slots[i + 1]) if i + 1 < len(slots) else []
            expected += [("wait", "compute", f"uploaded{s}"), ("d2h", cursor + i),
                         ("record", f"freed{s}")]
        assert log == expected
        slot = (slot + len(chunk)) % batch.RING
    assert len(rings) == 1


class _Issued(TorchDispatchMode):
    """The ops a call issues, each with its host arguments and, for each
    tensor it reads, its shape, its dtype and where it comes from (a leaf
    of the carried state, the frame, or the op that made it): what a CUDA
    graph captured from that call holds."""

    def __init__(self, state, frame):
        super().__init__()
        self.ops, self.made = [], {}
        self.given = {x.data_ptr(): f"state{i}" for i, x in enumerate(tree_leaves(state))
                      if isinstance(x, torch.Tensor)}
        self.given[frame.data_ptr()] = "frame"

    def _read(self, x):
        if not isinstance(x, torch.Tensor):
            return repr(x)
        p = x.data_ptr()
        return tuple(x.shape), x.dtype, self.given.get(p) or self.made.get(p, "other")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), tuple(map(self._read, tree_leaves((args, kwargs))))))
        out = func(*args, **kwargs)
        for j, x in enumerate(tree_leaves(out)):
            if isinstance(x, torch.Tensor):
                self.made[x.data_ptr()] = (len(self.ops), j)
        return out


def _issued(step, state, frame, dyn):
    with _Issued(state, frame) as rec:
        step(state, frame, dyn)
    return rec.ops


@pytest.mark.parametrize("mode,altered", [("phase", False), ("laplace", False), ("phase", True)],
                         ids=["phase", "laplace", "phase-count-branch"])
def test_a_replayed_step_branches_only_on_what_replays_reads(mode, altered, monkeypatch):
    """A step's CUDA graph (``models/chain.py::StepGraph``) replays the ops
    of the frame it captured, whatever the host inputs of a later frame. So
    every frame that the step's ``steady`` rule admits has to issue the same
    ops, on the same shapes, sources and host arguments, whatever its
    ``count``, and a flag of ``dyn`` that changes them has to be one that
    the rule reads. The first frame's branch is seen; a step with a host
    branch on ``count`` past the first frame (``altered``) is caught."""
    if altered:
        step = triesz.step

        def with_a_count_branch(state, frame, dyn, **kw):
            new_state, out = step(state, frame, dyn, **kw)
            return new_state, (out // 2 + 3 if state.count > 2 else out)

        monkeypatch.setattr(triesz, "step", with_a_count_branch)
    ui = tparams.defaults_for(tparams.MagnificationMode(mode))
    ui.levels = 3
    cfg = tparams.ProcessorConfig(magnification=tparams.to_params(ui))
    tc = TChain(device="cpu")
    key = tc.static_key(cfg, H, W, 3)
    dyn = tc._dyn_params(cfg, key)
    chain_step = _build_step(key, torch.device("cpu"))
    frames = [torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1))) for f in _clip()[:2]]
    state = chain_step.raw_fn(chain_step.init_state(), frames[0], dyn)[0]
    admits = chain_step.steady
    issued = lambda count, d=dyn: _issued(chain_step.raw_fn, state._replace(count=count),
                                          frames[1], d)
    steady = issued(1)
    assert issued(0) != steady and not admits(0, dyn)
    varied = [c for c in (2, 3, 63, 64, 2**31) if issued(c) != steady]
    assert all(admits(c, dyn) for c in (1, 2, 3, 63, 64, 2**31))
    assert varied == ([3, 63, 64, 2**31] if altered else [])
    flags = {f for f, v in dyn._asdict().items()
             if isinstance(v, bool) and issued(1, dyn._replace(**{f: not v})) != steady}
    assert flags == ({"reset_filters", "force_init"} if mode == "phase" else set())
    assert not any(admits(1, dyn._replace(**{f: True})) for f in flags)


# The kernel flags' variables, named here apart from the table they test.
FLAG_VARS = {"phase_fused": "LVMT_PHASE_FUSED", "tail": "LVMT_TAIL", "build": "LVMT_BUILD",
             "mxu_dtype": "LVMT_MXU_DTYPE", "pyr_io": "LVMT_PYR_IO", "tail_io": "LVMT_TAIL_IO"}


def _mode_key_cfg(mode):
    ui = tparams.defaults_for(tparams.MagnificationMode(mode))
    ui.levels = 3
    return tparams.ProcessorConfig(magnification=tparams.to_params(ui))


@pytest.fixture
def no_flags(monkeypatch):
    for var in FLAG_VARS.values():
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("mode,env,digest", [
    ("phase", {}, "45f8a5daa28768e6"),
    ("phase", "fast", "d8a107b43c6abc30"),
    ("phase", {"LVMT_TAIL": "level", "LVMT_PHASE_FUSED": "1"}, "0199bd9d380cd67a"),
    ("laplace", {}, "3edb44ce3eeb9e69"),
    ("laplace", "fast", "99d46961bcdc56c9"),
    ("laplace", {"LVMT_TAIL": "level", "LVMT_PHASE_FUSED": "1"}, "e0c2b2fef1214789"),
], ids=["phase-defaults", "phase-fast", "phase-level-fused", "laplace-defaults",
        "laplace-fast", "laplace-level-fused"])
def test_the_checkpoint_digest_is_the_one_written_checkpoints_hold(no_flags, mode, env, digest):
    """``ClipProcessor._config_digest`` at literal values that the port
    computed before its kernel flags had one table (at 64x96, levels 3,
    each mode's UI defaults): under the default flags, ``magnify --fast``'s
    and the level tail with the fused phase kernel. A checkpoint written
    then still loads."""
    from live_video_magnification_tpu_torch.cli import FAST_FLAGS

    for var, value in (FAST_FLAGS if env == "fast" else env).items():
        no_flags.setenv(var, value)
    assert ClipProcessor(_mode_key_cfg(mode), H, W, 3, device="cpu")._config_digest() == digest


@pytest.mark.parametrize("field,value", [("phase_fused", True), ("tail", "level"),
                                         ("build", "fused"), ("mxu_dtype", "hybrid"),
                                         ("pyr_io", "bf16"), ("tail_io", "bf16")])
def test_each_flag_variable_sets_its_field(no_flags, field, value):
    """Each variable sets its own field of ``env_flags`` and of the chain's
    static key, and no other; the phase-fused flag is on at "1" only."""
    no_flags.setenv(FLAG_VARS[field], "1" if value is True else value)
    want = triesz.KernelFlags()._replace(**{field: value})
    assert triesz.env_flags() == want
    key = TChain(device="cpu").static_key(_mode_key_cfg("phase"), H, W, 3)
    assert {f: getattr(key, f) for f in want._fields} == want._asdict()
    if value is True:
        no_flags.setenv(FLAG_VARS[field], "true")
        assert triesz.env_flags() == triesz.KernelFlags()


def test_the_step_and_the_static_key_default_to_the_flag_table(no_flags):
    """The table's defaults are the static key's and ``step``'s, which keeps
    no default of its own: a step given no flag is the step given the
    table's, bit for bit."""
    table = triesz.KernelFlags()
    assert {f: _StaticKey._field_defaults[f] for f in table._fields} == table._asdict()
    assert triesz.env_flags() == triesz.resolve_flags() == table
    for fn in (triesz.step, triesz.process_clip):
        assert not set(table._fields) & set(inspect.signature(fn).parameters)
    clip = torch.from_numpy(np.ascontiguousarray(_clip()[:3].transpose(0, 3, 1, 2)))
    dyn = riesz_dyn_from_jax(_jax_dyn())
    _, given = triesz.process_clip(clip, dyn, levels=3, device="cpu", **table._asdict())
    _, default = triesz.process_clip(clip, dyn, levels=3, device="cpu")
    torch.testing.assert_close(default, given, rtol=0, atol=0)


@pytest.mark.parametrize("field,message", [
    ("tail", "unknown tail 'x': expected one of jnp, pallas, mxu, level"),
    ("build", "unknown build 'x': expected one of auto, fused"),
    ("mxu_dtype", "unknown mxu_dtype 'x': expected one of f32, bf16, hybrid, hybrid-band"),
    ("pyr_io", "unknown dtype 'x': expected one of f32, bf16"),
    ("tail_io", "unknown dtype 'x': expected one of f32, bf16"),
])
def test_an_unknown_flag_value_raises_as_before(no_flags, field, message):
    """An unknown value raises with the message it always had, from the
    environment and from ``step``'s keywords; the sharded step reads only
    its tail, and another flag's bad value does not stop it."""
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import _Ops

    frame = torch.from_numpy(np.ascontiguousarray(_clip()[0].transpose(2, 0, 1)))
    with pytest.raises(ValueError, match=f"^{message}$"):
        triesz.step(triesz.init_state(H, W, 3, device="cpu"), frame,
                    riesz_dyn_from_jax(_jax_dyn()), levels=3, **{field: "x"})
    no_flags.setenv(FLAG_VARS[field], "x")
    with pytest.raises(ValueError, match=f"^{message}$"):
        triesz.env_flags()
    if field == "tail":
        with pytest.raises(ValueError, match=f"^{message}$"):
            _Ops()
    else:
        assert _Ops().tail == "jnp"


def test_dynamic_params_match_the_reference_chain():
    jcfg, tcfg = _cfg_pair(co_low=0.7, co_high=2.5, amplification=25.0)
    jc, tc = JChain(), TChain(device="cpu")
    jkey = jc.static_key(jcfg, H, W, 3)
    tkey = tc.static_key(tcfg, H, W, 3)
    assert (tkey.levels, tkey.geometry, tkey.channels) == (jkey.levels, jkey.geometry, jkey.channels)
    assert tc._dyn_params(tcfg, tkey) == riesz_dyn_from_jax(jc._dyn_params(jcfg, jkey))


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfg_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triesz.init_state(H, W, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TChain()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipProcessor(tcfg, H, W, 3)
    assert triesz.init_state(H, W, 3, device="cpu").old[0].lowpass.device.type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_unported_modes_and_paths_raise():
    """The sharded motion step, once unported here, is the row-sharded step
    now (tests/test_torch_row_sharding.py holds it to the unsharded step and
    to the reference's); the identity mode has no sharded step and raises.
    Frames too small to magnify are the identity in every mode, as in the
    reference, through the chain and through the time-parallel clip path
    (tests/test_torch_time_parallel.py holds that path; LAPLACE and COLOR
    are in tests/test_torch_modes.py)."""
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.sharding import build_sharded_step

    tc = TChain(device="cpu")
    _, tcfg = _cfg_pair()
    mesh = make_mesh((1, 2), ("batch", "tile"), devices=["cpu"] * 2)
    _, state = build_sharded_step(mesh, tparams.MagnificationMode.LAPLACE, 1, H, W, 3)
    assert state[0][1].lowpass_hi[0].shape == (3, H // 2, W)
    with pytest.raises(ValueError, match="no sharded step"):
        build_sharded_step(mesh, tparams.MagnificationMode.NONE, 1, H, W, 3)
    tiny = _clip()[0][:5, :9]
    for mode in tparams.MagnificationMode:
        cfg = dataclasses.replace(tcfg, magnification=dataclasses.replace(
            tcfg.magnification, mode=mode))
        out, orig = tc.process(tiny, cfg)
        np.testing.assert_array_equal(out.numpy(), tiny)
        np.testing.assert_array_equal(orig.numpy(), tiny)
        assert tc._key.mode is tparams.MagnificationMode.NONE
        chunk = np.ascontiguousarray(tiny.transpose(2, 0, 1))[None]
        proc = ClipProcessor(cfg, 5, 9, 3, time_parallel=True, device="cpu")
        processed, original = proc.process_chunk(chunk)
        np.testing.assert_array_equal(processed, chunk)
        np.testing.assert_array_equal(original, chunk)


@pytest.mark.parametrize("mode", ["phase", "laplace"])
def test_noise_frames_equal_the_reference_op_by_op_given_its_lab_planes(mode, monkeypatch):
    """The trace of ROADMAP.md queue 3's noise-frame fault. On the live
    engine's uniform-noise frames (engine/source.py::SyntheticSource, 96x128,
    levels 2, the parameters of tests/test_torch_engine.py's controller
    test) the port's chain differs from the reference's jitted chain by
    more than one LSB at isolated values. So does the reference's own
    op-by-op run (``jax.disable_jit``) at those values: XLA's fusion of the
    jitted step moves last ulps, which a singularity of the phase (acos,
    atan2) or a clip out of gamut turns into LSBs. Against the op-by-op
    reference, with the reference's Lab planes (its cube root and gamma
    round otherwise than torch's ``pow``) substituted for the port's, the
    port is within one LSB at every value: no formula differs."""
    from live_video_magnification_tpu.ops import color as jcolor
    from live_video_magnification_tpu_torch.engine.source import SyntheticSource
    from live_video_magnification_tpu_torch.models import motion as tmotion

    src = SyntheticSource(None, None, None, h=96, w=128, fps=240.0, n_frames=12)
    frames = [src._render(i) for i in range(12)]
    cfgs = [pm.ProcessorConfig(magnification=pm.MagnificationParams(
        mode=pm.MagnificationMode(mode), amplification=20, co_wavelength=40.0, co_low=1.0,
        co_high=5.0, levels=2, framerate=60.0)) for pm in (jparams, tparams)]

    def run(chain, cfg):
        return [np.asarray(chain.process(f, cfg)[0]) for f in frames]

    def lsb(a, b):
        d = np.abs(np.stack(a).astype(np.int16) - np.stack(b).astype(np.int16))
        return int(d.max()), int((d > 1).sum())

    jitted = run(JChain(), cfgs[0])
    with jax.disable_jit():
        op_by_op = run(JChain(), cfgs[0])
    port = run(TChain(device="cpu"), cfgs[1])

    def reference_lab(bgr):
        with jax.disable_jit():
            return torch.from_numpy(np.array(jcolor.bgr_to_lab(jnp.asarray(bgr.numpy()))))

    monkeypatch.setattr(triesz if mode == "phase" else tmotion, "bgr_to_lab", reference_lab)
    substituted = run(TChain(device="cpu"), cfgs[1])
    print(f"{mode}: port vs jitted {lsb(port, jitted)}, jitted vs op by op "
          f"{lsb(jitted, op_by_op)}, port vs op by op {lsb(port, op_by_op)}, with the "
          f"reference's Lab {lsb(substituted, op_by_op)} (max LSB, values over 1)")
    assert lsb(substituted, op_by_op)[0] <= 1
