"""The port's time-parallel clip path against the reference JAX package on the
CPU: the log-depth scan, the two DF-II scans, each mode's
``process_clip_parallel``, ``ClipProcessor(time_parallel=True)`` and
``export_frames(time_parallel=True)``, checkpoints across the two paths, and
state carried across from a JAX run.

Inputs are numpy-seeded arrays and the reference suite's ``synthetic_clip``
at its shapes (tests/test_time_parallel.py). The JAX side runs under
``jax.jit``. Bars: the scan bit for bit in the reference's combination tree
(a non-associative combine on small integers, exact in f32); the DF-II scans
atol 3e-5 / rtol 1e-4 against scipy.signal.lfilter, the reference's scans
and iterating ``riesz_df2_step``; frames within 1 u8 LSB of the reference's
time-parallel path and of the port's sequential path; carried states as the
reference suite holds them (phase: < 0.5% of elements outside rtol 1e-3 /
atol 1e-4, as pixels on the clamped arccos's edge may flip; motion and
colour: rtol 1e-3 / atol 1e-4).
"""

import functools
import math

import numpy as np
import pytest
import scipy.signal

import jax
import jax.numpy as jnp
import torch

from live_video_magnification_tpu.export.batch import ClipProcessor as JClipProcessor
from live_video_magnification_tpu.models import color as jcolor
from live_video_magnification_tpu.models import motion as jmotion
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.ops import temporal as jtemporal
from live_video_magnification_tpu_torch.convert import (
    color_dyn_from_jax,
    color_state_from_jax,
    motion_dyn_from_jax,
    motion_state_from_jax,
    riesz_dyn_from_jax,
    riesz_state_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.export.batch import ClipProcessor, export_frames
from live_video_magnification_tpu_torch.models import color as tcolor
from live_video_magnification_tpu_torch.models import motion as tmotion
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.chain import parallel_clip_fn
from live_video_magnification_tpu_torch.ops import riesz as triesz_ops
from live_video_magnification_tpu_torch.ops import temporal as ttemporal

from oracle import synthetic_clip

torch.set_num_threads(2)

FPS = 30.0
COLOR_FPS = 4.0  # a window of 16 frames: clips of 20 or more fill it and roll it
DF2_BARS = dict(atol=3e-5, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _clip(t, h, w, seed):
    frames = synthetic_clip(t, h, w, color=True, seed=seed)
    return np.stack([np.moveaxis(f, -1, 0) for f in frames])


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def _coeffs(hz):
    b, a = jtemporal.butterworth_bandpass_coeffs(hz, FPS)
    return np.asarray(b, np.float32), np.asarray(a, np.float32)


def _riesz_dyn(force_init=False):
    (b_lo, a_lo), (b_hi, a_hi) = _coeffs(0.5), _coeffs(3.0)
    return jriesz.RieszDynParams(
        jnp.float32(30.0), jnp.float32(40.0 * math.pi / 100.0),
        *(jnp.asarray(x) for x in (b_lo, a_lo, b_hi, a_hi)),
        jnp.asarray(False), jnp.asarray(force_init))


def _motion_dyn():
    blend = lambda hz: jparams.motion_hz_to_blend(hz, FPS)
    return jmotion.MotionDynParams(jnp.float32(18.0), jnp.float32(250.0),
                                   jnp.float32(blend(0.8)), jnp.float32(blend(3.5)),
                                   jnp.float32(0.4))


def _color_dyn():
    return jcolor.ColorDynParams(jnp.float32(80.0), jnp.float32(0.4), jnp.float32(1.2))


# mode: (reference module, port module, JAX dyn, dyn converter, state converter,
#        extra keyword arguments)
MODES = {
    "phase": (jriesz, triesz, _riesz_dyn, riesz_dyn_from_jax, riesz_state_from_jax, {}),
    "motion": (jmotion, tmotion, _motion_dyn, motion_dyn_from_jax, motion_state_from_jax, {}),
    "color": (jcolor, tcolor, _color_dyn, color_dyn_from_jax, color_state_from_jax,
              dict(framerate=COLOR_FPS)),
}
# the reference suite's clips: (frames, h, w, levels, seed)
CLIPS = {"phase": (10, 48, 64, 3, 31), "motion": (12, 32, 40, 2, 35),
         "color": (20, 48, 64, 3, 32)}
CHUNKED = {"phase": (12, 48, 64, 2, 33, 5), "motion": (12, 32, 40, 2, 35, 7),
           "color": (24, 32, 40, 2, 34, 10)}


@functools.lru_cache(maxsize=None)
def _jax_parallel(mode, levels):
    jmod, _, _, _, _, kw = MODES[mode]
    return jax.jit(functools.partial(jmod.process_clip_parallel, levels=levels, **kw))


@functools.lru_cache(maxsize=None)
def _jax_sequential(mode, levels):
    jmod, _, _, _, _, kw = MODES[mode]
    return jax.jit(functools.partial(jmod.process_clip, levels=levels, **kw))


def _port(mode, parallel, frames, levels, state=None):
    _, tmod, jdyn, convert, _, kw = MODES[mode]
    fn = tmod.process_clip_parallel if parallel else tmod.process_clip
    return fn(torch.from_numpy(frames), convert(jdyn()), levels=levels, state=state,
              device="cpu", **kw)


def _jax_leaves(state):
    return [np.asarray(x) for x in jax.tree.flatten(state)[0]]


def _assert_states_close(mode, got, ref):
    """The reference suite's bars for a carried state (port state against a
    list of numpy leaves)."""
    leaves = state_to_numpy(got)
    assert len(leaves) == len(ref) and int(leaves[0]) == int(ref[0])
    for a, b in zip(leaves[1:], ref[1:]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if mode == "phase":
            bad = ~np.isclose(a, b, rtol=1e-3, atol=1e-4)
            assert bad.mean() < 0.005, f"{bad.sum()}/{bad.size} state elements differ"
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


# --- the log-depth scan ---------------------------------------------------------------------------


def _twice_plus(lhs, rhs):
    """Deliberately non-associative: the result depends on the tree."""
    (s1, p1), (s2, p2) = lhs, rhs
    return 2 * s1 + s2, 2 * p1 + p2 - s2


@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 17, 32])
def test_associative_scan_combines_in_the_reference_tree(t):
    rng = np.random.default_rng(t)
    s = rng.integers(-3, 4, (t, 1, 1)).astype(np.float64)  # a coefficient column
    p = rng.integers(-3, 4, (t, 2, 3)).astype(np.float64)  # planes it broadcasts against
    ref = jax.jit(lambda a, b: jax.lax.associative_scan(_twice_plus, (a, b)))(
        jnp.asarray(s, jnp.float32), jnp.asarray(p, jnp.float32))
    got = ttemporal.associative_scan(_twice_plus, (torch.from_numpy(s), torch.from_numpy(p)))
    assert [tuple(g.shape) for g in got] == [s.shape, p.shape]
    for g, r in zip(got, ref):  # every value an integer below 2^24: exact in f32 and f64
        np.testing.assert_array_equal(g.numpy(), np.asarray(r, np.float64))
    folded = [(s[:1], p[:1])]
    for k in range(1, t):
        folded.append(_twice_plus(folded[-1], (s[k:k + 1], p[k:k + 1])))
    if t >= 4:  # a left fold combines otherwise from 4 elements on: the check has teeth
        assert not np.array_equal(got[1].numpy(), np.concatenate([f[1] for f in folded]))


# --- the DF-II scans ----------------------------------------------------------------------------


def _df2_both(xs, b, a, **inits):
    """(port, reference) df2_filter_parallel on the same inputs, as numpy."""
    got = ttemporal.df2_filter_parallel(torch.from_numpy(xs), tuple(b), tuple(a),
                                        **{k: torch.from_numpy(v) for k, v in inits.items()})
    ref = jax.jit(jtemporal.df2_filter_parallel)(
        jnp.asarray(xs), jnp.asarray(b), jnp.asarray(a),
        **{k: jnp.asarray(v) for k, v in inits.items()})
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("init", ["zero", "nonzero"])
def test_df2_filter_parallel_matches_reference_and_scipy(init):
    rng = np.random.default_rng(7 if init == "zero" else 8)
    xs = rng.standard_normal((24, 4, 5)).astype(np.float32)
    hz = 1.2 if init == "zero" else 2.0
    b, a = _coeffs(hz)
    zi, inits = np.zeros((2, 4, 5)), {}
    if init == "nonzero":
        r0, r1 = (rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2))
        zi, inits = np.stack([r0, r1]).astype(np.float64), dict(reg0_init=r0, reg1_init=r1)
    (y, reg0, reg1), ref = _df2_both(xs, b, a, **inits)
    for g, r in zip((y, reg0, reg1), ref):
        np.testing.assert_allclose(g, r, **DF2_BARS)
    bd, ad = jtemporal.butterworth_bandpass_coeffs(hz, FPS)
    want, zf = scipy.signal.lfilter(bd, ad, xs.astype(np.float64), axis=0, zi=zi)
    np.testing.assert_allclose(y, want, **DF2_BARS)
    # the final registers continue a chunk
    np.testing.assert_allclose(reg0[-1], zf[0], **DF2_BARS)
    np.testing.assert_allclose(reg1[-1], zf[1], **DF2_BARS)


@pytest.mark.parametrize("given", ["reg0_init", "reg1_init"])
def test_df2_filter_parallel_single_init_makes_the_other_zero(given):
    rng = np.random.default_rng(9)
    xs = torch.from_numpy(rng.standard_normal((10, 2, 3)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    b, a = _coeffs(1.0)
    other = "reg1_init" if given == "reg0_init" else "reg0_init"
    one = ttemporal.df2_filter_parallel(xs, tuple(b), tuple(a), **{given: r})
    both = ttemporal.df2_filter_parallel(xs, tuple(b), tuple(a),
                                         **{given: r, other: torch.zeros_like(r)})
    for g, w in zip(one, both):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    (y, _, _), (ry, _, _) = _df2_both(xs.numpy(), b, a, **{given: r.numpy()})
    np.testing.assert_allclose(y, ry, **DF2_BARS)


def test_df2_filter_parallel_chunked_continuation():
    rng = np.random.default_rng(10)
    xs = torch.from_numpy(rng.standard_normal((16, 3, 3)).astype(np.float32))
    b, a = (tuple(v) for v in _coeffs(1.5))
    y_full, _, _ = ttemporal.df2_filter_parallel(xs, b, a)
    y1, r0, r1 = ttemporal.df2_filter_parallel(xs[:9], b, a)
    y2, _, _ = ttemporal.df2_filter_parallel(xs[9:], b, a, reg0_init=r0[-1], reg1_init=r1[-1])
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y_full.numpy(), atol=1e-5)
    want = scipy.signal.lfilter(*(np.asarray(v, np.float64) for v in (b, a)),
                                xs.numpy().astype(np.float64), axis=0)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), want, **DF2_BARS)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_df2_dual_filter_parallel_matches_reference_and_stepping(warm):
    rng = np.random.default_rng(11)
    t, shape = 17, (4, 6)
    diffs = (rng.standard_normal((t,) + shape) * 0.1).astype(np.float32)
    (b_lo, a_lo), (b_hi, a_hi) = _coeffs(0.5), _coeffs(3.0)
    zeros = np.zeros(shape, np.float32)
    if warm:
        acc0, lo0, hi0 = (rng.standard_normal(shape).astype(np.float32),
                          tuple(rng.standard_normal(shape).astype(np.float32) for _ in "ab"),
                          tuple(rng.standard_normal(shape).astype(np.float32) for _ in "ab"))
    else:
        acc0, lo0, hi0 = zeros, (zeros, zeros), (zeros, zeros)
    coeffs = [tuple(float(x) for x in v) for v in (b_lo, a_lo, b_hi, a_hi)]
    tt = lambda x: torch.from_numpy(np.asarray(x))
    kw = dict(acc_init=tt(acc0), lo_init=tuple(map(tt, lo0)), hi_init=tuple(map(tt, hi0))) \
        if warm else {}
    y_lo, y_hi, acc, fin = ttemporal.df2_dual_filter_parallel(tt(diffs), *coeffs, **kw)
    jkw = {k: (jnp.asarray(v) if k == "acc_init" else tuple(map(jnp.asarray, v)))
           for k, v in dict(acc_init=acc0, lo_init=lo0, hi_init=hi0).items()} if warm else {}
    ref = jax.jit(jtemporal.df2_dual_filter_parallel)(
        jnp.asarray(diffs), *(jnp.asarray(v) for v in (b_lo, a_lo, b_hi, a_hi)), **jkw)
    for g, r in zip((y_lo, y_hi, acc) + fin, ref[:3] + tuple(ref[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **DF2_BARS)

    # the port's sequential step, the shared accumulator fed to both filters
    CE = ttemporal.CompExp
    z = torch.zeros(shape)
    acc_s = CE(tt(acc0), z)
    lo_s = [CE(tt(lo0[0]), z), CE(tt(lo0[1]), z)]
    hi_s = [CE(tt(hi0[0]), z), CE(tt(hi0[1]), z)]
    for i in range(t):
        d = CE(tt(diffs[i]), z)
        yl, acc_n, *lo_s = ttemporal.riesz_df2_step(acc_s, *lo_s, d, coeffs[0], coeffs[1])
        yh, _, *hi_s = ttemporal.riesz_df2_step(acc_s, *hi_s, d, coeffs[2], coeffs[3])
        acc_s = acc_n
        np.testing.assert_allclose(y_lo[i].numpy(), yl.cos.numpy(), **DF2_BARS)
        np.testing.assert_allclose(y_hi[i].numpy(), yh.cos.numpy(), **DF2_BARS)
    for g, r in zip(fin, (acc_s, *lo_s, *hi_s)):
        np.testing.assert_allclose(g.numpy(), r.cos.numpy(), **DF2_BARS)


# --- each mode's process_clip_parallel ------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_process_clip_parallel_matches_reference_and_sequential(mode):
    t, h, w, levels, seed = CLIPS[mode]
    arr = _clip(t, h, w, seed)
    jstate, jout = _jax_parallel(mode, levels)(jnp.asarray(arr), MODES[mode][2]())
    state, out = _port(mode, True, arr, levels)
    seq_state, seq = _port(mode, False, arr, levels)
    assert out.dtype == torch.uint8 and out.shape == arr.shape
    assert _lsb(out, jout) <= 1, f"{_lsb(out, jout)} LSB against the reference"
    assert _lsb(out, seq) <= 1, f"{_lsb(out, seq)} LSB against the sequential path"
    assert np.any(out.numpy()[1:] != arr[1:])  # frames magnified
    _assert_states_close(mode, state, _jax_leaves(jstate))
    _assert_states_close(mode, state, state_to_numpy(seq_state))
    assert state.count == seq_state.count


@pytest.mark.parametrize("mode", list(MODES))
def test_process_clip_parallel_chunked_continuation(mode):
    t, h, w, levels, seed, k = CHUNKED[mode]
    arr = _clip(t, h, w, seed)
    seq_state, seq = _port(mode, False, arr, levels)
    st, o1 = _port(mode, True, arr[:k], levels)
    st, o2 = _port(mode, True, arr[k:], levels, state=st)
    par = torch.cat([o1, o2])
    assert _lsb(par, seq) <= 1, f"{_lsb(par, seq)} LSB"
    _assert_states_close(mode, st, state_to_numpy(seq_state))
    assert st.count == seq_state.count
    whole_state, whole = _port(mode, True, arr, levels)
    assert _lsb(par, whole) <= 1


@pytest.mark.parametrize("mode", list(MODES))
def test_continuation_from_a_jax_state(mode):
    """A state the reference carried over its first chunk, converted, continues
    in the port as the reference's time-parallel path continues it."""
    t, h, w, levels, seed, k = CHUNKED[mode]
    arr = _clip(t, h, w, seed)
    jdyn = MODES[mode][2]()
    jstate, _ = _jax_sequential(mode, levels)(jnp.asarray(arr[:k]), jdyn)
    _, jout = _jax_parallel(mode, levels)(jnp.asarray(arr[k:]), jdyn, state=jstate)
    state = MODES[mode][4](_jax_leaves(jstate), device="cpu")
    assert state.count == k
    _, out = _port(mode, True, arr[k:], levels, state=state)
    assert _lsb(out, jout) <= 1, f"{_lsb(out, jout)} LSB"
    assert np.any(out.numpy()[0] != arr[k])  # no first-frame passthrough


def test_phase_force_init_passes_every_frame_through():
    t, h, w, levels, seed = CLIPS["phase"]
    arr = _clip(t, h, w, seed)
    jdyn = _riesz_dyn(force_init=True)
    _, jout = _jax_parallel("phase", levels)(jnp.asarray(arr), jdyn)
    state, out = triesz.process_clip_parallel(torch.from_numpy(arr), riesz_dyn_from_jax(jdyn),
                                              levels=levels, device="cpu")
    np.testing.assert_array_equal(out.numpy(), arr)
    np.testing.assert_array_equal(np.asarray(jout), arr)
    assert state.count == t


def test_phase_bf16_state_stays_bf16(monkeypatch):
    """A state with bf16 band levels (pyr_io) stays bf16 across two chunks, and
    the frames follow the reference's on the same state. The carried band
    levels agree to one bf16 ulp, or the state bar's atol 1e-4 near zero (a
    value an f32 ulp from a rounding edge may round either way; the filter
    planes downstream of it are not compared)."""
    t, h, w, levels, seed, k = CHUNKED["phase"]
    arr = _clip(t, h, w, seed)
    jdyn = _riesz_dyn()
    monkeypatch.setenv("LVMT_PYR_IO", "bf16")
    jstate = jriesz.init_state(h, w, levels)
    assert jstate.old[0].lowpass.dtype == jnp.bfloat16
    jfn = jax.jit(functools.partial(jriesz.process_clip_parallel, levels=levels))
    jstate, j1 = jfn(jnp.asarray(arr[:k]), jdyn, state=jstate)
    jstate, j2 = jfn(jnp.asarray(arr[k:]), jdyn, state=jstate)
    tdyn = riesz_dyn_from_jax(jdyn)
    state = triesz.init_state(h, w, levels, device="cpu", pyr_io="bf16")
    state, o1 = triesz.process_clip_parallel(torch.from_numpy(arr[:k]), tdyn, levels=levels,
                                             state=state)
    state, o2 = triesz.process_clip_parallel(torch.from_numpy(arr[k:]), tdyn, levels=levels,
                                             state=state)
    for lvl, (old, jold) in enumerate(zip(state.old, jstate.old)):
        want = torch.bfloat16 if lvl < levels - 1 else torch.float32
        assert {old.lowpass.dtype, old.riesz.cos.dtype, old.riesz.sin.dtype} == {want}
        assert str(jold.lowpass.dtype) == ("bfloat16" if lvl < levels - 1 else "float32")
        for got, ref in zip((old.lowpass, old.riesz.cos, old.riesz.sin), jax.tree.leaves(jold)):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                       rtol=2.0 ** -7, atol=1e-4)
    assert _lsb(o1, j1) <= 1 and _lsb(o2, j2) <= 1
    assert state.count == int(jstate.count) == t


@pytest.mark.parametrize("h,w,levels", [(48, 64, 3), (136, 240, 4), (270, 480, 6)])
def test_stencil_launches_count_the_phase_paths_stencil_calls(h, w, levels, monkeypatch):
    """``ops/riesz.py::stencil_launches``, which the card's checks hold the
    launch counts to, counts the stencil entry points that the time-parallel
    phase path calls (each launches once a call on a CUDA tensor)."""
    calls = {}
    for name in triesz_ops.stencil_launches(h, w, levels):
        real = getattr(triesz_ops, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(triesz_ops, name, counted)
    t = 2
    triesz.process_clip_parallel(torch.from_numpy(_clip(t, h, w, 40)),
                                 riesz_dyn_from_jax(_riesz_dyn()), levels=levels, device="cpu")
    want = {k: v * t for k, v in triesz_ops.stencil_launches(h, w, levels).items() if v}
    assert calls == want


# --- ClipProcessor, export_frames and checkpoints -----------------------------------------------


def _cfg_pair(mode, gray=False, pre=None, **mag):
    """(JAX config, port config) with the same values."""
    base = {"laplace": dict(amplification=20.0, co_wavelength=500.0,
                            co_low=jparams.motion_hz_to_blend(1.0, FPS),
                            co_high=jparams.motion_hz_to_blend(4.0, FPS),
                            chrom_attenuation=0.3, levels=3, framerate=FPS),
            "color": dict(amplification=100.0, co_low=0.8, co_high=1.6, levels=3,
                          framerate=COLOR_FPS),
            "phase": dict(amplification=30.0, co_wavelength=40.0, co_low=0.5, co_high=3.0,
                          levels=3, framerate=FPS),
            "none": dict(levels=3, framerate=FPS)}[mode]
    base.update(mag)
    return [mod.ProcessorConfig(
        grayscale=gray, preprocess=mod.PreprocessParams(**(pre or {})),
        magnification=mod.MagnificationParams(mode=mod.MagnificationMode(mode), **base))
        for mod in (jparams, tparams)]


ROI = dict(roi_enabled=True, roi_x=0.1, roi_y=0.05, roi_w=0.8, roi_h=0.9, downscale=2)
PROCESSOR_CASES = {
    # name: (mode, frames, config overrides, frame size)
    "laplace": ("laplace", 14, {}, (48, 64)),
    "laplace_odd_gray_roi": ("laplace", 14, dict(gray=True, pre=ROI), (63, 65)),
    "color": ("color", 22, {}, (48, 64)),
    "phase": ("phase", 12, {}, (48, 64)),
    "phase_roi": ("phase", 12, dict(pre=ROI), (63, 65)),
}


@pytest.mark.parametrize("name", list(PROCESSOR_CASES))
def test_clip_processor_time_parallel_matches_reference_and_sequential(name):
    mode, t, over, (h, w) = PROCESSOR_CASES[name]
    jcfg, tcfg = _cfg_pair(mode, **over)
    arr = _clip(t, h, w, 36)
    half = t // 2
    jproc = JClipProcessor(jcfg, h, w, 3, time_parallel=True)
    par = ClipProcessor(tcfg, h, w, 3, time_parallel=True, device="cpu")
    seq = ClipProcessor(tcfg, h, w, 3, device="cpu")
    for chunk in (arr[:half], arr[half:]):
        jp, jo = jproc.process_chunk(chunk)
        pp, po = par.process_chunk(chunk)
        sp, so = seq.process_chunk(chunk)
        assert pp.shape == jp.shape and pp.dtype == np.uint8
        assert _lsb(pp, jp) <= 1, f"{name}: {_lsb(pp, jp)} LSB against the reference"
        assert _lsb(pp, sp) <= 1, f"{name}: {_lsb(pp, sp)} LSB against the sequential path"
        assert _lsb(po, jo) <= 1  # the downscale's box mean may round a tie the other way
        np.testing.assert_array_equal(po, so)
    assert par.cursor == seq.cursor == t
    assert par.state.count == seq.state.count == int(np.asarray(jproc.state.count))


@pytest.mark.parametrize("mode", ["laplace", "color", "phase"])
def test_checkpoints_interchange_between_the_two_paths(mode, tmp_path):
    _, tcfg = _cfg_pair(mode)
    t, h, w = 22 if mode == "color" else 12, 48, 64
    arr = _clip(t, h, w, 37)
    whole, _ = ClipProcessor(tcfg, h, w, 3, device="cpu").process_chunk(arr)
    k = t // 2
    for writer_parallel in (False, True):
        ck = str(tmp_path / f"ck_{writer_parallel}")
        first = ClipProcessor(tcfg, h, w, 3, time_parallel=writer_parallel, device="cpu")
        a, _ = first.process_chunk(arr[:k])
        first.save_checkpoint(ck)
        resumed = ClipProcessor(tcfg, h, w, 3, time_parallel=not writer_parallel,
                                device="cpu")
        assert resumed.load_checkpoint(ck) == k
        assert resumed.state.count == k and isinstance(resumed.state.count, int)
        b, _ = resumed.process_chunk(arr[k:])
        got = np.concatenate([a, b])
        assert _lsb(got, whole) <= 1, f"{mode}, written by parallel={writer_parallel}"
    # time_parallel is not part of the configuration's digest
    assert (ClipProcessor(tcfg, h, w, 3, time_parallel=True, device="cpu")._config_digest()
            == ClipProcessor(tcfg, h, w, 3, device="cpu")._config_digest())


def test_export_frames_time_parallel_resumes_from_a_checkpoint(tmp_path):
    _, tcfg = _cfg_pair("phase")
    arr = _clip(12, 48, 64, 38)
    seq = np.concatenate([p for p, _ in export_frames(arr, tcfg, chunk_size=4, device="cpu")])
    ck = str(tmp_path / "export")
    chunks = list(export_frames(arr[:8], tcfg, chunk_size=4, checkpoint_path=ck,
                                checkpoint_every=4, time_parallel=True, device="cpu"))
    rest = list(export_frames(arr, tcfg, chunk_size=4, checkpoint_path=ck,
                              checkpoint_every=4, time_parallel=True, device="cpu"))
    got = np.concatenate([c[0] for c in chunks + rest])
    assert got.shape == seq.shape and _lsb(got, seq) <= 1


@pytest.mark.parametrize("mode", ["laplace", "phase"])
@pytest.mark.parametrize("time_parallel", [False, True], ids=["sequential", "time_parallel"])
def test_a_chunks_arrays_are_unchanged_by_the_next_chunk(mode, time_parallel):
    """The arrays a chunk returns are its own: processing the next chunk
    leaves them as they were and shares no memory with them."""
    _, tcfg = _cfg_pair(mode)
    arr = _clip(8, 48, 64, 40)
    proc = ClipProcessor(tcfg, 48, 64, 3, time_parallel=time_parallel, device="cpu")
    first = proc.process_chunk(arr[:4])
    kept = [x.copy() for x in first]
    second = proc.process_chunk(arr[4:])
    for a, b, c in zip(first, kept, second):
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, c)


@pytest.mark.parametrize("name,over", [("none", {}), ("phase_on_gray", dict(gray=True))])
def test_identity_path_returns_the_magnification_input(name, over):
    mode = "none" if name == "none" else "phase"
    jcfg, tcfg = _cfg_pair(mode, **over)
    arr = _clip(6, 48, 64, 39)
    proc = ClipProcessor(tcfg, 48, 64, 3, time_parallel=True, device="cpu")
    assert parallel_clip_fn(proc.key) is None
    processed, original = proc.process_chunk(arr)
    jp, jo = JClipProcessor(jcfg, 48, 64, 3, time_parallel=True).process_chunk(arr)
    np.testing.assert_array_equal(original, arr)
    np.testing.assert_array_equal(processed, np.asarray(jp))
    np.testing.assert_array_equal(original, np.asarray(jo))
    if over.get("gray"):  # the gray stage's output, one channel
        assert processed.shape == (6, 1, 48, 64)
    else:
        np.testing.assert_array_equal(processed, arr)


def test_time_parallel_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    _, tcfg = _cfg_pair("phase")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipProcessor(tcfg, 48, 64, 3, time_parallel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triesz.process_clip_parallel(torch.from_numpy(_clip(2, 48, 64, 1)),
                                     riesz_dyn_from_jax(_riesz_dyn()), levels=2)
    assert ClipProcessor(tcfg, 48, 64, 3, time_parallel=True,
                         device="cpu").state.old[0].lowpass.device.type == "cpu"
