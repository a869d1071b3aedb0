"""The port's motion (LAPLACE) and colour (COLOR) modes against the reference
JAX package on the CPU: the steps, the clips, the chain in all three modes,
state carried across from a JAX run, ClipProcessor with checkpoints, the
dynamic parameters and the device rule of the new entry points.

Inputs are numpy-seeded frames (``utils/synthetic.py``; gray = the green
plane) at the reference suite's 48x64 and at odd shapes. Bars: motion within
1 u8 LSB of JAX on every frame; colour >= 45 dB on every frame (the
reference suite's bar against its oracle, tests/test_modes.py) with the
warm-up frame bit for bit the input; phase as tests/test_torch_chain.py
(>= 40 dB and 1 LSB); bit-equal where the port runs the same step twice.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from live_video_magnification_tpu.models import color as jcolor
from live_video_magnification_tpu.models import motion as jmotion
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.models.chain import MagnificationChain as JChain
from live_video_magnification_tpu_torch.convert import (
    color_dyn_from_jax,
    color_state_from_jax,
    motion_dyn_from_jax,
    motion_state_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.export.batch import ClipProcessor, export_frames
from live_video_magnification_tpu_torch.models import color as tcolor
from live_video_magnification_tpu_torch.models import motion as tmotion
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.models.chain import MagnificationChain as TChain
from live_video_magnification_tpu_torch.ops import temporal as ttemporal
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

H, W = 48, 64
COLOR_FPS = 8.0  # window of 16 frames: 18 or more frames fill it and roll it


@functools.lru_cache(maxsize=None)
def _clip(t, h=H, w=W, seed=1):
    return moving_clip(t, h, w, seed=seed)


def _chw_frames(t, color, h=H, w=W, seed=1):
    """[t] frames as [C, H, W] u8 numpy (gray: the green plane)."""
    clip = _clip(t, h, w, seed)
    if color:
        return [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in clip]
    return [np.ascontiguousarray(f[None, :, :, 1]) for f in clip]


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def _motion_dyn():
    blend = lambda hz: jparams.motion_hz_to_blend(hz, 30.0)
    return jmotion.MotionDynParams(jnp.float32(20.0), jnp.float32(500.0),
                                   jnp.float32(blend(1.0)), jnp.float32(blend(4.0)),
                                   jnp.float32(0.3))


def _color_dyn():
    return jcolor.ColorDynParams(jnp.float32(100.0), jnp.float32(0.8), jnp.float32(1.6))


@functools.lru_cache(maxsize=None)
def _jax_motion_step(levels):
    return jax.jit(functools.partial(jmotion.step, levels=levels))


@functools.lru_cache(maxsize=None)
def _jax_color_step(levels, fps):
    return jax.jit(functools.partial(jcolor.step, levels=levels, framerate=fps))


def _assert_state_close(tstate, jstate, atol):
    jleaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    tleaves = state_to_numpy(tstate)
    assert len(tleaves) == len(jleaves)
    assert int(tleaves[0]) == int(jleaves[0])
    for a, b in zip(tleaves[1:], jleaves[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("color", [True, False], ids=["color", "gray"])
def test_motion_step_matches_reference_step(color):
    levels, t = 3, 12
    c = 3 if color else 1
    jdyn = _motion_dyn()
    tdyn = motion_dyn_from_jax(jdyn)
    jstate = jmotion.init_state(H, W, c, levels)
    tstate = tmotion.init_state(H, W, c, levels, device="cpu")
    moved = False
    for i, f in enumerate(_chw_frames(t, color)):
        jstate, jout = _jax_motion_step(levels)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = tmotion.step(tstate, torch.from_numpy(f), tdyn, levels=levels)
        assert tout.dtype == torch.uint8 and tout.shape == f.shape
        assert _lsb(tout, jout) <= 1, f"frame {i}: {_lsb(tout, jout)} LSB"
        moved |= i > 0 and bool(np.any(tout.numpy() != f))
    assert moved
    assert tstate.count == t
    _assert_state_close(tstate, jstate, atol=2e-4)  # Lab planes, magnitude <= 100


@pytest.mark.parametrize("color", [True, False], ids=["color", "gray"])
def test_color_step_matches_reference_step(color):
    levels, t = 3, 20
    c = 3 if color else 1
    jdyn = _color_dyn()
    tdyn = color_dyn_from_jax(jdyn)
    jstate = jcolor.init_state(H, W, c, levels, COLOR_FPS)
    tstate = tcolor.init_state(H, W, c, levels, COLOR_FPS, device="cpu")
    assert tstate.window.shape == jstate.window.shape == (16, c, 6, 8)
    dbs, lsbs = [], []
    for i, f in enumerate(_chw_frames(t, color, seed=2)):
        jstate, jout = _jax_color_step(levels, COLOR_FPS)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = tcolor.step(tstate, torch.from_numpy(f), tdyn, levels=levels,
                                   framerate=COLOR_FPS)
        if i == 0:  # warm-up: the input itself, bit for bit
            np.testing.assert_array_equal(tout.numpy(), f)
        dbs.append(psnr_u8(tout.numpy(), np.asarray(jout)))
        lsbs.append(_lsb(tout, jout))
    print(f"colour {'color' if color else 'gray'}: min {min(dbs):.2f} dB, max {max(lsbs)} LSB")
    assert min(dbs) >= 45.0, dbs
    assert tstate.count == int(jstate.count) == 16
    _assert_state_close(tstate, jstate, atol=2e-6 * 255)


@pytest.mark.parametrize("mode", ["motion", "color"])
def test_process_clip_equals_stepping(mode):
    levels, t = 3, 18
    frames = torch.from_numpy(np.stack(_chw_frames(t, True, seed=3)))
    if mode == "motion":
        dyn = motion_dyn_from_jax(_motion_dyn())
        step = functools.partial(tmotion.step, dyn=dyn, levels=levels)
        state = tmotion.init_state(H, W, 3, levels, device="cpu")
        got_state, got = tmotion.process_clip(frames, dyn, levels=levels, device="cpu")
    else:
        dyn = color_dyn_from_jax(_color_dyn())
        step = functools.partial(tcolor.step, dyn=dyn, levels=levels, framerate=COLOR_FPS)
        state = tcolor.init_state(H, W, 3, levels, COLOR_FPS, device="cpu")
        got_state, got = tcolor.process_clip(frames, dyn, levels=levels, framerate=COLOR_FPS,
                                             device="cpu")
    outs = []
    for f in frames:
        before = state_to_numpy(state)
        new_state, out = step(state, frame_u8=f)
        for a, b in zip(state_to_numpy(state), before):  # the step is functional
            np.testing.assert_array_equal(a, b)
        state = new_state
        outs.append(out)
    np.testing.assert_array_equal(got.numpy(), torch.stack(outs).numpy())
    for a, b in zip(state_to_numpy(got_state), state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)


def _cfg_pair(mode, gray=False, pre=None, **mag):
    """(JAX config, port config) with the same values."""
    base = {"laplace": dict(amplification=20.0, co_wavelength=500.0,
                            co_low=jparams.motion_hz_to_blend(1.0, 30.0),
                            co_high=jparams.motion_hz_to_blend(4.0, 30.0),
                            chrom_attenuation=0.3, levels=3, framerate=30.0),
            "color": dict(amplification=100.0, co_low=0.8, co_high=1.6, levels=3,
                          framerate=COLOR_FPS),
            "phase": dict(amplification=30.0, co_wavelength=40.0, co_low=0.5, co_high=3.0,
                          levels=3, framerate=30.0)}[mode]
    base.update(mag)
    return [mod.ProcessorConfig(
        grayscale=gray, preprocess=mod.PreprocessParams(**(pre or {})),
        magnification=mod.MagnificationParams(mode=mod.MagnificationMode(mode), **base))
        for mod in (jparams, tparams)]


ROI = dict(roi_enabled=True, roi_x=0.1, roi_y=0.05, roi_w=0.8, roi_h=0.9, downscale=2)
CHAIN_SCENARIOS = {
    # name: (mode, frames, config overrides, frame size)
    "laplace": ("laplace", 8, {}, (H, W)),
    "laplace_odd_gray_roi": ("laplace", 8, dict(gray=True, pre=ROI), (63, 65)),
    "color": ("color", 20, {}, (H, W)),
    "color_odd_gray_roi": ("color", 20, dict(gray=True, pre=ROI), (63, 65)),
    "phase": ("phase", 6, {}, (H, W)),
}


@pytest.mark.parametrize("name", list(CHAIN_SCENARIOS))
def test_chain_matches_reference_chain(name):
    mode, t, over, (h, w) = CHAIN_SCENARIOS[name]
    jcfg, tcfg = _cfg_pair(mode, **over)
    jc, tc = JChain(), TChain(device="cpu")
    dbs = []
    for i, f in enumerate(_clip(t, h, w, seed=4)):
        jp, jo = jc.process(f, jcfg)
        tp, to = tc.process(f, tcfg)
        jp, tp = np.asarray(jp), tp.numpy()
        assert tp.shape == jp.shape and tp.dtype == np.uint8
        assert _lsb(to, jo) <= 1  # the downscale's box mean may round a tie the other way
        dbs.append(psnr_u8(tp, jp))
        if mode == "color":
            if i == 0:  # warm-up: the magnification input passes through, bit for bit
                np.testing.assert_array_equal(tp, jp)
        else:
            assert _lsb(tp, jp) <= 1, f"{name} frame {i}: {_lsb(tp, jp)} LSB"
    assert min(dbs) >= (45.0 if mode == "color" else 40.0), dbs
    assert tc._key.mode.value == mode and tc._key.levels == jc._key.levels
    assert tc._key.channels == (1 if over.get("gray") else 3)


@pytest.mark.parametrize("mode", ["motion", "color"])
def test_state_carried_across_from_a_jax_run(mode):
    levels, k, t = 3, 10, 20
    frames = _chw_frames(t, True, seed=5)
    if mode == "motion":
        jdyn, jstate = _motion_dyn(), jmotion.init_state(H, W, 3, levels)
        jstep = _jax_motion_step(levels)
        tdyn = motion_dyn_from_jax(jdyn)
        tstep = functools.partial(tmotion.step, levels=levels)
        from_jax = motion_state_from_jax
    else:
        jdyn, jstate = _color_dyn(), jcolor.init_state(H, W, 3, levels, COLOR_FPS)
        jstep = _jax_color_step(levels, COLOR_FPS)
        tdyn = color_dyn_from_jax(jdyn)
        tstep = functools.partial(tcolor.step, levels=levels, framerate=COLOR_FPS)
        from_jax = color_state_from_jax
    for f in frames[:k]:
        jstate, _ = jstep(jstate, jnp.asarray(f), jdyn)
    tstate = from_jax([np.asarray(x) for x in jax.tree.flatten(jstate)[0]], device="cpu")
    assert tstate.count == k
    for i, f in enumerate(frames[k:]):
        jstate, jout = jstep(jstate, jnp.asarray(f), jdyn)
        tstate, tout = tstep(tstate, torch.from_numpy(f), tdyn)
        assert np.any(tout.numpy() != f)  # carried state: no first-frame passthrough
        if mode == "motion":
            assert _lsb(tout, jout) <= 1, f"carried frame {k + i}"
        else:
            assert psnr_u8(tout.numpy(), np.asarray(jout)) >= 45.0, f"carried frame {k + i}"
    assert tstate.count == int(jstate.count)


@pytest.mark.parametrize("mode", ["laplace", "color"])
def test_clip_processor_equals_chain_and_resumes_from_checkpoint(mode, tmp_path):
    _, tcfg = _cfg_pair(mode)
    t = 18
    clip = _clip(t, seed=6)
    tc = TChain(device="cpu")
    per_frame = np.stack([tc.process(f, tcfg)[0].numpy() for f in clip])
    tchw = np.ascontiguousarray(clip.transpose(0, 3, 1, 2))
    processed, original = ClipProcessor(tcfg, H, W, 3, device="cpu").process_chunk(tchw)
    np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), per_frame)
    np.testing.assert_array_equal(original, tchw)

    first = ClipProcessor(tcfg, H, W, 3, device="cpu")
    a, _ = first.process_chunk(tchw[:7])
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = ClipProcessor(tcfg, H, W, 3, device="cpu")
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 7
    assert resumed.state.count == 7 and isinstance(resumed.state.count, int)
    b, _ = resumed.process_chunk(tchw[7:])
    np.testing.assert_array_equal(np.concatenate([a, b]), processed)

    ck = str(tmp_path / "export")
    chunks = list(export_frames(tchw[:8], tcfg, chunk_size=4, checkpoint_path=ck,
                                checkpoint_every=4, device="cpu"))
    rest = list(export_frames(tchw, tcfg, chunk_size=4, checkpoint_path=ck,
                              checkpoint_every=4, device="cpu"))
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks + rest]), processed)

    _, other = _cfg_pair(mode, levels=2)
    with pytest.raises(ValueError, match="different configuration"):
        ClipProcessor(other, H, W, 3, device="cpu").load_checkpoint(str(tmp_path / "ck"))


@pytest.mark.parametrize("mode", ["laplace", "color"])
def test_dynamic_params_match_the_reference_chain(mode):
    jcfg, tcfg = _cfg_pair(mode, amplification=37.0)
    jc, tc = JChain(), TChain(device="cpu")
    jkey, tkey = jc.static_key(jcfg, H, W, 3), tc.static_key(tcfg, H, W, 3)
    assert (tkey.levels, tkey.geometry, tkey.channels, tkey.framerate) == (
        jkey.levels, jkey.geometry, jkey.channels, jkey.framerate)
    convert = motion_dyn_from_jax if mode == "laplace" else color_dyn_from_jax
    assert tc._dyn_params(tcfg, tkey) == convert(jc._dyn_params(jcfg, jkey))


def test_new_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda d: tmotion.init_state(H, W, 3, 3, **d),
                 lambda d: tcolor.init_state(H, W, 3, 3, 30.0, **d),
                 lambda d: ttemporal.ideal_bandpass_gains(16, 4, 0.8, 1.6, 30.0, **d),
                 lambda d: ClipProcessor(_cfg_pair("laplace")[1], H, W, 3, **d),
                 lambda d: ClipProcessor(_cfg_pair("color")[1], H, W, 3, **d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call({})
        call({"device": "cpu"})
    assert tmotion.init_state(H, W, 3, 3, device="cpu").lowpass_hi[0].device.type == "cpu"
    assert tcolor.init_state(H, W, 3, 3, 30.0, device="cpu").window.device.type == "cpu"


def test_motion_with_zero_wavelength_matches_reference_step():
    """lambda_c = 0: an infinite ladder gain, clamped to alpha, as in f32."""
    levels = 2
    jdyn = _motion_dyn()._replace(co_wavelength=jnp.float32(0.0))
    tdyn = motion_dyn_from_jax(jdyn)
    assert tmotion.ladder_gains(tdyn, H, W, levels) == [None, 20.0, None]
    jstate = jmotion.init_state(H, W, 3, levels)
    tstate = tmotion.init_state(H, W, 3, levels, device="cpu")
    for f in _chw_frames(3, True, seed=7):
        jstate, jout = _jax_motion_step(levels)(jstate, jnp.asarray(f), jdyn)
        tstate, tout = tmotion.step(tstate, torch.from_numpy(f), tdyn, levels=levels)
        assert _lsb(tout, jout) <= 1
