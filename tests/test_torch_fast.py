"""The port's ``--fast`` pairing on the CPU, where the kernels run their plain
versions, against the reference package: the bf16 arms of the stencils and
of riesz_amplify_mxu against the JAX Pallas kernels in interpret mode, the
step and the chain under the fast flags against the JAX step, the carried
bf16 pyramid (state, conversion, checkpoints), and the chain's flag key.

The four flags of ``lvmt magnify --fast`` (the reference's cli.py:40-64) are
LVMT_MXU_DTYPE=bf16, LVMT_TAIL=mxu, LVMT_TAIL_IO=bf16 and LVMT_PYR_IO=bf16;
the port takes them as the step's ``mxu_dtype``, ``tail``, ``tail_io`` and
``pyr_io`` and the chain reads them from the environment.

The JAX side reaches its kernels on the CPU as tests/test_pallas_kernels.py
does (entry points forced to interpret mode, LVMT_PALLAS=1,
LVMT_CONV9=dense, under which bf16 operands take the dense 9x9 bank), with
its 96-px MXU gate left as it is: the gate decides precision in the port too.

Bars:
  * bf16 arms with f32 outputs: max |diff| <= 1e-5 * max|x| * sum|taps| (f32
    sums of the same exact products in another order);
  * bf16 outputs, band5's i (its f32 sum rounded to bf16 in the bf16 arm)
    and riesz_amplify_mxu: within that f32 bar plus one bf16 ulp
    of the value at every pixel, beyond the f32 bar on under 1% of pixels (a
    sum's rounding to bf16 may flip between two orders);
  * every arm differs from its f32 arm (the JAX bf16-vs-f32 bars are ~100x
    looser and would not catch a missing rounding);
  * a step under the fast flags: per frame >= 40 dB, max <= 8 LSB and mean <
    0.5 LSB against the JAX step under the same flags (the reference's own
    storage-quantization bar, tests/test_modes.py:273-276).
"""

import functools
import hashlib
import json
import math
from collections import namedtuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.conv9_mxu as jc9
import live_video_magnification_tpu.ops.pallas.riesz_amplify_mxu as jram
import live_video_magnification_tpu.ops.pallas.riesz_build as jrb
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.models.chain import MagnificationChain as JChain
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.convert import (
    riesz_dyn_from_jax,
    riesz_state_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.chain import MagnificationChain as TChain
from live_video_magnification_tpu_torch.ops.hopper import stencils, tail
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
    RIESZ_LOWPASS_9x9,
)
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

FAST = dict(mxu_dtype="bf16", tail="mxu", tail_io="bf16", pyr_io="bf16")
FAST_ENV = {"LVMT_MXU_DTYPE": "bf16", "LVMT_TAIL": "mxu", "LVMT_TAIL_IO": "bf16",
            "LVMT_PYR_IO": "bf16"}
FLAG_VARS = ("LVMT_TAIL", "LVMT_PHASE_FUSED", "LVMT_BUILD", "LVMT_MXU_DTYPE",
             "LVMT_PYR_IO", "LVMT_TAIL_IO")


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.abs(v.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _f32_bar(x, taps) -> float:
    return 1e-5 * float(np.abs(x).max()) * float(np.abs(np.asarray(taps, np.float64)).sum())


def _assert_f32_close(got, want, bar, what):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= bar, f"{what}: max |diff| {d.max()} > {bar}"


def _assert_within_a_bf16_ulp(got, want, bar, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert np.all(d <= _bf16_ulp(want) + bar), f"{what}: beyond one bf16 ulp, max {d.max()}"
    off = float((d > bar).mean())
    assert off < 0.01, f"{what}: {off:.2%} of pixels beyond the f32 bar"


def _engaged(got, f32_arm, what):
    assert np.any(np.asarray(got, np.float32) != np.asarray(f32_arm, np.float32)), (
        f"{what}: the bf16 arm equals the f32 arm")


# ---------------------------------------------------------------- the bf16 arms


@pytest.fixture
def dense(monkeypatch):
    monkeypatch.setenv("LVMT_CONV9", "dense")
    monkeypatch.delenv("LVMT_MXU_DTYPE", raising=False)


@pytest.mark.parametrize("k9", ["lp", "hp"])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_conv9_bf16_arm_matches_reference_kernel(dense, k9, out_dtype):
    """tests/test_pallas_kernels.py:378-394 (96x128, normal x 50) and :630-655."""
    k = {"lp": RIESZ_LOWPASS_9x9, "hp": RIESZ_HIGHPASS_9x9}[k9]
    x = (np.random.default_rng(3).normal(size=(96, 128)) * 50.0).astype(np.float32)
    want = jc9.conv9_mxu(jnp.asarray(x), k, interpret=True, bf16=True, out_dtype=out_dtype)
    got = stencils.conv9(torch.from_numpy(x), k, bf16=True, out_dtype=out_dtype)
    assert got.dtype == stencils.DTYPES[out_dtype]
    bar = _f32_bar(x, k)
    if out_dtype == "f32":
        _assert_f32_close(got.float(), want, bar, "conv9[bf16]")
    else:
        _assert_within_a_bf16_ulp(got.float(), want, bar, "conv9[bf16] -> bf16")
    _engaged(got.float(), stencils.conv9(torch.from_numpy(x), k, out_dtype=out_dtype).float(),
             "conv9[bf16]")


@pytest.mark.parametrize("hp_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(96, 200), (135, 240)])
def test_band5_bf16_arm_matches_reference_kernel(dense, shape, hp_dtype):
    """bf16 input, operands and output (the fast build), and f32 input."""
    x = (np.random.default_rng(shape[1]).random(shape) * 100.0 - 50.0).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if hp_dtype == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(stencils.DTYPES[hp_dtype])
    bar = _f32_bar(x, RIESZ_BAND_KERNEL)
    for od in ("f32", "bf16"):
        want = jc9.band5_mxu(jx, RIESZ_BAND_KERNEL, interpret=True, bf16=True, out_dtype=od)
        got = stencils.band5(tx, RIESZ_BAND_KERNEL, bf16=True, out_dtype=od)
        f32_arm = stencils.band5(tx, RIESZ_BAND_KERNEL, out_dtype=od)
        for part, g, w, f in zip("ri", got, want, f32_arm):
            assert g.dtype == stencils.DTYPES[od]
            if od == "f32" and part == "r":
                _assert_f32_close(g, w, bar, f"band5[bf16] {part}")
            else:  # i of the bf16 arm is a sum rounded to bf16, in any output dtype
                _assert_within_a_bf16_ulp(g.float(), w, bar, f"band5[bf16] {part} -> bf16")
        # i of the bf16 arm is its f32 sum rounded, which a bf16 store also is
        _engaged(got[0].float(), f32_arm[0].float(), "band5[bf16] r")
        if od == "f32":
            _engaged(got[1], f32_arm[1], "band5[bf16] i")


@pytest.mark.parametrize("shape", [(97, 201), (130, 250)])
def test_lp9_decimate_bf16_arm_matches_reference_kernel(dense, shape):
    x = (np.random.default_rng(7).random(shape) * 100.0).astype(np.float32)
    want = jc9.lp9_decimate_mxu(jnp.asarray(x), LOWPASS_2X, interpret=True, bf16=True)
    got = stencils.lp9_decimate(torch.from_numpy(x), LOWPASS_2X, bf16=True)
    _assert_f32_close(got, want, _f32_bar(x, LOWPASS_2X), "lp9_decimate[bf16]")
    _engaged(got, stencils.lp9_decimate(torch.from_numpy(x), LOWPASS_2X), "lp9_decimate[bf16]")


@pytest.mark.parametrize("small,out", [((64, 64), (128, 128)), ((48, 100), (96, 200))])
def test_lp9_inject_bf16_arm_matches_reference_kernel(dense, small, out):
    s = (np.random.default_rng(9).random(small) * 10.0 - 5.0).astype(np.float32)
    want = jc9.lp9_inject_mxu(jnp.asarray(s), LOWPASS_2X, out, interpret=True, bf16=True)
    got = stencils.lp9_inject(torch.from_numpy(s), LOWPASS_2X, out, bf16=True)
    _assert_f32_close(got, want, _f32_bar(s, LOWPASS_2X), "lp9_inject[bf16]")
    _engaged(got, stencils.lp9_inject(torch.from_numpy(s), LOWPASS_2X, out), "lp9_inject[bf16]")


@pytest.mark.parametrize("planes", ["all_bf16", "transients_bf16"])
@pytest.mark.parametrize("preweighted", [False, True])
@pytest.mark.parametrize("shape", [(64, 128), (50, 70), (130, 250)])
def test_amplify_mxu_bf16_arm_matches_reference_kernel(monkeypatch, shape, preweighted, planes):
    """K6 under LVMT_MXU_DTYPE=bf16 with bf16 planes: all six (the fast
    pairing), or only the amplitude and change planes (LVMT_TAIL_IO alone);
    inputs as tests/test_pallas_kernels.py:630-655."""
    monkeypatch.setenv("LVMT_MXU_DTYPE", "bf16")
    rng = np.random.default_rng(shape[0] + 2 * shape[1] + preweighted)
    r = lambda: rng.random(shape).astype(np.float32) - 0.3
    amp = np.abs(r()) + 0.05
    cc, cs = r() * 0.4, r() * 0.4
    lp, rr, ri = r() * 50.0, r(), r()
    if preweighted:
        cc, cs = cc * amp, cs * amp
    ew_bf16 = planes == "all_bf16"
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (amp, cc, cs)]
    jin += [jnp.asarray(a).astype(jnp.bfloat16) if ew_bf16 else jnp.asarray(a)
            for a in (lp, rr, ri)]
    tin = [torch.from_numpy(a).to(torch.bfloat16) for a in (amp, cc, cs)]
    tin += [torch.from_numpy(a).to(torch.bfloat16 if ew_bf16 else torch.float32)
            for a in (lp, rr, ri)]
    want = jram.riesz_amplify_mxu(*jin, 30.0, 1.2, interpret=True, preweighted=preweighted)
    got = tail.riesz_amplify_mxu(*tin, 30.0, 1.2, preweighted=preweighted, bf16=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    bar = 1e-5 * float(np.abs(np.asarray(want)).max())
    _assert_within_a_bf16_ulp(got, want, bar, "riesz_amplify_mxu[bf16]")
    _engaged(got, tail.riesz_amplify_mxu(*tin, 30.0, 1.2, preweighted=preweighted),
             "riesz_amplify_mxu[bf16]")


def test_wrappers_take_bf16_where_the_reference_does():
    x = torch.zeros((20, 24))
    b = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        stencils.conv9(b, RIESZ_HIGHPASS_9x9, bf16=True)
    with pytest.raises(TypeError, match="float32"):
        stencils.lp9_decimate(b, LOWPASS_2X, bf16=True)
    with pytest.raises(TypeError, match="float32"):
        stencils.lp9_inject(b, LOWPASS_2X, (40, 48), bf16=True)
    r, i = stencils.band5(b, RIESZ_BAND_KERNEL, bf16=True, out_dtype="bf16")
    assert r.dtype == i.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        stencils.conv9(x, RIESZ_HIGHPASS_9x9, out_dtype="f16")
    six = [torch.ones((20, 24)) for _ in range(6)]
    assert tail.riesz_amplify_mxu(*[p.to(torch.bfloat16) for p in six], 30.0, 1.2,
                                  bf16=True).dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        tail.riesz_amplify_fused(*[p.to(torch.bfloat16) for p in six], 30.0, 1.2)
    with pytest.raises(TypeError, match="lowpass, riesz_r and riesz_i"):
        tail.riesz_amplify_mxu(*six[:4], b, six[5], 30.0, 1.2)
    before = (dict(stencils.LAUNCHES_BF16), dict(tail.LAUNCHES_BF16))
    stencils.conv9(x, RIESZ_HIGHPASS_9x9, bf16=True)
    assert (stencils.LAUNCHES_BF16, tail.LAUNCHES_BF16) == before  # CPU: plain versions


# ---------------------------------------------------------------- the step against JAX


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX step's kernels in interpret mode, its size gates as they are."""
    called = []
    for mod, name in [(jc9, "conv9_mxu"), (jc9, "band5_mxu"), (jc9, "lp9_decimate_mxu"),
                      (jc9, "lp9_inject_mxu"), (jrb, "riesz_build_level_fused"),
                      (jram, "riesz_amplify_mxu")]:
        def interpreted(*args, _fn=getattr(mod, name), _name=name, **kw):
            called.append(_name)
            return _fn(*args, interpret=True, **kw)

        monkeypatch.setattr(mod, name, interpreted)
    monkeypatch.setenv("LVMT_PALLAS", "1")
    monkeypatch.setenv("LVMT_CONV9", "dense")
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch, called


def _jax_dyn():
    b_lo, a_lo = butterworth_bandpass_coeffs(0.5, 30.0)
    b_hi, a_hi = butterworth_bandpass_coeffs(3.0, 30.0)
    f = lambda v: jnp.asarray(v, jnp.float32)
    return jriesz.RieszDynParams(f(30.0), f(0.4 * math.pi), f(b_lo), f(a_lo), f(b_hi),
                                 f(a_hi), jnp.asarray(False), jnp.asarray(False))


def _frames(t, h, w, seed):
    return [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in moving_clip(t, h, w, seed=seed)]


def _assert_storage_bar(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    db = psnr_u8(got, ref)
    assert db >= 40.0 and d.max() <= 8 and d.mean() < 0.5, (
        f"{what}: {db:.2f} dB, max {d.max()} LSB, mean {d.mean():.3f}")


def _dtypes(leaves):
    return [str(np.asarray(x).dtype) for x in leaves]


FAST_CASES = {"fast": FAST, "hybrid_pyr_bf16": dict(mxu_dtype="hybrid", pyr_io="bf16"),
              "hybrid_band_mxu": dict(mxu_dtype="hybrid-band", tail="mxu", pyr_io="bf16")}
ENV_NAMES = {"mxu_dtype": "LVMT_MXU_DTYPE", "tail": "LVMT_TAIL", "tail_io": "LVMT_TAIL_IO",
             "pyr_io": "LVMT_PYR_IO", "build": "LVMT_BUILD"}


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_step_matches_reference_step_under_the_fast_flags(jax_kernels, case):
    """136x240, levels=4: level 0 (>= 96, an exact doubling in the collapse)
    takes the bf16 arms; levels 1 and 2 (68x120, 34x60) the fused build and
    the f32 tail. The carried dtypes are the reference's."""
    h, w, levels = 136, 240, 4
    monkeypatch, called = jax_kernels
    flags = FAST_CASES[case]
    for k, v in flags.items():
        monkeypatch.setenv(ENV_NAMES[k], v)
    jdyn = _jax_dyn()
    tdyn = riesz_dyn_from_jax(jdyn)
    jstate = jriesz.init_state(h, w, levels)
    tstate = triesz.init_state(h, w, levels, device="cpu", pyr_io=flags.get("pyr_io", "f32"))
    assert _dtypes(state_to_numpy(tstate)) == [
        "float32" if d == "bfloat16" else d for d in _dtypes(jax.tree.flatten(jstate)[0])]
    for i, f in enumerate(_frames(4, h, w, seed=31)):
        jstate, jout = jriesz.step(jstate, jnp.asarray(f), jdyn, levels=levels)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels, **flags)
        _assert_storage_bar(tout.numpy(), jout, f"{case} frame {i}")
    jd = [x.dtype for x in jax.tree.flatten(jstate)[0][1:]]
    td = [x.dtype for x in jax.tree.flatten(tuple(tstate)[1:])[0]]
    assert [str(d).replace("torch.", "") for d in td] == [str(d) for d in jd]
    if flags.get("tail") == "mxu":
        assert called.count("riesz_amplify_mxu") == 4  # level 0 only, one a frame


def test_jax_state_with_bf16_leaves_continues_in_the_port(jax_kernels):
    h, w, levels, k = 136, 240, 4, 2
    monkeypatch, _ = jax_kernels
    for var, v in FAST_ENV.items():
        monkeypatch.setenv(var, v)
    frames = _frames(4, h, w, seed=13)
    jdyn = _jax_dyn()
    jstate = jriesz.init_state(h, w, levels)
    for f in frames[:k]:
        jstate, _ = jriesz.step(jstate, jnp.asarray(f), jdyn, levels=levels)
    leaves = jax.tree.flatten(jstate)[0]
    assert str(np.asarray(leaves[1]).dtype) == "bfloat16"
    tstate = riesz_state_from_jax(leaves, device="cpu")
    assert tstate.old[0].lowpass.dtype == torch.bfloat16
    assert tstate.old[levels - 1].lowpass.dtype == torch.float32
    torch.testing.assert_close(tstate.old[1].riesz.cos.float(),
                               torch.from_numpy(np.asarray(leaves[5], np.float32)),
                               rtol=0, atol=0)
    tdyn = riesz_dyn_from_jax(jdyn)
    for i, f in enumerate(frames[k:]):
        jstate, jout = jriesz.step(jstate, jnp.asarray(f), jdyn, levels=levels)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels, **FAST)
        assert np.any(tout.numpy() != f)  # carried state: no passthrough
        _assert_storage_bar(tout.numpy(), jout, f"carried fast frame {k + i}")


# ---------------------------------------------------------------- chain, clip, checkpoints


def _cfg_pair(levels=4):
    mag = dict(amplification=30.0, co_wavelength=40.0, co_low=0.5, co_high=3.0,
               levels=levels, framerate=30.0)
    return [mod.ProcessorConfig(magnification=mod.MagnificationParams(
        mode=mod.MagnificationMode.PHASE, **mag)) for mod in (jparams, tparams)]


@pytest.fixture
def fast_env(monkeypatch):
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, v in FAST_ENV.items():
        monkeypatch.setenv(var, v)
    return monkeypatch


def test_chain_and_clip_processor_agree_under_the_fast_flags(fast_env, tmp_path):
    h, w = 136, 240
    _, tcfg = _cfg_pair()
    tc = TChain(device="cpu")
    clip = moving_clip(4, h, w, seed=8)
    per_frame = np.stack([tc.process(f, tcfg)[0].numpy() for f in clip])
    assert (tc._key.mxu_dtype, tc._key.tail, tc._key.tail_io, tc._key.pyr_io) == (
        "bf16", "mxu", "bf16", "bf16")
    assert tc._state.old[0].lowpass.dtype == torch.bfloat16
    tchw = np.ascontiguousarray(clip.transpose(0, 3, 1, 2))
    proc = ClipProcessor(tcfg, h, w, 3, device="cpu")
    assert proc.key == tc._key
    processed, _ = proc.process_chunk(tchw)
    np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), per_frame)

    # a pyr_io=bf16 checkpoint round-trips bit for bit
    first = ClipProcessor(tcfg, h, w, 3, device="cpu")
    a, _ = first.process_chunk(tchw[:2])
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = ClipProcessor(tcfg, h, w, 3, device="cpu")
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 2
    for x, y in zip(jax.tree.flatten(tuple(first.state))[0],
                    jax.tree.flatten(tuple(resumed.state))[0]):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    b, _ = resumed.process_chunk(tchw[2:])
    np.testing.assert_array_equal(np.concatenate([a, b]), processed)
    # the same checkpoint does not load under the default flags
    for var in FAST_ENV:
        fast_env.delenv(var)
    with pytest.raises(ValueError, match="different configuration"):
        ClipProcessor(tcfg, h, w, 3, device="cpu").load_checkpoint(str(tmp_path / "ck"))


def test_a_flag_change_restarts_the_chain_with_the_keyed_state(monkeypatch):
    """Switching LVMT_PYR_IO between frames is a structural change: the chain
    starts afresh (first-frame passthrough) with bf16 band levels."""
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)
    _, tcfg = _cfg_pair(levels=3)
    tc = TChain(device="cpu")
    clip = moving_clip(4, 48, 64, seed=6)
    for f in clip[:2]:
        tc.process(f, tcfg)
    assert tc._state.count == 2 and tc._state.old[0].lowpass.dtype == torch.float32
    monkeypatch.setenv("LVMT_PYR_IO", "bf16")
    out, _ = tc.process(clip[2], tcfg)
    np.testing.assert_array_equal(out.numpy(), clip[2])
    assert tc._state.count == 1 and tc._state.old[0].lowpass.dtype == torch.bfloat16
    out, _ = tc.process(clip[3], tcfg)
    assert np.any(out.numpy() != clip[3])


def test_a_checkpoint_of_the_earlier_key_still_loads(monkeypatch, tmp_path):
    """A default-flag checkpoint as the port wrote it before the key had its
    build and dtype fields (its digest hides phase_fused and tail at their
    defaults) loads, and resumes as an uninterrupted run."""
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)
    h, w = 64, 96
    _, tcfg = _cfg_pair(levels=3)
    tchw = np.ascontiguousarray(moving_clip(4, h, w, seed=4).transpose(0, 3, 1, 2))
    whole, _ = ClipProcessor(tcfg, h, w, 3, device="cpu").process_chunk(tchw)
    first = ClipProcessor(tcfg, h, w, 3, device="cpu")
    first.process_chunk(tchw[:2])
    hidden = ("phase_fused", "tail", "build", "mxu_dtype", "pyr_io", "tail_io")
    fields = [f for f in first.key._fields if f not in hidden]
    earlier = namedtuple("_StaticKey", fields)(*(getattr(first.key, f) for f in fields))
    digest = hashlib.sha256((repr(earlier) + repr(tcfg)).encode()).hexdigest()[:16]
    meta = json.dumps({"cursor": 2, "digest": digest, "version": 2})
    arrays = {f"leaf_{i}": a for i, a in enumerate(state_to_numpy(first.state))}
    np.savez(str(tmp_path / "earlier"), __meta__=np.frombuffer(meta.encode(), dtype=np.uint8),
             **arrays)
    resumed = ClipProcessor(tcfg, h, w, 3, device="cpu")
    assert resumed.load_checkpoint(str(tmp_path / "earlier")) == 2
    rest, _ = resumed.process_chunk(tchw[2:])
    np.testing.assert_array_equal(rest, whole[2:])


def test_state_conversion_keeps_bf16_leaves_exactly():
    """bf16 leaves leave the port as float32 (numpy has no bfloat16) and come
    back bit for bit; float32 values entering a bf16 leaf are rounded once."""
    levels = 3
    state = triesz.init_state(40, 64, levels, device="cpu", pyr_io="bf16")
    leaves = state_to_numpy(state)
    assert all(x.dtype == np.float32 for x in leaves[1:])
    rng = np.random.default_rng(1)
    filled = [leaves[0]] + [rng.standard_normal(x.shape).astype(np.float32) for x in leaves[1:]]
    back = riesz_state_from_jax(filled, device="cpu", pyr_io="bf16")
    assert back.old[0].lowpass.dtype == torch.bfloat16
    assert back.old[levels - 1].lowpass.dtype == back.acc[0].cos.dtype == torch.float32
    again = state_to_numpy(back)
    n_band = 1 + 3 * (levels - 1)  # the count, then the band levels' planes
    for k, (a, b) in enumerate(zip(again[1:], filled[1:]), start=1):
        want = stencils.round_bf16(torch.from_numpy(b)).numpy() if k < n_band else b
        np.testing.assert_array_equal(a, want)
    # read back from its own leaves, the state is the same
    for x, y in zip(state_to_numpy(riesz_state_from_jax(again, device="cpu", pyr_io="bf16")),
                    again):
        np.testing.assert_array_equal(x, y)


def test_process_clip_forwards_every_flag_to_step():
    h, w, levels = 136, 240, 4
    frames = torch.from_numpy(np.stack(_frames(3, h, w, seed=2)))
    dyn = riesz_dyn_from_jax(_jax_dyn())
    for flags in (FAST, dict(tail="level", build="fused"), dict(tail="pallas", phase_fused=True)):
        state, outs = triesz.process_clip(frames, dyn, levels=levels, device="cpu", **flags)
        ref = triesz.init_state(h, w, levels, device="cpu", pyr_io=flags.get("pyr_io", "f32"))
        for i in range(frames.shape[0]):
            ref, out = triesz.step(ref, frames[i], dyn, levels=levels, **flags)
            torch.testing.assert_close(outs[i], out, rtol=0, atol=0)
        assert state.old[0].lowpass.dtype == ref.old[0].lowpass.dtype
    _, plain = triesz.process_clip(frames, dyn, levels=levels, device="cpu")
    _, fast = triesz.process_clip(frames, dyn, levels=levels, device="cpu", **FAST)
    assert not torch.equal(fast[1:], plain[1:])  # the flags reached the step


# ---------------------------------------------------------------- the chain's key


def test_flag_values_key_distinct_steps_and_defaults_equal_unset(monkeypatch):
    """As the reference's tests/test_modes.py:206-232: every value of a flag
    gives its own key, and the default value the key of the unset variable."""
    _, tcfg = _cfg_pair()
    chain = TChain(device="cpu")
    key = lambda: chain.static_key(tcfg, 48, 64, 3)
    for var in FLAG_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, default, others in [("LVMT_TAIL", "jnp", ["pallas", "mxu", "level"]),
                                 ("LVMT_BUILD", "auto", ["fused"]),
                                 ("LVMT_MXU_DTYPE", "f32", ["bf16", "hybrid", "hybrid-band"]),
                                 ("LVMT_PYR_IO", "f32", ["bf16"]),
                                 ("LVMT_TAIL_IO", "f32", ["bf16"])]:
        unset = key()
        seen = {unset}
        for val in others:
            monkeypatch.setenv(var, val)
            assert key() not in seen, f"{var}={val} collides with a cached key"
            seen.add(key())
        monkeypatch.setenv(var, default)
        assert key() == unset, f"{var}={default} must equal the unset key"
        monkeypatch.delenv(var)


@pytest.mark.parametrize("var,value", [("LVMT_BUILD", "mxu"), ("LVMT_MXU_DTYPE", "fp16"),
                                       ("LVMT_PYR_IO", "f16"), ("LVMT_TAIL_IO", "bfloat16")])
def test_unknown_flag_values_raise(monkeypatch, var, value):
    _, tcfg = _cfg_pair()
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match="unknown"):
        TChain(device="cpu").process(moving_clip(1, 32, 32, seed=1)[0], tcfg)
    with pytest.raises(ValueError, match="unknown"):
        ClipProcessor(tcfg, 32, 32, 3, device="cpu")
    name = {v: k for k, v in ENV_NAMES.items()}[var]
    state = triesz.init_state(32, 32, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        triesz.step(state, torch.zeros((3, 32, 32), dtype=torch.uint8),
                    riesz_dyn_from_jax(_jax_dyn()), levels=2, **{name: value})


def test_chain_under_the_fast_flags_matches_reference_chain(jax_kernels):
    """The JAX chain and the port's chain, both reading the four flags from
    the environment, at 136x240, levels=4."""
    monkeypatch, called = jax_kernels
    for var, v in FAST_ENV.items():
        monkeypatch.setenv(var, v)
    jcfg, tcfg = _cfg_pair()
    jc, tc = JChain(), TChain(device="cpu")
    for i, f in enumerate(moving_clip(3, 136, 240, seed=12)):
        jp, _ = jc.process(f, jcfg)
        tp, _ = tc.process(f, tcfg)
        _assert_storage_bar(tp.numpy(), jp, f"fast chain frame {i}")
    assert "riesz_amplify_mxu" in called and "riesz_build_level_fused" in called
