"""The port's fused level build (K5, ops/hopper/stencils.py::riesz_build_level)
and the build dispatch of ops/riesz.py on the CPU, where the kernels run
their plain versions, against the reference package: K5's plain version
against the JAX Pallas kernel in interpret mode, the build and collapse
dispatch (which kernel runs on which level, at which operand dtype) against
the reference's rule, and the step under LVMT_BUILD=auto and fused against the
JAX step.

The JAX side reaches its kernels on the CPU as tests/test_pallas_kernels.py
does (entry points forced to interpret mode, LVMT_PALLAS=1,
LVMT_CONV9=dense), but with its 96-px MXU gate left as it is: that gate
decides precision in the port too.

Bars: K5 against the JAX kernel 3e-4 at inputs x100 (the reference suite's
bar: its kernel takes hp's apron from the padded octave, another order of
the same sums); K5 against the three stencils bit for bit; per frame >= 40 dB
and at most 1 u8 LSB.
"""

import functools
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.conv9_mxu as jc9
import live_video_magnification_tpu.ops.pallas.riesz_build as jrb
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.ops import riesz as jops
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.convert import riesz_dyn_from_jax
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.ops import riesz as tops
from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
)
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

# the reference suite's K5 shapes (tests/test_pallas_kernels.py:23)
JAX_SHAPES = [(64, 128), (70, 130), (100, 101), (33, 257)]


def _octave(shape, seed=5):
    return np.random.default_rng(seed + shape[0] * 1000 + shape[1]).random(shape).astype(
        np.float32) * 100.0


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("h,w", JAX_SHAPES)
def test_build_level_plain_matches_reference_kernel(h, w):
    x = _octave((h, w))
    want = jrb.riesz_build_level_fused(jnp.asarray(x), interpret=True)
    got = stencils.riesz_build_level(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [tuple(v.shape) for v in want]
    for k, (g, v) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=3e-4, err_msg=f"output {k}")


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 16), (33, 257), (68, 120), (97, 201)])
def test_build_level_plain_is_the_three_stencils_bit_for_bit(shape, out_dtype):
    x = torch.from_numpy(_octave(shape, seed=11))
    hp, r, i, sub = stencils.riesz_build_level(x, out_dtype=out_dtype)
    hp3 = stencils.conv9(x, RIESZ_HIGHPASS_9x9)
    r3, i3 = stencils.band5(hp3, RIESZ_BAND_KERNEL)
    od = stencils.DTYPES[out_dtype]
    for got, want in zip((hp, r, i, sub),
                         (hp3.to(od), r3.to(od), i3.to(od), stencils.lp9_decimate(x, LOWPASS_2X))):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sub.dtype == torch.float32 and sub.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    if out_dtype == "bf16":  # rounded after the f32 sum: r and i come from the f32 hp
        torch.testing.assert_close(r.float(), stencils.round_bf16(r3), rtol=0, atol=0)


def test_build_level_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="below 16"):
        stencils.riesz_build_level(torch.zeros((15, 64)))
    with pytest.raises(TypeError, match="float32"):
        stencils.riesz_build_level(torch.zeros((32, 32), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unknown dtype"):
        stencils.riesz_build_level(torch.zeros((32, 32)), out_dtype="f16")
    before = dict(stencils.LAUNCHES)
    stencils.riesz_build_level(torch.zeros((32, 32)))
    assert stencils.LAUNCHES == before  # a CPU tensor runs the plain version


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("mode", ["f32", "bf16", "hybrid", "hybrid-band"])
def test_hybrid_bf16_matches_the_reference_resolution(monkeypatch, mode):
    """The port's hybrid_bf16 is the reference's _hybrid_bf16 with its env
    default (None: LVMT_MXU_DTYPE == "bf16" inside the kernels) resolved."""
    monkeypatch.setenv("LVMT_MXU_DTYPE", mode)
    for lvl in range(5):
        want = tuple(jc9._resolve_bf16(v) for v in jops._hybrid_bf16(lvl))
        assert tops.hybrid_bf16(lvl, mode) == want, (mode, lvl)
    assert tops.hybrid_bf16(0, "hybrid") == (False, False)
    assert tops.hybrid_bf16(3, "hybrid-band") == (True, False)


@pytest.fixture
def spy(monkeypatch):
    """Records (function, shape, bf16, out dtype) of every stencil call the
    build and the collapse make."""
    calls = []
    for name in ("conv9", "band5", "lp9_decimate", "lp9_inject", "riesz_build_level"):
        fn = getattr(tops, name)

        def wrapped(x, *args, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(x.shape), kw.get("bf16", False),
                          kw.get("out_dtype", "f32")))
            return _fn(x, *args, **kw)

        monkeypatch.setattr(tops, name, wrapped)
    return calls


def _pyramid_calls(spy, h, w, levels, **flags):
    x = torch.from_numpy(_octave((h, w), seed=3))
    pyr = tops.build_riesz_pyramid(x, levels, **{k: v for k, v in flags.items()
                                                   if k in ("build", "mxu_dtype", "pyr_io")})
    tops.collapse_riesz_pyramid([lvl.lowpass.float() for lvl in pyr],
                                mxu_dtype=flags.get("mxu_dtype", "f32"))
    out = list(spy)
    spy.clear()
    return pyr, out


def test_build_runs_k5_on_levels_from_16_to_95_by_default(spy):
    """24x40, levels=3: 24x40 by K5, 12x20 (under 16) by the three stencils;
    the collapse by lp9_inject and conv9, all f32."""
    pyr, calls = _pyramid_calls(spy, 24, 40, 3)
    f32 = lambda name, shape: (name, shape, False, "f32")
    assert calls == [f32("riesz_build_level", (24, 40)), f32("conv9", (12, 20)),
                     f32("band5", (12, 20)), f32("lp9_decimate", (12, 20)),
                     f32("lp9_inject", (6, 10)), f32("conv9", (12, 20)),
                     f32("lp9_inject", (12, 20)), f32("conv9", (24, 40))]
    assert len(pyr) == 3 and pyr[-1].lowpass.shape == (6, 10)


@pytest.mark.parametrize("build", ["auto", "fused"])
@pytest.mark.parametrize("mxu_dtype", ["f32", "bf16", "hybrid", "hybrid-band"])
def test_build_and_collapse_dispatch_at_136x240(spy, build, mxu_dtype):
    """136x240, levels=4: level 0 (136x240) takes the three stencils under
    auto, K5 under fused; levels 1 and 2 (68x120, 34x60) K5 either way. bf16
    operands only on level 0's stencils and the exact-doubling collapse step
    onto it, as hybrid_bf16 says; hp, r and i stored as bf16 under pyr_io."""
    pyr, calls = _pyramid_calls(spy, 136, 240, 4, build=build, mxu_dtype=mxu_dtype,
                                pyr_io="bf16")
    conv_bf16, band_bf16 = tops.hybrid_bf16(0, mxu_dtype)
    k5 = [("riesz_build_level", s, False, "bf16") for s in ((68, 120), (34, 60))]
    if build == "auto":
        head = [("conv9", (136, 240), conv_bf16, "bf16"), ("band5", (136, 240), band_bf16, "bf16"),
                ("lp9_decimate", (136, 240), conv_bf16, "f32")]
    else:
        head = [("riesz_build_level", (136, 240), False, "bf16")]
    collapse = [("lp9_inject", (17, 30), False, "f32"), ("conv9", (34, 60), False, "f32"),
                ("lp9_inject", (34, 60), False, "f32"), ("conv9", (68, 120), False, "f32"),
                ("lp9_inject", (68, 120), conv_bf16, "f32"), ("conv9", (136, 240), conv_bf16, "f32")]
    assert calls == head + k5 + collapse
    for lvl in pyr[:-1]:
        assert {x.dtype for x in (lvl.lowpass, *lvl.riesz)} == {torch.bfloat16}
    assert {x.dtype for x in (pyr[-1].lowpass, *pyr[-1].riesz)} == {torch.float32}


def test_fused_build_equals_auto_in_f32_bit_for_bit():
    x = torch.from_numpy(_octave((136, 240), seed=8))
    for a, b in zip(tops.build_riesz_pyramid(x, 4), tops.build_riesz_pyramid(x, 4, build="fused")):
        for p, q in zip((a.lowpass, *a.riesz), (b.lowpass, *b.riesz)):
            torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_unknown_build_values_raise():
    x = torch.zeros((32, 32))
    with pytest.raises(ValueError, match="unknown build 'mxu'"):
        tops.build_riesz_pyramid(x, 2, build="mxu")
    with pytest.raises(ValueError, match="unknown mxu_dtype 'fp16'"):
        tops.build_riesz_pyramid(torch.zeros((128, 128)), 2, mxu_dtype="fp16")
    with pytest.raises(ValueError, match="unknown dtype"):
        tops.build_riesz_pyramid(x, 2, pyr_io="fp16")
    with pytest.raises(ValueError, match="unknown mxu_dtype"):
        tops.collapse_riesz_pyramid([torch.zeros((128, 128)), torch.zeros((64, 64))],
                                    mxu_dtype="f16")


# ---------------------------------------------------------------- the step against JAX


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX step's kernels in interpret mode, its size gates as they are."""
    called = []
    for mod, name in [(jc9, "conv9_mxu"), (jc9, "band5_mxu"), (jc9, "lp9_decimate_mxu"),
                      (jc9, "lp9_inject_mxu"), (jrb, "riesz_build_level_fused")]:
        def interpreted(*args, _fn=getattr(mod, name), _name=name, **kw):
            called.append(_name)
            return _fn(*args, interpret=True, **kw)

        monkeypatch.setattr(mod, name, interpreted)
    monkeypatch.setenv("LVMT_PALLAS", "1")
    monkeypatch.setenv("LVMT_CONV9", "dense")
    for var in ("LVMT_TAIL", "LVMT_PHASE_FUSED", "LVMT_BUILD", "LVMT_MXU_DTYPE",
                "LVMT_PYR_IO", "LVMT_TAIL_IO"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch, called


def _jax_dyn():
    b_lo, a_lo = butterworth_bandpass_coeffs(0.5, 30.0)
    b_hi, a_hi = butterworth_bandpass_coeffs(3.0, 30.0)
    f = lambda v: jnp.asarray(v, jnp.float32)
    return jriesz.RieszDynParams(f(30.0), f(0.4 * math.pi), f(b_lo), f(a_lo), f(b_hi),
                                 f(a_hi), jnp.asarray(False), jnp.asarray(False))


@pytest.mark.parametrize("build", ["auto", "fused"])
def test_step_matches_reference_step_under_each_build(jax_kernels, build):
    """136x240, levels=4, f32: the reference runs its MXU stencils on level 0
    (auto) and its fused build on levels 1 and 2; both steps' frames within 1
    LSB."""
    h, w, levels = 136, 240, 4
    monkeypatch, called = jax_kernels
    monkeypatch.setenv("LVMT_BUILD", build)
    jstep = functools.partial(jriesz.step, levels=levels)
    jdyn = _jax_dyn()
    tdyn = riesz_dyn_from_jax(jdyn)
    jstate = jriesz.init_state(h, w, levels)
    tstate = triesz.init_state(h, w, levels, device="cpu")
    frames = [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in moving_clip(3, h, w, seed=21)]
    for i, f in enumerate(frames):
        jstate, jout = jstep(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels, build=build)
        got, ref = tout.numpy(), np.asarray(jout)
        lsb = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
        assert psnr_u8(got, ref) >= 40.0 and lsb <= 1, f"{build} frame {i}: {lsb} LSB"
    per_frame = {"auto": 2, "fused": 3}[build]
    assert called.count("riesz_build_level_fused") == per_frame * len(frames)
    assert ("band5_mxu" in called) == (build == "auto")
