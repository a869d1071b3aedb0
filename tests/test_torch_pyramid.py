"""The port's motion and colour ops against the reference JAX package, on the CPU:
the pyramid ops, resize_linear, the temporal filters, bgr_to_gray and the UI
mapping.

Inputs are made with numpy from a seed and handed to both packages, at the
sizes of the reference suite (tests/test_pyramid.py: 48x64 and the odd
shapes 63x65, 31x47, 17x10). Bar: allclose at f32 tolerance, atol =
2e-6 x max(1, max|ref|); equal where the reference's value is a host number.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.ops import color as jcolor
from live_video_magnification_tpu.ops import kernels as jkernels
from live_video_magnification_tpu.ops import pyramid as jpyramid
from live_video_magnification_tpu.ops import resize as jresize
from live_video_magnification_tpu.ops import temporal as jtemporal
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.ops import color as tcolor
from live_video_magnification_tpu_torch.ops import kernels as tkernels
from live_video_magnification_tpu_torch.ops import pyramid as tpyramid
from live_video_magnification_tpu_torch.ops import resize as tresize
from live_video_magnification_tpu_torch.ops import temporal as ttemporal

torch.set_num_threads(2)

SHAPES = [(48, 64), (63, 65), (31, 47), (17, 10)]


def _jit(fn, **static):
    """The reference function under jax.jit, its static arguments bound: one
    compile a shape instead of one a jnp op."""
    return _jitted(fn, tuple(sorted(static.items())))


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


def _img(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


def _close(got, ref, what="", ref_max=None):
    """allclose at atol = 2e-6 x max(1, max|ref|); ``ref_max`` is max|ref| over
    the whole reference result where ``ref`` is one part of it (a pyramid
    level)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    atol = 2e-6 * max(1.0, float(np.abs(ref).max()) if ref_max is None else ref_max)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def test_pyramid_kernel_equals_reference():
    np.testing.assert_array_equal(tkernels.PYR_KERNEL_1D, jkernels.PYR_KERNEL_1D)
    assert tkernels.PYR_KERNEL_1D.dtype == jkernels.PYR_KERNEL_1D.dtype


@pytest.mark.parametrize("h,w", SHAPES + [(64, 64)])
def test_pyr_down_matches_reference(h, w):
    x = _img(1, 3, h, w, scale=255.0)
    _close(tpyramid.pyr_down(torch.from_numpy(x)), _jit(jpyramid.pyr_down)(jnp.asarray(x)))


@pytest.mark.parametrize("h,w,oh,ow", [
    (32, 32, 64, 64), (31, 33, 62, 66), (17, 23, 34, 46),       # exact 2x
    (24, 32, 47, 64), (32, 33, 63, 65), (16, 24, 31, 47),       # odd targets
    (9, 5, 17, 10), (51, 50, 101, 99),
])
def test_pyr_up_matches_reference(h, w, oh, ow):
    """Both reflected edges (Z[-2] -> src[1], Z[2n] -> src[n-1]) and the odd
    targets' dropped dummy row."""
    x = _img(2, 2, h, w)
    ref = _jit(jpyramid.pyr_up, out_hw=(oh, ow))(jnp.asarray(x))
    _close(tpyramid.pyr_up(torch.from_numpy(x), (oh, ow)), ref)
    if (oh, ow) == (2 * h, 2 * w):
        _close(tpyramid.pyr_up(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("h,w,levels", [(48, 64, 3), (63, 65, 4), (31, 47, 3), (17, 10, 1)])
def test_laplace_build_and_collapse_match_reference(h, w, levels):
    x = _img(3, 3, h, w, scale=100.0)
    ref = _jit(jpyramid.build_laplace_pyr, levels=levels)(jnp.asarray(x))
    got = tpyramid.build_laplace_pyr(torch.from_numpy(x), levels)
    assert len(got) == len(ref) == levels + 1
    ref_max = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for lvl, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"level {lvl}", ref_max)
    pyr = [np.asarray(r) for r in ref]
    _close(tpyramid.collapse_laplace_pyr([torch.from_numpy(p.copy()) for p in pyr]),
           _jit(jpyramid.collapse_laplace_pyr)([jnp.asarray(p) for p in pyr]))
    assert [tuple(g.shape[-2:]) for g in got[1:]] == tpyramid.pyramid_sizes(h, w, levels)
    assert tpyramid.pyramid_sizes(h, w, levels) == jpyramid.pyramid_sizes(h, w, levels)


@pytest.mark.parametrize("h,w,levels", [(48, 64, 3), (63, 65, 3), (31, 47, 2), (17, 10, 2)])
def test_gauss_pyr_and_reconstruct_match_reference(h, w, levels):
    """Odd shapes reach resize_linear after the pyrUps; 48x64 at 3 levels is
    the identity resize."""
    x = _img(4, 3, h, w, scale=255.0)
    ref = _jit(jpyramid.build_gauss_pyr, levels=levels)(jnp.asarray(x))
    got = tpyramid.build_gauss_pyr(torch.from_numpy(x), levels)
    for g, r in zip(got, ref):
        _close(g, r)
    small = np.asarray(ref[-1]) * 37.0
    _close(tpyramid.reconstruct_from_gauss_level(torch.from_numpy(small), levels, (h, w)),
           _jit(jpyramid.reconstruct_from_gauss_level, levels=levels, out_hw=(h, w))(
               jnp.asarray(small)))


@pytest.mark.parametrize("h,w,oh,ow", [(64, 64, 67, 61), (33, 47, 64, 64), (32, 40, 63, 65),
                                       (20, 12, 17, 10)])
def test_resize_linear_matches_reference(h, w, oh, ow):
    x = _img(5, 2, h, w, scale=255.0)
    _close(tresize.resize_linear(torch.from_numpy(x), (oh, ow)),
           _jit(jresize.resize_linear, out_hw=(oh, ow))(jnp.asarray(x)))


def test_resize_linear_same_size_is_the_input_and_matrices_are_cached():
    x = torch.from_numpy(_img(6, 3, 48, 64))
    assert tresize.resize_linear(x, (48, 64)) is x
    a = tresize._device_matrix(48, 50, "linear", torch.float32, x.device)
    assert tresize._device_matrix(48, 50, "linear", torch.float32, x.device) is a


@pytest.mark.parametrize("co_lo,co_hi", [(0.19, 0.71), (0.0, 0.3), (0.02, 0.999999)])
def test_iir_filter_matches_reference(co_lo, co_hi):
    src, hi, lo = (_img(s, 3, 17, 10) for s in (7, 8, 9))
    ref = _jit(jtemporal.iir_filter)(jnp.asarray(src), jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.float32(co_lo), jnp.float32(co_hi))
    got = ttemporal.iir_filter(*(torch.from_numpy(a) for a in (src, hi, lo)), co_lo, co_hi)
    for g, r in zip(got, ref):
        _close(g, r)


def test_optimal_buffer_size_matches_reference():
    for fps in (1, 8, 9, 15, 24, 30, 31, 60, 120, 1000):
        assert ttemporal.optimal_buffer_size(fps) == jtemporal.optimal_buffer_size(fps)


@pytest.mark.parametrize("length", [1, 2, 3, 5, 15, 16])
def test_ideal_bandpass_matches_reference(length):
    """The gains, the circulant column and its application at every
    warm-up length class, garbage rows past the active window ignored."""
    w_static, n_px = 16, 37
    win = _img(10, w_static, n_px, scale=255.0)
    win[length:] = 123.456
    for lo, hi, fps in [(0.84, 1.43, 30.0), (0.0, 4.0, 8.0), (0.5, 3.0, 30.0), (0.8, 1.6, 8.0)]:
        jargs = (jnp.float32(lo), jnp.float32(hi))
        jg = _jit(jtemporal.ideal_bandpass_gains, w_static=w_static, framerate=fps)(
            length=length, cutoff_lo=jargs[0], cutoff_hi=jargs[1])
        tg = ttemporal.ideal_bandpass_gains(w_static, length, lo, hi, fps, device="cpu")
        np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
        np.testing.assert_array_equal(tg[1].numpy(), np.asarray(jg[1]))
        assert (tg[2], tg[3]) == (float(jg[2]), float(jg[3]))
        _close(ttemporal.ideal_bandpass_circulant_col(w_static, length, lo, hi, fps, device="cpu"),
               _jit(jtemporal.ideal_bandpass_circulant_col, w_static=w_static, framerate=fps)(
                   length=length, cutoff_lo=jargs[0], cutoff_hi=jargs[1]))
        got = ttemporal.ideal_bandpass_apply(torch.from_numpy(win), length, lo, hi, fps)
        _close(got, _jit(jtemporal.ideal_bandpass_apply, framerate=fps)(
            jnp.asarray(win), length, *jargs))
        assert not got[length:].any()


@pytest.mark.parametrize("case", ["whole", "active_rows", "constant"])
def test_minmax_normalize_matches_reference(case):
    x = np.random.default_rng(11).standard_normal((16, 5, 9)).astype(np.float32)
    rows, mask = None, None
    if case == "active_rows":
        rows = 6
        x[rows:] = 1e6  # past the active rows: ignored by the min and max
        mask = jnp.asarray((np.arange(16) < rows)[:, None, None])
    if case == "constant":
        x[:] = 2.5  # OpenCV maps a constant array to zeros, not NaN
    got = ttemporal.minmax_normalize(torch.from_numpy(x), valid_rows=rows)
    _close(got, _jit(jtemporal.minmax_normalize)(jnp.asarray(x), valid_mask=mask))
    if case == "constant":
        assert not got.any()


def test_bgr_to_gray_and_a_tensor_scaled_to_u8_match_reference():
    x = _img(12, 3, 31, 47, scale=300.0) - 20.0
    _close(tcolor.bgr_to_gray(torch.from_numpy(x)), jcolor.bgr_to_gray(jnp.asarray(x)))
    mn, mx = x.min(), x.max()
    ref = jcolor.to_u8(jnp.asarray(x), 255.0 / (jnp.float32(mx) - jnp.float32(mn)),
                       -jnp.float32(mn) * 255.0 / (jnp.float32(mx) - jnp.float32(mn)))
    t = torch.from_numpy(x)
    tmn, tmx = t.min(), t.max()
    got = tcolor.to_u8(t, (tmx - tmn).new_full((), 255.0) / (tmx - tmn),
                       -tmn * 255.0 / (tmx - tmn))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _as_dict(v):
    d = dataclasses.asdict(v)
    d["mode"] = d["mode"].value
    return d


@pytest.mark.parametrize("mode", ["laplace", "phase", "color", "none"])
def test_ui_mapping_equals_reference(mode):
    jm, tm = jparams.MagnificationMode(mode), tparams.MagnificationMode(mode)
    assert _as_dict(tparams.defaults_for(tm)) == _as_dict(jparams.defaults_for(jm))
    for fps in (8.0, 30.0, 0.0):
        for low, high in [(1.0, 5.0), (0.01, 40.0), (6.0, 2.0)]:
            for wavelength, chroma, amp in [(50.0, 0, 20), (30.0, 30, 100)]:
                kw = dict(amplification=amp, wavelength=wavelength, low=low, high=high,
                          chroma=chroma, levels=4, capture_fps=fps)
                jv = jparams.clamp_band_to_nyquist(jparams.MagUiValues(mode=jm, **kw))
                tv = tparams.clamp_band_to_nyquist(tparams.MagUiValues(mode=tm, **kw))
                assert _as_dict(tv) == _as_dict(jv)
                jp, tp = jparams.to_params(jv), tparams.to_params(tv)
                assert _as_dict(tp) == _as_dict(jp)
                assert _as_dict(tparams.to_ui(tp)) == _as_dict(jparams.to_ui(jp))
    for fps in (0.0, 24.0, 30.0):
        for hz in (0.0, 0.1, 1.0, 15.0):
            assert tparams.motion_hz_to_blend(hz, fps) == jparams.motion_hz_to_blend(hz, fps)
        for blend in (-0.5, 0.0, 0.3, 1.0):
            assert tparams.motion_blend_to_hz(blend, fps) == jparams.motion_blend_to_hz(blend, fps)
