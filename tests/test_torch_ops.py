"""The port's plain ops against the reference JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Tolerances
are f32 ones: 2e-4 to 3e-4 for values of magnitude 5 to 100, as the reference
suite holds its own kernels (tests/test_pallas_kernels.py), and exact where
both sides do the same IEEE operations in the same order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from live_video_magnification_tpu.ops import color as jcolor
from live_video_magnification_tpu.ops import conv as jconv
from live_video_magnification_tpu.ops import kernels as jkernels
from live_video_magnification_tpu.ops import pyramid as jpyramid
from live_video_magnification_tpu.ops import resize as jresize
from live_video_magnification_tpu.ops import riesz as jriesz
from live_video_magnification_tpu.ops import temporal as jtemporal
from live_video_magnification_tpu_torch.ops import color as tcolor
from live_video_magnification_tpu_torch.ops import conv as tconv
from live_video_magnification_tpu_torch.ops import kernels as tkernels
from live_video_magnification_tpu_torch.ops import pyramid as tpyramid
from live_video_magnification_tpu_torch.ops import resize as tresize
from live_video_magnification_tpu_torch.ops import riesz as triesz
from live_video_magnification_tpu_torch.ops import temporal as ttemporal

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", ["RIESZ_BAND_KERNEL", "RIESZ_LOWPASS_9x9",
                                  "RIESZ_HIGHPASS_9x9", "AMPLITUDE_BLUR_KERNEL_1D"])
def test_kernel_constants_equal_reference(name):
    a, b = getattr(tkernels, name), getattr(jkernels, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_double_lowpass_is_exact_in_f32():
    lp2 = 2.0 * tkernels.RIESZ_LOWPASS_9x9
    assert lp2.dtype == np.float32
    np.testing.assert_array_equal(lp2 / 2.0, tkernels.RIESZ_LOWPASS_9x9)
    np.testing.assert_array_equal(tkernels.gaussian_kernel_1d(7, 0.0),
                                  jkernels.gaussian_kernel_1d(7, 0.0))


@pytest.mark.parametrize("n,pad", [(5, 4), (6, 2), (9, 4), (3, 7), (2, 5)])
def test_reflect_pad_matches_numpy_reflect(n, pad):
    x = _rng(n).random((n + 1, n)).astype(np.float32)
    got = tconv.reflect_pad(_t(x), pad, pad).numpy()
    np.testing.assert_array_equal(got, np.pad(x, pad, mode="reflect"))


@pytest.mark.parametrize("h,w", [(33, 57), (16, 24)])
def test_correlations_match_reference(h, w):
    x = (_rng(h).random((h, w)).astype(np.float32) * 10.0 - 5.0)
    k = jkernels.RIESZ_HIGHPASS_9x9
    t5 = jkernels.RIESZ_BAND_KERNEL
    g = jkernels.AMPLITUDE_BLUR_KERNEL_1D
    pairs = [
        (tconv.correlate2d(_t(x), k), jconv.correlate2d(jnp.asarray(x), k)),
        (tconv.correlate_rows(_t(x), t5), jconv.correlate_rows(jnp.asarray(x), t5)),
        (tconv.correlate_cols(_t(x), t5), jconv.correlate_cols(jnp.asarray(x), t5)),
        (tconv.sep_correlate2d(_t(x), g, g), jconv.sep_correlate2d(jnp.asarray(x), g, g)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=2e-5)


def test_zero_taps_are_skipped_so_nan_meets_the_same_taps():
    x = np.zeros((12, 12), np.float32)
    x[0, 0] = np.nan  # only the zero corner taps of HP9 would reach (4, 4) from here
    got = tconv.correlate2d(_t(x), jkernels.RIESZ_HIGHPASS_9x9).numpy()
    ref = _np(jconv.correlate2d(jnp.asarray(x), jkernels.RIESZ_HIGHPASS_9x9))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert not np.isnan(got[4, 4])


def test_color_conversions_match_reference():
    rng = _rng(3)
    u8 = rng.integers(0, 256, (3, 24, 40), dtype=np.uint8)
    unit_t = tcolor.u8_to_unit_f32(_t(u8))
    unit_j = jcolor.u8_to_unit_f32(jnp.asarray(u8))
    np.testing.assert_array_equal(unit_t.numpy(), _np(unit_j))
    # cbrt via pow(x, 1/3): a few f32 ulps, < 2e-4 in L/a/b of magnitude <= 100
    lab_t = tcolor.bgr_to_lab(unit_t)
    lab_j = jcolor.bgr_to_lab(unit_j)
    np.testing.assert_allclose(lab_t.numpy(), _np(lab_j), atol=2e-4)
    back_t = tcolor.lab_to_bgr(_t(_np(lab_j)))
    back_j = jcolor.lab_to_bgr(lab_j)
    np.testing.assert_allclose(back_t.numpy(), _np(back_j), atol=2e-6)
    # the round trip itself, in either package, is good to ~2e-5 of the unit range
    np.testing.assert_allclose(back_t.numpy(), unit_t.numpy(), atol=5e-5)


def test_to_u8_rounds_half_to_even_and_saturates():
    x = np.array([-3.0, 0.5, 1.5, 2.5, 254.5, 255.49, 300.0, 127.5], np.float32)
    got = tcolor.to_u8(_t(x)).numpy()
    np.testing.assert_array_equal(got, _np(jcolor.to_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(got, [0, 0, 2, 2, 254, 255, 255, 128])
    v = _rng(4).random((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tcolor.to_u8(_t(v), 255.0, 1.0 / 255.0).numpy(),
                                  _np(jcolor.to_u8(jnp.asarray(v), 255.0, 1.0 / 255.0)))


def test_gray_is_bit_exact():
    u8 = _rng(5).integers(0, 256, (3, 31, 17), dtype=np.uint8)
    got = tcolor.bgr_to_gray_u8(_t(u8))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, 31, 17)
    np.testing.assert_array_equal(got.numpy(), _np(jcolor.bgr_to_gray_u8(jnp.asarray(u8))))


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((50, 70), (12, 17))])
def test_resize_area_matches_reference(src, dst):
    x = _rng(6).random((3,) + src).astype(np.float32) * 255.0
    got = tresize.resize_area(_t(x), dst).numpy()
    np.testing.assert_allclose(got, _np(jresize.resize_area(jnp.asarray(x), dst)), atol=3e-4)
    np.testing.assert_array_equal(tresize.resize_matrix(50, 12, "area"),
                                  jresize.resize_matrix(50, 12, "area"))


@pytest.mark.parametrize("small,out", [((6, 8), (12, 16)), ((6, 8), (11, 15)), ((68, 120), (135, 240))])
def test_nearest_even_inject_matches_reference(small, out):
    x = _rng(7).random(small).astype(np.float32)
    got = tresize.resize_nearest_even_inject(_t(x), out).numpy()
    np.testing.assert_array_equal(got, _np(jresize.resize_nearest_even_inject(jnp.asarray(x), out)))
    with pytest.raises(ValueError):
        tresize.resize_nearest_even_inject(_t(x), (2 * small[0] + 1, out[1]))


@pytest.mark.parametrize("hz,fps", [(0.5, 30.0), (3.0, 30.0), (14.9, 30.0), (0.0, 30.0), (20.0, 30.0)])
def test_butterworth_matches_reference(hz, fps):
    b_t, a_t = ttemporal.butterworth_bandpass_coeffs(hz, fps)
    b_j, a_j = jtemporal.butterworth_bandpass_coeffs(hz, fps)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(a_t, a_j)


def test_df2_step_matches_reference():
    rng = _rng(8)
    planes = [rng.random((9, 11)).astype(np.float32) - 0.5 for _ in range(8)]
    b, a = jtemporal.butterworth_bandpass_coeffs(1.0, 30.0)
    b32 = tuple(float(v) for v in b.astype(np.float32))
    a32 = tuple(float(v) for v in a.astype(np.float32))
    tc = lambda i: ttemporal.CompExp(_t(planes[i]), _t(planes[i + 1]))
    jc = lambda i: jtemporal.CompExp(jnp.asarray(planes[i]), jnp.asarray(planes[i + 1]))
    got = ttemporal.riesz_df2_step(tc(0), tc(2), tc(4), tc(6), b32, a32)
    ref = jtemporal.riesz_df2_step(jc(0), jc(2), jc(4), jc(6),
                                   jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cos.numpy(), _np(r.cos), atol=1e-6)
        np.testing.assert_allclose(g.sin.numpy(), _np(r.sin), atol=1e-6)


@pytest.mark.parametrize("hw", [(2160, 3840), (1080, 1920), (64, 96), (5, 100), (6, 6), (135, 241)])
def test_level_counts_and_sizes_match_reference(hw):
    assert tpyramid.calculate_max_levels(hw) == jpyramid.calculate_max_levels(hw)
    assert triesz.riesz_level_sizes(*hw, 6) == jriesz.riesz_level_sizes(*hw, 6)


def test_clamped_arccos_quirk_and_patch_nans():
    x = np.array([-1.5, -1.0000001, -1.0, -0.3, 0.0, 0.7, 1.0, 1.2, np.nan], np.float32)
    got = triesz.clamped_arccos(_t(x)).numpy()
    ref = _np(jriesz.clamped_arccos(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-7, equal_nan=True)
    assert got[0] == -1.0 and got[1] == -1.0  # below -1 maps to -1.0, not pi
    assert got[7] == 1.0
    y = np.array([np.nan, np.inf, -np.inf, 2.0], np.float32)
    np.testing.assert_array_equal(triesz.patch_nans(_t(y)).numpy(), [0.0, np.inf, -np.inf, 2.0])


def _level_pair(rng, h, w):
    mk = lambda: rng.random((h, w)).astype(np.float32) * 2.0 - 1.0
    return [mk() for _ in range(3)], [mk() for _ in range(3)]


def test_phase_tail_matches_reference():
    rng = _rng(9)
    h, w = 23, 37
    cur, prior = _level_pair(rng, h, w)
    cur[1][3, 4] = cur[2][3, 4] = prior[1][3, 4] = prior[2][3, 4] = 0.0  # xy_norm == 0
    tl = lambda p: triesz.RieszLevel(_t(p[0]), ttemporal.CompExp(_t(p[1]), _t(p[2])))
    jl = lambda p: jriesz.RieszLevel(jnp.asarray(p[0]),
                                     jtemporal.CompExp(jnp.asarray(p[1]), jnp.asarray(p[2])))
    pt = triesz.phase_difference_and_amplitude(tl(cur), tl(prior))
    pj = jriesz.phase_difference_and_amplitude(jl(cur), jl(prior))
    np.testing.assert_allclose(pt.phase_diff.cos.numpy(), _np(pj.phase_diff.cos), atol=2e-6)
    np.testing.assert_allclose(pt.phase_diff.sin.numpy(), _np(pj.phase_diff.sin), atol=2e-6)
    np.testing.assert_allclose(pt.amplitude.numpy(), _np(pj.amplitude), atol=1e-6)
    np.testing.assert_allclose(pt.amplitude_blurred.numpy(), _np(pj.amplitude_blurred), atol=1e-6)

    hi = [rng.random((h, w)).astype(np.float32) - 0.5 for _ in range(2)]
    lo = [rng.random((h, w)).astype(np.float32) - 0.5 for _ in range(2)]
    nt = triesz.normalize_phase(ttemporal.CompExp(_t(hi[0]), _t(hi[1])),
                                ttemporal.CompExp(_t(lo[0]), _t(lo[1])),
                                pt.amplitude, pt.amplitude_blurred)
    nj = jriesz.normalize_phase(jtemporal.CompExp(jnp.asarray(hi[0]), jnp.asarray(hi[1])),
                                jtemporal.CompExp(jnp.asarray(lo[0]), jnp.asarray(lo[1])),
                                pj.amplitude, pj.amplitude_blurred)
    np.testing.assert_allclose(nt.cos.numpy(), _np(nj.cos), atol=2e-5)
    np.testing.assert_allclose(nt.sin.numpy(), _np(nj.sin), atol=2e-5)
    alpha, thr = float(np.float32(30.0)), float(np.float32(1.2))
    ot = triesz.amplify_level(tl(cur), nt, alpha, thr)
    oj = jriesz.amplify_level(jl(cur), nj, jnp.float32(alpha), jnp.float32(thr))
    np.testing.assert_allclose(ot.numpy(), _np(oj), atol=2e-4)
