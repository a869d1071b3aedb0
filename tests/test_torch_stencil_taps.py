"""The zero-pattern classifier of the 9x9 stencils (ops/hopper/stencils.py)
and the CPU route of conv9 and lp9_decimate under every pattern.

conv9 and lp9_decimate tell their CUDA kernel whether the taps they pass have
the zero pattern of their main-path bank, which the kernel skips at compile
time: exactly the taps the plain version skips. The classifier must therefore
be exact: a bank is "dense" or "no_corners" only if its used taps are
precisely those, after the bf16 arm's rounding. On CPU tensors both functions run their plain versions, bit for
bit, and launch nothing.
"""

import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_HIGHPASS_9x9,
)

torch.set_num_threads(2)


def _random_taps(seed=3, zeros=()):
    k = np.random.default_rng(seed).standard_normal((9, 9)).astype(np.float32)
    for a, b in zeros:
        k[a, b] = 0.0
    return k


def _one_interior_zero():
    k = LOWPASS_2X.copy()
    k[4, 3] = 0.0
    return k


def _hp9_with_a_corner():
    k = RIESZ_HIGHPASS_9x9.copy()
    k[0, 0] = 1e-3
    return k


def _dense_with_negative_zero():
    k = LOWPASS_2X.copy()
    k[8, 8] = -0.0  # skipped by the plain version, like +0
    return k


@pytest.mark.parametrize("taps,pattern", [
    (RIESZ_HIGHPASS_9x9, "no_corners"),
    (stencils.round_taps_bf16(RIESZ_HIGHPASS_9x9), "no_corners"),
    (LOWPASS_2X, "dense"),
    (stencils.round_taps_bf16(LOWPASS_2X), "dense"),
    (_random_taps(), "dense"),
    (_random_taps(zeros=[(2, 5), (7, 1)]), "any"),
    (_one_interior_zero(), "any"),
    (_hp9_with_a_corner(), "any"),
    (_dense_with_negative_zero(), "any"),
    (np.zeros((9, 9), np.float32), "any"),
], ids=["hp9", "hp9_bf16", "lp2", "lp2_bf16", "random_dense", "random_zeros",
        "interior_zero", "hp9_one_corner", "negative_zero", "all_zero"])
def test_tap_pattern_classifies_exactly_the_used_taps(taps, pattern):
    assert stencils.tap_pattern(taps) == pattern
    assert stencils.tap_pattern(np.asarray(taps).reshape(-1)) == pattern


def test_kernel_taps_are_classified_after_the_bf16_rounding():
    k = LOWPASS_2X.copy()
    k[0, 4] = 1e-45  # an f32 denormal that bf16 rounds to zero
    key = np.ascontiguousarray(k, np.float32).reshape(-1).tobytes()
    taps, main = stencils._kernel_taps(key, False, "lp9_decimate")
    assert main
    np.testing.assert_array_equal(taps, k.reshape(-1))
    taps, main = stencils._kernel_taps(key, True, "lp9_decimate")
    assert not main and taps[4] == 0.0
    np.testing.assert_array_equal(taps, stencils.round_taps_bf16(k).reshape(-1))


@pytest.mark.parametrize("fn,bank,bf16,main", [
    ("conv9", "hp9", False, True), ("conv9", "hp9", True, True),
    ("conv9", "lp2", False, False), ("conv9", "random_dense", True, False),
    ("lp9_decimate", "lp2", False, True), ("lp9_decimate", "lp2", True, True),
    ("lp9_decimate", "random_dense", False, True), ("lp9_decimate", "hp9", False, False),
])
def test_only_the_main_path_pattern_takes_its_instantiation(fn, bank, bf16, main):
    """conv9's compile-time taps are the high-pass's (no corners), decimate's
    2*LP9's (all 81); any other bank takes the run-time tap test."""
    k9 = {"hp9": RIESZ_HIGHPASS_9x9, "lp2": LOWPASS_2X, "random_dense": _random_taps()}[bank]
    key = np.ascontiguousarray(k9, np.float32).reshape(-1).tobytes()
    assert stencils._kernel_taps(key, bf16, fn)[1] is main


BANKS = {"hp9": RIESZ_HIGHPASS_9x9, "lp2": LOWPASS_2X,
         "random_zeros": _random_taps(zeros=[(2, 5), (7, 1), (4, 4)]),
         "all_zero": np.zeros((9, 9), np.float32)}
ARMS = [("conv9", False, "f32"), ("conv9", True, "f32"), ("conv9", True, "bf16"),
        ("lp9_decimate", False, "f32"), ("lp9_decimate", True, "f32")]


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("fn,bf16,out_dtype", ARMS)
def test_cpu_tensors_take_the_plain_version_under_every_pattern(fn, bf16, out_dtype, bank):
    k9 = BANKS[bank]
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((13, 37)).astype(np.float32)
                         * 50.0)
    before = (dict(stencils.LAUNCHES), dict(stencils.LAUNCHES_BF16))
    if fn == "conv9":
        got = stencils.conv9(x, k9, bf16=bf16, out_dtype=out_dtype)
        ref = stencils.conv9_plain(x, k9, bf16, out_dtype)
    else:
        got = stencils.lp9_decimate(x, k9, bf16=bf16)
        ref = stencils.lp9_decimate_plain(x, k9, bf16)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    # bit for bit, the sign of a zero included
    assert torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32),
                       ref.view(torch.int16 if ref.dtype == torch.bfloat16 else torch.int32))
    assert (dict(stencils.LAUNCHES), dict(stencils.LAUNCHES_BF16)) == before
