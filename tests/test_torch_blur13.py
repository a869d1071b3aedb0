"""The plain tail's 13x13 amplitude blur, ``ops/hopper/stencils.py::blur13``,
on the CPU, where it runs its plain version: equal to ``sep_correlate2d`` with
the 13 taps at the shapes that reach every edge of the kernel's tiles and on
batches of planes; ``ops/riesz.py::amplitude_blur`` through it, unchanged and
against the reference package's; what the launcher refuses; the tail
kernels' plain versions on ``blur13_plain``, never the launcher; and
``models/riesz.py::blur_launches``, which the card's checks hold the launch
counts to, against the calls each phase path makes. The CUDA kernel itself
is held against ``blur13_plain`` bit for bit on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from live_video_magnification_tpu.ops import riesz as jriesz
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.ops import riesz as triesz_ops
from live_video_magnification_tpu_torch.ops.conv import sep_correlate2d
from live_video_magnification_tpu_torch.ops.hopper import stencils, tail
from live_video_magnification_tpu_torch.ops.kernels import AMPLITUDE_BLUR_KERNEL_1D
from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# the CPU runs the composition itself: the shapes that stay small here
CPU_SHAPES = [s for s in stencils.blur13_shapes() if s[0] * s[1] <= 300_000]


def _bits(got, ref):
    """Bit-equal, the sign of a zero included; NaN where ref has NaN."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])


def _planes(shape, seed=0):
    rng = np.random.default_rng(seed + 1000 * shape[-2] + shape[-1])
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 30.0)


def _reference(x):
    return sep_correlate2d(x, AMPLITUDE_BLUR_KERNEL_1D, AMPLITUDE_BLUR_KERNEL_1D)


def test_blur13_shapes_reach_every_edge_of_the_tiles():
    src = (REPO / "live_video_magnification_tpu_torch/ops/hopper/csrc/stencils.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    tw = const("BLUR_TW")
    assert stencils.BLUR13_TILES == {"tall": (const("BLUR_TALL_TH"), tw),
                                     "small": (const("BLUR_SMALL_TH"), tw)}
    assert "constexpr int BLUR_TALL_MIN = 2 * BLUR_MIN_BLOCKS * 132;" in src
    assert stencils.BLUR13_TALL_MIN == 2 * const("BLUR_MIN_BLOCKS") * 132
    tiles = lambda s, kind: (-(-s[0] // stencils.BLUR13_TILES[kind][0])
                             * -(-s[1] // stencils.BLUR13_TILES[kind][1]))
    shapes = stencils.blur13_shapes()
    for n in (1, 2, 6, 7, 13, 14):  # under, at and over the 6-px reach, either side
        assert any(s[0] == n for s in shapes) and any(s[1] == n for s in shapes)
    for kind in ("small", "tall"):
        th, _ = stencils.BLUR13_TILES[kind]
        sized = [s for s in shapes
                 if (tiles(s, "tall") >= stencils.BLUR13_TALL_MIN) == (kind == "tall")]
        assert any(s[0] % th == 0 and s[1] % tw == 0 for s in sized)
        assert any(s[0] % th == 1 for s in sized) and any(s[1] % tw == 1 for s in sized)
    assert {s[1] % 4 for s in shapes if s[1] > tw} == {0, 1, 2, 3}
    assert (2160, 3840) in shapes and (1080, 1920) in shapes
    assert tiles((2160, 3840), "tall") >= stencils.BLUR13_TALL_MIN > tiles((1080, 1920), "tall")
    assert "int lvmt_blur13(" in src
    # the roofline of the benchmark reads K1-K4 by these names; the blur's
    # kernel must not be counted among them
    kernels = set(re.findall(r"^(\w+_kernel)\(", src, re.M))
    assert "blur13_kernel" in kernels
    assert not any(k in "blur13_kernel"
                   for k in ("stencil9_kernel", "band5_kernel", "inject9_kernel"))


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_blur13_on_the_cpu_equals_sep_correlate2d(shape):
    x = _planes(shape)
    before = dict(stencils.LAUNCHES)
    _bits(stencils.blur13(x), _reference(x))
    _bits(stencils.blur13_plain(x), _reference(x))
    assert stencils.LAUNCHES == before  # a CPU tensor runs the plain version


@pytest.mark.parametrize("shape", [(4, 33, 70), (2, 3, 13, 6)], ids=["THW", "BTHW"])
def test_blur13_blurs_each_plane_of_a_batch(shape):
    """[..., H, W]: each plane as if alone (the time-parallel path's [T, H, W])."""
    x = _planes(shape)
    got = stencils.blur13(x)
    _bits(got, _reference(x))
    flat = x.reshape(-1, *shape[-2:])
    for k, plane in enumerate(got.reshape(-1, *shape[-2:])):
        _bits(plane, _reference(flat[k]))


def test_blur13_keeps_nan_inf_signed_zeros_and_subnormals():
    x = _planes((40, 72))
    x[3:10, 4:12] = 0.0
    x[3:10, 4:8] = -0.0
    x[20, 30] = float("nan")
    x[25, 60] = float("inf")
    x[30, 5] = float("-inf")
    x[12:18, 40:60] *= np.float32(1e-39)
    _bits(stencils.blur13(x), _reference(x))


def test_amplitude_blur_on_the_cpu_is_unchanged():
    x = _planes((97, 201)).abs()
    got = triesz_ops.amplitude_blur(x)
    _bits(got, _reference(x))
    ref = np.asarray(jriesz.amplitude_blur(x.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_blur13_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((16, 16))
    with pytest.raises(TypeError, match="float32"):
        stencils.blur13(x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        stencils.blur13(x.double())
    with pytest.raises(ValueError, match=r"\[\.\.\., H, W\]"):
        stencils.blur13(torch.zeros(16))
    with pytest.raises(ValueError, match="contiguous"):
        stencils.blur13(torch.zeros((16, 20)).t())
    with pytest.raises(ValueError, match="empty"):
        stencils.blur13(torch.zeros((0, 16)))


def test_tail_plain_versions_blur_with_blur13_plain(monkeypatch):
    """riesz_amplify_plain and riesz_level_mxu_plain take the blur's plain
    version, never the launcher (on the card they hold the tail kernels
    against plain PyTorch)."""
    def refuse(*a, **k):
        raise AssertionError("a tail plain version called the blur13 launcher")

    monkeypatch.setattr(stencils, "blur13", refuse)
    monkeypatch.setattr(triesz_ops, "blur13", refuse)
    calls = []
    real = tail.blur13_plain
    monkeypatch.setattr(tail, "blur13_plain", lambda x: calls.append(1) or real(x))
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.standard_normal((20, 30), dtype=np.float32))
              for _ in range(16)]
    planes[0] = planes[0].abs()
    tail.riesz_amplify_plain(*planes[:6], 30.0, 1.2)
    assert len(calls) == 3
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, 30.0),
                                  butterworth_bandpass_coeffs(3.0, 30.0))
    tail.riesz_level_mxu_plain(*planes[:6], planes[6:8], planes[8:12], planes[12:], b_lo, a_lo,
                               b_hi, a_hi, False, 30.0, 1.2)
    assert len(calls) == 6


def _dyn():
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, 30.0),
                                  butterworth_bandpass_coeffs(3.0, 30.0))
    return triesz.RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo), c3(a_lo),
                                 c3(b_hi), c3(a_hi), False, False)


def _counting(monkeypatch):
    calls = []
    real = triesz_ops.blur13
    monkeypatch.setattr(triesz_ops, "blur13", lambda x: calls.append(x.shape) or real(x))
    return calls


@pytest.mark.parametrize("tail_name,phase_fused", [("jnp", False), ("pallas", False),
                                                   ("mxu", False), ("level", False),
                                                   ("jnp", True), ("pallas", True)])
def test_blur_launches_count_the_steps_blur13_calls(tail_name, phase_fused, monkeypatch):
    """48x64 levels 4: band levels 48x64 and 24x32 take a tail kernel where
    the flags ask for one, 12x16 (under the kernels' 16) the plain tail."""
    h, w, levels = 48, 64, 4
    calls = _counting(monkeypatch)
    state = triesz.init_state(h, w, levels, device="cpu")
    frames = moving_clip(2, h, w, seed=5)
    for k, f in enumerate(frames):
        before = len(calls)
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1)))
        state, _ = triesz.step(state, chw, _dyn(), levels=levels, tail=tail_name,
                               phase_fused=phase_fused)
        assert len(calls) - before == triesz.blur_launches(h, w, levels, tail_name, phase_fused)
    kernel_levels = 0 if tail_name == "jnp" or (phase_fused and tail_name != "pallas") else 2
    assert triesz.blur_launches(h, w, levels, tail_name, phase_fused) == 3 * (3 - kernel_levels)


def test_blur_launches_count_a_time_parallel_chunk_and_a_4k_frame(monkeypatch):
    """process_clip_parallel blurs each level's frames as one [T, H, W]
    batch; a 4K levels-6 frame of the default tail blurs 15 times."""
    h, w, levels, t = 40, 56, 3, 3
    calls = _counting(monkeypatch)
    clip = np.ascontiguousarray(moving_clip(t, h, w, seed=6).transpose(0, 3, 1, 2))
    triesz.process_clip_parallel(torch.from_numpy(clip), _dyn(), levels=levels, device="cpu")
    assert len(calls) == triesz.blur_launches(h, w, levels) == 6
    assert all(s[0] == t for s in calls)
    assert triesz.blur_launches(2160, 3840, 6) == 15
    assert triesz.blur_launches(2160, 3840, 6, "mxu") == 0
    assert triesz.blur_launches(2160, 3840, 6, "level", phase_fused=True) == 15
    with pytest.raises(ValueError):
        triesz.blur_launches(64, 64, 3, "nope")
