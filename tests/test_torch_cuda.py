"""Card-only tests of the port: the CUDA stencil kernels against their plain
versions, and the phase chain on the card against the CPU.

Marked ``cuda``; each test decides inside itself whether a card exists and
skips otherwise. They import neither JAX nor cv2, so they run where only torch
and numpy are installed; run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.kernels import (
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
    RIESZ_LOWPASS_9x9,
)

pytestmark = pytest.mark.cuda

LP2 = 2.0 * RIESZ_LOWPASS_9x9
SHAPES = [(33, 257), (97, 201), (135, 241), (128, 128), (5, 5), (270, 480)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from live_video_magnification_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _plane(shape, dev, seed=0):
    rng = np.random.default_rng(seed + shape[0] * 1000 + shape[1])
    return torch.from_numpy(rng.random(shape, dtype=np.float32) * 100.0 - 20.0).to(dev)


def _same(got, ref):
    """Bit-equal up to the sign of a zero: the kernels round every product and
    sum in the plain version's order."""
    assert got.shape == ref.shape and got.device == ref.device
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_build_stencils_equal_plain_versions(cuda, shape):
    x = _plane(shape, cuda)
    before = dict(stencils.LAUNCHES)
    _same(stencils.conv9(x, RIESZ_HIGHPASS_9x9), stencils.conv9_plain(x, RIESZ_HIGHPASS_9x9))
    for got, ref in zip(stencils.band5(x, RIESZ_BAND_KERNEL),
                        stencils.band5_plain(x, RIESZ_BAND_KERNEL)):
        _same(got, ref)
    _same(stencils.lp9_decimate(x, LP2), stencils.lp9_decimate_plain(x, LP2))
    torch.cuda.synchronize()
    for k in ("conv9", "band5", "lp9_decimate"):
        assert stencils.LAUNCHES[k] == before[k] + 1


@pytest.mark.parametrize("small,out", [((17, 129), (33, 257)), ((49, 101), (97, 201)),
                                       ((68, 121), (135, 241)), ((68, 120), (135, 240)),
                                       ((64, 64), (128, 128)), ((3, 3), (5, 5)),
                                       ((135, 240), (270, 480))])
def test_inject_stencil_equals_plain_version(cuda, small, out):
    s = _plane(small, cuda)
    if min(small) < stencils.MIN_SIDE:
        with pytest.raises(ValueError):
            stencils.lp9_inject(s, LP2, out)
        return
    _same(stencils.lp9_inject(s, LP2, out), stencils.lp9_inject_plain(s, LP2, out))


def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("conv9_plain", "band5_plain", "lp9_decimate_plain", "lp9_inject_plain"):
        monkeypatch.setattr(stencils, name, refuse)
    x = _plane((40, 60), cuda)
    stencils.conv9(x, RIESZ_HIGHPASS_9x9)
    stencils.band5(x, RIESZ_BAND_KERNEL)
    stencils.lp9_decimate(x, LP2)
    stencils.lp9_inject(x, LP2, (79, 120))
    torch.cuda.synchronize()


def test_chain_on_the_card_matches_the_cpu(cuda):
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    cfg = ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=30.0, co_wavelength=40.0,
        co_low=0.5, co_high=3.0, levels=4, framerate=30.0))
    gpu, cpu = MagnificationChain(device=cuda), MagnificationChain(device="cpu")
    for i, f in enumerate(moving_clip(6, 135, 241, seed=4)):
        a = gpu.process(f, cfg)[0]
        assert a.device.type == "cuda"
        a = a.cpu().numpy()
        b = cpu.process(f, cfg)[0].numpy()
        # the stencils agree bit for bit; CUDA's and the CPU's acos, sqrt, pow,
        # sin and cos do not, so a frame may move by an LSB or two
        lsb = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        assert psnr_u8(a, b) >= 40.0, f"frame {i}: {psnr_u8(a, b):.2f} dB, max {lsb} LSB"
