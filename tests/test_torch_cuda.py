"""Card-only tests of the port: the CUDA stencil, build and tail kernels
(with their bf16 arms) and the plain tail's amplitude blur (blur13) against
their plain versions, the phase step
(under each tail configuration, each build and the fast flags) and chain on
the card against the CPU, the motion and colour modes (step, chain and
ClipProcessor) on the card against the CPU, the time-parallel clip path
of all three modes against the sequential one and the CPU, ClipProcessor's
pinned readback on its copy stream against a plain ``.cpu()``, its step
replayed as a CUDA graph against the eager step, its upload of a host chunk
through its pinned ring against a chunk already on the card, and the live
engine (``PlaybackController``'s stencil launches) and the ``Exporter`` on the
card.

Marked ``cuda``; each test decides inside itself whether a card exists and
skips otherwise. They import neither JAX nor cv2, so they run where only torch
and numpy are installed; run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.hopper.tail import amplify13_shapes
from live_video_magnification_tpu_torch.ops.kernels import (
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
    RIESZ_LOWPASS_9x9,
)

pytestmark = pytest.mark.cuda

LP2 = 2.0 * RIESZ_LOWPASS_9x9
# conv9's and lp9_decimate's tiles (csrc/stencils.cu): the smallest sides;
# one block of each tile (conv9 8x128 and 32x128 outputs, decimate 16x128
# and 32x256 inputs) and one more row or column; widths of each residue mod 4
# (16-byte rows or not), small and large enough for the tall tiles; two
# levels of 2160x3840
STENCIL9_SHAPES = ([(5, 9), (9, 5)]
                   + [s for th, tw in [(8, 128), (32, 128), (16, 128), (32, 256)]
                      for s in [(th, tw), (th + 1, tw), (th, tw + 1)]]
                   + [(37, 200 + m) for m in range(4)] + [(545, 2048 + m) for m in range(4)]
                   + [(544, 2048), (1088, 4096), (1089, 4097), (135, 240), (1080, 1920)])
SHAPES = [(33, 257), (97, 201), (135, 241), (128, 128), (5, 5), (270, 480)] + STENCIL9_SHAPES


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


def _bits(got, ref):
    """Bit-equal, the sign of a zero included."""
    _same(got, ref)
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    assert torch.equal(got.view(as_int[got.dtype]), ref.view(as_int[ref.dtype]))


@pytest.mark.parametrize("shape", SHAPES)
def test_build_stencils_equal_plain_versions(cuda, shape):
    x = _plane(shape, cuda)
    before = dict(stencils.LAUNCHES)
    _same(stencils.conv9(x, RIESZ_HIGHPASS_9x9), stencils.conv9_plain(x, RIESZ_HIGHPASS_9x9))
    for got, ref in zip(stencils.band5(x, RIESZ_BAND_KERNEL),
                        stencils.band5_plain(x, RIESZ_BAND_KERNEL)):
        _bits(got, ref)
    _same(stencils.lp9_decimate(x, LP2), stencils.lp9_decimate_plain(x, LP2))
    torch.cuda.synchronize()
    for k in ("conv9", "band5", "lp9_decimate"):
        assert stencils.LAUNCHES[k] == before[k] + 1


ANY_TAPS_SHAPES = [(5, 9), (33, 257), (37, 202), (545, 2049), (544, 2048), (1080, 1920)]


@pytest.mark.parametrize("shape", ANY_TAPS_SHAPES)
def test_stencils_take_any_taps(cuda, shape):
    """Standard-normal taps with scattered zeros, and an all-zero bank: the
    kernel's run-time tap test, in both arms and both conv9 outputs. A band
    of zero pixels makes signed zeros, whose signs match as well."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    k9 = rng.standard_normal((9, 9)).astype(np.float32)
    k9.flat[rng.choice(81, 9, replace=False)] = 0.0
    k9[4, 3] = 0.0
    assert stencils.tap_pattern(k9) == "any"
    x = _plane(shape, cuda)
    x[:, : shape[1] // 2] = 0.0
    before = (stencils.LAUNCHES["conv9"], stencils.LAUNCHES["lp9_decimate"])
    for k in (k9, np.zeros((9, 9), np.float32)):
        for bf16 in (False, True):
            for od in ("f32", "bf16"):
                _bits(stencils.conv9(x, k, bf16=bf16, out_dtype=od),
                      stencils.conv9_plain(x, k, bf16, od))
            _bits(stencils.lp9_decimate(x, k, bf16=bf16), stencils.lp9_decimate_plain(x, k, bf16))
    torch.cuda.synchronize()
    assert (stencils.LAUNCHES["conv9"], stencils.LAUNCHES["lp9_decimate"]) == (
        before[0] + 4, before[1] + 2)


@pytest.mark.parametrize("shape", [(5, 9), (37, 203), (544, 2048), (1080, 1920)])
def test_main_path_taps_match_the_sign_of_zero(cuda, shape):
    """HP9 (no corners) and 2*LP9 (dense) start each row sum from its first
    product and the total from its first row, as the plain version does."""
    x = _plane(shape, cuda)
    x[: shape[0] // 2] = 0.0
    for bf16 in (False, True):
        _bits(stencils.conv9(x, RIESZ_HIGHPASS_9x9, bf16=bf16),
              stencils.conv9_plain(x, RIESZ_HIGHPASS_9x9, bf16))
        _bits(stencils.lp9_decimate(x, LP2, bf16=bf16), stencils.lp9_decimate_plain(x, LP2, bf16))


@pytest.mark.parametrize("shape", [(5, 9), (37, 203), (544, 2048), (1080, 1920)])
def test_each_others_bank_takes_the_run_time_taps(cuda, shape):
    """2*LP9 through conv9 and HP9 through decimate: a bank with no
    instantiation of its own, so the kernel tests its taps as it runs."""
    x = _plane(shape, cuda)
    x[: shape[0] // 2] = 0.0
    for bf16 in (False, True):
        for od in ("f32", "bf16"):
            _bits(stencils.conv9(x, LP2, bf16=bf16, out_dtype=od),
                  stencils.conv9_plain(x, LP2, bf16, od))
        _bits(stencils.lp9_decimate(x, RIESZ_HIGHPASS_9x9, bf16=bf16),
              stencils.lp9_decimate_plain(x, RIESZ_HIGHPASS_9x9, bf16))


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
    _bits(stencils.lp9_inject(s, LP2, out), stencils.lp9_inject_plain(s, LP2, out))


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


# ---------------------------------------------------------------- the plain tail's amplitude blur


def _bits_nan(got, ref):
    """Bit-equal, the sign of a zero included; NaN where ref has NaN."""
    assert got.shape == ref.shape and got.dtype == ref.dtype and got.device == ref.device
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])


def _specials(x):
    """``_zeros_and_tiny(x)`` with a NaN and both infinities, where the shape
    allows."""
    x = _zeros_and_tiny(x)
    h, w = x.shape[-2:]
    x[..., (2 * h) // 3, (2 * w) // 3] = float("nan")
    if h * w > 4:
        x[..., h - 1, w - 1] = float("inf")
        x[..., h // 2, 0] = float("-inf")
    return x


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", stencils.blur13_shapes())
def test_blur13_equals_its_plain_version_bit_for_bit(cuda, shape, offset):
    """Every shape of ``stencils.blur13_shapes()`` (sides 1 to 14 on either
    side, the tile's edges, every band level of 1080p and of 2160x3840
    levels 6), aligned and one element off, on a plain plane and on one
    with NaN, infinities, -0 and subnormals."""
    before = stencils.LAUNCHES["blur13"]
    for x in (_plane(shape, cuda), _specials(_plane(shape, cuda, seed=1))):
        if offset:
            x = _misaligned(x)
        _bits_nan(stencils.blur13(x), stencils.blur13_plain(x))
    torch.cuda.synchronize()
    assert stencils.LAUNCHES["blur13"] == before + 2


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(5, 135, 241), (32, 68, 120), (32, 270, 480), (3, 2, 70, 64),
                                   (2, 7, 13)])
def test_blur13_blurs_a_batch_of_planes_in_one_launch(cuda, shape, offset):
    """[T, H, W] (the time-parallel path's; 32 x 270 x 480 in tall tiles)
    and [B, T, H, W]: one launch, each plane bit for bit the plain
    version's, aligned and one element off."""
    x = _specials(_plane(shape[-2:], cuda).expand(shape).contiguous()
                  + torch.arange(int(np.prod(shape[:-2])), device=cuda,
                                 dtype=torch.float32).reshape(*shape[:-2], 1, 1))
    if offset:
        x = _misaligned(x)
    before = stencils.LAUNCHES["blur13"]
    got = stencils.blur13(x)
    torch.cuda.synchronize()
    assert stencils.LAUNCHES["blur13"] == before + 1
    _bits_nan(got, stencils.blur13_plain(x))
    flat = x.reshape(-1, *shape[-2:])
    for k, plane in enumerate(got.reshape(-1, *shape[-2:])):
        _bits_nan(plane, stencils.blur13_plain(flat[k].contiguous()))


def test_a_4k_phase_frame_launches_15_blurs_and_no_plain_stencil(cuda, monkeypatch):
    """The jnp tail at 2160x3840 levels 6 on the card: 15 blur13 launches a
    frame (three a band level), and no ``*_plain`` stencil or tail function
    called for a CUDA tensor."""
    from live_video_magnification_tpu_torch.models import riesz
    from live_video_magnification_tpu_torch.ops.hopper import tail
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, names in ((stencils, ("conv9_plain", "band5_plain", "lp9_decimate_plain",
                                   "lp9_inject_plain", "riesz_build_level_plain",
                                   "blur13_plain")),
                       (tail, ("riesz_phase_df2_fused_plain", "riesz_amplify_plain",
                               "riesz_level_mxu_plain", "blur13_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    h, w, levels = 2160, 3840, 6
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(1.0, 30.0),
                                  butterworth_bandpass_coeffs(5.0, 30.0))
    dyn = riesz.RieszDynParams(50.0, float(np.float32(0.5 * np.pi)), c3(b_lo), c3(a_lo),
                               c3(b_hi), c3(a_hi), False, False)
    state = riesz.init_state(h, w, levels, device=cuda)
    assert riesz.blur_launches(h, w, levels) == 15
    for f in moving_clip(2, h, w, seed=9):
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1))).to(cuda)
        before = dict(stencils.LAUNCHES)
        state, _ = riesz.step(state, chw, dyn, levels=levels, tail="jnp")
        torch.cuda.synchronize()
        assert stencils.LAUNCHES["blur13"] - before["blur13"] == 15
        assert stencils.LAUNCHES["conv9"] - before["conv9"] == 10


@pytest.mark.parametrize("phase_fused", [False, True], ids=["jnp", "phase_fused"])
def test_phase_chain_frames_equal_those_of_the_plain_blur(cuda, phase_fused, monkeypatch):
    """A jnp phase chain on the card at 540x960 levels 6 (the plain tail's
    three blurs on each of five band levels; alone and after K8 under
    LVMT_PHASE_FUSED) gives the same frames, byte for byte, as with
    ``amplitude_blur`` monkeypatched to ``blur13_plain``: the kernel changes
    no output."""
    from live_video_magnification_tpu_torch.models import riesz as model
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.ops import riesz as ops_riesz
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    if phase_fused:
        monkeypatch.setenv("LVMT_PHASE_FUSED", "1")
    cfg = _phase_cfg(levels=6)
    clip = moving_clip(6, 540, 960, seed=14)

    def run():
        chain = MagnificationChain(device=cuda)
        return np.stack([chain.process(f, cfg)[0].cpu().numpy() for f in clip])

    before = stencils.LAUNCHES["blur13"]
    kernel = run()
    assert stencils.LAUNCHES["blur13"] - before == 6 * 3 * 5
    with monkeypatch.context() as m:
        m.setattr(ops_riesz, "amplitude_blur", stencils.blur13_plain)
        m.setattr(model, "amplitude_blur", stencils.blur13_plain)
        before = stencils.LAUNCHES["blur13"]
        plain = run()
        assert stencils.LAUNCHES["blur13"] == before
    np.testing.assert_array_equal(kernel, plain)
    assert not np.array_equal(kernel[1], clip[1])  # magnified after the first frame


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


# ---------------------------------------------------------------- the tail kernels

TAIL_SHAPES = [(16, 16), (33, 257), (97, 201), (135, 241), (270, 480)]
TAIL_BARS = {"riesz_phase_df2_fused": (1e-5, 1e-5), "riesz_amplify_fused": (2e-4, 1e-4),
             "riesz_amplify_mxu": (2e-4, 1e-4), "riesz_level_mxu": (5e-4, 1e-3)}


def _tail_args(entry, shape, arm, dev):
    """Standard-normal planes; ``arm`` is rebuild (phase, level) or
    preweighted (amplify, whose amplitude is a standard normal's magnitude)."""
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs

    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 7 * arm)
    planes = lambda n: [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                        for _ in range(n)]
    coeffs = [np.asarray(c, np.float32) for c in (*butterworth_bandpass_coeffs(0.7, 30.0),
                                                  *butterworth_bandpass_coeffs(3.0, 30.0))]
    if entry == "riesz_phase_df2_fused":
        x = planes(18)
        return (*x[:6], tuple(x[6:12]), tuple(x[12:]), *coeffs, arm), {}
    if entry == "riesz_level_mxu":
        x = planes(16)
        return (*x[:6], tuple(x[6:8]), tuple(x[8:12]), tuple(x[12:]), *coeffs, arm,
                30.0, 1.2), {}
    amp, cc, cs, lp, rr, ri = planes(6)
    amp = amp.abs()
    if arm:
        cc, cs = cc * amp, cs * amp
    return (amp, cc, cs, lp, rr, ri, 30.0, 1.2), {"preweighted": arm}


def _flat_out(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for part in out for x in _flat_out(part)]


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("shape", TAIL_SHAPES)
@pytest.mark.parametrize("entry", list(TAIL_BARS))
def test_tail_kernels_match_plain_versions(cuda, entry, shape, arm):
    from live_video_magnification_tpu_torch.ops.hopper import tail

    plain = {"riesz_phase_df2_fused": tail.riesz_phase_df2_fused_plain,
             "riesz_amplify_fused": tail.riesz_amplify_plain,
             "riesz_amplify_mxu": tail.riesz_amplify_plain,
             "riesz_level_mxu": tail.riesz_level_mxu_plain}[entry]
    args, kw = _tail_args(entry, shape, arm, cuda)
    before = tail.LAUNCHES[entry]
    got = _flat_out(getattr(tail, entry)(*args, **kw))
    ref = _flat_out(plain(*args, **kw))
    torch.cuda.synchronize()
    assert tail.LAUNCHES[entry] == before + 1
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.device == r.device
        # K9's state planes: the reference suite's 1e-4 / 1e-4
        atol, rtol = (1e-4, 1e-4) if entry == "riesz_level_mxu" and k else TAIL_BARS[entry]
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, equal_nan=True,
                                   msg=lambda m: f"{entry} plane {k}: {m}")


def test_tail_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    from live_video_magnification_tpu_torch.ops.hopper import tail

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("riesz_phase_df2_fused_plain", "riesz_amplify_plain", "riesz_level_mxu_plain"):
        monkeypatch.setattr(tail, name, refuse)
    for entry in TAIL_BARS:
        args, kw = _tail_args(entry, (40, 60), False, cuda)
        getattr(tail, entry)(*args, **kw)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tail_name,phase_fused", [("jnp", False), ("pallas", False),
                                                   ("mxu", False), ("level", False),
                                                   ("jnp", True), ("pallas", True)])
def test_step_on_the_card_matches_the_cpu_under_each_tail(cuda, tail_name, phase_fused):
    from live_video_magnification_tpu_torch.models import riesz
    from live_video_magnification_tpu_torch.ops.hopper import tail
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w, levels = 135, 241, 4
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, 30.0),
                                  butterworth_bandpass_coeffs(3.0, 30.0))
    dyn = riesz.RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo), c3(a_lo),
                               c3(b_hi), c3(a_hi), False, False)
    gpu = riesz.init_state(h, w, levels, device=cuda)
    cpu = riesz.init_state(h, w, levels, device="cpu")
    before = dict(tail.LAUNCHES)
    for i, f in enumerate(moving_clip(5, h, w, seed=6)):
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1)))
        gpu, a = riesz.step(gpu, chw.to(cuda), dyn, levels=levels, tail=tail_name,
                            phase_fused=phase_fused)
        cpu, b = riesz.step(cpu, chw, dyn, levels=levels, tail=tail_name,
                            phase_fused=phase_fused)
        a, b = a.cpu().numpy(), b.numpy()
        lsb = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        assert lsb <= 1 and psnr_u8(a, b) >= 40.0, (
            f"{tail_name}/{phase_fused} frame {i}: {psnr_u8(a, b):.2f} dB, max {lsb} LSB")
    launched = {k for k, v in tail.LAUNCHES.items() if v > before[k]}
    expected = {("jnp", False): set(), ("pallas", False): {"riesz_amplify_fused"},
                ("mxu", False): {"riesz_amplify_mxu"}, ("level", False): {"riesz_level_mxu"},
                ("jnp", True): {"riesz_phase_df2_fused"},
                ("pallas", True): {"riesz_phase_df2_fused", "riesz_amplify_fused"}}
    assert launched == expected[(tail_name, phase_fused)]


# ---------------------------------------------------------------- K5 and the bf16 arms

# odd shapes, the 1080p level K5 runs on by default, and every band level of
# 1080p and 2160x3840 levels=6
BUILD_SHAPES = [(16, 16), (33, 257), (97, 201), (135, 241), (70, 130), (100, 101), (68, 120),
                (1080, 1920), (540, 960), (270, 480), (135, 240), (2160, 3840)]


def _exact(got, ref):
    """Within 1e-6 x max(1, max|plain|), the stencils' bar; 0 expected."""
    assert got.shape == ref.shape and got.dtype == ref.dtype and got.device == ref.device
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 1e-6 * max(1.0, float(ref.float().abs().max())), err


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", BUILD_SHAPES)
def test_build_level_equals_plain_version_and_the_three_stencils(cuda, shape, out_dtype):
    x = _plane(shape, cuda)
    before = stencils.LAUNCHES["riesz_build_level"]
    got = stencils.riesz_build_level(x, out_dtype=out_dtype)
    ref = stencils.riesz_build_level_plain(x, out_dtype)
    torch.cuda.synchronize()
    assert stencils.LAUNCHES["riesz_build_level"] == before + 1
    for g, r in zip(got, ref):
        _exact(g, r)
    hp = stencils.conv9(x, RIESZ_HIGHPASS_9x9)
    r, i = stencils.band5(hp, RIESZ_BAND_KERNEL)
    od = stencils.DTYPES[out_dtype]
    for g, k in zip(got, (hp.to(od), r.to(od), i.to(od), stencils.lp9_decimate(x, LP2))):
        _bits(g, k)


def _zeros_and_tiny(x):
    """x with a band of zeros (signed zeros in the outputs), a patch of -0
    and a patch of tiny and subnormal values (products below f32's smallest
    subnormal, bf16 operands included), where the shape allows; each plane
    of an [..., H, W] batch alike."""
    x = x.clone()
    h, w = x.shape[-2:]
    x[..., : h // 3, :] = 0.0
    x[..., h // 3:, : min(3, w)] = -0.0
    if h > 8 and w > 12:
        x[..., h // 2: h // 2 + 4, 4:12] = torch.tensor([1e-30, -3e-36, 1e-39, -1e-42],
                                                        device=x.device)[:, None]
    return x


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", stencils.build_level_shapes())
def test_build_level_tiles_equal_plain_version_bit_for_bit(cuda, shape, offset):
    """K5 at every edge of its tiles (both instantiations, 16-byte staging
    and stores or not, blocks that walk several tiles), the octave aligned
    and one element off, both output dtypes: bit for bit with the plain
    version and with K1+K2+K3, the sign of a zero included."""
    x = _zeros_and_tiny(_plane(shape, cuda))
    if offset:
        x = _misaligned(x)
    before = stencils.LAUNCHES["riesz_build_level"]
    hp = stencils.conv9(x, RIESZ_HIGHPASS_9x9)
    three = (hp, *stencils.band5(hp, RIESZ_BAND_KERNEL), stencils.lp9_decimate(x, LP2))
    for od in ("f32", "bf16"):
        got = stencils.riesz_build_level(x, out_dtype=od)
        ref = stencils.riesz_build_level_plain(x, od)
        for g, r, k in zip(got, ref, three):
            _bits(g, r)
            _bits(g, k.to(g.dtype))
    torch.cuda.synchronize()
    assert stencils.LAUNCHES["riesz_build_level"] == before + 2


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", stencils.band5_shapes())
def test_band5_tiles_equal_plain_version_bit_for_bit(cuda, shape, offset):
    """All eight band5 instantiations (f32 or bf16 input, f32 or bf16
    outputs, f32 or bf16 operands) at every edge of their tiles (tall and
    small, 16-byte staging and stores or not, blocks that walk several
    tiles), the plane aligned and one element off, with zeros, -0 and tiny
    and subnormal pixels: bit for bit with the plain version, the sign of a
    zero included, under the main bank (compile-time taps, the bf16 arm's r
    fused), a random bank with a zero and a bank of the main pattern with
    taps below 2^-7, whose bf16 products may round (both the run-time
    taps, never fused)."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 1)
    kr = rng.standard_normal(5).astype(np.float32)
    kr[rng.integers(5)] = 0.0
    small = np.array([-0.2, -1e-3, 0.0, 1e-3, 0.2], np.float32)
    x = _zeros_and_tiny(_plane(shape, cuda))
    before = (stencils.LAUNCHES["band5"], stencils.LAUNCHES_BF16["band5"])
    for dtype in (torch.float32, torch.bfloat16):
        hp = x.to(dtype)
        if offset:
            hp = _misaligned(hp)
        for taps in (RIESZ_BAND_KERNEL, kr, small):
            for bf16 in (False, True):
                for od in ("f32", "bf16"):
                    got = stencils.band5(hp, taps, bf16=bf16, out_dtype=od)
                    ref = stencils.band5_plain(hp, taps, bf16, od)
                    for g, r in zip(got, ref):
                        _bits(g, r)
    torch.cuda.synchronize()
    assert (stencils.LAUNCHES["band5"], stencils.LAUNCHES_BF16["band5"]) == (
        before[0] + 12, before[1] + 12)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("small,out", stencils.inject9_shapes())
def test_inject9_tiles_equal_plain_version_bit_for_bit(cuda, small, out, offset):
    """K4 and its bf16 arm at every edge of their tiles (tall and small, the
    dense bank's instantiations and the run-time taps of any other), the
    small image aligned and one element off, with zeros, -0 and tiny and
    subnormal pixels: bit for bit with the plain version, the sign of a zero
    included, under the collapse's 2*LP9, an all-negative dense bank (every
    zero site's product -0) and a random bank with zeros."""
    rng = np.random.default_rng(small[0] * 1000 + small[1])
    kr = rng.standard_normal((9, 9)).astype(np.float32)
    kr.flat[rng.choice(81, 9, replace=False)] = 0.0
    s = _zeros_and_tiny(_plane(small, cuda))
    if offset:
        s = _misaligned(s)
    before = (stencils.LAUNCHES["lp9_inject"], stencils.LAUNCHES_BF16["lp9_inject"])
    for k9 in (LP2, -np.abs(LP2), kr):
        for bf16 in (False, True):
            _bits(stencils.lp9_inject(s, k9, out, bf16=bf16),
                  stencils.lp9_inject_plain(s, k9, out, bf16))
    torch.cuda.synchronize()
    assert (stencils.LAUNCHES["lp9_inject"], stencils.LAUNCHES_BF16["lp9_inject"]) == (
        before[0] + 3, before[1] + 3)


def test_build_and_inject_refuse_taps_they_cannot_match(cuda):
    """K5's launcher refuses banks without the zero patterns it compiles in,
    K4's non-finite taps (the plain version's 0 * inf at a zero site is
    NaN): a CUDA error, nothing launched, no plain version."""
    import ctypes

    x = _plane((40, 60), cuda)
    outs = [torch.empty_like(x) for _ in range(3)] + [torch.empty((20, 30), device=cuda)]
    banks = [np.ascontiguousarray(np.asarray(k, np.float32).reshape(-1))
             for k in (LP2, RIESZ_BAND_KERNEL, LP2)]
    err = stencils._lib().lvmt_riesz_build_level(
        x.data_ptr(), *(o.data_ptr() for o in outs), 40, 60, *(b.ctypes.data for b in banks),
        0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err != 0
    bad = LP2.copy()
    bad[0, 0] = np.inf
    with pytest.raises(RuntimeError, match="cudaError"):
        stencils.lp9_inject(x, bad, (79, 120))
    torch.cuda.synchronize()


LEVEL_SHAPES = [(2160, 3840), (1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)]


@pytest.mark.parametrize("shape", SHAPES + [s for s in LEVEL_SHAPES if s not in SHAPES])
def test_bf16_stencil_arms_equal_plain_versions(cuda, shape):
    x = _plane(shape, cuda)
    before = dict(stencils.LAUNCHES_BF16)
    for bf16 in (False, True):
        for od in ("f32", "bf16"):
            _exact(stencils.conv9(x, RIESZ_HIGHPASS_9x9, bf16=bf16, out_dtype=od),
                   stencils.conv9_plain(x, RIESZ_HIGHPASS_9x9, bf16, od))
            for hp in (x, x.to(torch.bfloat16)):
                got = stencils.band5(hp, RIESZ_BAND_KERNEL, bf16=bf16, out_dtype=od)
                ref = stencils.band5_plain(hp, RIESZ_BAND_KERNEL, bf16, od)
                for g, r in zip(got, ref):
                    _exact(g, r)
    _exact(stencils.lp9_decimate(x, LP2, bf16=True), stencils.lp9_decimate_plain(x, LP2, True))
    torch.cuda.synchronize()
    assert stencils.LAUNCHES_BF16["conv9"] == before["conv9"] + 2
    assert stencils.LAUNCHES_BF16["band5"] == before["band5"] + 4
    assert stencils.LAUNCHES_BF16["lp9_decimate"] == before["lp9_decimate"] + 1


@pytest.mark.parametrize("small,out", [((17, 129), (33, 257)), ((68, 121), (135, 241)),
                                       ((34, 60), (68, 120)), ((68, 120), (135, 240)),
                                       ((135, 240), (270, 480)), ((270, 480), (540, 960)),
                                       ((540, 960), (1080, 1920)), ((1080, 1920), (2160, 3840))])
def test_bf16_inject_arm_equals_plain_version(cuda, small, out):
    s = _plane(small, cuda)
    _exact(stencils.lp9_inject(s, LP2, out, bf16=True),
           stencils.lp9_inject_plain(s, LP2, out, bf16=True))


@pytest.mark.parametrize("preweighted", [False, True])
@pytest.mark.parametrize("shape", TAIL_SHAPES + LEVEL_SHAPES)
def test_amplify_mxu_fast_arms_equal_plain_versions(cuda, shape, preweighted):
    from live_video_magnification_tpu_torch.ops.hopper import tail

    args, kw = _tail_args("riesz_amplify_mxu", shape, preweighted, cuda)
    planes, scalars = args[:6], args[6:]
    before = dict(tail.LAUNCHES_BF16)
    n = 0
    for blur_dt in (torch.float32, torch.bfloat16):
        for ew_dt in (torch.float32, torch.bfloat16):
            for bf16 in (False, True):
                ins = [p.to(blur_dt) for p in planes[:3]] + [p.to(ew_dt) for p in planes[3:]]
                got = tail.riesz_amplify_mxu(*ins, *scalars, bf16=bf16, **kw)
                ref = tail.riesz_amplify_plain(*ins, *scalars, bf16=bf16, **kw)
                assert got.dtype == torch.float32
                torch.testing.assert_close(got, ref, rtol=0, equal_nan=True,
                                           atol=1e-6 * max(1.0, float(ref.abs().max())))
                n += bf16
    torch.cuda.synchronize()
    assert tail.LAUNCHES_BF16["riesz_amplify_mxu"] == before["riesz_amplify_mxu"] + n


def _amplify_planes(shape, dev):
    """Standard-normal planes, the amplitude a magnitude, zero on a patch
    wider than the blur's reach where the shape allows (some outputs NaN),
    and on another the amplitude and change down in the subnormal range
    (products of subnormal bf16 operands in the bf16 arm)."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 11)
    planes = [rng.standard_normal(shape, dtype=np.float32) for _ in range(6)]
    planes[0] = np.abs(planes[0])
    if min(shape) > 20:
        planes[0][3:18, 5:20] = 0.0
    if min(shape) > 40:
        for x in planes[:3]:
            x[20:34, 24:40] *= np.float32(1e-38)
    return [torch.from_numpy(x).to(dev) for x in planes]


def _misaligned(x):
    """A contiguous copy of x one element past an aligned start: the kernel's
    unaligned staging, load and store paths."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", amplify13_shapes())
def test_amplify13_instantiations_equal_plain_versions_bit_for_bit(cuda, shape, offset):
    """Each of the sixteen amplify13 instantiations (preweighted x amplitude /
    change dtype x lowpass / Riesz dtype x bf16 operands), through
    riesz_amplify_mxu and, on f32 planes, riesz_amplify_fused: max |kernel -
    plain| 0, NaN where the plain version has NaN."""
    from live_video_magnification_tpu_torch.ops.hopper import tail

    planes = _amplify_planes(shape, cuda)
    counts = lambda: (tail.LAUNCHES["riesz_amplify_mxu"] + tail.LAUNCHES["riesz_amplify_fused"]
                      + tail.LAUNCHES_BF16["riesz_amplify_mxu"])
    before = counts()
    for preweighted in (False, True):
        f32 = list(planes)
        if preweighted:
            f32[1], f32[2] = f32[1] * f32[0], f32[2] * f32[0]
        for blur_dt in (torch.float32, torch.bfloat16):
            for ew_dt in (torch.float32, torch.bfloat16):
                ins = [p.to(blur_dt) for p in f32[:3]] + [p.to(ew_dt) for p in f32[3:]]
                if offset:
                    ins = [_misaligned(p) for p in ins]
                for bf16 in (False, True):
                    runs = [(tail.riesz_amplify_mxu, {"bf16": bf16})]
                    if blur_dt == ew_dt == torch.float32 and not bf16:
                        runs.append((tail.riesz_amplify_fused, {}))
                    for entry, kw in runs:
                        got = entry(*ins, 30.0, 1.2, preweighted=preweighted, **kw)
                        ref = tail.riesz_amplify_plain(*ins, 30.0, 1.2, preweighted=preweighted,
                                                       bf16=bf16)
                        torch.testing.assert_close(
                            got, ref, rtol=0, atol=0, equal_nan=True,
                            msg=lambda m: f"{entry.__name__} preweighted={preweighted} "
                                          f"{blur_dt}/{ew_dt} bf16={bf16}: {m}")
    torch.cuda.synchronize()
    assert counts() == before + 16 + 2


def test_build_and_bf16_arms_never_take_the_plain_version(cuda, monkeypatch):
    from live_video_magnification_tpu_torch.ops.hopper import tail

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, names in ((stencils, ("conv9_plain", "band5_plain", "lp9_decimate_plain",
                                   "lp9_inject_plain", "riesz_build_level_plain")),
                       (tail, ("riesz_amplify_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    x = _plane((40, 60), cuda)
    stencils.riesz_build_level(x, out_dtype="bf16")
    stencils.conv9(x, RIESZ_HIGHPASS_9x9, bf16=True, out_dtype="bf16")
    stencils.band5(x.to(torch.bfloat16), RIESZ_BAND_KERNEL, bf16=True, out_dtype="bf16")
    stencils.lp9_decimate(x, LP2, bf16=True)
    stencils.lp9_inject(x, LP2, (79, 120), bf16=True)
    args, kw = _tail_args("riesz_amplify_mxu", (40, 60), False, cuda)
    tail.riesz_amplify_mxu(*[a.to(torch.bfloat16) for a in args[:6]], *args[6:], bf16=True)
    torch.cuda.synchronize()


FAST = dict(tail="mxu", mxu_dtype="bf16", pyr_io="bf16", tail_io="bf16")


@pytest.mark.parametrize("flags", [dict(build="auto"), dict(build="fused"), FAST],
                         ids=["auto", "fused", "fast"])
def test_step_on_the_card_matches_the_cpu_under_each_build(cuda, flags):
    """136x240, levels=4: level 0 takes the three stencils (bf16 operands
    under the fast flags), levels 1 and 2 (68x120, 34x60) the fused build."""
    from live_video_magnification_tpu_torch.models import riesz
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w, levels = 136, 240, 4
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, 30.0),
                                  butterworth_bandpass_coeffs(3.0, 30.0))
    dyn = riesz.RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo), c3(a_lo),
                               c3(b_hi), c3(a_hi), False, False)
    pyr_io = flags.get("pyr_io", "f32")
    gpu = riesz.init_state(h, w, levels, device=cuda, pyr_io=pyr_io)
    cpu = riesz.init_state(h, w, levels, device="cpu", pyr_io=pyr_io)
    before = stencils.LAUNCHES["riesz_build_level"]
    for i, f in enumerate(moving_clip(5, h, w, seed=6)):
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1)))
        gpu, a = riesz.step(gpu, chw.to(cuda), dyn, levels=levels, **flags)
        cpu, b = riesz.step(cpu, chw, dyn, levels=levels, **flags)
        a, b = a.cpu().numpy(), b.numpy()
        lsb = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        assert psnr_u8(a, b) >= 40.0, f"{flags} frame {i}: {psnr_u8(a, b):.2f} dB, max {lsb} LSB"
        if flags is not FAST:
            assert lsb <= 1, f"{flags} frame {i}: max {lsb} LSB"
    per_frame = {"fused": 3}.get(flags.get("build"), 2)
    assert stencils.LAUNCHES["riesz_build_level"] == before + 5 * per_frame
    assert gpu.old[0].lowpass.dtype == stencils.DTYPES[pyr_io]


# ---------------------------------------------------------------- motion and colour modes

def _mode_cfg(mode, levels, fps):
    from live_video_magnification_tpu_torch.models import params

    ui = params.defaults_for(params.MagnificationMode(mode))
    ui.levels, ui.capture_fps = levels, fps
    return params.ProcessorConfig(magnification=params.to_params(ui))


@pytest.mark.parametrize("mode,t,fps", [("laplace", 6, 30.0), ("color", 20, 8.0)])
@pytest.mark.parametrize("gray", [False, True], ids=["color", "gray"])
def test_motion_and_color_on_the_card_match_the_cpu(cuda, mode, t, fps, gray):
    """136x240 at each mode's default depth (motion 4, colour 3); colour at
    8 fps so its 16-frame window fills and rolls. Motion within 1 LSB of the
    CPU, colour >= 45 dB with the warm-up frame passed through; no stencil or
    tail kernel is launched."""
    import dataclasses

    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.ops.hopper import tail
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    cfg = dataclasses.replace(_mode_cfg(mode, 4 if mode == "laplace" else 3, fps),
                              grayscale=gray)
    gpu, cpu = MagnificationChain(device=cuda), MagnificationChain(device="cpu")
    before = dict(stencils.LAUNCHES), dict(tail.LAUNCHES)
    for i, f in enumerate(moving_clip(t, 136, 240, seed=8)):
        a = gpu.process(torch.from_numpy(f).to(cuda), cfg)[0].cpu().numpy()
        b = cpu.process(f, cfg)[0].numpy()
        lsb = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        if mode == "laplace":
            assert lsb <= 1, f"{mode} frame {i}: max {lsb} LSB"
        else:
            assert psnr_u8(a, b) >= 45.0, f"{mode} frame {i}: {psnr_u8(a, b):.2f} dB"
            if i == 0:
                np.testing.assert_array_equal(a, b)
    assert (dict(stencils.LAUNCHES), dict(tail.LAUNCHES)) == before


@pytest.mark.parametrize("mode", ["laplace", "color"])
def test_clip_processor_on_the_card_equals_the_chain_and_resumes(cuda, mode, tmp_path):
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w = 72, 128
    cfg = _mode_cfg(mode, 3, 8.0)
    clip = moving_clip(18, h, w, seed=9)
    chain = MagnificationChain(device=cuda)
    per_frame = np.stack([chain.process(f, cfg)[0].cpu().numpy() for f in clip])
    tchw = np.ascontiguousarray(clip.transpose(0, 3, 1, 2))
    proc = ClipProcessor(cfg, h, w, 3, device=cuda)
    processed, _ = proc.process_chunk(torch.from_numpy(tchw).to(cuda))
    np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), per_frame)
    first = ClipProcessor(cfg, h, w, 3, device=cuda)
    a, _ = first.process_chunk(tchw[:7])
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = ClipProcessor(cfg, h, w, 3, device=cuda)
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 7
    b, _ = resumed.process_chunk(tchw[7:])
    np.testing.assert_array_equal(np.concatenate([a, b]), processed)


@pytest.mark.parametrize("mode,levels,fps,t", [("phase", 4, 30.0, 8), ("laplace", 4, 30.0, 8),
                                               ("color", 3, 8.0, 20)])
def test_time_parallel_on_the_card_matches_sequential_and_the_cpu(cuda, mode, levels, fps, t):
    """ClipProcessor(time_parallel=True) at 136x240 in two chunks: against the
    sequential ClipProcessor on the card (motion, colour within 1 LSB; phase
    >= 40 dB) and against its own run on the CPU (phase >= 40 dB, motion
    within 1 LSB, colour >= 45 dB); phase launches its f32 stencils once a
    frame and level (``ops/riesz.py::stencil_launches``), its blur13 once a
    chunk (``models/riesz.py::blur_launches``) and no tail kernel, motion and
    colour none."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.hopper import tail
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches
    from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w = 136, 240
    cfg = _mode_cfg(mode, levels, fps)
    tchw = np.ascontiguousarray(moving_clip(t, h, w, seed=10).transpose(0, 3, 1, 2))
    half = t // 2
    runs = {}
    for name, dev, parallel in (("par", cuda, True), ("seq", cuda, False),
                                ("cpu", "cpu", True)):
        proc = ClipProcessor(cfg, h, w, 3, time_parallel=parallel, device=dev)
        before = dict(stencils.LAUNCHES), dict(tail.LAUNCHES)
        outs = [proc.process_chunk(tchw[:half])[0], proc.process_chunk(tchw[half:])[0]]
        launched = ({k: v - before[0][k] for k, v in stencils.LAUNCHES.items()},
                    {k: v - before[1][k] for k, v in tail.LAUNCHES.items()})
        runs[name] = np.concatenate(outs)
        if name == "par":
            want = ({**{k: v * t for k, v in stencil_launches(h, w, levels).items()},
                     "blur13": 2 * blur_launches(h, w, levels)}  # a batch a chunk
                    if mode == "phase" else {k: 0 for k in stencils.LAUNCHES})
            assert launched == (want, {k: 0 for k in tail.LAUNCHES}), launched
    for other in ("seq", "cpu"):
        a, b = runs["par"], runs[other]
        lsb = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        dbs = [psnr_u8(x, y) for x, y in zip(a, b)]
        if mode == "phase":
            assert min(dbs) >= 40.0, f"against {other}: {dbs} dB, max {lsb} LSB"
        elif mode == "color" and other == "cpu":
            assert min(dbs) >= 45.0, f"against {other}: {dbs} dB"
            np.testing.assert_array_equal(a[0], b[0])
        else:
            assert lsb <= 1, f"against {other}: max {lsb} LSB"


def test_the_time_parallel_spans_read_their_device_time_on_the_card(cuda):
    """With the recorder on, ClipProcessor(time_parallel=True) in phase at
    136x240 levels 4, two chunks: each chunk's stage spans carry its cursor
    and, once it is back, their CUDA events' time; the launches are exactly
    those of the recorder off (``stencil_launches`` a frame, the blurs a
    chunk, no tail kernel), and so are the frames."""
    import time

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.hopper import tail
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w, levels, t = 136, 240, 4, 8
    cfg = _mode_cfg("phase", levels, 30.0)
    tchw = np.ascontiguousarray(moving_clip(t, h, w, seed=10).transpose(0, 3, 1, 2))
    want = ({**{k: v * t for k, v in stencil_launches(h, w, levels).items()},
             "blur13": 2 * blur_launches(h, w, levels)}, {k: 0 for k in tail.LAUNCHES})
    runs = []
    for on in (False, True):
        proc = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=cuda)
        before = dict(stencils.LAUNCHES), dict(tail.LAUNCHES)
        t0 = time.monotonic()
        if on:
            profiling.enable()
        try:
            runs.append(np.concatenate([proc.process_chunk(tchw[:t // 2])[0],
                                        proc.process_chunk(tchw[t // 2:])[0]]))
        finally:
            profiling.disable()
        torch.cuda.synchronize(cuda)
        launched = ({k: v - before[0][k] for k, v in stencils.LAUNCHES.items()},
                    {k: v - before[1][k] for k, v in tail.LAUNCHES.items()})
        assert launched == want, (on, launched)
    np.testing.assert_array_equal(runs[0], runs[1])
    held = profiling.spans(t0, time.monotonic())
    stages = [s for s in held if s.name.startswith("phase_tp.")]
    assert len(stages) == 2 * (2 + 3 * (levels - 1))
    assert sorted({s.id for s in stages}) == [0, t // 2]
    assert all(s.parent.name == "export.step" and s.id == s.parent.id for s in stages)
    assert all(s.device_ms is not None and s.device_ms > 0 for s in stages)


# ---------------------------------------------------------------- the clip export's readback

@pytest.mark.parametrize("mode,levels", [("phase", 4), ("laplace", 4)])
@pytest.mark.parametrize("time_parallel", [False, True], ids=["sequential", "time_parallel"])
def test_pinned_readback_equals_a_plain_readback(cuda, mode, levels, time_parallel, tmp_path):
    """ClipProcessor on the card reads its panes back on its copy stream into
    pinned host tensors: bit for bit what plain copies of the same outputs
    give (a processor without the copy stream) over a full chunk, a chunk
    resumed from a checkpoint and a partial one; every array pinned and new,
    the first chunk's unchanged after the later ones."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w = 136, 240
    cfg = _mode_cfg(mode, levels, 30.0)
    tchw = np.ascontiguousarray(moving_clip(11, h, w, seed=11).transpose(0, 3, 1, 2))
    plain = ClipProcessor(cfg, h, w, 3, time_parallel=time_parallel, device=cuda)
    plain._copies = None  # plain copies into pageable tensors, as on the CPU
    pinned = ClipProcessor(cfg, h, w, 3, time_parallel=time_parallel, device=cuda)
    assert pinned._copies is not None
    got = []
    for a, b in [(0, 4), (4, 8), (8, 11)]:
        if a == 4:
            pinned.save_checkpoint(str(tmp_path / "ck"))
            pinned = ClipProcessor(cfg, h, w, 3, time_parallel=time_parallel, device=cuda)
            assert pinned.load_checkpoint(str(tmp_path / "ck")) == 4
        got.append(pinned.process_chunk(tchw[a:b]))
        if a == 0:
            kept = [x.copy() for x in got[0]]
        want = plain.process_chunk(tchw[a:b])
        for g, r in zip(got[-1], want):
            assert g.shape == r.shape and g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
            assert torch.from_numpy(g).is_pinned()
    for g, k in zip(got[0], kept):
        np.testing.assert_array_equal(g, k)
    arrays = [x for pair in got for x in pair]
    assert not any(np.shares_memory(x, y) for i, x in enumerate(arrays) for y in arrays[i + 1:])


@pytest.mark.parametrize("time_parallel", [False, True], ids=["sequential", "time_parallel"])
def test_the_pinned_readback_spans_each_frames_copies(cuda, time_parallel):
    """With the recorder on: one ``export.d2h`` a frame (one a chunk
    time-parallel), inside ``export.chunk``, with both panes' bytes and its
    CUDA events read, and one ``export.readback`` a chunk."""
    import time

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w = 72, 128
    tchw = np.ascontiguousarray(moving_clip(5, h, w, seed=12).transpose(0, 3, 1, 2))
    proc = ClipProcessor(_mode_cfg("laplace", 3, 30.0), h, w, 3, time_parallel=time_parallel,
                         device=cuda)
    t0 = time.monotonic()
    profiling.enable()
    try:
        proc.process_chunk(tchw[:3])
        proc.process_chunk(tchw[3:])
    finally:
        profiling.disable()
    torch.cuda.synchronize(cuda)
    held = profiling.spans(t0, time.monotonic())
    d2h = [s for s in held if s.name == "export.d2h"]
    frame = 2 * 3 * h * w
    if time_parallel:
        assert [(s.id, s.nbytes) for s in d2h] == [(0, 3 * frame), (3, 2 * frame)]
    else:
        assert [(s.id, s.nbytes) for s in d2h] == [(i, frame) for i in range(5)]
    assert all(s.parent.name == "export.chunk" and s.device_ms > 0 for s in d2h)
    readbacks = [s for s in held if s.name == "export.readback"]
    assert [(s.id, s.nbytes) for s in readbacks] == [(0, 3 * frame), (3, 2 * frame)]
    assert all(s.device_ms is not None for s in readbacks)


# ---------------------------------------------------------------- the clip export's step graph

def _launched(proc, chunk, traced=False):
    """``proc.process_chunk(chunk)``, the increments of the kernel wrappers'
    host counters over it (stencils and tail, f32 and bf16) and, ``traced``,
    the device kernels it ran by name and count (torch.profiler; copies and
    memsets left out, as ``launches_per_frame.export`` leaves them)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from live_video_magnification_tpu_torch.ops.hopper import tail

    counters = (stencils.LAUNCHES, stencils.LAUNCHES_BF16, tail.LAUNCHES, tail.LAUNCHES_BF16)
    before = [dict(c) for c in counters]
    if not traced:
        return proc.process_chunk(chunk), None, _since(counters, before)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        panes = proc.process_chunk(chunk)
        torch.cuda.synchronize()
    kernels = Counter({e.key: e.count for e in prof.key_averages()
                       if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
                       and not e.key.startswith(("Memcpy", "Memset", "Activity Buffer"))})
    return panes, kernels, _since(counters, before)


def _since(counters, before):
    return [{k: v - b[k] for k, v in c.items()} for c, b in zip(counters, before)]


@pytest.mark.parametrize("mode,h,w,levels,fast", [("phase", 540, 960, 4, False),
                                                  ("phase", 540, 960, 4, True),
                                                  ("laplace", 720, 1280, 5, False)],
                         ids=["phase", "phase-fast", "laplace"])
def test_the_step_graph_equals_the_eager_step_bit_for_bit(cuda, mode, h, w, levels, fast,
                                                           monkeypatch, tmp_path):
    """ClipProcessor on the card replays its step as a CUDA graph from frame
    1 on: three chunks of 8 bit for bit the eager processor's (phase at
    540x960 levels 4, whose band levels all take K1-K4, in f32 and under the
    ``--fast`` flags, whose carried band levels are bf16; Laplace at 720p
    levels 5), the first frame's passthrough included; a replayed chunk runs
    on the card every kernel the eager chunk runs, as many times, and no
    other kernel than the copies into the static state (the device trace:
    the host counters see no replay); each chunk's panes unchanged after the
    later chunks; a checkpoint after chunk 1 resumed by a fresh processor,
    and loaded back into the graphed one; one ``export.replay`` inside each
    replayed frame's ``export.step``."""
    import time

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.export import batch
    from live_video_magnification_tpu_torch.models.chain import StepGraph
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    if fast:
        for flag, value in FAST.items():
            monkeypatch.setenv(f"LVMT_{flag.upper()}", value)
    cfg = _mode_cfg(mode, levels, 30.0)
    tchw = np.ascontiguousarray(moving_clip(24, h, w, seed=13).transpose(0, 3, 1, 2))
    chunks = [tchw[k:k + 8] for k in (0, 8, 16)]
    with monkeypatch.context() as m:
        m.setattr(batch, "replays", lambda *args: False)
        eager = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
        want = [_launched(eager, c, traced=k == 1) for k, c in enumerate(chunks)]
        assert eager._graph is None
    if mode == "phase" and not fast:
        per_frame = stencil_launches(h, w, levels)
        assert per_frame["riesz_build_level"] == 0 < per_frame["conv9"]
        assert want[1][2][0] == {**{k: 8 * v for k, v in per_frame.items()},
                                 "blur13": 8 * blur_launches(h, w, levels)}
    if fast:
        assert any(want[1][2][1].values())  # the bf16 arms' launches
    np.testing.assert_array_equal(want[0][0][0][0], tchw[0])  # the first frame passes through

    graphed = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    t0 = time.monotonic()
    profiling.enable()
    try:
        got = [_launched(graphed, chunks[0])]
        kept = [x.copy() for x in got[0][0]]
        graphed.save_checkpoint(str(tmp_path / "ck"))
        got += [_launched(graphed, c, traced=k == 1) for k, c in enumerate(chunks) if k]
    finally:
        profiling.disable()
    torch.cuda.synchronize(cuda)
    assert isinstance(graphed._graph, StepGraph)
    if fast:
        assert graphed.state.old[0].lowpass.dtype == torch.bfloat16
    for (panes, _, _), (ref, _, _) in zip(got, want):
        for g, r in zip(panes, ref):
            np.testing.assert_array_equal(g, r)
    for g, k in zip(got[0][0], kept):
        np.testing.assert_array_equal(g, k)
    (_, replayed, counted), (_, ref_kernels, _) = got[1], want[1]
    lost, extra = ref_kernels - replayed, replayed - ref_kernels
    assert not lost and all("copy" in k.lower() or "memcpy" in k.lower() for k in extra), (
        lost, extra)
    if mode == "phase":
        assert any(k in name for k in ("stencil9_kernel", "band5_kernel") for name in replayed)
    assert not any(v for c in counted for v in c.values())  # no wrapper is called
    held = profiling.spans(t0, time.monotonic())
    replayed = [s for s in held if s.name == "export.replay"]
    assert [s.id for s in replayed] == list(range(1, 24))
    assert all(s.parent.name == "export.step" and s.parent.id == s.id for s in replayed)

    resumed = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == 8
    assert graphed.load_checkpoint(str(tmp_path / "ck")) == 8
    for proc in (resumed, graphed):
        for chunk, (ref, _, _) in zip(chunks[1:], want[1:]):
            for g, r in zip(proc.process_chunk(chunk), ref):
                np.testing.assert_array_equal(g, r)


def test_a_step_that_cannot_be_captured_runs_eagerly(cuda, monkeypatch):
    """A capture that raises: one warning, then every frame eager, bit for
    bit, and no ``export.replay``."""
    import time
    import warnings

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.export import batch
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    h, w = 72, 128
    cfg = _mode_cfg("laplace", 3, 30.0)
    tchw = np.ascontiguousarray(moving_clip(8, h, w, seed=14).transpose(0, 3, 1, 2))
    with monkeypatch.context() as m:
        m.setattr(batch, "replays", lambda *args: False)
        eager = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
        want = [eager.process_chunk(tchw[:4]), eager.process_chunk(tchw[4:])]

    def refuse(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    proc = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    t0 = time.monotonic()
    profiling.enable()
    try:
        with pytest.warns(RuntimeWarning, match="CUDA graph"):
            got = [proc.process_chunk(tchw[:4])]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got.append(proc.process_chunk(tchw[4:]))
    finally:
        profiling.disable()
    assert proc._graph is False
    for g, r in zip(got, want):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    assert not [s for s in profiling.spans(t0, time.monotonic()) if s.name == "export.replay"]


@pytest.mark.parametrize("mode,h,w,levels", [("phase", 540, 960, 4), ("laplace", 720, 1280, 5)],
                         ids=["phase", "laplace"])
def test_a_staged_host_chunk_equals_the_chunk_on_the_card_bit_for_bit(cuda, mode, h, w, levels,
                                                                     tmp_path):
    """ClipProcessor uploads a host chunk one frame ahead of its steps
    through its upload ring (``export/batch.py::stages``): chunks of 1,
    ``RING``, ``RING`` + 1 and 11 distinct frames handed as numpy arrays give
    bit for bit the panes of the same chunks handed as CUDA tensors (no
    copy), the first frame eager, the second capturing the step graph, the
    rest replaying it; the last chunk as a pinned CPU tensor too; a checkpoint after the second chunk resumed by a
    fresh processor from numpy chunks. One ring a processor, of ``RING``
    slots. The recorder sees one ``export.h2d`` a chunk with the chunk's
    bytes, holding frame 0's ``export.stage``, and one ``export.stage`` a
    frame (id: its index in the clip; the frame's bytes), frame i+1's opened
    before frame i's ``export.step``, all with their events read. The
    time-parallel path stages nothing."""
    import time

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.export import batch
    from live_video_magnification_tpu_torch.models.chain import StepGraph
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    cfg = _mode_cfg(mode, levels, 30.0)
    lengths = [1, batch.RING, batch.RING + 1, 11]
    tchw = np.ascontiguousarray(moving_clip(sum(lengths), h, w, seed=15).transpose(0, 3, 1, 2))
    cuts = [int(c) for c in np.cumsum([0] + lengths)]
    chunks = [tchw[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    on_card = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    want = [on_card.process_chunk(torch.from_numpy(c).to(cuda)) for c in chunks]
    assert on_card._ring is None

    staged = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    t0 = time.monotonic()
    profiling.enable()
    try:
        got = [staged.process_chunk(c) for c in chunks[:2]]
        ring = staged._ring
        staged.save_checkpoint(str(tmp_path / "ck"))
        got += [staged.process_chunk(chunks[2]),
                staged.process_chunk(torch.from_numpy(chunks[3]).pin_memory())]
    finally:
        profiling.disable()
    torch.cuda.synchronize(cuda)
    held = profiling.spans(t0, time.monotonic())
    assert isinstance(staged._graph, StepGraph) and staged._ring is ring
    assert len(ring.pinned) == len(ring.frames) == batch.RING <= 3
    for g, r in zip(got, want):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)

    h2d = [s for s in held if s.name == "export.h2d"]
    assert [(s.id, s.nbytes) for s in h2d] == [(c, n * 3 * h * w) for c, n in zip(cuts, lengths)]
    stage = [s for s in held if s.name == "export.stage"]
    assert [s.id for s in stage] == list(range(sum(lengths)))
    assert all(s.nbytes == 3 * h * w for s in stage)
    assert all(s.device_ms is not None for s in h2d + stage)
    steps = {s.id: s for s in held if s.name == "export.step"}
    for s in stage:
        if s.id in cuts:
            assert s.parent.name == "export.h2d" and s.parent.id == s.id
        else:
            assert s.parent.name == "export.chunk" and s.start_ns < steps[s.id - 1].start_ns
    assert [s.id for s in held if s.name == "export.replay"] == list(range(1, sum(lengths)))

    resumed = batch.ClipProcessor(cfg, h, w, 3, device=cuda)
    assert resumed.load_checkpoint(str(tmp_path / "ck")) == cuts[2]
    for chunk, ref in zip(chunks[2:], want[2:]):
        for a, b in zip(resumed.process_chunk(chunk), ref):
            np.testing.assert_array_equal(a, b)

    whole = batch.ClipProcessor(cfg, h, w, 3, time_parallel=True, device=cuda)
    t0 = time.monotonic()
    profiling.enable()
    try:
        whole.process_chunk(chunks[3])
    finally:
        profiling.disable()
    torch.cuda.synchronize(cuda)
    held = profiling.spans(t0, time.monotonic())
    assert whole._ring is None and not [s for s in held if s.name == "export.stage"]
    assert [s.nbytes for s in held if s.name == "export.h2d"] == [lengths[3] * 3 * h * w]


def test_the_colour_spans_read_their_device_time_on_the_card(cuda):
    """With the recorder on: each colour step's spans carry the frame's id
    and, once the frame is back, their CUDA events' time; each new window
    length builds its operator in one ``color.operator`` span."""
    import time

    from live_video_magnification_tpu_torch.engine import profiling
    from live_video_magnification_tpu_torch.models import color
    from live_video_magnification_tpu_torch.ops.temporal import ideal_bandpass_operator

    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (6, 3, 48, 64), dtype=np.uint8)).to(cuda)
    dyn = color.ColorDynParams(100.0, 0.8, 1.2)
    state = color.init_state(48, 64, 3, 3, 8.0, device=cuda)
    ideal_bandpass_operator.cache_clear()
    t0 = time.monotonic()
    profiling.enable()
    try:
        for i in range(6):
            with profiling.span("consumer.step", i):
                state, out = color.step(state, frames[i], dyn, levels=3, framerate=8.0)
        out.cpu()
    finally:
        profiling.disable()
    torch.cuda.synchronize(cuda)
    held = profiling.spans(t0, time.monotonic())
    parts = [s for s in held if s.name in ("color.pyramid", "color.bandpass", "color.reconstruct")]
    assert len(parts) == 2 + 3 * 5  # the first frame passes through
    assert all(s.parent.name == "consumer.step" and s.id == s.parent.id for s in parts)
    assert all(s.device_ms is not None and s.device_ms > 0 for s in parts)
    assert [s.id for s in held if s.name == "color.operator"] == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------- K10 and the sharded step

HALO_SHAPES = [(33, 13), (97, 31), (135, 61), (6, 33, 13), (6, 135, 61)]


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_halo_kernel_equals_plain_version(cuda, n, shape):
    """K10 on n virtual shards of one card, every halo and right mode: a copy,
    so bit-equal; one launch for the device's shards."""
    from live_video_magnification_tpu_torch.ops.hopper import halo

    rng = np.random.default_rng(n * 100 + shape[-1])
    xs = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)
          for _ in range(n)]
    for h in (2, 4, 6):
        for mode in ("reflect", "symmetric"):
            before = halo.LAUNCHES["halo_exchange_cols_rdma"]
            got = halo.halo_exchange_cols_rdma(xs, h, mode)
            ref = halo.halo_exchange_cols_rdma_plain(xs, h, mode)
            torch.cuda.synchronize()
            assert halo.LAUNCHES["halo_exchange_cols_rdma"] == before + 1
            for g, r in zip(got, ref):
                _same(g, r)


def test_halo_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    from live_video_magnification_tpu_torch.ops.hopper import halo

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(halo, "halo_exchange_cols_rdma_plain", refuse)
    xs = [_plane((40, 20), cuda, seed=k) for k in range(4)]
    halo.halo_exchange_cols_rdma(xs, 6)
    with pytest.raises(TypeError, match="float32"):
        halo.halo_exchange_cols_rdma([x.to(torch.bfloat16) for x in xs], 6)
    torch.cuda.synchronize()


def _sharded_against_unsharded(devices, h, w, levels, tail, frames=4):
    """Frames of the sharded step on a (1, len(devices)) mesh against the
    unsharded step's on the first device; returns (worst LSB, K10 launches)."""
    from live_video_magnification_tpu_torch.models import riesz
    from live_video_magnification_tpu_torch.ops.hopper import halo
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.riesz_sharded import build_sharded_riesz_step
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, 30.0),
                                  butterworth_bandpass_coeffs(3.0, 30.0))
    dyn = riesz.RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo), c3(a_lo),
                               c3(b_hi), c3(a_hi), False, False)
    step, state = build_sharded_riesz_step(make_mesh((1, len(devices)), devices=devices), 1,
                                           h, w, levels, tail=tail)
    ref = riesz.init_state(h, w, levels, device=devices[0])
    before = halo.LAUNCHES["halo_exchange_cols_rdma"]
    worst = 0
    for f in moving_clip(frames, h, w, seed=8):
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1)))
        state, a = step(state, chw[None], dyn)
        ref, b = riesz.step(ref, chw.to(devices[0]), dyn, levels=levels, tail=tail)
        assert a.device == b.device  # gathered on the mesh's first device
        worst = max(worst, int((a[0].to(torch.int16) - b.to(torch.int16)).abs().max()))
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)
    return worst, halo.LAUNCHES["halo_exchange_cols_rdma"] - before


@pytest.mark.parametrize("tail", ["mxu", "jnp", "pallas"])
def test_sharded_step_on_a_virtual_mesh_equals_the_unsharded_step(cuda, tail):
    """270x480, levels=5 on 4 virtual shards of one card: levels 0-2 sharded,
    3-4 replicated. K10 launches once an exchange: build 3, tail 3 (mxu,
    pallas) or 9 (jnp), collapse 2 + 2 + 1."""
    worst, launched = _sharded_against_unsharded([cuda] * 4, 270, 480, 5, tail)
    assert worst <= 1, f"{worst} LSB"
    assert launched == 4 * {"mxu": 11, "pallas": 11, "jnp": 17}[tail]


def test_sharded_step_across_two_cards(cuda):
    """The same on two cards: K10 reads the neighbour's edge over peer
    access, one launch per card and exchange. 2-way, every level shards:
    build 4, last band 1, tail 4, collapse 8."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the cross-card branch of K10 reads a peer's memory")
    from live_video_magnification_tpu_torch.ops.hopper import halo

    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    # shards alternating over the cards: every neighbour is on the other one
    xs = [_plane((6, 97, 31), devices[k % 2], seed=k) for k in range(4)]
    for mode in ("reflect", "symmetric"):
        before = halo.LAUNCHES["halo_exchange_cols_rdma"]
        got = halo.halo_exchange_cols_rdma(xs, 6, mode)
        assert halo.LAUNCHES["halo_exchange_cols_rdma"] == before + 2
        for g, r, x in zip(got, halo.halo_exchange_cols_rdma_plain(xs, 6, mode), xs):
            assert g.device == x.device
            _same(g, r)
    worst, launched = _sharded_against_unsharded(devices, 270, 480, 5, "mxu")
    assert worst <= 1, f"{worst} LSB"
    assert launched == 4 * 2 * 17


@pytest.mark.parametrize("mode", ["phase", "laplace", "color"])
def test_row_sharded_step_on_the_card_equals_unsharded_and_the_cpu(cuda, mode):
    """The row-sharded step (264x202 on 4 virtual shards of one card; 202 does
    not lane-shard) against the unsharded step on the card: frames and state
    bit for bit (on the card every element of a strip takes the whole
    plane's code); against the same row-sharded step on the CPU: within one
    LSB. Phase launches exactly ``row_stencil_launches(plan)`` a frame and
    no K10; motion and colour launch no kernel."""
    from live_video_magnification_tpu_torch.convert import (
        sharded_color_state_to_jax,
        sharded_motion_state_to_jax,
        sharded_riesz_state_to_jax,
        state_to_numpy,
    )
    from live_video_magnification_tpu_torch.models import color, motion, riesz
    from live_video_magnification_tpu_torch.models.params import MagnificationMode
    from live_video_magnification_tpu_torch.ops.hopper import halo, tail
    from live_video_magnification_tpu_torch.ops.temporal import butterworth_bandpass_coeffs
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.parallel.row_sharded import row_stencil_launches
    from live_video_magnification_tpu_torch.parallel.sharding import (
        build_sharded_step,
        sharded_plan,
    )
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    m = MagnificationMode(mode)
    h, w, fps = 264, 202, 8.0
    levels = {"phase": 4, "laplace": 3, "color": 2}[mode]
    c3 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    (b_lo, a_lo), (b_hi, a_hi) = (butterworth_bandpass_coeffs(0.5, fps),
                                  butterworth_bandpass_coeffs(3.0, fps))
    dyn = {"phase": riesz.RieszDynParams(30.0, float(np.float32(0.4 * np.pi)), c3(b_lo),
                                         c3(a_lo), c3(b_hi), c3(a_hi), False, False),
           "laplace": motion.MotionDynParams(15.0, 300.0, 0.2, 0.6, 0.5),
           "color": color.ColorDynParams(80.0, 0.8, 1.5)}[mode]
    if mode == "phase":
        init = lambda: riesz.init_state(h, w, levels, device=cuda)
        ref_step = lambda s, f: riesz.step(s, f, dyn, levels=levels)
    elif mode == "laplace":
        init = lambda: motion.init_state(h, w, 3, levels, device=cuda)
        ref_step = lambda s, f: motion.step(s, f, dyn, levels=levels)
    else:
        init = lambda: color.init_state(h, w, 3, levels, fps, device=cuda)
        ref_step = lambda s, f: color.step(s, f, dyn, levels=levels, framerate=fps)
    card = make_mesh((1, 4), devices=[cuda] * 4)
    step, state = build_sharded_step(card, m, 1, h, w, levels, fps)
    cpu_step, cpu_state = build_sharded_step(make_mesh((1, 4), devices=["cpu"] * 4), m, 1, h, w,
                                             levels, fps)
    plan = sharded_plan(card, m, h, w, levels)
    assert plan.axis == -2 and plan.sharded[0]
    ref = init()
    counts = (stencils.LAUNCHES, tail.LAUNCHES, halo.LAUNCHES)
    frames = moving_clip(12 if mode == "color" else 4, h, w, seed=8)
    for f in frames:
        chw = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 0, 1)))
        before = [dict(c) for c in counts]
        state, out = step(state, chw[None], dyn)
        torch.cuda.synchronize(cuda)
        launched = {k: c[k] - b[k] for c, b in zip(counts, before) for k in c if c[k] != b[k]}
        want = row_stencil_launches(plan) if mode == "phase" else {}
        assert launched == {k: v for k, v in want.items() if v}
        ref, want_out = ref_step(ref, chw.to(cuda))
        assert torch.equal(out[0], want_out)
        cpu_state, cpu_out = cpu_step(cpu_state, chw[None], dyn)
        assert int((out[0].cpu().to(torch.int16) - cpu_out[0].to(torch.int16)).abs().max()) <= 1
    to_jax = {"phase": sharded_riesz_state_to_jax, "laplace": sharded_motion_state_to_jax,
              "color": sharded_color_state_to_jax}[mode]
    for a, b in zip(to_jax(state, plan), state_to_numpy(ref)):
        np.testing.assert_array_equal(a[0], b)


# ---------------------------------------------------------------- the time mesh

def _time_mesh_runs(mode, levels, fps, t, devices, h=1080, w=1920):
    """One chunk of ``t`` frames through DistributedClipExporter on a
    ("time",) mesh of ``devices`` and through ClipProcessor(time_parallel=True)
    on the first of them. Returns (sharded, unsharded, launches of the
    sharded run by module, levels)."""
    from live_video_magnification_tpu_torch.export.batch import ClipProcessor
    from live_video_magnification_tpu_torch.ops.hopper import halo, tail
    from live_video_magnification_tpu_torch.parallel.batch_export import (
        DistributedClipExporter,
    )
    from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    cfg = _mode_cfg(mode, levels, fps)
    tchw = np.ascontiguousarray(moving_clip(t, h, w, seed=12).transpose(0, 3, 1, 2))
    exp = DistributedClipExporter(cfg, h, w, 3, mesh=make_mesh((len(devices),), ("time",),
                                                               devices))
    modules = (stencils.LAUNCHES, tail.LAUNCHES, halo.LAUNCHES)
    before = [dict(m) for m in modules]
    sharded, _ = exp.process_chunk(tchw, t, fetch_original=False)
    launched = [{k: v - b[k] for k, v in m.items()} for m, b in zip(modules, before)]
    plain = ClipProcessor(cfg, h, w, 3, time_parallel=True, device=devices[0])
    unsharded, _ = plain.process_chunk(tchw)
    return sharded, unsharded, launched, exp.proc.key.levels


@pytest.mark.parametrize("mode,levels,fps", [("phase", 6, 30.0), ("laplace", 4, 30.0),
                                             ("color", 3, 8.0)])
def test_time_mesh_on_virtual_shards_matches_the_unsharded_path(cuda, mode, levels, fps):
    """1080x1920, 8 frames on 4 virtual shards of one card against the
    unsharded time-parallel path: within 1 LSB. Phase launches its f32
    stencils once a frame and level summed over the shards
    (``ops/riesz.py::stencil_launches``: K1-K4 23 a frame, K5 once, on the
    68x120 level) and its blur13 once a shard (``models/riesz.py::
    blur_launches``: 15), and no tail or halo kernel; motion and colour
    launch none of K1-K10."""
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    t = 8
    sharded, unsharded, launched, lv = _time_mesh_runs(mode, levels, fps, t, [cuda] * 4)
    lsb = int(np.abs(sharded.astype(np.int16) - unsharded.astype(np.int16)).max())
    assert lsb <= 1, f"{mode}: {lsb} LSB against the unsharded path"
    want = ({**{k: v * t for k, v in stencil_launches(1080, 1920, lv).items()},
             "blur13": 4 * blur_launches(1080, 1920, lv)}
            if mode == "phase" else {k: 0 for k in stencils.LAUNCHES})
    assert launched[0] == want, launched
    if mode == "phase":
        assert want == {"conv9": 9 * t, "band5": 4 * t, "lp9_decimate": 4 * t,
                        "lp9_inject": 5 * t, "riesz_build_level": t, "blur13": 4 * 15}
    assert all(v == 0 for m in launched[1:] for v in m.values()), launched


def test_time_mesh_across_cards_matches_the_unsharded_path(cuda):
    """Phase over two real cards, two shards each: the carry and the halo
    cross cards; within 1 LSB of the unsharded path on the first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the shards' exchanges cross cards")
    devices = [torch.device("cuda", i) for i in (0, 0, 1, 1)]
    sharded, unsharded, _, _ = _time_mesh_runs("phase", 6, 30.0, 8, devices)
    assert int(np.abs(sharded.astype(np.int16) - unsharded.astype(np.int16)).max()) <= 1


# ---------------------------------------------------------------- the live engine and the Exporter


def _phase_cfg(levels=6, fps=30.0):
    from live_video_magnification_tpu_torch.models.params import (
        MagnificationMode,
        MagnificationParams,
        ProcessorConfig,
    )

    return ProcessorConfig(magnification=MagnificationParams(
        mode=MagnificationMode.PHASE, amplification=20.0, co_wavelength=40.0, co_low=1.0,
        co_high=5.0, levels=levels, framerate=fps))


def test_controller_on_the_card_launches_the_stencils_of_every_frame(cuda):
    """PlaybackController on the card, a lossless 1080x1920 synthetic source,
    phase levels 6: every frame processed, none an error, and exactly the
    stencil launches of ``ops/riesz.py::stencil_launches`` and the blur13 of
    ``models/riesz.py::blur_launches`` a frame."""
    import time

    from live_video_magnification_tpu_torch.engine.controller import PlaybackController
    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    n = 6
    ctrl = PlaybackController(device="cuda")
    try:
        assert ctrl.device.type == "cuda"
        ctrl.set_magnification(_phase_cfg().magnification)
        assert ctrl.open_synthetic(h=1080, w=1920, fps=30.0, n_frames=n)
        for k in stencils.LAUNCHES:
            stencils.LAUNCHES[k] = 0
        ctrl.play()
        end = time.monotonic() + 20.0
        while time.monotonic() < end and ctrl.stats().processed + ctrl.stats().proc_errors < n:
            time.sleep(0.02)
        s = ctrl.stats()
        pair = ctrl.mailbox.latest()
    finally:
        ctrl.close()
    assert (s.processed, s.proc_errors, s.read_errors) == (n, 0, 0)
    assert dict(stencils.LAUNCHES) == {**{k: v * n for k, v in
                                          stencil_launches(1080, 1920, 6).items()},
                                       "blur13": n * blur_launches(1080, 1920, 6)}
    assert pair.processed.data.shape == (1080, 1920, 3) and pair.processed.seq == n - 1
    assert not np.array_equal(pair.processed.data, pair.original.data)


def test_exporter_on_the_card_writes_the_chains_frames(cuda, monkeypatch):
    """Exporter(device="cuda") over a recording, split left-right, with an
    in-memory writer: bit for bit MagnificationChain + compose on the card."""
    import live_video_magnification_tpu_torch.export.exporter as texporter
    from live_video_magnification_tpu_torch.engine.processing import hwc_result
    from live_video_magnification_tpu_torch.export.sources import BufferExportFrameSource
    from live_video_magnification_tpu_torch.export.types import (
        ExportPhase,
        ExportRequest,
        SplitMode,
    )
    from live_video_magnification_tpu_torch.models.chain import MagnificationChain
    from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

    written = []

    class Memory:
        def write(self, canvas):
            written.append(canvas.copy())

        def release(self):
            pass

    monkeypatch.setattr(texporter, "open_writer", lambda fmt, path, fps, size: (Memory(), path, "m"))
    frames = list(moving_clip(5, 1080, 1920, seed=6))
    cfg = _phase_cfg()
    exp = texporter.Exporter(device="cuda")
    exp.start(BufferExportFrameSource(frames), ExportRequest(
        config=cfg, output_path="memory.avi", split=SplitMode.LEFT_RIGHT))
    exp.join(timeout=60.0)
    p = exp.progress()
    assert p.phase is ExportPhase.DONE and p.frames_done == 5, p.error
    chain = MagnificationChain(device=cuda)
    for i, f in enumerate(frames):
        processed, original = (hwc_result(x) for x in chain.process(f, cfg))
        want = texporter.compose(original, processed, SplitMode.LEFT_RIGHT, False)
        np.testing.assert_array_equal(written[i], want, err_msg=f"frame {i}")


def test_gui_record_flow_on_the_card_equals_a_fresh_chain(cuda):
    """The GUI's record -> export flow, headless (``chip_smoke.py``'s
    ``gui_record_flow``, the ``gui_flow_1080p`` phase at 270x480): the panel
    switched to phase at levels 6, a synthetic camera recorded and exported
    with an edited amplification by ``Exporter(device="cuda")``; every
    written frame bit for bit a fresh chain's (checked inside) and exactly
    ``stencil_launches`` and ``blur_launches`` a frame."""
    import sys
    from pathlib import Path

    from live_video_magnification_tpu_torch.models.riesz import blur_launches
    from live_video_magnification_tpu_torch.ops.hopper import halo, tail
    from live_video_magnification_tpu_torch.ops.riesz import stencil_launches

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    row = chip_smoke.gui_record_flow(torch, cuda, 270, 480, seconds=1.0,
                                     modules=(stencils, tail, halo))
    assert row["bit_equal_to_chain"] and row["frames"] >= 5
    assert row["export_amplification"] == row["live_amplification"] + 30
    assert row["stencil_launches_per_frame"] == {
        **{k: float(v) for k, v in stencil_launches(270, 480, row["levels"]).items() if v},
        "blur13": float(blur_launches(270, 480, row["levels"]))}


@pytest.mark.parametrize("flags", [[], ["--mode", "laplace"], ["--mode", "color"],
                                   ["--time-parallel"], ["--sharded"]])
def test_bench_runs_on_the_card(cuda, flags, capsys):
    """The port's bench at 1080p, levels 6, 4 steps: one JSON line with a
    rate, the card's name and power limit on stderr."""
    import json

    from live_video_magnification_tpu_torch import bench

    assert bench.main(["--res", "1080x1920", "--levels", "6", "--steps", "4", *flags]) == 0
    out, err = capsys.readouterr()
    (line,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert "error" not in line and line["value"] > 0 and line["unit"] == "fps"
    assert torch.cuda.get_device_name(cuda) in err and " W)" in err and "checksums=(" in err
