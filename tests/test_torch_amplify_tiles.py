"""amplify13_kernel's tile edges on the CPU, where the amplify entry points
run their plain version: ``riesz_amplify_plain`` against the JAX Pallas
kernels (riesz_amplify_fused, K7, and riesz_amplify_mxu, K6) in interpret
mode at every shape of ``tail.amplify13_shapes()`` up to 140x260, across
every arm of the kernel (preweighted, the amplitude/change and the
lowpass/Riesz plane dtypes, bf16 operands); that list against the tile
constants of the CUDA source; and the CPU route, which launches nothing.

The shapes take the arms in turn, so each arm meets several tile edges and
the file stays short; the card's test (tests/test_torch_cuda.py) holds every
arm at every shape against the plain version bit for bit.

Inputs are those of the reference suite's amplify tests
(tests/test_pallas_kernels.py:630-655): uniform planes, the amplitude kept
off zero. Bars: the f32 arms the reference suite's kernel-against-jnp bar
(2e-4 abs + 1e-4 rel); the bf16 arms within one bf16 ulp plus an f32 bar of
1e-5 x max|kernel| at every pixel, beyond the f32 bar on under 1% of pixels
(a sum rounded to bf16 may flip between two orders), as
tests/test_torch_fast.py holds them.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.riesz_amplify as jra
import live_video_magnification_tpu.ops.pallas.riesz_amplify_mxu as jram
from live_video_magnification_tpu_torch.ops.hopper import tail
from live_video_magnification_tpu_torch.ops.hopper._build import CSRC
from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes

torch.set_num_threads(2)

ALPHA, THRESHOLD = 30.0, 1.2
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (entry point, preweighted, amplitude/change dtype, lowpass/Riesz dtype,
# bf16 operands): the sixteen arms of riesz_amplify_mxu, then the two of
# riesz_amplify_fused (f32 planes only)
ARMS = ([("riesz_amplify_mxu", pw, tb, te, b) for pw in (False, True)
         for tb in ("f32", "bf16") for te in ("f32", "bf16") for b in (False, True)]
        + [("riesz_amplify_fused", pw, "f32", "f32", False) for pw in (False, True)])
CPU_SHAPES = [s for s in tail.amplify13_shapes() if s[0] <= 140 and s[1] <= 260]
CASES = [(s, ARMS[i % len(ARMS)]) for i, s in enumerate(CPU_SHAPES)]


def _arm_id(arm):
    entry, pw, tb, te, b = arm
    return f"{entry[len('riesz_amplify_'):]}-{'pw' if pw else 'w'}-{tb}-{te}{'-bf16ops' if b else ''}"


def _planes(shape, preweighted, seed):
    rng = np.random.default_rng(seed)
    r = lambda: rng.random(shape).astype(np.float32) - 0.3
    amp = np.abs(r()) + 0.05
    cc, cs = r() * 0.4, r() * 0.4
    if preweighted:
        cc, cs = cc * amp, cs * amp
    return [amp, cc, cs, r() * 50.0, r(), r()]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.abs(v.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _source_constant(name: str) -> int:
    text = (CSRC / "tail.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not found in tail.cu"
    return int(found.group(1))


@pytest.mark.parametrize("shape,arm", CASES, ids=[f"{s[0]}x{s[1]}-{_arm_id(a)}" for s, a in CASES])
def test_plain_version_matches_reference_kernel_at_tile_edges(monkeypatch, shape, arm):
    entry, preweighted, tb, te, bf16 = arm
    assert entry == "riesz_amplify_mxu" or min(shape) >= jra.MIN_FUSED_DIM
    for var in ("LVMT_MXU_DTYPE", "LVMT_MXU_PRECISION", "LVMT_TAIL_VERT", "LVMT_TAIL_DB",
                "LVMT_TAIL_TILE", "LVMT_TAIL_PACK"):
        monkeypatch.delenv(var, raising=False)
    if bf16:
        monkeypatch.setenv("LVMT_MXU_DTYPE", "bf16")  # read inside the reference kernel
    planes = _planes(shape, preweighted, seed=shape[0] * 1000 + shape[1])
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    jin = [jnp.asarray(x).astype(jdt[tb]) for x in planes[:3]]
    jin += [jnp.asarray(x).astype(jdt[te]) for x in planes[3:]]
    jmod = {"riesz_amplify_fused": jra, "riesz_amplify_mxu": jram}[entry]
    want = np.asarray(getattr(jmod, entry)(*jin, ALPHA, THRESHOLD, interpret=True,
                                           preweighted=preweighted))
    tin = [torch.from_numpy(x).to(DTYPES[tb]) for x in planes[:3]]
    tin += [torch.from_numpy(x).to(DTYPES[te]) for x in planes[3:]]
    kw = {"bf16": True} if bf16 else {}
    got = getattr(tail, entry)(*tin, ALPHA, THRESHOLD, preweighted=preweighted, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    if not bf16:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4, err_msg=_arm_id(arm))
        return
    bar = 1e-5 * float(np.abs(want).max())
    d = np.abs(got - want)
    assert np.all(d <= _bf16_ulp(want) + bar), f"{_arm_id(arm)}: beyond one bf16 ulp, max {d.max()}"
    assert float((d > bar).mean()) < 0.01, f"{_arm_id(arm)}: over 1% of pixels beyond the f32 bar"


def test_shapes_reach_every_edge_of_the_kernel_tile():
    th, tw = _source_constant("AMP_TH"), _source_constant("AMP_TW")
    halo = _source_constant("HALO")
    assert tail.AMPLIFY_TILE == (th, tw)
    shapes = tail.amplify13_shapes()
    assert len(set(shapes)) == len(shapes)
    # sides under the blur's reach, mirrored periodically (1 px included), each way
    assert (1, 1) in shapes and (16, 16) in shapes
    assert any(h <= halo and w > 2 * halo for h, w in shapes)
    assert any(w <= halo and h > 2 * halo for h, w in shapes)
    # one tile, one more row, one more column, and several tiles with a ragged edge
    assert {(th, tw), (th + 1, tw), (th, tw + 1)} <= set(shapes)
    assert any(h > 2 * th and h % th and w > 2 * tw and w % tw for h, w in shapes)
    # every width residue of the 16-byte staging chunks (4 f32, 8 bf16)
    assert {w % 8 for h, w in shapes if w >= tw} == set(range(8))
    # the five band levels of a 4K frame
    assert set(riesz_level_sizes(2160, 3840, 6)[:-1]) <= set(shapes)


@pytest.mark.parametrize("arm", ARMS, ids=[_arm_id(a) for a in ARMS])
def test_cpu_route_launches_nothing(arm):
    entry, preweighted, tb, te, bf16 = arm
    shape = (tail.AMPLIFY_TILE[0] + 1, tail.AMPLIFY_TILE[1] + 3)
    planes = _planes(shape, preweighted, seed=5)
    tin = [torch.from_numpy(x).to(DTYPES[tb]) for x in planes[:3]]
    tin += [torch.from_numpy(x).to(DTYPES[te]) for x in planes[3:]]
    before = (dict(tail.LAUNCHES), dict(tail.LAUNCHES_BF16))
    kw = {"bf16": True} if bf16 else {}
    got = getattr(tail, entry)(*tin, ALPHA, THRESHOLD, preweighted=preweighted, **kw)
    assert (tail.LAUNCHES, tail.LAUNCHES_BF16) == before
    ref = tail.riesz_amplify_plain(*tin, ALPHA, THRESHOLD, preweighted=preweighted, bf16=bf16)
    assert torch.equal(got, ref)
