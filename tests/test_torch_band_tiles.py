"""The Riesz band pair's (K2, band5) tile edges on the CPU, where band5 runs
its plain version: ``stencils.band5_shapes()`` against the tile constants of
the CUDA source and the edges it must reach; the plain version against the
reference JAX package's band5_mxu in interpret mode at one small shape of
each kind of tile edge, both operand arms and both input dtypes; and the CPU
route, which launches nothing. The card's test (tests/test_torch_cuda.py)
holds all eight kernel instantiations at every shape of the list against
the plain version bit for bit.

Bars: the f32 arm 3e-4 absolute at inputs of magnitude 100 (the reference
suite's, tests/test_torch_stencils.py); the bf16 arm as in
tests/test_torch_fast.py: r with f32 outputs within 1e-5 * max|x| *
sum|taps| (sums of the same exact products in another order), i (its f32
sum rounded to bf16) and bf16 outputs within that plus one bf16 ulp, beyond
the f32 bar on under 1% of pixels.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.conv9_mxu as jc9
from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.hopper._build import CSRC
from live_video_magnification_tpu_torch.ops.kernels import RIESZ_BAND_KERNEL
from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes

torch.set_num_threads(2)

LEVELS_4K = [tuple(s) for s in riesz_level_sizes(2160, 3840, 6)]
LEVELS_1080P = [tuple(s) for s in riesz_level_sizes(1080, 1920, 6)]
STRIP_W = 3840 // 4 + 2 * 2  # a 4K level-0 strip of four lane shards, band5's 2-px halo


def _source_constant(name: str) -> int:
    text = (CSRC / "stencils.cu").read_text()
    found = re.search(rf"constexpr int {name} = ([0-9 *]+);", text)
    assert found, f"{name} not found in stencils.cu"
    return int(np.prod([int(v) for v in found.group(1).split("*")]))


def _tall_tiles(tile, hw):
    return -(-hw[0] // tile[0]) * -(-hw[1] // tile[1])


def test_band_tiles_match_the_source():
    tiles = {size: (_source_constant(f"BAND_{size.upper()}_TY"),
                    _source_constant(f"BAND_{size.upper()}_TX"))
             for size in ("tall_f32", "tall", "small")}
    assert stencils.BAND_TILES == tiles
    assert stencils.TALL_GRID_MIN == _source_constant("TALL_GRID_MIN")


def test_band5_shapes_reach_every_edge_of_the_kernel_tiles():
    shapes = stencils.band5_shapes()
    assert len(set(shapes)) == len(shapes)
    assert min(min(s) for s in shapes) == stencils.MIN_SIDE
    # the smallest side at every width residue of the 16-byte chunks of f32
    # (4 elements) and bf16 (8), and as the width
    assert {w % 8 for h, w in shapes if h == stencils.MIN_SIDE} == set(range(8))
    assert any(w == stencils.MIN_SIDE for h, w in shapes)
    (sh, sw), (th, tw) = stencils.BAND_TILES["small"], stencils.BAND_TILES["tall"]
    assert {(sh, sw), (sh + 1, sw), (sh, sw + 1), (2 * sh + 1, 2 * sw + 1)} <= set(shapes)
    for size in ("tall_f32", "tall"):
        th, tw = stencils.BAND_TILES[size]
        tall = [s for s in shapes if _tall_tiles((th, tw), s) >= stencils.TALL_GRID_MIN]
        if size == "tall":  # and not the f32 tile's
            tall = [s for s in tall if _tall_tiles(stencils.BAND_TILES["tall_f32"], s)
                    < stencils.TALL_GRID_MIN]
        # aligned, one element more each way, and with rows of whole f32
        # chunks but not bf16 ones
        assert any(h % th == 0 and w % tw == 0 for h, w in tall), size
        assert any(h % th == 1 for h, w in tall) and any(w % tw == 1 for h, w in tall), size
        assert any(w % 8 == 4 for h, w in tall), size
    # shapes that stay on the small tiles though large
    assert any(_tall_tiles((th, tw), s) < stencils.TALL_GRID_MIN and min(s) > 64 for s in shapes)
    # the reference's band5 test shapes, every band level of 4K and 1080p
    # (blocks walk several tiles), a lane-sharded strip
    assert {(128, 128), (130, 250), (96, 200)} <= set(shapes)
    assert set(LEVELS_4K[:-1]) | set(LEVELS_1080P[:-1]) <= set(shapes)
    assert (LEVELS_4K[0][0], STRIP_W) in shapes


# One small shape of each kind of tile edge: the smallest side (height,
# width), the small tile one column over, two tiles and a ragged third, a
# reference test shape, and a strip as wide as a sharded 4K level-0 strip
# (the tall tiles need >= 264 tiles: too large for the interpret mode).
JAX_SHAPES = [(5, 13), (13, 5), (8, 65), (17, 129), (130, 250), (20, STRIP_W)]


def test_cpu_shapes_are_tile_edges_of_the_list():
    shapes = set(stencils.band5_shapes())
    widths = {w for _, w in shapes}
    for h, w in JAX_SHAPES:
        assert (h, w) in shapes or (w in widths and h < 32), (h, w)


def _hp(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 9)
    return (rng.random(shape) * 100.0 - 50.0).astype(np.float32)


def _f32_bar(x) -> float:
    return 1e-5 * float(np.abs(x).max()) * float(np.abs(np.asarray(RIESZ_BAND_KERNEL)).sum())


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (2^(e - 7) for |v| in [2^e, 2^(e+1)))."""
    a = np.abs(v.astype(np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _within_a_bf16_ulp(got, want, bar, what):
    d = np.abs(got - want)
    assert np.all(d <= _bf16_ulp(want) + bar), f"{what}: beyond one bf16 ulp, max {d.max()}"
    assert float((d > bar).mean()) < 0.01, f"{what}: beyond the f32 bar on 1% of pixels"


@pytest.fixture
def mxu_unset(monkeypatch):
    monkeypatch.delenv("LVMT_MXU_DTYPE", raising=False)


@pytest.mark.parametrize("hp_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=[f"{h}x{w}" for h, w in JAX_SHAPES])
def test_band5_plain_matches_reference_kernel_at_tile_edges(mxu_unset, shape, hp_dtype):
    x = _hp(shape)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if hp_dtype == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(stencils.DTYPES[hp_dtype])
    bar = _f32_bar(x)
    for bf16 in (False, True):
        got = stencils.band5(tx, RIESZ_BAND_KERNEL, bf16=bf16)
        want = jc9.band5_mxu(jx, RIESZ_BAND_KERNEL, interpret=True, bf16=bf16)
        for part, g, w in zip("ri", got, want):
            assert tuple(g.shape) == shape and g.dtype == torch.float32
            g, w = g.numpy(), np.asarray(w, np.float32)
            what = f"band5 {part} bf16={bf16}"
            if not bf16:
                np.testing.assert_allclose(g, w, atol=3e-4, err_msg=what)
            elif part == "r":
                assert np.abs(g - w).max() <= bar, what
            else:  # i of the bf16 arm is its f32 sum rounded to bf16
                _within_a_bf16_ulp(g, w, bar, what)


@pytest.mark.parametrize("shape", [(8, 65), (130, 250)], ids=["8x65", "130x250"])
def test_band5_plain_bf16_outputs_match_reference_kernel(mxu_unset, shape):
    """bf16 in, bf16 out, bf16 operands: the --fast build's call."""
    x = _hp(shape)
    got = stencils.band5(torch.from_numpy(x).to(torch.bfloat16), RIESZ_BAND_KERNEL, bf16=True,
                         out_dtype="bf16")
    want = jc9.band5_mxu(jnp.asarray(x).astype(jnp.bfloat16), RIESZ_BAND_KERNEL,
                         interpret=True, bf16=True, out_dtype="bf16")
    for part, g, w in zip("ri", got, want):
        assert g.dtype == torch.bfloat16
        _within_a_bf16_ulp(g.float().numpy(), np.asarray(w, np.float32), _f32_bar(x),
                           f"band5[bf16] {part}")


ARMS = [(ti, to, ops) for ti in ("f32", "bf16") for to in ("f32", "bf16") for ops in (False, True)]


@pytest.mark.parametrize("hp_dtype,out_dtype,bf16", ARMS)
def test_cpu_route_launches_nothing(hp_dtype, out_dtype, bf16):
    """Every instantiation's arguments on a CPU tensor: the plain version,
    no launch counted, for the main bank and a bank with a zero."""
    x = torch.from_numpy(_hp((stencils.BAND_TILES["small"][0] + 1, 37))).to(
        stencils.DTYPES[hp_dtype])
    other = np.array([0.3, 0.0, -1.5, 0.25, 2.0], np.float32)
    before = (dict(stencils.LAUNCHES), dict(stencils.LAUNCHES_BF16))
    for taps in (RIESZ_BAND_KERNEL, other):
        got = stencils.band5(x, taps, bf16=bf16, out_dtype=out_dtype)
        ref = stencils.band5_plain(x, taps, bf16, out_dtype)
        for g, r in zip(got, ref):
            assert g.dtype == stencils.DTYPES[out_dtype] and torch.equal(g, r)
    assert (stencils.LAUNCHES, stencils.LAUNCHES_BF16) == before
