"""The fused build's (K5) and the collapse inject's (K4) tile edges on the CPU,
where riesz_build_level and lp9_inject run their plain versions: the plain
versions against the reference JAX package at one shape of each kind of
tile edge of ``stencils.build_level_shapes()`` and
``stencils.inject9_shapes()`` up to 140x260 (K5: riesz_build_level_fused
in interpret mode; K4: lp9_inject_mxu in interpret mode for exact-2x
targets, both operand arms at one, and correlate2d of
resize_nearest_even_inject for the others); those lists
against the tile constants of the CUDA source; the inject's bank
classification; and the CPU route, which launches nothing. The card's test
(tests/test_torch_cuda.py) holds the kernels at every shape of the lists
against the plain versions bit for bit.

Bars: the reference suite's (tests/test_pallas_kernels.py): K5 3e-4 at
inputs x100 (the JAX kernel takes hp's apron from the padded octave, another
order of the same sums), K4 2e-4 at inputs of magnitude 10 (its banded
matmuls sum in another order).
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.conv9_mxu as jc9
import live_video_magnification_tpu.ops.pallas.riesz_build as jrb
from live_video_magnification_tpu.ops import conv as jconv
from live_video_magnification_tpu.ops.resize import resize_nearest_even_inject
from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.ops.hopper._build import CSRC
from live_video_magnification_tpu_torch.ops.kernels import (
    LOWPASS_2X,
    RIESZ_HIGHPASS_9x9,
)
from live_video_magnification_tpu_torch.ops.riesz import riesz_level_sizes

torch.set_num_threads(2)

LEVELS_4K = [tuple(s) for s in riesz_level_sizes(2160, 3840, 6)]


def _source_constant(name: str) -> int:
    text = (CSRC / "stencils.cu").read_text()
    found = re.search(rf"constexpr int {name} = ([0-9 *]+);", text)
    assert found, f"{name} not found in stencils.cu"
    return int(np.prod([int(v) for v in found.group(1).split("*")]))  # "64", "2 * 132"


def _tiles(prefix):
    return {size: (_source_constant(f"{prefix}_{size.upper()}_TY"),
                   _source_constant(f"{prefix}_{size.upper()}_TX"))
            for size in ("tall", "small")}


def _tall_tiles(tile, hw):
    return -(-hw[0] // tile[0]) * -(-hw[1] // tile[1])


def test_build_shapes_reach_every_edge_of_the_kernel_tiles():
    tiles = _tiles("BUILD")
    assert stencils.BUILD_TILES == tiles
    assert stencils.TALL_GRID_MIN == _source_constant("TALL_GRID_MIN")
    shapes = stencils.build_level_shapes()
    assert len(set(shapes)) == len(shapes)
    assert min(min(s) for s in shapes) == stencils.MIN_FUSED_SIDE
    # the smallest side at every width residue of the 16-byte chunks
    assert {w % 4 for h, w in shapes if h == stencils.MIN_FUSED_SIDE} == set(range(4))
    (sh, sw), (th, tw) = tiles["small"], tiles["tall"]
    assert {(sh, sw), (sh + 1, sw), (sh, sw + 1), (2 * sh + 1, 2 * sw + 1)} <= set(shapes)
    tall = [s for s in shapes if _tall_tiles((th, tw), s) >= stencils.TALL_GRID_MIN]
    # the tall tiles aligned, one row more, and at every width residue
    assert any(h % th == 0 and w % tw == 0 for h, w in tall)
    assert any(h % th == 1 for h, w in tall)
    assert {w % 4 for h, w in tall} == set(range(4))
    # shapes that stay on the small tiles, and the five band levels of a 4K
    # frame (blocks walk several tiles) and 1080p's level 4
    assert any(_tall_tiles((th, tw), s) < stencils.TALL_GRID_MIN and min(s) > 64 for s in shapes)
    assert set(LEVELS_4K[:-1]) | {(68, 120)} <= set(shapes)


def test_inject_shapes_reach_every_edge_of_the_kernel_tiles():
    tiles = _tiles("INJECT")
    assert stencils.INJECT_TILES == tiles
    pairs = stencils.inject9_shapes()
    assert len(set(pairs)) == len(pairs)
    for small, out in pairs:
        assert (out[0] + 1) // 2 <= small[0] and (out[1] + 1) // 2 <= small[1]
    outs = [o for _, o in pairs]
    assert min(min(s) for s, _ in pairs) == stencils.MIN_SIDE
    (sh, sw), (th, tw) = tiles["small"], tiles["tall"]
    assert {(sh, sw), (sh + 1, sw), (sh, sw + 1), (2 * sh + 1, 2 * sw + 1)} <= set(outs)
    tall = [o for o in outs if _tall_tiles((th, tw), o) >= stencils.TALL_GRID_MIN]
    assert any(h % th == 0 and w % tw == 0 for h, w in tall)
    assert any(h % 2 and w % 2 for h, w in tall)  # odd targets on the tall tiles
    # output widths of every residue mod 4; small images with 16-byte rows
    # under outputs without, and without under outputs with
    assert {w % 4 for w in (o[1] for o in outs)} == set(range(4))
    assert any(s[1] % 4 == 0 and o[1] % 4 for s, o in pairs)
    assert any(s[1] % 4 and o[1] % 4 == 0 for s, o in pairs)
    # a small image larger than the injected array needs
    assert any(s[0] > (o[0] + 1) // 2 or s[1] > (o[1] + 1) // 2 for s, o in pairs)
    # the collapse onto every band level of a 4K frame
    assert {(LEVELS_4K[i + 1], LEVELS_4K[i]) for i in range(5)} <= set(pairs)


def _octave(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 3)
    return rng.random(shape).astype(np.float32) * 100.0


# One shape of each kind of tile edge up to 140x260, each reference call
# ~2 s on the CPU: K5 against the Pallas kernel in interpret mode; K4 against
# lp9_inject_mxu in interpret mode (exact-2x targets; the third field: both
# operand arms) or correlate2d of resize_nearest_even_inject (any target).
BUILD_JAX = [(16, 16), (16, 19), (17, 32), (33, 65), (68, 120), (135, 241)]
INJECT_PALLAS = [((8, 32), (16, 64), True), ((34, 60), (68, 120), False)]
INJECT_PLAIN = [((5, 5), (9, 9)), ((9, 32), (17, 64)), ((12, 66), (24, 131)),
                ((68, 121), (135, 241)), ((70, 124), (135, 241)), ((9, 33), (16, 64))]


def test_cpu_shapes_are_tile_edges_of_the_lists():
    assert set(BUILD_JAX) <= set(stencils.build_level_shapes())
    pairs = set(stencils.inject9_shapes())
    assert {(s, o) for s, o, _ in INJECT_PALLAS} | set(INJECT_PLAIN) <= pairs


@pytest.mark.parametrize("shape", BUILD_JAX, ids=[f"{h}x{w}" for h, w in BUILD_JAX])
def test_build_plain_matches_reference_kernel_at_tile_edges(shape):
    x = _octave(shape)
    got = stencils.riesz_build_level(torch.from_numpy(x))
    want = jrb.riesz_build_level_fused(jnp.asarray(x), interpret=True)
    for name, g, r in zip(("hp", "r", "i", "decimated"), got, want):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-4, err_msg=name)


def _small(small):
    rng = np.random.default_rng(small[0] * 1000 + small[1] + 5)
    return rng.random(small).astype(np.float32) * 10.0 - 5.0


@pytest.mark.parametrize("small,out,both_arms", INJECT_PALLAS,
                         ids=[f"{s[0]}x{s[1]}-{o[0]}x{o[1]}" for s, o, _ in INJECT_PALLAS])
def test_inject_plain_matches_reference_kernel_at_tile_edges(small, out, both_arms):
    s = _small(small)
    for bf16 in (False, True) if both_arms else (False,):
        got = stencils.lp9_inject(torch.from_numpy(s), LOWPASS_2X, out, bf16=bf16)
        want = jc9.lp9_inject_mxu(jnp.asarray(s), LOWPASS_2X, out, interpret=True, bf16=bf16)
        assert tuple(got.shape) == out
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("small,out", INJECT_PLAIN,
                         ids=[f"{s[0]}x{s[1]}-{o[0]}x{o[1]}" for s, o in INJECT_PLAIN])
def test_inject_plain_matches_zero_inject_then_correlate_at_tile_edges(small, out):
    s = _small(small)
    got = stencils.lp9_inject(torch.from_numpy(s), LOWPASS_2X, out)
    want = jconv.correlate2d(resize_nearest_even_inject(jnp.asarray(s), out), LOWPASS_2X)
    assert tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def _random_taps(zeros):
    k = np.random.default_rng(7).standard_normal((9, 9)).astype(np.float32)
    for ij in zeros:
        k[ij] = 0.0
    return k


@pytest.mark.parametrize("bank,bf16,main", [
    ("lp2", False, True), ("lp2", True, True), ("negative_dense", False, True),
    ("random_dense", True, True), ("hp9", False, False), ("random_zeros", False, False),
    ("interior_zero", True, False),
])
def test_only_dense_banks_take_the_inject_instantiations(bank, bf16, main):
    """The inject's compile-time taps are 2*LP9's pattern (all 81 used);
    any bank with a zero, after the bf16 rounding, takes the run-time test."""
    k9 = {"lp2": LOWPASS_2X, "negative_dense": -np.abs(LOWPASS_2X),
          "random_dense": _random_taps([]), "hp9": RIESZ_HIGHPASS_9x9,
          "random_zeros": _random_taps([(0, 3), (8, 8)]),
          "interior_zero": _random_taps([(4, 4)])}[bank]
    key = np.ascontiguousarray(k9, np.float32).reshape(-1).tobytes()
    assert stencils._kernel_taps(key, bf16, "lp9_inject")[1] is main


CPU_ROUTE = [("build", "f32"), ("build", "bf16"), ("inject", False), ("inject", True)]


@pytest.mark.parametrize("fn,arm", CPU_ROUTE)
def test_cpu_route_launches_nothing(fn, arm):
    before = (dict(stencils.LAUNCHES), dict(stencils.LAUNCHES_BF16))
    if fn == "build":
        x = torch.from_numpy(_octave((stencils.BUILD_TILES["small"][0] + 1, 37)))
        got = stencils.riesz_build_level(x, out_dtype=arm)
        ref = stencils.riesz_build_level_plain(x, arm)
    else:
        s = torch.from_numpy(_octave((9, 33)))
        got = (stencils.lp9_inject(s, LOWPASS_2X, (17, 65), bf16=arm),
               stencils.lp9_inject(s, _random_taps([(2, 2)]), (17, 65), bf16=arm))
        ref = (stencils.lp9_inject_plain(s, LOWPASS_2X, (17, 65), arm),
               stencils.lp9_inject_plain(s, _random_taps([(2, 2)]), (17, 65), arm))
    assert (stencils.LAUNCHES, stencils.LAUNCHES_BF16) == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
