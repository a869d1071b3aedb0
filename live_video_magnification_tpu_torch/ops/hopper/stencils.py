"""The Riesz pyramid's stencils and the plain tail's amplitude blur: CUDA
kernels for Hopper and their plain PyTorch versions.

Each public function takes [H, W] contiguous tensors (blur13 [..., H, W]).
On a CUDA tensor it launches its kernel from ``csrc/stencils.cu`` on the
current stream (or raises); on a CPU tensor it runs the plain version beside
it, the composition of ``ops/conv.py`` functions that the kernel must equal.
There is no switch and no fallback.

==================  ==================================================  =========
function            replaces (reference package)                        bound
==================  ==================================================  =========
conv9               ops/pallas/conv9_mxu.py::conv9_mxu                  bytes
band5               ops/pallas/conv9_mxu.py::band5_mxu                  bytes
lp9_decimate        ops/pallas/conv9_mxu.py::lp9_decimate_mxu           bytes
lp9_inject          ops/pallas/conv9_mxu.py::lp9_inject_mxu             bytes
riesz_build_level   ops/pallas/riesz_build.py::riesz_build_level_fused  bytes
blur13              no TPU kernel (ops/riesz.py::amplitude_blur, jnp)   bytes
==================  ==================================================  =========

The four MXU stencils take the reference's ``bf16`` operand arm: with
``bf16=True`` every pixel and every tap is rounded to bfloat16 (nearest even)
and the exact products are summed in f32, which is what the TPU kernels'
``dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)`` computes.
band5's vertical taps are the exception: the TPU kernel sums them on the VPU
in f32 and rounds only that sum (its matmul is by an identity shift), so the
bf16 arm of ``i`` is the f32 sum rounded to bfloat16. conv9 and band5 also
take ``out_dtype="bf16"`` (the f32 sum rounded on the store), and band5 a
bfloat16 input plane; everything else is float32, as in the reference.

riesz_build_level is one pass over an octave: hp = octave (*) HP9, its Riesz
pair, and the decimated 2*LP9 octave. It computes what conv9, band5 and
lp9_decimate compute, in the same order, so it equals their composition bit
for bit (hp's apron is taken by mirroring hp's index, as band5 reads it, not
from the padded octave as the TPU kernel does). Its operands are always f32.
Every kernel here matches its plain version's sign of a zero too.

conv9, lp9_decimate and lp9_inject tell their kernel whether the taps they
pass have the zero pattern of the bank each runs on the main path
(``tap_pattern``: conv9's high-pass uses all but the corners, decimate's and
inject's 2*LP9 all 81), which has an instantiation that skips those zeros at
compile time; any other bank takes the kernel's run-time test of each tap.
band5's launcher tells the same itself (the band taps' zero centre; in the
bf16 arm also taps whose products with bf16 pixels are exact, which its
kernel fuses into the sums).
riesz_build_level always passes the same three banks, whose patterns its
kernel compiles in. The design notes (tiles, reflect-101 by index
mirroring, the exact tap order) are at the top of the CUDA source. Unlike the
TPU kernels, these take any side of at least 5 (reflect-101 with a 4-px
reach), odd sides included; riesz_build_level takes sides of at least 16, the
reference's MIN_FUSED_DIM.

blur13 is the plain tail's GaussianBlur(13x13, sigma=3) of the amplitudes,
which the reference package leaves to jnp (XLA fuses it); its plain version
is ``sep_correlate2d`` with the 13 taps, 62 launches a plane. It takes
[..., H, W] f32 (the leading dims are planes of one launch, as the
time-parallel path's [T, H, W]) of any sides, and equals its plain version
bit for bit, NaN, infinities, signed zeros and subnormals included.

``LAUNCHES`` counts the kernel launches of each function with f32 operands,
``LAUNCHES_BF16`` those of the bf16 operand arms; a run that resets them can
show which kernels, and which arms, its main path went through. They count
calls on the host: a CUDA graph's replay launches its kernels without one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import (
    correlate2d,
    correlate_cols,
    correlate_rows,
    sep_correlate2d,
)
from live_video_magnification_tpu_torch.ops.hopper._build import launch, load_library
from live_video_magnification_tpu_torch.ops.kernels import (
    AMPLITUDE_BLUR_KERNEL_1D,
    LOWPASS_2X,
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
)
from live_video_magnification_tpu_torch.ops.resize import resize_nearest_even_inject

LAUNCHES = {"conv9": 0, "band5": 0, "lp9_decimate": 0, "lp9_inject": 0,
            "riesz_build_level": 0, "blur13": 0}
LAUNCHES_BF16 = {"conv9": 0, "band5": 0, "lp9_decimate": 0, "lp9_inject": 0}

MIN_SIDE = 5
MIN_FUSED_SIDE = 16  # riesz_build_level, the reference's MIN_FUSED_DIM

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# Output tiles (rows, columns) of the fused build's, the inject's and band5's
# kernels (csrc/stencils.cu BUILD_*_TX/TY, INJECT_*_TX/TY, BAND_*_TX/TY): the
# tall tiles run where they give at least TALL_GRID_MIN tiles, the small ones
# below (band5's for any bank but the main one; band5 with f32 in and out
# takes "tall_f32" where that gives as many, else "tall").
BUILD_TILES = {"tall": (32, 64), "small": (16, 32)}
INJECT_TILES = {"tall": (32, 128), "small": (16, 64)}
BAND_TILES = {"tall_f32": (64, 128), "tall": (32, 128), "small": (8, 64)}
TALL_GRID_MIN = 2 * 132
# blur13's output tiles (rows, columns): BLUR_TALL_TH / BLUR_SMALL_TH by
# BLUR_TW of csrc/stencils.cu; the tall ones where a launch has at least
# BLUR13_TALL_MIN of them (BLUR_TALL_MIN: its planes' tiles summed).
BLUR13_TILES = {"tall": (64, 64), "small": (32, 64)}
BLUR13_TALL_MIN = 2 * 4 * 132
# The 13 taps of the amplitude blur as f32, as blur13's and the tail's kernels take them.
TAPS13 = np.ascontiguousarray(np.asarray(AMPLITUDE_BLUR_KERNEL_1D, np.float32))

# The zero pattern of each function's main-path bank, for which its kernel
# has an instantiation (csrc/stencils.cu); the kernel tests any other bank's
# taps as it runs.
MAIN_TAPS = {"conv9": "no_corners", "lp9_decimate": "dense", "lp9_inject": "dense"}
_NO_CORNERS = np.ones((9, 9), bool)
_NO_CORNERS[::8, ::8] = False


def tap_pattern(k9) -> str:
    """Which taps of a 9x9 bank are used (non-zero, as the plain version
    skips zeros): "dense", "no_corners" or "any"."""
    used = np.asarray(k9, dtype=np.float32).reshape(9, 9) != 0
    if used.all():
        return "dense"
    if np.array_equal(used, _NO_CORNERS):
        return "no_corners"
    return "any"


@functools.lru_cache(maxsize=64)
def _kernel_taps(key: bytes, bf16: bool, fn: str) -> Tuple[np.ndarray, bool]:
    """The 81 taps fn's kernel takes (bf16-rounded for the bf16 arm) and
    whether they have the zero pattern of fn's main-path bank, classified
    after the rounding; cached by value so a call costs the host no more than
    a lookup."""
    taps = np.frombuffer(key, dtype=np.float32).copy()
    if bf16:
        taps = round_taps_bf16(taps)
    return taps, tap_pattern(taps) == MAIN_TAPS[fn]


def _tall_shape(tiles) -> Tuple[int, int]:
    """The smallest aligned shape of 17 x 16 tall tiles: at least
    TALL_GRID_MIN of them, so the tall instantiation runs."""
    th, tw = tiles["tall"]
    assert 17 * 16 >= TALL_GRID_MIN
    return 17 * th, 16 * tw


def build_level_shapes():
    """Shapes that reach every edge of riesz_build_level's tiles
    (BUILD_TILES): the smallest side (16) at every width residue mod 4
    (16-byte rows or not); one small tile, one more row, one more column, two
    and a ragged third each way; tall tiles (TALL_GRID_MIN or more) aligned,
    one row more and at every width residue; odd shapes; 1080p's level 4 and
    the five band levels of 2160x3840 (where blocks walk and prefetch several
    tiles each)."""
    sh, sw = BUILD_TILES["small"]
    th, tw = _tall_shape(BUILD_TILES)
    shapes = [(16, 16 + m) for m in range(4)]
    shapes += [(sh, sw), (sh + 1, sw), (sh, sw + 1), (2 * sh + 1, 2 * sw + 1)]
    shapes += [(th, tw), (th + 1, tw)] + [(th, tw + m) for m in range(1, 4)]
    shapes += [(33, 257), (97, 201), (135, 241), (68, 120)]
    return shapes + [(2160, 3840), (1080, 1920), (540, 960), (270, 480), (135, 240)]


def inject9_shapes():
    """(small shape, output shape) pairs that reach every edge of
    lp9_inject's tiles (INJECT_TILES): the smallest sides (small images of
    5 rows or columns); one small tile, one more row, one more column, two
    and a ragged third each way; widths of every residue mod 4 (16-byte
    output rows or not) and small images with 16-byte rows under odd
    outputs, and the reverse; a small image larger than the output needs; tall tiles
    (TALL_GRID_MIN or more) aligned and one element off; odd collapse
    targets; the collapse onto each band level of 2160x3840."""
    half = lambda hw: ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    sh, sw = INJECT_TILES["small"]
    th, tw = _tall_shape(INJECT_TILES)
    outs = [(9, 9), (9, 16), (16, 9), (sh, sw), (sh + 1, sw), (sh, sw + 1),
            (2 * sh + 1, 2 * sw + 1)]
    outs += [(24, 2 * sw + m) for m in range(4)] + [(sh, sw - 1)]
    outs += [(th, tw), (th + 1, tw + 1), (th, tw - 1), (th - 1, tw + 2)]
    outs += [(33, 257), (97, 201), (135, 241), (68, 120)]
    pairs = [(half(o), o) for o in outs] + [((70, 124), (135, 241)), ((9, 33), (sh, sw))]
    levels = [(2160, 3840), (1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)]
    return pairs + [(levels[i + 1], levels[i]) for i in range(len(levels) - 1)]


def band5_shapes():
    """Shapes that reach every edge of band5's tiles (BAND_TILES): the
    smallest side (5) at every width residue mod 8 (16-byte rows of f32 or
    of bf16, or not) and as the width; one small tile, one more row, one
    more column, two and a ragged third each way; tall tiles (TALL_GRID_MIN
    or more, of each tall size) aligned, one element more each way and (the
    32-row ones) with rows of f32 but not bf16 chunks; the odd shapes of the
    reference's band5 tests; every band level of 2160x3840 and 1080x1920
    (where blocks walk several tiles); the strips of the sharded step's
    first two levels (width 960 + 2 x 2)."""
    sh, sw = BAND_TILES["small"]
    th, tw = _tall_shape({"tall": BAND_TILES["tall"]})
    fh, fw = _tall_shape({"tall": BAND_TILES["tall_f32"]})
    shapes = [(5, 8 + m) for m in range(8)] + [(13, 5)]
    shapes += [(sh, sw), (sh + 1, sw), (sh, sw + 1), (2 * sh + 1, 2 * sw + 1)]
    shapes += [(th, tw), (th + 1, tw + 1), (th, tw + 4), (fh, fw), (fh + 1, fw + 1)]
    shapes += [(128, 128), (130, 250), (96, 200), (33, 257), (97, 201), (135, 241)]
    shapes += [(2160, 3840), (1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)]
    return shapes + [(2160, 964), (1080, 484)]


def blur13_shapes():
    """Shapes that reach every edge of blur13's tiles (BLUR13_TILES): sides
    under the blur's 6-px reach (mirrored periodically, down to 1) and just
    over it, on either side; one small tile, one more row, one more column,
    two and a ragged third each way; a width of every residue mod 4 (16-byte
    rows or not); tall tiles (BLUR13_TALL_MIN or more) aligned, one row more
    and one column more; odd shapes; every band level of 1080x1920 and of
    2160x3840 levels 6 (the finest in tall tiles)."""
    th, tw = BLUR13_TILES["small"]
    narrow = [(n, 37) for n in (1, 2, 6, 7, 13, 14)] + [(29, n) for n in (1, 2, 6, 7, 13, 14)]
    shapes = narrow + [(1, 1), (2, 5), (6, 7)]
    shapes += [(th, tw), (th + 1, tw), (th, tw + 1), (2 * th + 1, 2 * tw + 1)]
    shapes += [(40, 2 * tw + m) for m in range(4)]
    tth, ttw = BLUR13_TILES["tall"]
    assert 33 * 32 >= BLUR13_TALL_MIN
    shapes += [(33 * tth, 32 * ttw), (33 * tth + 1, 32 * ttw), (33 * tth, 32 * ttw + 1)]
    shapes += [(33, 257), (97, 201), (135, 241)]
    shapes += [(1080, 1920), (540, 960), (270, 480), (135, 240), (68, 120)]
    return shapes + [(2160, 3840)]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


def round_taps_bf16(k) -> np.ndarray:
    """f32 taps rounded to bfloat16, as float32 host values."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(k, dtype=np.float32)))
    return round_bf16(t).numpy()


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a storage name ("f32" or "bf16"); raises otherwise."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}: expected one of {', '.join(DTYPES)}")
    return DTYPES[name]


# ---------------------------------------------------------------- plain versions


def conv9_plain(x: torch.Tensor, k9, bf16: bool = False, out_dtype: str = "f32") -> torch.Tensor:
    if bf16:
        x, k9 = round_bf16(x), round_taps_bf16(k9)
    return correlate2d(x, k9).to(resolve_dtype(out_dtype))


def band5_plain(hp: torch.Tensor, taps, bf16: bool = False,
                out_dtype: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    hp = hp.float()
    if bf16:
        r = correlate_rows(round_bf16(hp), round_taps_bf16(taps))
        i = round_bf16(correlate_cols(hp, taps))
    else:
        r, i = correlate_rows(hp, taps), correlate_cols(hp, taps)
    od = resolve_dtype(out_dtype)
    return r.to(od), i.to(od)


def lp9_decimate_plain(x: torch.Tensor, k9, bf16: bool = False) -> torch.Tensor:
    if bf16:
        x, k9 = round_bf16(x), round_taps_bf16(k9)
    return correlate2d(x, k9)[::2, ::2].contiguous()


def lp9_inject_plain(small: torch.Tensor, k9, out_hw: Tuple[int, int],
                     bf16: bool = False) -> torch.Tensor:
    if bf16:
        small, k9 = round_bf16(small), round_taps_bf16(k9)
    return correlate2d(resize_nearest_even_inject(small, out_hw), k9)


def blur13_plain(x: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(13x13, sigma=3), reflect-101: the W-axis pass, then the
    H-axis pass, each tap's product and each sum rounded to f32."""
    return sep_correlate2d(x, AMPLITUDE_BLUR_KERNEL_1D, AMPLITUDE_BLUR_KERNEL_1D)


def riesz_build_level_plain(octave: torch.Tensor, out_dtype: str = "f32"):
    """(hp, r, i, decimated octave): conv9, band5 on its f32 result, and
    lp9_decimate; hp, r and i rounded to ``out_dtype`` last."""
    hp = conv9_plain(octave, RIESZ_HIGHPASS_9x9)
    r, i = band5_plain(hp, RIESZ_BAND_KERNEL)
    sub = lp9_decimate_plain(octave, LOWPASS_2X)
    od = resolve_dtype(out_dtype)
    return hp.to(od), r.to(od), i.to(od), sub


# ---------------------------------------------------------------- launching


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("stencils")
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "lvmt_conv9": [p, p, i, i, p, i, i, i, p],
        "lvmt_lp9_decimate": [p, p, i, i, p, i, i, p],
        "lvmt_band5": [p, p, p, i, i, p, p, i, i, i, p],
        "lvmt_lp9_inject": [p, p, i, i, i, i, p, i, i, p],
        "lvmt_riesz_build_level": [p, p, p, p, p, i, i, p, p, p, i, p],
        "lvmt_blur13": [p, p, i, i, i, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_plane(x: torch.Tensor, what: str, dtypes=(torch.float32,)) -> None:
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what}: expected {names}, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: expected an [H, W] plane, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if min(x.shape) < MIN_SIDE:
        raise ValueError(
            f"{what}: sides {tuple(x.shape)} below {MIN_SIDE}: reflect-101 with a "
            "4-px reach is undefined"
        )
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _taps(k, n: int) -> np.ndarray:
    t = np.ascontiguousarray(np.asarray(k, dtype=np.float32).reshape(-1))
    if t.size != n:
        raise ValueError(f"expected {n} taps, got {t.size}")
    return t


def _launch(name: str, bf16: bool, device: torch.device, *args) -> None:
    launch(getattr(_lib(), "lvmt_" + name), name, device, *args)
    (LAUNCHES_BF16 if bf16 else LAUNCHES)[name] += 1


def conv9(x: torch.Tensor, k9, *, bf16: bool = False, out_dtype: str = "f32") -> torch.Tensor:
    """correlate2d(x, k9), 9x9, reflect-101: [H, W] f32 -> [H, W] ``out_dtype``."""
    _check_plane(x, "conv9")
    od = resolve_dtype(out_dtype)
    taps = _taps(k9, 81)
    bf16 = bool(bf16)
    if x.device.type == "cpu":
        return conv9_plain(x, taps.reshape(9, 9), bf16, out_dtype)
    ktaps, main_taps = _kernel_taps(taps.tobytes(), bf16, "conv9")
    out = torch.empty(x.shape, dtype=od, device=x.device)
    h, w = x.shape
    _launch("conv9", bf16, x.device, x.data_ptr(), out.data_ptr(), h, w, ktaps.ctypes.data,
            int(bf16), int(od == torch.bfloat16), int(main_taps))
    return out


def band5(hp: torch.Tensor, taps, *, bf16: bool = False,
          out_dtype: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """(correlate_rows(hp, taps), correlate_cols(hp, taps)), 5 taps, reflect-101;
    hp float32 or bfloat16."""
    _check_plane(hp, "band5", (torch.float32, torch.bfloat16))
    od = resolve_dtype(out_dtype)
    t5 = _taps(taps, 5)
    bf16 = bool(bf16)
    if hp.device.type == "cpu":
        return band5_plain(hp, t5, bf16, out_dtype)
    r_taps = round_taps_bf16(t5) if bf16 else t5
    r = torch.empty(hp.shape, dtype=od, device=hp.device)
    i = torch.empty(hp.shape, dtype=od, device=hp.device)
    h, w = hp.shape
    _launch("band5", bf16, hp.device, hp.data_ptr(), r.data_ptr(), i.data_ptr(), h, w,
            r_taps.ctypes.data, t5.ctypes.data, int(hp.dtype == torch.bfloat16),
            int(od == torch.bfloat16), int(bf16))
    return r, i


def lp9_decimate(x: torch.Tensor, k9, *, bf16: bool = False) -> torch.Tensor:
    """correlate2d(x, k9)[::2, ::2]: [H, W] -> [ceil(H/2), ceil(W/2)], f32."""
    _check_plane(x, "lp9_decimate")
    taps = _taps(k9, 81)
    bf16 = bool(bf16)
    if x.device.type == "cpu":
        return lp9_decimate_plain(x, taps.reshape(9, 9), bf16)
    ktaps, main_taps = _kernel_taps(taps.tobytes(), bf16, "lp9_decimate")
    h, w = x.shape
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=x.dtype, device=x.device)
    _launch("lp9_decimate", bf16, x.device, x.data_ptr(), out.data_ptr(), h, w,
            ktaps.ctypes.data, int(bf16), int(main_taps))
    return out


def lp9_inject(small: torch.Tensor, k9, out_hw: Tuple[int, int], *,
               bf16: bool = False) -> torch.Tensor:
    """correlate2d(resize_nearest_even_inject(small, out_hw), k9): [h, w] ->
    out_hw, f32, for any out_hw with ceil(out/2) <= the small side."""
    _check_plane(small, "lp9_inject")
    taps = _taps(k9, 81)
    bf16 = bool(bf16)
    h, w = (int(v) for v in out_hw)
    sh, sw = small.shape
    if min(h, w) < MIN_SIDE or (h + 1) // 2 > sh or (w + 1) // 2 > sw:
        raise ValueError(f"lp9_inject: target {out_hw} does not fit source {(sh, sw)}")
    if small.device.type == "cpu":
        return lp9_inject_plain(small, taps.reshape(9, 9), (h, w), bf16)
    ktaps, main_taps = _kernel_taps(taps.tobytes(), bf16, "lp9_inject")
    out = torch.empty((h, w), dtype=small.dtype, device=small.device)
    _launch("lp9_inject", bf16, small.device, small.data_ptr(), out.data_ptr(), sh, sw, h, w,
            ktaps.ctypes.data, int(bf16), int(main_taps))
    return out


def riesz_build_level(octave: torch.Tensor, *, out_dtype: str = "f32"):
    """One band level of the pyramid in one pass: (hp, r, i, decimated octave)
    as the reference's riesz_build_level_fused returns them. hp, r and i are
    [H, W] ``out_dtype``, the octave [ceil(H/2), ceil(W/2)] f32. Both sides of
    the f32 input must be at least 16."""
    _check_plane(octave, "riesz_build_level")
    od = resolve_dtype(out_dtype)
    if min(octave.shape) < MIN_FUSED_SIDE:
        raise ValueError(f"riesz_build_level: sides {tuple(octave.shape)} below "
                         f"{MIN_FUSED_SIDE}")
    if octave.device.type == "cpu":
        return riesz_build_level_plain(octave, out_dtype)
    h, w = octave.shape
    hp, r, i = (torch.empty((h, w), dtype=od, device=octave.device) for _ in range(3))
    sub = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=octave.device)
    hp9, t5, lp9 = _taps(RIESZ_HIGHPASS_9x9, 81), _taps(RIESZ_BAND_KERNEL, 5), _taps(LOWPASS_2X, 81)
    _launch("riesz_build_level", False, octave.device, octave.data_ptr(), hp.data_ptr(),
            r.data_ptr(), i.data_ptr(), sub.data_ptr(), h, w, hp9.ctypes.data,
            t5.ctypes.data, lp9.ctypes.data, int(od == torch.bfloat16))
    return hp, r, i, sub


def blur13(x: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(13x13, sigma=3), reflect-101, of each [H, W] plane of x:
    [..., H, W] f32, contiguous, sides of at least 1 -> the same shape."""
    if x.dtype != torch.float32:
        raise TypeError(f"blur13: expected float32, got {x.dtype}")
    if x.ndim < 2:
        raise ValueError(f"blur13: expected [..., H, W] planes, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("blur13: expected a contiguous tensor")
    if x.numel() == 0:
        raise ValueError(f"blur13: empty planes {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"blur13: unsupported device {x.device}")
    if x.device.type == "cpu":
        return blur13_plain(x)
    out = torch.empty_like(x)
    h, w = x.shape[-2:]
    _launch("blur13", False, x.device, x.data_ptr(), out.data_ptr(), x.numel() // (h * w), h, w,
            TAPS13.ctypes.data)
    return out
