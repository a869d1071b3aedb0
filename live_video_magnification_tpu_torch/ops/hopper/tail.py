"""The per-level Riesz tail: CUDA kernels for Hopper and their plain PyTorch
versions.

Each public function keeps the name and the signature of the reference
package's entry point (without ``interpret`` and the TPU geometry options)
and takes [H, W] float32 contiguous tensors of one shape on one device. On a
CUDA tensor it launches its kernel from ``csrc/tail.cu`` on the current
stream (or raises); on a CPU tensor it runs the plain version beside it.
There is no switch and no fallback.

riesz_amplify_mxu also takes the reference's fast arms: its amplitude and
change planes may be bfloat16 (``LVMT_TAIL_IO``), its lowpass and Riesz pair
too (``LVMT_PYR_IO``), each group of three of one dtype; and ``bf16=True``
(``LVMT_MXU_DTYPE=bf16``, which the reference reads inside the kernel) runs
its blurs on bf16 operands as the TPU kernel's default vertical matmul does:
the vertical pass on bf16 taps and bf16 strip values (the amplitude, or the
f32 product change * amplitude), summed in f32; that sum and the taps
rounded to bf16 for the horizontal pass. The f32 arm keeps the W-axis pass
first.

  * riesz_phase_df2_fused -> phase_df2_kernel, replaces
    ops/pallas/riesz_phase_fused.py::riesz_phase_df2_fused (K8);
  * riesz_amplify_fused -> amplify13_kernel, replaces
    ops/pallas/riesz_amplify.py::riesz_amplify_fused (K7);
  * riesz_amplify_mxu -> amplify13_kernel, replaces
    ops/pallas/riesz_amplify_mxu.py::riesz_amplify_mxu (K6);
  * riesz_level_mxu -> level_tail_kernel, replaces
    ops/pallas/riesz_level_mxu.py::riesz_level_mxu (K9).

The two amplify entry points compute one function and share one kernel.
Their plain versions use the rotation of ``ops/riesz.py`` and the blur's plain
version ``stencils.blur13_plain`` (plain PyTorch on a CUDA tensor too, so the
card tests hold the kernels against PyTorch, not against another kernel); the
front of the phase (K8, K9) uses the reference kernels' polynomial arccos
(``polynomial_arccos``), not torch.arccos, as the TPU kernels do. The design
notes (tiles, halo, the exact operation order) are at the top of the CUDA
source. All four bound by bytes at every level of a 4K frame.

``MIN_SIDE`` is the step's size rule: a level whose sides are both at least
16 runs its tail kernel; smaller levels take the plain tail, as the reference
package does below its own gate. The functions themselves take any size.

``LAUNCHES`` counts the kernel launches of each entry point with f32
operands, ``LAUNCHES_BF16`` those of riesz_amplify_mxu's bf16 operand arm; a
run that resets them can show which kernels its main path went through.
They count calls on the host: a CUDA graph's replay launches its kernels
without one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.ops.conv import correlate_cols, correlate_rows
from live_video_magnification_tpu_torch.ops.hopper._build import launch, load_library
from live_video_magnification_tpu_torch.ops.hopper.stencils import (
    TAPS13,
    blur13_plain,
    round_bf16,
    round_taps_bf16,
)
from live_video_magnification_tpu_torch.ops.riesz import (
    RieszLevel,
    amplify_level,
    phase_difference_and_amplitude,
    polynomial_arccos,
    riesz_level_sizes,
)
from live_video_magnification_tpu_torch.ops.temporal import CompExp, riesz_df2_step

LAUNCHES = {"riesz_phase_df2_fused": 0, "riesz_amplify_fused": 0,
            "riesz_amplify_mxu": 0, "riesz_level_mxu": 0}
LAUNCHES_BF16 = {"riesz_amplify_mxu": 0}

MIN_SIDE = 16

# amplify13_kernel's block tile in outputs (rows, columns): AMP_TH and AMP_TW
# of csrc/tail.cu. It stages its planes in 16-byte chunks: 4 f32 or 8 bf16.
AMPLIFY_TILE = (32, 64)


def amplify13_shapes():
    """Shapes that reach every edge of amplify13_kernel's tile: sides under
    the 13-tap blur's reach (mirrored periodically, down to 1x1) and 16x16;
    one tile, one tile plus a row or a column, two tiles each way and one
    more; a width of every residue mod 8 (16-byte rows of f32 and bf16
    planes or not); odd shapes; the five band levels of 2160x3840."""
    th, tw = AMPLIFY_TILE
    shapes = [(1, 1), (2, 5), (5, 2), (6, 7), (3, 40), (40, 6), (16, 16)]
    shapes += [(th, tw), (th + 1, tw), (th, tw + 1), (2 * th, 2 * tw), (2 * th + 1, 2 * tw + 1)]
    shapes += [(70, 2 * tw + m) for m in range(8)]
    shapes += [(97, 201), (135, 241)]
    return shapes + [tuple(s) for s in riesz_level_sizes(2160, 3840, 6)[:-1]]

_TAPS13_BF16 = np.ascontiguousarray(round_taps_bf16(TAPS13))


# ---------------------------------------------------------------- plain versions


def riesz_phase_df2_fused_plain(cur_lp, cur_r, cur_i, old_lp, old_r, old_i,
                                lo_state: Sequence[torch.Tensor],
                                hi_state: Sequence[torch.Tensor],
                                b_lo, a_lo, b_hi, a_hi, rebuild: bool):
    """Rebuild selection, phase front (polynomial arccos), lo and hi DF-II,
    wc/ws = (hi - lo) * amplitude. Returns (amplitude, wc, ws, lo', hi'), each
    filter state as 6 planes (phase_c, phase_s, r0_c, r0_s, r1_c, r1_s)."""
    cur = RieszLevel(cur_lp, CompExp(cur_r, cur_i))
    if rebuild:  # a selection, not a blend: inf state must not become NaN
        old = cur
        lo_state = hi_state = [torch.zeros_like(cur_lp)] * 6
    else:
        old = RieszLevel(old_lp, CompExp(old_r, old_i))
    pr = phase_difference_and_amplitude(cur, old, compute_blur=False,
                                        arccos=polynomial_arccos)

    def filt(st, b, a):
        res, phase, r0, r1 = riesz_df2_step(CompExp(st[0], st[1]), CompExp(st[2], st[3]),
                                            CompExp(st[4], st[5]), pr.phase_diff, b, a)
        return res, (phase.cos, phase.sin, r0.cos, r0.sin, r1.cos, r1.sin)

    lo_res, lo2 = filt(lo_state, _c3(b_lo), _c3(a_lo))
    hi_res, hi2 = filt(hi_state, _c3(b_hi), _c3(a_hi))
    change = hi_res - lo_res
    return (pr.amplitude, change.cos * pr.amplitude, change.sin * pr.amplitude, lo2, hi2)


def _blur_bf16(x: torch.Tensor) -> torch.Tensor:
    """The 13x13 blur on bf16 operands, vertical pass first, each pass summed
    in f32: the bf16 arm of riesz_amplify_mxu."""
    vertical = correlate_cols(round_bf16(x), _TAPS13_BF16)
    return correlate_rows(round_bf16(vertical), _TAPS13_BF16)


def riesz_amplify_plain(amplitude, change_c, change_s, lowpass, riesz_r, riesz_i,
                        alpha, threshold, preweighted: bool = False,
                        bf16: bool = False) -> torch.Tensor:
    """normalize_phase + amplify_level: n = g13(change * amplitude) / g13(amplitude)
    (g13(change) / g13(amplitude) when ``preweighted``), then the rotation.
    Planes of any float dtype are computed in f32; ``bf16`` blurs on bf16
    operands (``_blur_bf16``)."""
    amplitude, change_c, change_s, lowpass, riesz_r, riesz_i = (
        x.float() for x in (amplitude, change_c, change_s, lowpass, riesz_r, riesz_i))
    wc, ws = ((change_c, change_s) if preweighted
              else (change_c * amplitude, change_s * amplitude))
    blur = _blur_bf16 if bf16 else blur13_plain
    ab = blur(amplitude)
    normalized = CompExp(blur(wc) / ab, blur(ws) / ab)
    return amplify_level(RieszLevel(lowpass, CompExp(riesz_r, riesz_i)), normalized,
                         _f32(alpha), _f32(threshold))


def riesz_level_mxu_plain(cur_lp, cur_r, cur_i, old_lp, old_r, old_i, acc,
                          lo_regs, hi_regs, b_lo, a_lo, b_hi, a_hi, rebuild,
                          alpha, threshold):
    """The K8 plain version on the shared accumulator, then the preweighted
    amplify plain version. Returns (amplified, acc', lo', hi')."""
    amp, wc, ws, lo6, hi6 = riesz_phase_df2_fused_plain(
        cur_lp, cur_r, cur_i, old_lp, old_r, old_i, (*acc, *lo_regs), (*acc, *hi_regs),
        b_lo, a_lo, b_hi, a_hi, rebuild)
    out = riesz_amplify_plain(amp, wc, ws, cur_lp, cur_r, cur_i, alpha, threshold,
                              preweighted=True)
    return out, tuple(lo6[:2]), tuple(lo6[2:]), tuple(hi6[2:])


# ---------------------------------------------------------------- launching


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("tail")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "lvmt_phase_df2": [p, ctypes.c_longlong, p, i, p],
        "lvmt_amplify13": [p, i, i, f, f, i, i, i, i, p, p],
        "lvmt_level_tail": [p, i, i, p, i, f, f, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_planes(what: str, planes: Sequence[torch.Tensor],
                  dtypes=(torch.float32,)) -> torch.device:
    """Every plane of a dtype in ``dtypes``, [H, W], contiguous, of one shape
    on one device."""
    first = planes[0]
    for x in planes:
        if not isinstance(x, torch.Tensor) or x.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{what}: expected {names} tensors, got "
                            f"{getattr(x, 'dtype', type(x))}")
        if x.ndim != 2:
            raise ValueError(f"{what}: expected [H, W] planes, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
        if x.shape != first.shape:
            raise ValueError(f"{what}: planes of shapes {tuple(first.shape)} and "
                             f"{tuple(x.shape)}")
        if x.device != first.device:
            raise ValueError(f"{what}: planes on {first.device} and {x.device}")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {first.device}")
    if first.numel() == 0:
        raise ValueError(f"{what}: empty planes")
    return first.device


def _f32(v) -> float:
    return float(np.float32(v))


def _c3(v) -> Tuple[float, float, float]:
    """Three filter coefficients as host floats rounded to f32."""
    c = np.asarray(v, dtype=np.float32).reshape(-1)
    if c.size != 3:
        raise ValueError(f"expected 3 filter coefficients, got {c.size}")
    return tuple(float(x) for x in c)


def _coeff_array(b_lo, a_lo, b_hi, a_hi) -> np.ndarray:
    """b_lo[0..2], a_lo[1..2], b_hi[0..2], a_hi[1..2] as the kernels take them."""
    return np.ascontiguousarray(np.asarray(
        [*_c3(b_lo), *_c3(a_lo)[1:], *_c3(b_hi), *_c3(a_hi)[1:]], np.float32))


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(entry: str, symbol: str, device: torch.device, *args, bf16: bool = False) -> None:
    launch(getattr(_lib(), symbol), entry, device, *args)
    (LAUNCHES_BF16 if bf16 else LAUNCHES)[entry] += 1


def riesz_phase_df2_fused(cur_lp, cur_r, cur_i, old_lp, old_r, old_i,
                          lo_state, hi_state, b_lo, a_lo, b_hi, a_hi, rebuild):
    """Returns (amplitude, wc, ws, lo_state', hi_state') for one level; each
    state is 6 planes (phase_c, phase_s, r0_c, r0_s, r1_c, r1_s). wc/ws are
    (hi - lo) * amplitude, the inputs of the preweighted amplify."""
    ins = (cur_lp, cur_r, cur_i, old_lp, old_r, old_i, *lo_state, *hi_state)
    if len(ins) != 18:
        raise ValueError("riesz_phase_df2_fused: each filter state is 6 planes")
    dev = _check_planes("riesz_phase_df2_fused", ins)
    rebuild = bool(rebuild)
    if dev.type == "cpu":
        return riesz_phase_df2_fused_plain(*ins[:6], ins[6:12], ins[12:], b_lo, a_lo,
                                           b_hi, a_hi, rebuild)
    outs = [torch.empty_like(cur_lp) for _ in range(15)]
    coeff = _coeff_array(b_lo, a_lo, b_hi, a_hi)
    _launch("riesz_phase_df2_fused", "lvmt_phase_df2", dev, _pointers([*ins, *outs]),
            cur_lp.numel(), coeff.ctypes.data, int(rebuild))
    return outs[0], outs[1], outs[2], tuple(outs[3:9]), tuple(outs[9:15])


def _amplify(entry: str, amplitude, change_c, change_s, lowpass, riesz_r, riesz_i,
             alpha, threshold, preweighted: bool, bf16: bool = False,
             dtypes=(torch.float32,)) -> torch.Tensor:
    ins = (amplitude, change_c, change_s, lowpass, riesz_r, riesz_i)
    dev = _check_planes(entry, ins, dtypes)
    for group, names in ((ins[:3], "amplitude, change_c and change_s"),
                         (ins[3:], "lowpass, riesz_r and riesz_i")):
        if len({x.dtype for x in group}) > 1:
            raise TypeError(f"{entry}: {names} must be all float32 or all bfloat16, "
                            f"got {[x.dtype for x in group]}")
    bf16 = bool(bf16)
    if dev.type == "cpu":
        return riesz_amplify_plain(*ins, alpha, threshold, preweighted=preweighted, bf16=bf16)
    out = torch.empty(lowpass.shape, dtype=torch.float32, device=dev)
    h, w = lowpass.shape
    taps = _TAPS13_BF16 if bf16 else TAPS13
    _launch(entry, "lvmt_amplify13", dev, _pointers([*ins, out]), h, w,
            _f32(alpha), _f32(threshold), int(bool(preweighted)),
            int(amplitude.dtype == torch.bfloat16), int(lowpass.dtype == torch.bfloat16),
            int(bf16), taps.ctypes.data, bf16=bf16)
    return out


def riesz_amplify_fused(amplitude, change_c, change_s, lowpass, riesz_r, riesz_i,
                        alpha, threshold, preweighted: bool = False) -> torch.Tensor:
    """Normalize + amplify of one level: normalize_phase + amplify_level.
    ``preweighted``: change_c/s already carry the amplitude factor (the
    outputs wc/ws of riesz_phase_df2_fused)."""
    return _amplify("riesz_amplify_fused", amplitude, change_c, change_s, lowpass,
                    riesz_r, riesz_i, alpha, threshold, preweighted)


def riesz_amplify_mxu(amplitude, change_c, change_s, lowpass, riesz_r, riesz_i,
                      alpha, threshold, preweighted: bool = False,
                      bf16: bool = False) -> torch.Tensor:
    """The same function as riesz_amplify_fused, the entry point of the
    reference package's LVMT_TAIL=mxu tail, with its fast arms: float32 or
    bfloat16 planes (one dtype for amplitude and change, one for lowpass and
    the Riesz pair) and, with ``bf16``, bf16 blur operands. Returns f32."""
    return _amplify("riesz_amplify_mxu", amplitude, change_c, change_s, lowpass,
                    riesz_r, riesz_i, alpha, threshold, preweighted, bf16,
                    (torch.float32, torch.bfloat16))


def riesz_level_mxu(cur_lp, cur_r, cur_i, old_lp, old_r, old_i, acc, lo_regs, hi_regs,
                    b_lo, a_lo, b_hi, a_hi, rebuild, alpha, threshold):
    """The whole per-level tail: phase front, shared-accumulator DF-II,
    normalize and amplify. acc is (acc_c, acc_s), lo_regs and hi_regs are
    (r0_c, r0_s, r1_c, r1_s). Returns (amplified, acc', lo', hi') in the
    same layouts."""
    ins = (cur_lp, cur_r, cur_i, old_lp, old_r, old_i, *acc, *lo_regs, *hi_regs)
    if len(ins) != 16:
        raise ValueError("riesz_level_mxu: acc is 2 planes, each filter's registers 4")
    dev = _check_planes("riesz_level_mxu", ins)
    rebuild = bool(rebuild)
    if dev.type == "cpu":
        return riesz_level_mxu_plain(*ins[:6], ins[6:8], ins[8:12], ins[12:], b_lo, a_lo,
                                     b_hi, a_hi, rebuild, alpha, threshold)
    outs = [torch.empty_like(cur_lp) for _ in range(11)]
    h, w = cur_lp.shape
    coeff = _coeff_array(b_lo, a_lo, b_hi, a_hi)
    _launch("riesz_level_mxu", "lvmt_level_tail", dev, _pointers([*ins, *outs]), h, w,
            coeff.ctypes.data, int(rebuild), _f32(alpha), _f32(threshold),
            TAPS13.ctypes.data)
    return outs[0], tuple(outs[1:3]), tuple(outs[3:7]), tuple(outs[7:11])
