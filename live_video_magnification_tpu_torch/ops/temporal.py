"""Temporal filters of the three modes.

The counterpart of the reference package's ``ops/temporal.py``
(TemporalFilter.cpp):

  * iir_filter: the two-EMA bandpass of motion mode (:9-22);
  * ideal_bandpass_*: the row-wise DFT bandpass of colour mode (:24-80) with
    OpenCV's CCS packed-spectrum quirk (an in-band bin is scaled by 1 + 1i).
    The operator is linear and diagonal in the Fourier basis, hence
    circulant: its first column for the active window length L is built in
    f32 on the device and applied as one [W, W] @ [W, N] matmul over the
    time axis, in IEEE f32 (``device.pin_ieee_f32``);
  * minmax_normalize: cv::normalize NORM_MINMAX with OpenCV's constant guard;
  * optimal_buffer_size: the pow2(max(2*fps, 16)) rolling window (:82-94);
  * butterworth / butterworth_bandpass_coeffs: scipy-compatible digital
    Butterworth design, on the host in float64 (:268-297, :324-327);
  * CompExp and riesz_df2_step: the Direct-Form-II step with quaternionic
    phase accumulation (:340-351);
  * associative_scan, df2_filter_parallel and df2_dual_filter_parallel: the
    time-parallel forms (the reference's :211-412), log-depth scans over the
    time axis that combine in the reference's tree;
  * their shard forms, for a time axis split into shards: a shard scans from
    a zero state, and the state s_in that later arrives from the shards
    before it is carried in as s_t = local_t + M_t s_in, M_t the product of
    the shard's first t + 1 transitions: on the shard's last step for the
    fold of the shard totals (``df2_carry``, ``df2_dual_carry``), and on the
    outputs that read the states (``df2_filter_carry``,
    ``df2_dual_carry_outputs``, ``ema_carry``: one addmm or addcmul each).
    The transitions are constant, so M_t = A^(t+1): it is computed on the
    host in f64 and rounded once to f32, the same on every process, and
    kept on the device per shard length.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from live_video_magnification_tpu_torch.device import resolve_device

_DBL_EPSILON = 2.220446049250313e-16


# --- motion-mode IIR bandpass -------------------------------------------------------------------

def iir_filter(src: torch.Tensor, lowpass_hi: torch.Tensor, lowpass_lo: torch.Tensor,
               cutoff_lo: float, cutoff_hi: float):
    """One step of the double-EMA bandpass. Returns (bandpassed, new_hi, new_lo).

    The cutoffs are host values taken as f32, as the reference's f32
    scalars; cutoff_lo == 0 is floored to 0.01 as the reference does (exact
    compare)."""
    lo, hi = np.float32(cutoff_lo), np.float32(cutoff_hi)
    if lo == 0.0:
        lo = np.float32(0.01)
    new_hi = float(np.float32(1.0) - hi) * lowpass_hi + float(hi) * src
    new_lo = float(np.float32(1.0) - lo) * lowpass_lo + float(lo) * src
    return new_hi - new_lo, new_hi, new_lo


# --- colour-mode ideal FFT bandpass -------------------------------------------------------------

def optimal_buffer_size(fps: int) -> int:
    """Two seconds of footage rounded up to a power of two, minimum 16."""
    n = max(2 * int(fps), 16)
    return 1 << max(0, math.ceil(math.log2(n)))


def _band_edges(length: int, cutoff_lo: float, cutoff_hi: float, framerate: float):
    """(fl, fh): the packed-index band [2*lo*L/fps, 2*hi*L/fps] in f32, the
    reference's order of operations; cutoff_lo == 0 is bumped to 0.01."""
    lf = np.float32(length)
    lo, hi = np.float32(cutoff_lo), np.float32(cutoff_hi)
    if lo == 0.0:
        lo = lo + np.float32(0.01)
    fps = np.float32(framerate)
    return (np.float32(2.0) * lo * lf) / fps, (np.float32(2.0) * hi * lf) / fps


def ideal_bandpass_gains(w_static: int, length: int, cutoff_lo: float, cutoff_hi: float,
                         framerate: float, device=None):
    """Per-frequency gains (gr[k], gi[k], g_dc, g_ny) of the packed-mask bandpass.

    ``length`` (a host int) is the active window length L <= w_static. Packed
    CCS index mapping: Re_k at 2k-1, Im_k at 2k (1 <= k <= ceil(L/2)-1), DC
    real at 0, Nyquist real at L-1 for even L. Mask = 1 on packed indices in
    [fl, fh] (TemporalFilter.cpp:59-80). gr and gi are f32 tensors on
    ``device`` (CUDA by default); g_dc and g_ny are host floats."""
    dev = resolve_device(device)
    fl, fh = _band_edges(length, cutoff_lo, cutoff_hi, framerate)
    in_band = lambda x: ((x >= float(fl)) & (x <= float(fh))).to(torch.float32)
    k = torch.arange(w_static, device=dev)
    interior = (k >= 1) & (k < (length + 1) // 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gr = torch.where(interior, in_band((2 * k - 1).to(torch.float32)), zero)
    gi = torch.where(interior, in_band((2 * k).to(torch.float32)), zero)
    g_dc = float(fl <= 0.0 <= fh)
    g_ny = float(fl <= np.float32(length - 1) <= fh) if length % 2 == 0 else 0.0
    return gr, gi, g_dc, g_ny


def ideal_bandpass_circulant_col(w_static: int, length: int, cutoff_lo: float,
                                 cutoff_hi: float, framerate: float, device=None) -> torch.Tensor:
    """First column b[d] of the circulant bandpass operator for window length L.

    y[n] = sum_m b[(n - m) mod L] x[m], with the double DFT_SCALE (1/L^2) of
    the reference's dft/idft round trip folded in; b[d] = 0 for d >= L."""
    gr, gi, g_dc, g_ny = ideal_bandpass_gains(w_static, length, cutoff_lo, cutoff_hi,
                                              framerate, device)
    lf = float(length)
    d = torch.arange(w_static, dtype=torch.float32, device=gr.device)[:, None]  # displacement
    k = torch.arange(w_static, dtype=torch.float32, device=gr.device)[None, :]  # frequency
    ang = 2.0 * math.pi * k * d / lf
    # 2*Re(G_k e^{i ang}) = 2*(gr*cos - gi*sin); DC and Nyquist contribute once.
    terms = 2.0 * (gr[None, :] * torch.cos(ang) - gi[None, :] * torch.sin(ang))
    b = g_dc + torch.sum(terms, dim=1) + g_ny * torch.cos(math.pi * d[:, 0])
    b = b / (lf * lf)
    return torch.where(torch.arange(w_static, device=gr.device) < length, b, 0.0)


@lru_cache(maxsize=256)
def ideal_bandpass_operator(w_static: int, length: int, cutoff_lo: float, cutoff_hi: float,
                            framerate: float, device: torch.device) -> torch.Tensor:
    """The [W, W] circulant operator for window length L: rows and columns
    >= L are zero. It depends only on its arguments, so it is built once on
    ``device`` per key and then reused: the steady step makes no operator.
    Each build is one ``color.operator`` span of the port's recorder."""
    # imported here: importing the engine package imports the models
    from live_video_magnification_tpu_torch.engine.profiling import span

    with span("color.operator", device=device):
        b = ideal_bandpass_circulant_col(w_static, length, cutoff_lo, cutoff_hi, framerate,
                                         device)
        n = torch.arange(w_static, device=b.device)[:, None]
        m = torch.arange(w_static, device=b.device)[None, :]
        bmat = b[torch.remainder(n - m, max(length, 1))]
        return torch.where((n < length) & (m < length), bmat, 0.0)


def ideal_bandpass_apply(window: torch.Tensor, count: int, cutoff_lo: float,
                         cutoff_hi: float, framerate: float) -> torch.Tensor:
    """The ideal bandpass over the time axis of ``window`` [W, N] f32.

    Rows >= count are ignored (zero operator rows and columns). Returns the
    filtered [W, N], with the reference's 1/L^2 pre-normalization scale."""
    op = ideal_bandpass_operator(window.shape[0], int(count), float(cutoff_lo),
                                 float(cutoff_hi), float(framerate), window.device)
    return torch.matmul(op, window)


def minmax_normalize(x: torch.Tensor, valid_rows: Optional[int] = None) -> torch.Tensor:
    """cv::normalize(..., 0, 1, NORM_MINMAX) over the whole tensor (all channels).

    ``valid_rows`` (a host int) limits the min and max to rows [0, valid_rows)
    of dim 0, the active part of colour mode's window (the reference's
    ``valid_mask``). OpenCV guards the constant input: scale = (max-min >
    DBL_EPSILON) ? 1/(max-min) : 0, so a constant array maps to zeros, not
    NaN (core/src/norm.cpp normalize()). The min and max stay on the device."""
    mn, inv = minmax_bounds(x if valid_rows is None else x[:valid_rows])
    return (x - mn) * inv


def minmax_bounds(valid: torch.Tensor, dims: Optional[Tuple[int, ...]] = None):
    """(min, scale) of cv::normalize NORM_MINMAX over ``valid``: scale is
    1/(max-min), or 0 where max-min <= DBL_EPSILON. Over all of ``valid``
    (0-d results), or over ``dims`` (kept as dims of size 1: one pair per
    index of the others)."""
    if dims is None:
        mn, mx = valid.min(), valid.max()
    else:
        mn, mx = valid.amin(dim=dims, keepdim=True), valid.amax(dim=dims, keepdim=True)
    return mn, minmax_scale(mn, mx)


def minmax_scale(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """The NORM_MINMAX scale of a min and a max: 1/(max-min), or 0 where
    max-min <= DBL_EPSILON."""
    delta = mx - mn
    return torch.where(delta > _DBL_EPSILON, 1.0 / delta, 0.0)


def butterworth(order: int, wn: float) -> Tuple[np.ndarray, np.ndarray]:
    """Digital Butterworth lowpass (b, a), scipy.signal.butter-compatible.

    Analog prototype poles exp(j*(2k-1)/(2N)*pi)*j, warp w0 = 2*fs*tan(pi*Wn/fs)
    with fs=2, bilinear transform. Degenerate inputs (wn<=0, wn>=1, nan) give
    nan/inf coefficients, which callers detect as the reference's
    isnan(itsA[0]) re-init check (MagnifyCore.hpp:226)."""
    fs = 2.0
    with np.errstate(all="ignore"):
        w0 = 2.0 * fs * math.tan(math.pi * float(wn) / fs) if np.isfinite(wn) else float("nan")
        k_idx = np.arange(1, order + 1, dtype=np.float64)
        poles = np.exp(1j * (2.0 * k_idx - 1.0) / (2.0 * order) * np.pi) * 1j
        poles = poles * w0
        gain = w0**order
        fs2 = 2.0 * fs
        poles_z = (fs2 + poles) / (fs2 - poles)
        gain_z = gain * np.real(1.0 / np.prod(fs2 - poles))
        zeros_z = -np.ones(order)
        b = np.real(gain_z * np.poly(zeros_z))
        a = np.real(np.poly(poles_z))
    return b.astype(np.float64), a.astype(np.float64)


def butterworth_bandpass_coeffs(freq_hz: float, framerate: float) -> Tuple[np.ndarray, np.ndarray]:
    """Order-2 Butterworth for one cutoff: Wn = freq / (fps/2) (TemporalFilter.cpp:324-327)."""
    wn = 0.0 if framerate == 0.0 else freq_hz / (framerate / 2.0)
    return butterworth(2, wn)


class CompExp(NamedTuple):
    """A (cos, sin) pair of planes: the reference's CompExpMat (ComplexMat.hpp:9-110)."""

    cos: torch.Tensor
    sin: torch.Tensor

    def __add__(self, o):
        return CompExp(self.cos + o.cos, self.sin + o.sin)

    def __sub__(self, o):
        return CompExp(self.cos - o.cos, self.sin - o.sin)

    def scale(self, s):
        return CompExp(self.cos * s, self.sin * s)

    def square_sum(self):
        return self.cos * self.cos + self.sin * self.sin


def riesz_df2_step(phase_acc: CompExp, reg0: CompExp, reg1: CompExp,
                   phase_diff: CompExp, b, a):
    """One DF-II step (TemporalFilter.cpp:340-351): accumulate the quaternionic
    phase difference (phase unwrapping), then filter. ``b`` and ``a`` are three
    host floats each, already rounded to f32; a[0] == 1 is assumed. Returns
    (result, new_phase_acc, new_reg0, new_reg1)."""
    phase = phase_acc + phase_diff
    result = phase.scale(b[0]) + reg0
    new_reg0 = phase.scale(b[1]) + reg1 - result.scale(a[1])
    new_reg1 = phase.scale(b[2]) - result.scale(a[2])
    return result, phase, new_reg0, new_reg1


# --- time-parallel forms ------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 0 (len(even) - len(odd) is 0 or 1)."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(combine: Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]],
                                       Sequence[torch.Tensor]],
                     elems: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of ``combine`` over dim 0 of every tensor in ``elems``,
    in O(log T) depth: element k of the result combines elements 0..k.

    The recursion of the reference's ``jax.lax.associative_scan``
    (jax/_src/lax/control_flow/loops.py, JAX 0.9.0): combine the adjacent
    pairs (elems[0:-1:2], elems[1::2]), scan those, combine the odd results
    with elems[2::2], interleave. So the port combines in the same tree and
    differs from the reference only in each element's rounding.
    ``combine(lhs, rhs)`` takes and returns sequences shaped like ``elems``,
    lhs the earlier; it must broadcast, as a [T, 1, 1] coefficient stays one
    scalar a step against [T, H, W] planes."""
    elems = list(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    rest = [e[2::2] for e in elems]
    even = combine([e[:-1] for e in odd] if n % 2 == 0 else odd, rest)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _f32s(*values) -> Tuple[np.float32, ...]:
    return tuple(np.float32(v) for v in values)


def _scalars(t: int, ndim: int, like: torch.Tensor, value: float, first=None) -> torch.Tensor:
    """A [t, 1, ...] column of ``value`` (``first`` at t = 0 where given)."""
    col = torch.full((t,) + (1,) * (ndim - 1), float(value), dtype=like.dtype,
                     device=like.device)
    if first is not None:
        col[0] = float(first)
    return col


def _shifted(v: torch.Tensor, init: Optional[torch.Tensor]) -> torch.Tensor:
    """v one step later along dim 0: ``init`` (zeros if None) at t = 0."""
    first = (torch.zeros_like(v[:1]) if init is None
             else torch.broadcast_to(init, v[:1].shape).to(v.dtype))
    return torch.cat([first, v[:-1]])


def df2_filter_parallel(xs: torch.Tensor, b, a, reg0_init=None, reg1_init=None):
    """Whole-sequence DF-II filter as an associative scan over dim 0 (the
    reference's ``ops/temporal.py::df2_filter_parallel``).

    The same outputs as iterating the DF-II filter of ``riesz_df2_step`` over
    time, without the phase accumulation: the register recurrence

        reg0[t] = (b1 - a1*b0)*x[t] - a1*reg0[t-1] + reg1[t-1]
        reg1[t] = (b2 - a2*b0)*x[t] - a2*reg0[t-1]
        y[t]    =  b0*x[t] + reg0[t-1]

    is affine in the register pair. ``b`` and ``a`` are three host values
    each (a[0] == 1), taken as f32. ``reg0_init`` / ``reg1_init``
    (broadcastable to xs[0]) continue a chunk; one of them alone makes the
    other zero. Returns (y [T, ...], reg0 [T, ...], reg1 [T, ...])."""
    if (reg0_init is None) != (reg1_init is None):
        if reg0_init is None:
            reg0_init = torch.zeros_like(xs[0])
        else:
            reg1_init = torch.zeros_like(xs[0])
    b0, b1, b2 = _f32s(*b)
    _, a1, a2 = _f32s(*a)
    c1 = float(b1 - a1 * b0) * xs
    c2 = float(b2 - a2 * b0) * xs
    warm = reg0_init is not None
    if warm:  # fold the init into the t = 0 offset: s[0] = A s_init + c[0]
        c1[0] += float(-a1) * reg0_init + reg1_init
        c2[0] += float(-a2) * reg0_init
    t, nd = xs.shape[0], xs.ndim
    # t = 0's transition is then the identity, so A is applied once a step
    m = (_scalars(t, nd, xs, -a1, 1.0 if warm else None),
         _scalars(t, nd, xs, 1.0, 0.0 if warm else None),
         _scalars(t, nd, xs, -a2, 0.0 if warm else None),
         _scalars(t, nd, xs, 0.0, 1.0 if warm else None))

    def combine(lhs, rhs):
        l11, l12, l21, l22, lv1, lv2 = lhs
        r11, r12, r21, r22, rv1, rv2 = rhs
        return (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
                r21 * l11 + r22 * l21, r21 * l12 + r22 * l22,
                r11 * lv1 + r12 * lv2 + rv1, r21 * lv1 + r22 * lv2 + rv2)

    scanned = associative_scan(combine, m + (c1, c2))
    reg0, reg1 = scanned[4], scanned[5]
    y = float(b0) * xs + _shifted(reg0, reg0_init)
    return y, reg0, reg1


def _powers(a: np.ndarray, t: int, first: int = 1) -> np.ndarray:
    """[t, n, n] f32: entry i is a^(i + first), multiplied out in f64 and
    rounded once."""
    out = np.empty((t,) + a.shape, np.float64)
    m = np.linalg.matrix_power(a, first)
    for i in range(t):
        out[i] = m
        m = a @ m
    return out.astype(np.float32)


def _key(*coeffs) -> Tuple[Tuple[float, ...], ...]:
    """Coefficient triples as hashable f32-rounded floats."""
    return tuple(tuple(float(x) for x in _f32s(*c)) for c in coeffs)


def _df2_transition(a) -> np.ndarray:
    _, a1, a2 = _f32s(*a)
    return np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)


def _dual_transition(b_lo, a_lo, b_hi, a_hi) -> np.ndarray:
    """The 5x5 transition of (acc, r0lo, r1lo, r0hi, r1hi) without input,
    its entries rounded to f32 as ``df2_dual_filter_parallel`` rounds them."""
    m = np.zeros((5, 5), np.float64)
    m[0, 0] = 1.0
    for row, b, a in ((1, b_lo, a_lo), (3, b_hi, a_hi)):
        b0, b1, b2 = _f32s(*b)
        _, a1, a2 = _f32s(*a)
        m[row, 0], m[row + 1, 0] = b1 - a1 * b0, b2 - a2 * b0
        m[row, row], m[row, row + 1], m[row + 1, row] = -a1, 1.0, -a2
    return m


@lru_cache(maxsize=64)
def _output_carry(kind: str, t: int, coeffs, device: torch.device) -> torch.Tensor:
    """[t, k, n] f32 on ``device``: row t maps the state that enters a shard
    to what it adds to the shard's outputs at step t (A^0 = I):
      df2:  y[t]   += (A^t s_in)[reg0]                      (k = 1, n = 2)
      dual: y_x[t] += bx0 acc_in + (A^t s_in)[r0x], x in lo, hi  (k = 2, n = 5)
      ema:  l[t]   += keep^(t+1) carry                      (k = 1, n = 1)
    Built once per key and reused: a steady chunk copies nothing to the
    device."""
    if kind == "df2":
        rows = _powers(_df2_transition(coeffs[1]), t, first=0)[:, :1]
    elif kind == "dual":
        b_lo, a_lo, b_hi, a_hi = coeffs
        p = _powers(_dual_transition(b_lo, a_lo, b_hi, a_hi), t, first=0)
        rows = p[:, [1, 3]].copy()
        rows[:, 0, 0] += np.float32(b_lo[0])
        rows[:, 1, 0] += np.float32(b_hi[0])
    else:
        rows = _powers(np.array([[coeffs[0]]], np.float64), t)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def _add_carry(ys, rows: torch.Tensor, carry) -> List[torch.Tensor]:
    """Each y [t, ...] plus rows[:, i] @ carry: one product-and-add (addmm)
    a y over the flattened planes."""
    t = ys[0].shape[0]
    s_in = torch.stack([torch.broadcast_to(c, ys[0].shape[1:]) for c in carry]).to(ys[0])
    flat = s_in.reshape(len(carry), -1)
    return [torch.addmm(y.reshape(t, -1), rows[:, i].contiguous(), flat).reshape(y.shape)
            for i, y in enumerate(ys)]


def df2_carry(states, carry, a, at: int):
    """The register pair (reg0, reg1) after step ``at`` of a shard scanned
    from a zero state (``df2_filter_parallel`` without inits), with the
    registers ``carry`` that entered it carried in: s = local + A^(at+1)
    carry. ``states``: that step's [...] planes. The fold of the shard
    totals takes one such step a shard (``parallel/time_shard.py``)."""
    m = _powers(_df2_transition(a), 1, at + 1)[0]
    (r0, r1), (i0, i1) = states, carry
    return (r0 + float(m[0, 0]) * i0 + float(m[0, 1]) * i1,
            r1 + float(m[1, 0]) * i0 + float(m[1, 1]) * i1)


def df2_filter_carry(y: torch.Tensor, carry, b, a) -> torch.Tensor:
    """``df2_filter_parallel``'s output y [t, ...] for a shard scanned from a
    zero state, once the registers ``carry`` (reg0, reg1) that entered it
    are known: y[t] + (A^t carry)[reg0], the reg0 read at step t."""
    rows = _output_carry("df2", y.shape[0], _key(b, a), y.device)
    return _add_carry([y], rows, carry)[0]


def df2_dual_carry(states, carry, b_lo, a_lo, b_hi, a_hi, at: int):
    """The state (acc, r0lo, r1lo, r0hi, r1hi) after step ``at`` of a shard
    scanned from a zero state (``df2_dual_filter_parallel`` without inits),
    with the state ``carry`` that entered it carried in: s = local +
    A^(at+1) carry, the accumulator row of A the identity. ``states``: that
    step's [...] planes (the shard's totals, for the fold)."""
    m = _powers(_dual_transition(b_lo, a_lo, b_hi, a_hi), 1, at + 1)[0]
    out = []
    for i, s in enumerate(states):
        for j, c in enumerate(carry):
            if m[i, j] != 0.0:  # block lower-triangular
                s = s + float(m[i, j]) * c
        out.append(s)
    return tuple(out)


def df2_dual_carry_outputs(y_lo: torch.Tensor, y_hi: torch.Tensor, carry,
                           b_lo, a_lo, b_hi, a_hi):
    """``df2_dual_filter_parallel``'s y_lo, y_hi [t, ...] for a shard scanned
    from a zero state, once the state ``carry`` (acc, r0lo, r1lo, r0hi,
    r1hi) that entered it is known: s_t = local_t + A^(t+1) carry, so
    y_x[t] = bx0 acc[t] + r0x[t-1] gains bx0 acc_in + (A^t carry)[r0x]
    (A^0 = I: at t = 0 the entering register). One addmm a component."""
    rows = _output_carry("dual", y_lo.shape[0], _key(b_lo, a_lo, b_hi, a_hi), y_lo.device)
    return tuple(_add_carry([y_lo, y_hi], rows, carry))


def ema_carry(local: torch.Tensor, carry, keep, at: Optional[int] = None):
    """An EMA l_t = keep * l_(t-1) + x_t of a shard scanned from a zero
    state, with the EMA ``carry`` that entered the shard carried in:
    l_t = keep^(t+1) carry + local_t, one addcmul. ``local`` is [t, ...], or
    one [...] row with ``at`` its index in the shard."""
    keep = float(np.float32(keep))
    if at is not None:
        return local + float(_powers(np.array([[keep]], np.float64), 1, at + 1)[0, 0, 0]) * carry
    col = _output_carry("ema", local.shape[0], (keep,), local.device)
    return torch.addcmul(local, col.reshape((-1,) + (1,) * (local.ndim - 1)), carry)


def df2_dual_filter_parallel(diff: torch.Tensor, b_lo, a_lo, b_hi, a_hi,
                             acc_init=None, lo_init=None, hi_init=None):
    """Phase accumulation and both Butterworth DF-II filters as one associative
    scan over dim 0 (the reference's ``ops/temporal.py::df2_dual_filter_parallel``).

    The lo and hi filters of ``riesz_df2_step`` read the same accumulated
    phase, so the recurrence

        acc[t]  = acc[t-1] + d[t]
        r0x[t]  = kx1*acc[t] - ax1*r0x[t-1] + r1x[t-1]     kx1 = bx1 - ax1*bx0
        r1x[t]  = kx2*acc[t] - ax2*r0x[t-1]                kx2 = bx2 - ax2*bx0
        yx[t]   = bx0*acc[t] + r0x[t-1]                    (x in {lo, hi})

    is affine in s = (acc, r0lo, r1lo, r0hi, r1hi) with a constant block
    lower-triangular transition: 12 scalar entries, carried as [T, 1, ...]
    columns, and 5 planes of offsets. The coefficients are host values taken
    as f32, and kx1, kx2 are computed in f32, as the reference computes them
    from its f32 arrays.

    diff: [T, ...]. The inits (broadcastable to diff[0]; pass all or none)
    are folded into the t = 0 offsets, with an identity transition there.
    Returns (y_lo [T, ...], y_hi, acc [T, ...], finals) with finals =
    (acc, r0lo, r1lo, r0hi, r1hi) after the last step."""
    t, nd = diff.shape[0], diff.ndim
    blo0, blo1, blo2 = _f32s(*b_lo)
    bhi0, bhi1, bhi2 = _f32s(*b_hi)
    _, alo1, alo2 = _f32s(*a_lo)
    _, ahi1, ahi2 = _f32s(*a_hi)
    kl1, kl2 = float(blo1 - alo1 * blo0), float(blo2 - alo2 * blo0)
    kh1, kh2 = float(bhi1 - ahi1 * bhi0), float(bhi2 - ahi2 * bhi0)

    warm = acc_init is not None
    c_acc = diff.clone() if warm else diff
    c_l0, c_l1 = kl1 * diff, kl2 * diff
    c_h0, c_h1 = kh1 * diff, kh2 * diff
    if warm:  # fold A @ s_init into c[0]; t = 0's transition becomes the identity
        s0 = [torch.broadcast_to(x, diff.shape[1:]).to(diff.dtype)
              for x in (acc_init, *lo_init, *hi_init)]
        c_acc[0] += s0[0]
        c_l0[0] += kl1 * s0[0] - float(alo1) * s0[1] + s0[2]
        c_l1[0] += kl2 * s0[0] - float(alo2) * s0[1]
        c_h0[0] += kh1 * s0[0] - float(ahi1) * s0[3] + s0[4]
        c_h1[0] += kh2 * s0[0] - float(ahi2) * s0[3]

    def col(value, identity):
        return _scalars(t, nd, diff, value, identity if warm else None)

    # per block (lo, hi): first-column entries x0, x1_0 acting on acc, and the
    # 2x2 block [[x11, x12], [x21, x22]] acting on (r0, r1)
    lo = (col(kl1, 0.0), col(kl2, 0.0), col(-alo1, 1.0), col(1.0, 0.0),
          col(-alo2, 0.0), col(0.0, 1.0))
    hi = (col(kh1, 0.0), col(kh2, 0.0), col(-ahi1, 1.0), col(1.0, 0.0),
          col(-ahi2, 0.0), col(0.0, 1.0))

    def combine(lhs, rhs):
        (ll0, ll10, ll11, ll12, ll21, ll22, lh0, lh10, lh11, lh12, lh21, lh22,
         lca, lcl0, lcl1, lch0, lch1) = lhs
        (rl0, rl10, rl11, rl12, rl21, rl22, rh0, rh10, rh11, rh12, rh21, rh22,
         rca, rcl0, rcl1, rch0, rch1) = rhs
        # new = R @ L, both block lower-triangular with an identity acc row
        return (rl0 + rl11 * ll0 + rl12 * ll10,
                rl10 + rl21 * ll0 + rl22 * ll10,
                rl11 * ll11 + rl12 * ll21, rl11 * ll12 + rl12 * ll22,
                rl21 * ll11 + rl22 * ll21, rl21 * ll12 + rl22 * ll22,
                rh0 + rh11 * lh0 + rh12 * lh10,
                rh10 + rh21 * lh0 + rh22 * lh10,
                rh11 * lh11 + rh12 * lh21, rh11 * lh12 + rh12 * lh22,
                rh21 * lh11 + rh22 * lh21, rh21 * lh12 + rh22 * lh22,
                lca + rca,
                rl0 * lca + rl11 * lcl0 + rl12 * lcl1 + rcl0,
                rl10 * lca + rl21 * lcl0 + rl22 * lcl1 + rcl1,
                rh0 * lca + rh11 * lch0 + rh12 * lch1 + rch0,
                rh10 * lca + rh21 * lch0 + rh22 * lch1 + rch1)

    scanned = associative_scan(combine, lo + hi + (c_acc, c_l0, c_l1, c_h0, c_h1))
    del c_acc, c_l0, c_l1, c_h0, c_h1
    acc, r0l, r1l, r0h, r1h = scanned[12:]
    y_lo = float(blo0) * acc + _shifted(r0l, lo_init[0] if warm else None)
    y_hi = float(bhi0) * acc + _shifted(r0h, hi_init[0] if warm else None)
    finals = tuple(v[-1].clone() for v in (acc, r0l, r1l, r0h, r1h))
    return y_lo, y_hi, acc, finals
