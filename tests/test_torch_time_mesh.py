"""The port's time mesh against the reference JAX package on the CPU: each
mode's ``process_clip_parallel`` with its time axis split into 8 shards of
``["cpu"] * 8`` (``parallel/time_shard.py``), against the port unsharded and
against the reference's T-sharded ``jax.jit`` call on its 8-device virtual
mesh (tests/test_time_parallel.py's T-sharded tests, at their shapes and
dynamic parameters); a carried state entering mid-clip; the first-frame
rules on global shard 0 alone; and the scans' carry-in against the unsharded
scans.

Bars: frames within 1 u8 LSB (the reference suite's bar: the fold rounds
otherwise than one scan tree); carried states as the reference suite holds
them (tests/test_torch_time_parallel.py); the scans at the DF-II bars,
atol 3e-5 / rtol 1e-4.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from live_video_magnification_tpu.models import color as jcolor
from live_video_magnification_tpu.models import motion as jmotion
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.ops import temporal as jtemporal
from live_video_magnification_tpu.parallel.mesh import make_mesh as jmake_mesh
from live_video_magnification_tpu_torch.convert import (
    color_dyn_from_jax,
    motion_dyn_from_jax,
    riesz_dyn_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.models import color as tcolor
from live_video_magnification_tpu_torch.models import motion as tmotion
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.motion import _ema_combine
from live_video_magnification_tpu_torch.ops import temporal as ttemporal
from live_video_magnification_tpu_torch.parallel.time_shard import (
    TimeShards,
    fold_carries,
)

from oracle import synthetic_clip

torch.set_num_threads(2)

FPS = 30.0
SHARDS = TimeShards(["cpu"] * 8)
DF2_BARS = dict(atol=3e-5, rtol=1e-4)


def _riesz_dyn():
    (b_lo, a_lo), (b_hi, a_hi) = (jtemporal.butterworth_bandpass_coeffs(hz, FPS)
                                  for hz in (0.5, 3.0))
    return jriesz.RieszDynParams(
        jnp.float32(30.0), jnp.float32(40.0 * math.pi / 100.0),
        *(jnp.asarray(x, jnp.float32) for x in (b_lo, a_lo, b_hi, a_hi)),
        jnp.asarray(False), jnp.asarray(False))


def _motion_dyn():
    blend = lambda hz: jparams.motion_hz_to_blend(hz, FPS)
    return jmotion.MotionDynParams(jnp.float32(18.0), jnp.float32(250.0),
                                   jnp.float32(blend(0.8)), jnp.float32(blend(3.5)),
                                   jnp.float32(0.4))


def _color_dyn():
    return jcolor.ColorDynParams(jnp.float32(60.0), jnp.float32(0.4), jnp.float32(1.2))


# mode: (reference module, port module, JAX dyn, dyn converter, keyword arguments,
#        the reference suite's T-sharded clip: frames, h, w, levels, seed)
MODES = {
    "phase": (jriesz, triesz, _riesz_dyn, riesz_dyn_from_jax, {}, (16, 32, 40, 2, 41)),
    # 4 fps: a window of 16; each of 8 shards holds 3 frames and reaches up
    # to 15 tops back over the shards before it
    "color": (jcolor, tcolor, _color_dyn, color_dyn_from_jax, dict(framerate=4.0),
              (24, 32, 40, 2, 42)),
    "motion": (jmotion, tmotion, _motion_dyn, motion_dyn_from_jax, {}, (16, 32, 40, 2, 43)),
}


@functools.lru_cache(maxsize=None)
def _clip(t, h, w, seed):
    frames = synthetic_clip(t, h, w, color=True, seed=seed)
    return np.stack([np.moveaxis(f, -1, 0) for f in frames])


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def _port(mode, frames, state=None, shards=None):
    """The port's process_clip_parallel of [T, C, H, W] u8 frames, unsharded
    or split evenly over ``shards``. Returns (state, outs [T, ...] numpy)."""
    _, tmod, jdyn, convert, kw, (_, _, _, levels, _) = MODES[mode]
    x = torch.from_numpy(frames)
    if shards is None:
        state, out = tmod.process_clip_parallel(x, convert(jdyn()), levels=levels,
                                                state=state, device="cpu", **kw)
        return state, out.numpy()
    state, outs = tmod.process_clip_parallel(list(x.chunk(shards.count)), convert(jdyn()),
                                             levels=levels, state=state, shards=shards, **kw)
    assert len(outs) == shards.count
    return state, torch.cat(outs).numpy()


def _jax_t_sharded(mode, frames):
    """The reference's T-sharded call: process_clip_parallel jitted with the
    frame axis sharded over its 8-device virtual mesh."""
    jmod, _, jdyn, _, kw, (_, _, _, levels, _) = MODES[mode]
    dyn = jdyn()
    fn = lambda f: jmod.process_clip_parallel(f, dyn, levels=levels, **kw)[1]
    sh = NamedSharding(jmake_mesh((8,), ("time",)), P("time"))
    return np.asarray(jax.jit(fn, in_shardings=sh, out_shardings=sh)(
        jax.device_put(jnp.asarray(frames), sh)))


def _assert_states_close(mode, got, ref):
    a_leaves, b_leaves = state_to_numpy(got), state_to_numpy(ref)
    assert int(a_leaves[0]) == int(b_leaves[0])
    for a, b in zip(a_leaves[1:], b_leaves[1:]):
        if mode == "phase":  # pixels on the clamped arccos's edge may flip
            bad = ~np.isclose(a, b, rtol=1e-3, atol=1e-4)
            assert bad.mean() < 0.005, f"{bad.sum()}/{bad.size} state elements differ"
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


# --- the T-sharded tests of the reference suite ---------------------------------------------------


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh")
@pytest.mark.parametrize("mode", list(MODES))
def test_time_sharded_equals_unsharded_and_reference(mode):
    t, h, w, _, seed = MODES[mode][5]
    arr = _clip(t, h, w, seed)
    state, got = _port(mode, arr, shards=SHARDS)
    ref_state, ref = _port(mode, arr)
    jax_sharded = _jax_t_sharded(mode, arr)
    assert got.shape == arr.shape and got.dtype == np.uint8
    assert _lsb(got, ref) <= 1, f"{_lsb(got, ref)} LSB against the port unsharded"
    assert _lsb(got, jax_sharded) <= 1, f"{_lsb(got, jax_sharded)} LSB against JAX's T-sharded"
    assert np.any(got[1:] != arr[1:])  # frames magnified
    _assert_states_close(mode, state, ref_state)
    assert state.count == ref_state.count == min(t, 16 if mode == "color" else t)


@pytest.mark.parametrize("mode", list(MODES))
def test_time_sharded_second_chunk_takes_the_carried_state(mode):
    """A state carried out of a first chunk enters the second mid-clip: the
    sharded continuation against the unsharded one, the first chunk run
    either way."""
    t, h, w, _, seed = MODES[mode][5]
    arr = _clip(t, h, w, seed)
    k = 8
    ref_state, ref1 = _port(mode, arr[:k])
    ref_state, ref2 = _port(mode, arr[k:], state=ref_state)
    for first_shards in (None, TimeShards(["cpu"] * 4)):
        state, out1 = _port(mode, arr[:k], shards=first_shards)
        state, out2 = _port(mode, arr[k:], state=state, shards=SHARDS)
        got = np.concatenate([out1, out2])
        ref = np.concatenate([ref1, ref2])
        assert _lsb(got, ref) <= 1, f"{_lsb(got, ref)} LSB"
        assert np.any(out2[0] != arr[k])  # no first-frame passthrough mid-clip
        _assert_states_close(mode, state, ref_state)


@pytest.mark.parametrize("mode", ["phase", "color"])
def test_first_frame_rules_hold_on_shard_zero_alone(mode):
    """The clip's first frame lies on shard 0: it passes the input through;
    the first frame of every later shard is magnified as in the unsharded
    path."""
    t, h, w, _, seed = MODES[mode][5]
    arr = _clip(t, h, w, seed)
    _, got = _port(mode, arr, shards=SHARDS)
    _, ref = _port(mode, arr)
    per = t // SHARDS.count
    np.testing.assert_array_equal(got[0], arr[0])
    for k in range(1, SHARDS.count):
        assert np.any(got[k * per] != arr[k * per]), f"shard {k}'s first frame passed through"
        assert _lsb(got[k * per], ref[k * per]) <= 1


def test_time_shards_check_their_place_in_the_group():
    with pytest.raises(ValueError, match="not in a group"):
        TimeShards(["cpu"] * 2, first=7, count=8, group=object())
    with pytest.raises(ValueError, match="process group"):
        TimeShards(["cpu"] * 2, first=2, count=8)
    assert TimeShards.single("cpu").count == 1


# --- the scans' carry-in ----------------------------------------------------------------------------


def _dual_coeffs():
    (b_lo, a_lo), (b_hi, a_hi) = (jtemporal.butterworth_bandpass_coeffs(hz, FPS)
                                  for hz in (0.5, 3.0))
    return [tuple(float(x) for x in np.asarray(c, np.float32)) for c in (b_lo, a_lo, b_hi, a_hi)]


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dual_scan_carry_in_matches_the_unsharded_scan(n):
    """df2_dual_filter_parallel over 16 steps from a carried state, against
    n shards: shard 0 scans from the carried state, the others from zero,
    and the fold carries each one's state in (s_t = local_t + A^(t+1) s_in);
    and against the reference's scan."""
    rng = np.random.default_rng(n)
    diff = _normal(rng, 16, 9, 11)
    inits = [_normal(rng, 9, 11) for _ in range(5)]
    coeffs = _dual_coeffs()
    y_lo, y_hi, acc, fin = ttemporal.df2_dual_filter_parallel(
        diff, *coeffs, acc_init=inits[0], lo_init=inits[1:3], hi_init=inits[3:])
    jref = jax.jit(jtemporal.df2_dual_filter_parallel)(
        jnp.asarray(diff.numpy()), *(jnp.asarray(c, jnp.float32) for c in coeffs),
        acc_init=jnp.asarray(inits[0].numpy()),
        lo_init=tuple(jnp.asarray(x.numpy()) for x in inits[1:3]),
        hi_init=tuple(jnp.asarray(x.numpy()) for x in inits[3:]))
    parts = list(diff.chunk(n))
    per = parts[0].shape[0]
    first = ttemporal.df2_dual_filter_parallel(parts[0], *coeffs, acc_init=inits[0],
                                               lo_init=inits[1:3], hi_init=inits[3:])
    cold = [ttemporal.df2_dual_filter_parallel(p, *coeffs) for p in parts[1:]]
    ins, last = fold_carries([list(first[3])] + [list(c[3]) for c in cold],
                             lambda f, s: ttemporal.df2_dual_carry(f, s, *coeffs, at=per - 1))
    ys = [first[:2]] + [ttemporal.df2_dual_carry_outputs(c[0], c[1], ins[k], *coeffs)
                        for k, c in enumerate(cold, start=1)]
    for i, ref in enumerate((y_lo, y_hi)):
        got = torch.cat([y[i] for y in ys])
        torch.testing.assert_close(got, ref, **DF2_BARS)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref[i]), **DF2_BARS)
    for a, b in zip(last, fin):
        torch.testing.assert_close(a, b, **DF2_BARS)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_df2_scan_carry_in_matches_the_unsharded_scan(n):
    """df2_filter_parallel's shard form: shards scanned from zero, the
    registers carried in (the fold on each shard's last step, the outputs
    by ``df2_filter_carry``), against one scan from the carried registers
    and the reference's."""
    rng = np.random.default_rng(10 + n)
    xs = _normal(rng, 16, 7, 5)
    r0, r1 = _normal(rng, 7, 5), _normal(rng, 7, 5)
    b, a = (tuple(float(v) for v in np.asarray(c, np.float32))
            for c in jtemporal.butterworth_bandpass_coeffs(3.0, FPS))
    y, reg0, reg1 = ttemporal.df2_filter_parallel(xs, b, a, r0, r1)
    jy = np.asarray(jax.jit(jtemporal.df2_filter_parallel)(
        jnp.asarray(xs.numpy()), jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32),
        jnp.asarray(r0.numpy()), jnp.asarray(r1.numpy()))[0])
    parts = list(xs.chunk(n))
    per = parts[0].shape[0]
    scans = [ttemporal.df2_filter_parallel(p, b, a) for p in parts]
    ins, last = fold_carries([[r0, r1]] + [[s[1][-1], s[2][-1]] for s in scans],
                             lambda f, s: ttemporal.df2_carry(f, s, a, at=per - 1))
    got = torch.cat([ttemporal.df2_filter_carry(sc[0], ins[k + 1], b, a)
                     for k, sc in enumerate(scans)])
    torch.testing.assert_close(got, y, **DF2_BARS)
    np.testing.assert_allclose(got.numpy(), jy, **DF2_BARS)
    torch.testing.assert_close(last[0], reg0[-1], **DF2_BARS)
    torch.testing.assert_close(last[1], reg1[-1], **DF2_BARS)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ema_scan_carry_in_matches_the_unsharded_scan(n):
    """The motion EMA l_t = keep l_(t-1) + cut x_t: shards scanned from zero
    and carried in as keep^(t+1) carry + local_t, against one scan from the
    carried EMA and against stepping the recurrence."""
    rng = np.random.default_rng(20 + n)
    cut = np.float32(0.3)
    keep = np.float32(1.0) - cut
    xs = _normal(rng, 16, 3, 6, 4)
    carry = _normal(rng, 3, 6, 4)
    a = torch.full((16, 1, 1, 1), float(keep))
    b = float(cut) * xs
    b0 = b.clone()
    b0[0] = float(keep) * carry + float(cut) * xs[0]
    a0 = a.clone()
    a0[0] = 1.0
    ref = ttemporal.associative_scan(_ema_combine, (a0, b0))[1]
    stepped, l = [], carry
    for x in xs:
        l = float(keep) * l + float(cut) * x
        stepped.append(l)
    parts = list(b.chunk(n))
    per = parts[0].shape[0]
    scans = [ttemporal.associative_scan(_ema_combine, (a[:per], p))[1] for p in parts]
    ins, (last,) = fold_carries(
        [[ttemporal.ema_carry(scans[0], carry, keep)[-1]]] + [[s[-1]] for s in scans[1:]],
        lambda f, s: (ttemporal.ema_carry(f[0], s[0], keep, at=per - 1),))
    got = torch.cat([ttemporal.ema_carry(s, ins[k][0] if k else carry, keep)
                     for k, s in enumerate(scans)])
    torch.testing.assert_close(got, ref, **DF2_BARS)
    torch.testing.assert_close(got, torch.stack(stepped), **DF2_BARS)
    torch.testing.assert_close(last, ref[-1], **DF2_BARS)
