"""The port's row-sharded steps (parallel/row_sharded.py, behind
parallel/sharding.py::build_sharded_step) on the CPU: motion, colour, and
phase at widths that do not lane-shard.

Against the reference package's build_sharded_step on its 8-device virtual
CPU mesh (tests/conftest.py), at the shapes, meshes and seeds of
tests/test_sharding.py: one u8 LSB, the reference's own bar for its sharded
step. Against the port's unsharded step on meshes of ``["cpu"] * n`` at
shapes that really row-shard: bit-equal frames in every mode (row halos
are copies, every stencil reads the same taps in the same order on a strip,
and the min and max are exact), and bit-equal state where torch's CPU
kernels compute every element of a strip with the code they use for the
whole frame.

That condition is the CPU's, not the step's: torch's CPU ``pow`` (the Lab
conversion) and ``acos`` compute the elements past a tensor's last full
vector with scalar code that can differ by an ulp from the vector code, and
a strip's last vector is not the whole plane's. On such shapes (the
``exact_state=False`` cases below, 66 rows x 202 columns a strip) the state
is held to f32 rounding, and the frames still to the bit; on the card every
element takes the same code, and tests/test_torch_cuda.py holds the state
to the bit there. The bit-exact comparisons run on one torch thread, so the
partial vectors do not move with the thread split.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from live_video_magnification_tpu.models import color as jcolor
from live_video_magnification_tpu.models import motion as jmotion
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.models.params import MagnificationMode as JMode
from live_video_magnification_tpu.models.params import motion_hz_to_blend
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu.parallel import mesh as jmesh
from live_video_magnification_tpu.parallel import sharding as jsharding
from live_video_magnification_tpu_torch.convert import (
    color_dyn_from_jax,
    motion_dyn_from_jax,
    riesz_dyn_from_jax,
    sharded_color_state_from_jax,
    sharded_color_state_to_jax,
    sharded_motion_state_from_jax,
    sharded_motion_state_to_jax,
    sharded_riesz_state_from_jax,
    sharded_riesz_state_to_jax,
    state_to_numpy,
    tree_unflatten,
)
from live_video_magnification_tpu_torch.models import color as tcolor
from live_video_magnification_tpu_torch.models import motion as tmotion
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.params import MagnificationMode as M
from live_video_magnification_tpu_torch.ops.hopper import halo as khalo
from live_video_magnification_tpu_torch.ops.hopper import stencils
from live_video_magnification_tpu_torch.parallel import halo as thalo
from live_video_magnification_tpu_torch.parallel import row_sharded as rs
from live_video_magnification_tpu_torch.parallel import shard_batched_state, sharded_plan
from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
from live_video_magnification_tpu_torch.parallel.sharding import build_sharded_step

from oracle import synthetic_clip

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)

FPS = 30.0
TO_JAX = {M.PHASE: sharded_riesz_state_to_jax, M.LAPLACE: sharded_motion_state_to_jax,
          M.COLOR: sharded_color_state_to_jax}
FROM_JAX = {M.PHASE: sharded_riesz_state_from_jax, M.LAPLACE: sharded_motion_state_from_jax,
            M.COLOR: sharded_color_state_from_jax}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames(batch, t, h, w, channels=3):
    clips = []
    for b in range(batch):
        clip = synthetic_clip(t, h, w, color=True, seed=100 + b)
        clips.append(np.stack([np.moveaxis(f, -1, 0)[:channels] for f in clip]))
    return np.ascontiguousarray(np.stack(clips))  # [B, T, C, H, W]


def _cpu_mesh(shape):
    return make_mesh(shape, ("batch", "tile"), devices=["cpu"] * int(np.prod(shape)))


def _jax_dyn(mode):
    if mode is M.PHASE:
        b_lo, a_lo = butterworth_bandpass_coeffs(0.5, FPS)
        b_hi, a_hi = butterworth_bandpass_coeffs(3.0, FPS)
        return jriesz.RieszDynParams(
            jnp.float32(30.0), jnp.float32(0.5 * math.pi),
            jnp.asarray(b_lo, jnp.float32), jnp.asarray(a_lo, jnp.float32),
            jnp.asarray(b_hi, jnp.float32), jnp.asarray(a_hi, jnp.float32),
            jnp.asarray(False), jnp.asarray(False))
    if mode is M.LAPLACE:
        return jmotion.MotionDynParams(
            jnp.float32(15.0), jnp.float32(300.0), jnp.float32(motion_hz_to_blend(1.0, FPS)),
            jnp.float32(motion_hz_to_blend(3.0, FPS)), jnp.float32(0.5))
    return jcolor.ColorDynParams(jnp.float32(80.0), jnp.float32(0.8), jnp.float32(1.5))


def _port_dyn(mode):
    conv = {M.PHASE: riesz_dyn_from_jax, M.LAPLACE: motion_dyn_from_jax,
            M.COLOR: color_dyn_from_jax}[mode]
    return conv(_jax_dyn(mode))


def _max_lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def _unsharded_step(mode, h, w, levels, channels, framerate):
    """(init, step) of the port's unsharded step of ``mode`` on the CPU."""
    if mode is M.PHASE:
        return (lambda: triesz.init_state(h, w, levels, device="cpu"),
                lambda s, f, d: triesz.step(s, f, d, levels=levels))
    if mode is M.LAPLACE:
        return (lambda: tmotion.init_state(h, w, channels, levels, device="cpu"),
                lambda s, f, d: tmotion.step(s, f, d, levels=levels))
    return (lambda: tcolor.init_state(h, w, channels, levels, framerate, device="cpu"),
            lambda s, f, d: tcolor.step(s, f, d, levels=levels, framerate=framerate))


# ---------------------------------------------------------------- the row halo


@pytest.mark.parametrize("dim", [0, -2])
@pytest.mark.parametrize("bottom_mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_row_halo_equals_the_unsharded_pads(n, bottom_mode, dim):
    """Interior halos are the neighbours' rows; the global top pads
    reflect-101 and the bottom reflect-101 or symmetric, as np.pad does the
    whole array."""
    x = np.random.default_rng(n).random((8 * n, 5, 7)).astype(np.float32)
    if dim == -2:
        x = np.ascontiguousarray(np.moveaxis(x, 0, 1))
    halo = 3
    got = thalo.halo_exchange_rows(list(torch.from_numpy(x).chunk(n, dim=dim)), halo,
                                   bottom_mode=bottom_mode, dim=dim)
    axis = dim % x.ndim
    pad = [(0, 0)] * x.ndim
    pad[axis] = (halo, halo)
    want = np.pad(x, pad, mode="reflect")
    if bottom_mode == "symmetric":
        tail = [slice(None)] * x.ndim
        tail[axis] = slice(-halo, None)
        want[tuple(tail)] = np.pad(x, pad, mode="symmetric")[tuple(tail)]
    for k, g in enumerate(got):
        assert g.shape[axis] == 8 + 2 * halo
        np.testing.assert_array_equal(g.numpy(), np.take(want, range(8 * k, 8 * k + 8 + 2 * halo),
                                                         axis=axis))


def test_row_halo_rejects_what_it_cannot_pad():
    x = torch.zeros((4, 6))
    with pytest.raises(ValueError, match="bottom_mode"):
        thalo.halo_exchange_rows([x, x], 2, bottom_mode="wrap")
    with pytest.raises(ValueError, match="local rows"):
        thalo.halo_exchange_rows([x, x], 4)


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("h,w,levels,n,want", [
    (256, 202, 5, 4, (True, True, True, False, False)),   # 64, 32, 16 rows; 8 < 14
    (256, 202, 3, 4, (True, True, True)),                 # the last level needs 6
    (264, 202, 4, 4, (True, False, False, False)),        # 33 rows: odd, not last
    (250, 202, 3, 2, (False, False, False)),              # 125 rows: odd
    (257, 202, 3, 2, (False, False, False)),              # does not divide
    (64, 64, 3, 8, (False, False, False)),                # 8 rows < 14: no sharded level
    (768, 1366, 6, 4, (True, True, True, True, False, False)),
    (256, 202, 3, 1, (False, False, False)),              # a mesh of 1 shards nothing
])
def test_row_plan_cases(h, w, levels, n, want):
    plan = rs.make_row_plan(h, w, levels, n)
    assert plan.sharded == want and plan.n == n and plan.levels == levels
    assert plan.sizes[0] == (h, w) and len(plan.sizes) == levels
    assert (plan.axis, plan.gather_to_first) == (-2, True)


def test_mode_row_plans_take_each_modes_levels_and_reaches():
    # motion and colour: the frame and `levels` pyrDowns, strips of >= 6 rows
    # (>= 4 at the last level)
    assert rs.mode_row_plan(M.LAPLACE, 64, 64, 3, 4).sharded == (True, True, False, False)
    assert rs.mode_row_plan(M.COLOR, 64, 64, 2, 4).sharded == (True, True, True)
    assert rs.mode_row_plan(M.COLOR, 264, 202, 1, 4).sharded == (True, True)  # 33-row strips
    assert rs.mode_row_plan(M.PHASE, 64, 64, 3, 4).sharded == (True, False, False)
    with pytest.raises(ValueError, match="no sharded step"):
        rs.mode_row_plan(M.NONE, 64, 64, 3, 4)


def test_dispatch_takes_the_lane_step_where_it_applies():
    mesh = _cpu_mesh((1, 4))
    assert sharded_plan(mesh, M.PHASE, 48, 128, 2).axis == -1
    assert sharded_plan(mesh, M.PHASE, 48, 130, 2).axis == -2
    assert sharded_plan(mesh, M.LAPLACE, 48, 128, 2).axis == -2
    _, state = build_sharded_step(mesh, M.PHASE, 1, 48, 128, 2)
    assert state[0][1].old[0].lowpass.shape == (48, 32)
    _, state = build_sharded_step(mesh, M.PHASE, 1, 64, 130, 2)
    assert state[0][1].old[0].lowpass.shape == (16, 130)
    with pytest.raises(ValueError, match="no sharded step"):
        build_sharded_step(mesh, M.NONE, 1, 64, 128, 2)


# ---------------------------------------------------------------- against JAX


def _jax_step(mode, mesh_shape, batch, h, w, levels, channels=3):
    return jsharding.build_sharded_step(jmesh.make_mesh(mesh_shape, ("batch", "tile")),
                                        JMode[mode.name], batch, h, w, levels, FPS, channels)


@pytest.mark.parametrize("mode,mesh_shape,t,levels", [
    (M.PHASE, (2, 4), 4, 3),
    (M.PHASE, (1, 8), 4, 3),
    (M.COLOR, (2, 4), 5, 2),
    (M.LAPLACE, (2, 4), 4, 3),
], ids=["phase-2x4-lane", "phase-1x8-fallback", "color-2x4", "motion-2x4"])
def test_sharded_step_matches_reference_sharded_step(mode, mesh_shape, t, levels, monkeypatch):
    """tests/test_sharding.py's three tests on the port: 64x64, both sharded
    steps over every frame. Phase (2,4) lane-shards in both packages; (1,8)
    takes the reference's GSPMD fallback and the port's row step (8-row
    strips are under the blur's reach: no sharded level)."""
    monkeypatch.delenv("LVMT_TAIL", raising=False)
    batch, h, w = 2, 64, 64
    frames = _frames(batch, t, h, w)
    jstep, jstate = _jax_step(mode, mesh_shape, batch, h, w, levels)
    tstep, tstate = build_sharded_step(_cpu_mesh(mesh_shape), mode, batch, h, w, levels, FPS)
    jdyn, tdyn = _jax_dyn(mode), _port_dyn(mode)
    for ti in range(t):
        jstate, jout = jstep(jstate, jnp.asarray(frames[:, ti]), jdyn)
        tstate, tout = tstep(tstate, torch.from_numpy(frames[:, ti]), tdyn)
        assert tout.shape == frames[:, ti].shape and tout.dtype == torch.uint8
        assert _max_lsb(tout.numpy(), jout) <= 1, f"frame {ti}"


@pytest.mark.parametrize("mode,mesh_shape,h,w,levels", [
    (M.PHASE, (2, 4), 64, 202, 3),
    (M.LAPLACE, (2, 4), 64, 64, 3),
    (M.COLOR, (2, 4), 64, 64, 2),
], ids=["phase", "motion", "color"])
def test_jax_sharded_state_carried_into_the_port_and_back(mode, mesh_shape, h, w, levels):
    """Two frames in the reference's sharded step, its batched state carried
    into the port's row-sharded step (which round-trips its leaves exactly),
    then both step on: frames within one LSB, and the state back in the
    reference's layout close to the reference's."""
    batch = mesh_shape[0]
    t = 6 if mode is M.COLOR else 4
    frames = _frames(batch, t, h, w)
    jstep, jstate = _jax_step(mode, mesh_shape, batch, h, w, levels)
    jdyn, tdyn = _jax_dyn(mode), _port_dyn(mode)
    for ti in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(frames[:, ti]), jdyn)
    leaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    mesh = _cpu_mesh(mesh_shape)
    plan = sharded_plan(mesh, mode, h, w, levels)
    assert plan.axis == -2 and plan.sharded[0]
    tstate = FROM_JAX[mode](leaves, mesh, plan)
    assert len(tstate) == batch and len(tstate[0]) == mesh_shape[1] and tstate[0][0].count == 2
    for a, b in zip(TO_JAX[mode](tstate, plan), leaves):
        np.testing.assert_array_equal(a, b)
    tstep, _ = build_sharded_step(mesh, mode, batch, h, w, levels, FPS)
    for ti in range(2, t):
        jstate, jout = jstep(jstate, jnp.asarray(frames[:, ti]), jdyn)
        tstate, tout = tstep(tstate, torch.from_numpy(frames[:, ti]), tdyn)
        assert _max_lsb(tout.numpy(), jout) <= 1, f"frame {ti}"
    assert not np.array_equal(tout.numpy(), frames[:, -1])
    got = TO_JAX[mode](tstate, plan)
    want = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        # phase: at a singularity an ulp turns the orientation by O(1)
        off = ~np.isclose(a, b, atol=2e-3, rtol=1e-4, equal_nan=True)
        assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} state values differ"


# ---------------------------------------------------------------- against the port


ROW_CASES = [
    # mode, mesh, (h, w), levels, channels, frames, fps, exact_state
    (M.PHASE, (1, 4), (256, 202), 5, 3, 3, FPS, True),
    (M.PHASE, (2, 4), (256, 202), 3, 3, 3, FPS, True),
    (M.PHASE, (1, 4), (264, 202), 4, 3, 3, FPS, False),
    (M.PHASE, (1, 2), (257, 202), 3, 3, 2, FPS, True),
    (M.LAPLACE, (1, 4), (256, 202), 3, 3, 3, FPS, True),
    (M.LAPLACE, (2, 4), (256, 202), 4, 3, 3, FPS, True),
    (M.LAPLACE, (1, 4), (256, 202), 3, 1, 3, FPS, True),
    (M.LAPLACE, (1, 4), (264, 202), 1, 3, 3, FPS, False),
    (M.LAPLACE, (1, 2), (257, 202), 3, 3, 2, FPS, True),
    (M.COLOR, (1, 4), (256, 200), 3, 3, 20, 8.0, True),
    (M.COLOR, (2, 4), (200, 202), 2, 3, 6, 8.0, True),
    (M.COLOR, (1, 4), (264, 202), 1, 3, 18, 8.0, True),
    (M.COLOR, (1, 4), (256, 202), 3, 1, 18, 8.0, True),
]


@pytest.mark.parametrize("mode,mesh_shape,hw,levels,channels,t,fps,exact_state", ROW_CASES,
                         ids=lambda v: v.name.lower() if isinstance(v, M) else None)
def test_row_sharded_step_equals_unsharded_step(mode, mesh_shape, hw, levels, channels, t, fps,
                                                exact_state, one_thread):
    """256x202 does not lane-shard 4-way and row-shards at every level
    (phase levels 5: the last two gathered); 264x202 gathers after level 0,
    with odd levels below (phase), or shards a 33-row last level (motion,
    colour); 257 rows split nowhere: the unsharded step on one device.
    Colour runs at 8 fps, where the cutoffs give a non-empty band within
    a few frames (at 30 fps the window of a short clip filters to a
    constant): 18-20 frames fill its 16-frame window and roll it, after the
    warm-up passthrough; 200x202 gathers its window. Frames bit-equal;
    state bit-equal, or within f32 rounding where torch's CPU kernels take
    other code for a strip's last vector (the module docstring)."""
    h, w = hw
    batch = mesh_shape[0]
    frames = _frames(batch, t, h, w, channels)
    dyn = _port_dyn(mode)
    mesh = _cpu_mesh(mesh_shape)
    step, state = build_sharded_step(mesh, mode, batch, h, w, levels, fps, channels)
    init, ref_step = _unsharded_step(mode, h, w, levels, channels, fps)
    refs = [init() for _ in range(batch)]
    for ti in range(t):
        state, out = step(state, torch.from_numpy(frames[:, ti]), dyn)
        for b in range(batch):
            refs[b], want = ref_step(refs[b], torch.from_numpy(frames[b, ti]), dyn)
            assert torch.equal(out[b], want), f"frame {ti}, stream {b}: {_max_lsb(out[b], want)} LSB"
    if mode is M.COLOR:
        assert state[0][0].count == min(t, tcolor.window_size(fps))
    plan = sharded_plan(mesh, mode, h, w, levels)
    got = TO_JAX[mode](state, plan)
    for b in range(batch):
        for a, want in zip(got, state_to_numpy(refs[b])):
            if exact_state:
                np.testing.assert_array_equal(a[b], want)
            else:
                np.testing.assert_allclose(a[b], want, rtol=1e-5, atol=1e-4)


def test_phase_fallback_launches_the_planned_stencils(monkeypatch):
    """Every stencil entry point the row-sharded phase step calls, counted a
    frame against row_stencil_launches(plan) (on the card each call is one
    launch), the plain tail's blur13 included; the row halos never reach K10."""
    from live_video_magnification_tpu_torch.ops import riesz as triesz_ops

    h, w, levels, n = 256, 202, 5, 4
    calls = {k: 0 for k in ("conv9", "band5", "lp9_decimate", "lp9_inject", "riesz_build_level",
                            "blur13")}
    for name in calls:
        # amplitude_blur calls blur13 by the name ops/riesz.py imports
        module = triesz_ops if name == "blur13" else stencils
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)
    k10 = dict(khalo.LAUNCHES)
    monkeypatch.setattr(khalo, "halo_exchange_cols_rdma",
                        lambda *a, **k: pytest.fail("K10 called on the row path"))
    frames = _frames(2, 2, h, w)
    step, state = build_sharded_step(_cpu_mesh((2, 4)), M.PHASE, 2, h, w, levels)
    plan = rs.make_row_plan(h, w, levels, n)
    want = rs.row_stencil_launches(plan)
    # levels 256x202, 128x101 sharded (K1-K3), 64x51 sharded and 32x26
    # gathered (K5), 16x13 the gathered residual (plain band pair); three
    # blurs a band level and shard, once on the gathered one
    assert want == {"conv9": 2 * 4 + 3 * 4 + 1, "band5": 2 * 4, "lp9_decimate": 2 * 4,
                    "lp9_inject": 2 * 4 + 2, "riesz_build_level": 4 + 1,
                    "blur13": 3 * (3 * 4 + 1)}
    for ti in range(2):
        before = dict(calls)
        state, _ = step(state, torch.from_numpy(frames[:, ti]), _port_dyn(M.PHASE))
        assert {k: calls[k] - before[k] for k in calls} == {k: 2 * v for k, v in want.items()}
    assert khalo.LAUNCHES == k10
    # a gathered level of 16-95 px builds with K5 once, as the unsharded step
    assert rs.row_stencil_launches(rs.make_row_plan(768, 1366, 6, 4)) == {
        "conv9": 4 * 4 + 4 * 4 + 1, "band5": 4 * 4, "lp9_decimate": 4 * 4,
        "lp9_inject": 3 * 4 + 2, "riesz_build_level": 1, "blur13": 3 * (4 * 4 + 1)}


@pytest.mark.parametrize("mode", [M.PHASE, M.LAPLACE, M.COLOR])
def test_shard_batched_state_places_a_batched_state(mode):
    """The unsharded zero state, batched, placed by the plan equals the
    step's own initial state; the count becomes a host int per shard."""
    h, w, levels, batch = 64, 202, 2, 2
    mesh = _cpu_mesh((2, 4))
    plan = sharded_plan(mesh, mode, h, w, levels)
    _, state0 = build_sharded_step(mesh, mode, batch, h, w, levels, FPS)
    init, _ = _unsharded_step(mode, h, w, levels, 3, FPS)
    one = state_to_numpy(init())
    leaves = [np.stack([x] * batch) if x.ndim else np.zeros(batch, np.int32) for x in one]
    batched = tree_unflatten(rs.state_layout(mode, plan), leaves)
    placed = shard_batched_state(batched, mesh, plan)
    assert len(placed) == batch and all(len(row) == 4 for row in placed)
    for row_p, row_0 in zip(placed, state0):
        for sp, s0 in zip(row_p, row_0):
            for a, b in zip(state_to_numpy(sp), state_to_numpy(s0)):
                assert a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert isinstance(placed[0][3].count, int)
    with pytest.raises(TypeError, match="not a mode state"):
        shard_batched_state((np.zeros(2),), mesh, plan)
