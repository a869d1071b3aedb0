"""The port's lane-sharded phase step (parallel/) on the CPU against the
reference package's, and against the port's own unsharded step.

JAX runs on its 8-device virtual CPU mesh (tests/conftest.py); the port on
meshes of ``["cpu"] * n``, where K10 (ops/hopper/halo.py) and every other
kernel entry point run their plain versions. Frames come from
``oracle.synthetic_clip`` with the seeds of tests/test_sharding.py.

Bars: the halo exchanges are copies, so exact. Sharded frames against the
reference's sharded step: one u8 LSB (its stencils and kernels sum in other
orders than the port's), as the reference holds its sharded step against
its single-device step. The port's sharded step against its unsharded step:
bit-equal, frames and state, because every kernel reads the same taps in
the same order on a strip as on the whole level.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.parallel import halo as jhalo
from live_video_magnification_tpu.parallel import mesh as jmesh
from live_video_magnification_tpu.parallel import riesz_sharded as jrs
from live_video_magnification_tpu.ops.kernels import RIESZ_HIGHPASS_9x9
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.convert import (
    riesz_dyn_from_jax,
    sharded_riesz_state_from_jax,
    sharded_riesz_state_to_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.params import MagnificationMode
from live_video_magnification_tpu_torch.ops.conv import correlate2d
from live_video_magnification_tpu_torch.ops.hopper import _build
from live_video_magnification_tpu_torch.ops.hopper import halo as khalo
from live_video_magnification_tpu_torch.parallel import halo as thalo
from live_video_magnification_tpu_torch.parallel import riesz_sharded as trs
from live_video_magnification_tpu_torch.parallel.mesh import make_mesh
from live_video_magnification_tpu_torch.parallel.sharding import build_sharded_step

from oracle import synthetic_clip

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)

FPS = 30.0


def _frames(batch, t, h, w):
    clips = []
    for b in range(batch):
        clip = synthetic_clip(t, h, w, color=True, seed=100 + b)
        clips.append(np.stack([np.moveaxis(f, -1, 0) for f in clip]))
    return np.stack(clips)  # [B, T, C, H, W]


def _jax_dyn():
    b_lo, a_lo = butterworth_bandpass_coeffs(0.5, FPS)
    b_hi, a_hi = butterworth_bandpass_coeffs(3.0, FPS)
    return jriesz.RieszDynParams(
        jnp.float32(30.0), jnp.float32(0.5 * math.pi),
        jnp.asarray(b_lo, jnp.float32), jnp.asarray(a_lo, jnp.float32),
        jnp.asarray(b_hi, jnp.float32), jnp.asarray(a_hi, jnp.float32),
        jnp.asarray(False), jnp.asarray(False),
    )


def _cpu_mesh(shape, axes=("batch", "tile")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _max_lsb(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16)).max())


def _split(x, n):
    return [torch.from_numpy(np.ascontiguousarray(s)) for s in np.split(x, n, axis=-1)]


# ---------------------------------------------------------------- halo exchanges


def _jax_exchange(fn, x, **kw):
    mesh = jmesh.make_mesh((8,), ("tile",))
    spec = P(*([None] * (x.ndim - 1)), "tile")
    run = jax.jit(jax.shard_map(functools.partial(fn, axis_name="tile", **kw), mesh=mesh,
                                in_specs=spec, out_specs=spec, check_vma=False))
    return np.asarray(run(jnp.asarray(x)))


@pytest.mark.parametrize("right_mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("halo", [2, 4, 6])
def test_k10_plain_equals_reference_rdma_kernel(halo, right_mode):
    """K10's plain version (what the wrapper runs on CPU tensors) against the
    reference's Pallas RDMA ring in interpret mode, 8 shards."""
    x = np.random.default_rng(5).random((3, 16, 64)).astype(np.float32)
    want = _jax_exchange(jhalo.halo_exchange_cols_rdma, x, halo=halo, right_mode=right_mode,
                         interpret=True)
    before = dict(khalo.LAUNCHES)
    got = khalo.halo_exchange_cols_rdma(_split(x, 8), halo, right_mode=right_mode)
    assert khalo.LAUNCHES == before  # CPU tensors launch nothing
    assert all(g.shape == (3, 16, 8 + 2 * halo) for g in got)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got], axis=-1), want)


@pytest.mark.parametrize("right_mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("halo", [2, 4, 6])
def test_plain_exchange_equals_reference_ppermute(halo, right_mode):
    """The reference's plain (lax.ppermute) exchange computes K10's function
    too: K10's plain version equals it."""
    x = np.random.default_rng(6).random((2, 9, 56)).astype(np.float32)
    want = _jax_exchange(jrs.halo_exchange_cols, x, halo=halo, right_mode=right_mode)
    got = khalo.halo_exchange_cols_rdma_plain(_split(x, 8), halo, right_mode=right_mode)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got], axis=-1), want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_exchange_of_one_shard_reflects_both_edges(n):
    """The mesh-of-1 short-cut, and the global edges of every mesh, against
    the reflect-101 / symmetric pads of the unsharded array."""
    x = torch.from_numpy(np.random.default_rng(n).random((5, 8 * n)).astype(np.float32))
    for right_mode in ("reflect", "symmetric"):
        got = torch.cat(khalo.halo_exchange_cols_rdma(list(x.chunk(n, dim=-1)), 3, right_mode),
                        dim=-1)
        padded = np.pad(x.numpy(), ((0, 0), (3, 3)), mode="reflect")
        if right_mode == "symmetric":
            padded[:, -3:] = np.pad(x.numpy(), ((0, 0), (3, 3)), mode="symmetric")[:, -3:]
        assert np.array_equal(got[:, :8 + 3].numpy(), padded[:, :8 + 3])
        assert np.array_equal(got[:, -(8 + 3):].numpy(), padded[:, -(8 + 3):])


def test_k10_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="halo"):
        khalo.halo_exchange_cols_rdma([x, x], 8)
    with pytest.raises(ValueError, match="one shape"):
        khalo.halo_exchange_cols_rdma([x, torch.zeros((4, 9))], 2)
    with pytest.raises(ValueError, match="right_mode"):
        khalo.halo_exchange_cols_rdma([x, x], 2, right_mode="wrap")
    with pytest.raises(ValueError, match="no shards"):
        khalo.halo_exchange_cols_rdma([], 2)


def test_halo_source_builds_beside_the_other_kernels():
    assert _build.SOURCES["halo"] == "halo.cu"
    src = (_build.CSRC / "halo.cu").read_text()
    for fn in ("lvmt_halo_cols", "lvmt_enable_peer_access"):
        assert f"int {fn}(" in src
    assert len({_build.library_path(n) for n in _build.SOURCES}) == len(_build.SOURCES)


def test_row_halo_exchange_equals_reference():
    x = np.random.default_rng(3).random((64, 12)).astype(np.float32)
    mesh = jmesh.make_mesh((8,), ("tile",))
    want = np.asarray(jax.jit(jax.shard_map(
        functools.partial(jhalo.halo_exchange_rows, halo=4, axis_name="tile"), mesh=mesh,
        in_specs=P("tile", None), out_specs=P("tile", None)))(jnp.asarray(x)))
    got = thalo.halo_exchange_rows([torch.from_numpy(s) for s in np.split(x, 8)], 4)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got]), want)


def test_row_sharded_conv_equals_reference_and_unsharded():
    h, w = 128, 96  # 16 rows a shard > halo of 4
    x = np.random.default_rng(8).random((h, w)).astype(np.float32)
    want = np.asarray(jhalo.make_sharded_conv(jmesh.make_mesh((8,), ("tile",)), "tile",
                                              RIESZ_HIGHPASS_9x9)(jnp.asarray(x)))
    fn = thalo.make_sharded_conv(_cpu_mesh((8,), ("tile",)), "tile", RIESZ_HIGHPASS_9x9)
    got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_array_equal(got, correlate2d(torch.from_numpy(x), RIESZ_HIGHPASS_9x9).numpy())


# ---------------------------------------------------------------- mesh, plan, dispatch


def test_mesh_repeats_devices_and_checks_its_shape():
    mesh = _cpu_mesh((2, 4))
    assert mesh.shape == {"batch": 2, "tile": 4} and mesh.axis_names == ("batch", "tile")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(axis_names=("tile",), devices=["cpu"] * 3).shape == {"tile": 3}
    assert make_mesh(devices=["cpu"] * 2).shape == {"batch": 1, "tile": 2}
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh((2, 2), devices=["cpu"] * 3)


def test_mesh_defaults_to_the_cards_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is every CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 2), devices=["cuda", "cuda"])


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_equals_reference_plan(n, force):
    for h, w in [(64, 256), (64, 192), (48, 64), (2160, 3840), (1080, 1920), (270, 480),
                 (135, 241), (64, 96), (96, 112)]:
        for levels in range(1, 8):
            got = trs.make_plan(h, w, levels, n, force_sharded=force)
            want = jrs.make_plan(h, w, levels, n, force_sharded=force)
            assert (got.n, got.levels, got.sharded, got.fully_sharded) == (
                want.n, want.levels, want.sharded, want.fully_sharded), (h, w, levels)
            assert got.sizes == tuple(tuple(s) for s in want.sizes)


def test_phase_sharded_step_takes_the_lane_sharded_path():
    step, state = build_sharded_step(_cpu_mesh((1, 4)), MagnificationMode.PHASE, 1, 48, 128, 2)
    assert len(state) == 1 and len(state[0]) == 4
    assert state[0][1].old[0].lowpass.shape == (48, 32)


def test_unknown_halo_impl_and_tail_raise(monkeypatch):
    # every exchange is K10: the reference's halo_impl choice is not taken
    with pytest.raises(TypeError, match="halo_impl"):
        trs.build_sharded_riesz_step(_cpu_mesh((1, 2)), 1, 32, 64, 2, halo_impl="nccl")
    with pytest.raises(ValueError, match="unknown tail"):
        trs.build_sharded_riesz_step(_cpu_mesh((1, 2)), 1, 32, 64, 2, tail="vpu")
    monkeypatch.setenv("LVMT_TAIL", "level")
    assert trs._Ops().tail == "mxu"  # LVMT_TAIL read at build time; level -> mxu
    monkeypatch.setenv("LVMT_TAIL", "pallas")
    assert trs._Ops().tail == "pallas"
    with pytest.raises(ValueError, match="lane-sharded.*sharding.py::build_sharded_step"):
        trs.build_sharded_riesz_step(_cpu_mesh((1, 8)), 1, 32, 200, 2)


# ---------------------------------------------------------------- the step against JAX


def _run_both(jstep, jstate, tstep, tstate, frames, dyn, start=0):
    """Step both over frames[:, start:]; returns the states and the worst LSB."""
    worst = 0
    tdyn = riesz_dyn_from_jax(dyn)
    for ti in range(start, frames.shape[1]):
        jstate, jout = jstep(jstate, jnp.asarray(frames[:, ti]), dyn)
        tstate, tout = tstep(tstate, torch.from_numpy(frames[:, ti]), tdyn)
        assert tout.shape == frames[:, ti].shape and tout.dtype == torch.uint8
        worst = max(worst, _max_lsb(tout.numpy(), jout))
    return jstate, tstate, worst


@pytest.mark.parametrize("case", [
    dict(mesh=(2, 4), axes=("batch", "tile"), batch=2, t=3, h=64, w=256, levels=3,
         jax=dict(kernels="jnp"), port=dict(tail="jnp")),
    dict(mesh=(1, 8), axes=("batch", "tile"), batch=2, t=3, h=64, w=256, levels=3,
         jax=dict(kernels="jnp"), port=dict(tail="jnp")),
    dict(mesh=(8,), axes=("tile",), batch=1, t=2, h=64, w=256, levels=2,
         jax=dict(kernels="interpret", halo_impl="rdma"), port=dict(tail="jnp")),
    dict(mesh=(1, 8), axes=("batch", "tile"), batch=1, t=3, h=64, w=192, levels=3,
         jax=dict(kernels="jnp", band_parallel=True), port=dict(tail="jnp", band_parallel=True)),
], ids=["jnp-2x4", "jnp-1x8", "interpret-rdma-8", "band-parallel-1x8"])
def test_sharded_step_matches_reference_sharded_step(case, monkeypatch):
    monkeypatch.delenv("LVMT_TAIL", raising=False)
    b, h, w, levels = case["batch"], case["h"], case["w"], case["levels"]
    frames = _frames(b, case["t"], h, w)
    dyn = _jax_dyn()
    jstep, jstate = jrs.build_sharded_riesz_step(jmesh.make_mesh(case["mesh"], case["axes"]),
                                                 b, h, w, levels, **case["jax"])
    tstep, tstate = trs.build_sharded_riesz_step(_cpu_mesh(case["mesh"], case["axes"]),
                                                 b, h, w, levels, **case["port"])
    _, _, worst = _run_both(jstep, jstate, tstep, tstate, frames, dyn)
    assert worst <= 1, f"{worst} LSB"


def test_jax_sharded_state_carried_into_the_port_and_back():
    """2 frames in JAX's sharded step, the state converted, then both step on;
    the conversion round-trips the JAX leaves exactly."""
    batch, h, w, levels = 2, 64, 256, 3
    frames = _frames(batch, 4, h, w)
    dyn = _jax_dyn()
    jstep, jstate = jrs.build_sharded_riesz_step(jmesh.make_mesh((2, 4), ("batch", "tile")),
                                                 batch, h, w, levels, kernels="jnp")
    for ti in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(frames[:, ti]), dyn)
    leaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    mesh = _cpu_mesh((2, 4))
    plan = trs.make_plan(h, w, levels, 4)
    tstate = sharded_riesz_state_from_jax(leaves, mesh, plan)
    assert tstate[1][3].count == 2 and tstate[1][3].acc[0].cos.shape == (64, 64)
    back = sharded_riesz_state_to_jax(tstate, plan)
    assert len(back) == len(leaves)
    for a, b_ in zip(back, leaves):
        assert a.shape == b_.shape
        np.testing.assert_array_equal(a, b_)
    tstep, _ = trs.build_sharded_riesz_step(mesh, batch, h, w, levels, tail="jnp")
    jstate, tstate, worst = _run_both(jstep, jstate, tstep, tstate, frames, dyn, start=2)
    assert worst <= 1, f"{worst} LSB"
    assert not np.array_equal(frames[:, 3], tstep(tstate, torch.from_numpy(frames[:, 3]),
                                                  riesz_dyn_from_jax(dyn))[1].numpy())
    got = sharded_riesz_state_to_jax(tstate, plan)
    want = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    np.testing.assert_array_equal(got[0], want[0])
    n_old = 1 + 3 * levels
    for a, b_ in zip(got[1:n_old], want[1:n_old]):
        np.testing.assert_allclose(a, b_, atol=3e-4)
    for a, b_ in zip(got[n_old:], want[n_old:]):
        # at a phase singularity an ulp turns the orientation by O(1)
        off = ~np.isclose(a, b_, atol=2e-3, rtol=1e-4, equal_nan=True)
        assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} filter-state values differ"


# ---------------------------------------------------------------- the step against the port


def _unsharded(frames, levels, tail, dyn):
    """The port's unsharded step per batch element: frames and final states."""
    b, t, _, h, w = frames.shape
    states = [triesz.init_state(h, w, levels, device="cpu") for _ in range(b)]
    outs = []
    for ti in range(t):
        row = []
        for k in range(b):
            states[k], o = triesz.step(states[k], torch.from_numpy(frames[k, ti]), dyn,
                                       levels=levels, tail=tail)
            row.append(o.numpy())
        outs.append(np.stack(row))
    return outs, states


@pytest.mark.parametrize("mesh_shape,tail,force,hw,levels", [
    ((1, 1), "jnp", False, (48, 64), 2),
    ((1, 1), "jnp", True, (48, 64), 2),
    ((1, 1), "mxu", True, (48, 64), 2),
    ((1, 4), "jnp", False, (64, 256), 3),
    ((1, 4), "pallas", False, (64, 256), 3),
    ((1, 4), "mxu", False, (64, 256), 3),
    ((1, 8), "jnp", False, (64, 256), 3),
    ((1, 8), "pallas", False, (64, 256), 3),
    ((1, 8), "mxu", False, (64, 256), 3),
    ((1, 8), "mxu", False, (64, 192), 3),
    ((1, 4), "mxu", False, (66, 416), 4),
])
def test_sharded_step_equals_unsharded_step(mesh_shape, tail, force, hw, levels):
    """64x192 on 8 replicates from level 1; 66x416 levels=4 on 4 runs K5
    (16-95 px strips) on edge and inner shards and an odd-height collapse.

    A mesh of 1 is bit-equal, frames and state. Wider meshes: frames within
    one LSB (0 expected), state within f32 rounding: torch's CPU kernels run
    the elements past a tensor's last full vector through scalar code, whose
    arccos can differ by an ulp from the vector code, so a strip, shorter
    than its level, can round an element of the phase front otherwise (on
    the card every element takes the same code)."""
    h, w = hw
    frames = _frames(1, 3, h, w)
    dyn = riesz_dyn_from_jax(_jax_dyn())
    mesh = _cpu_mesh(mesh_shape)
    step, state = trs.build_sharded_riesz_step(mesh, 1, h, w, levels, tail=tail,
                                               force_sharded=force)
    want, ref_states = _unsharded(frames, levels, tail, dyn)
    exact = mesh_shape == (1, 1)
    for ti in range(frames.shape[1]):
        state, out = step(state, torch.from_numpy(frames[:, ti]), dyn)
        lsb = _max_lsb(out.numpy(), want[ti])
        assert lsb == 0 if exact else lsb <= 1, f"frame {ti}: {lsb} LSB"
    plan = trs.make_plan(h, w, levels, mesh_shape[1], force_sharded=force)
    got = sharded_riesz_state_to_jax(state, plan)
    for a, b_ in zip(got, state_to_numpy(ref_states[0])):
        if exact:
            np.testing.assert_array_equal(a[0], b_)
        else:
            off = ~np.isclose(a[0], b_, atol=1e-5, rtol=1e-5, equal_nan=True)
            assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} state values differ"


def test_repeat_steps_form_checksums_the_varied_frames():
    h, w, levels, reps = 48, 128, 2, 4
    frames = torch.from_numpy(_frames(1, 1, h, w)[:, 0])
    dyn = riesz_dyn_from_jax(_jax_dyn())
    mesh = _cpu_mesh((1, 4))
    bench, state = trs.build_sharded_riesz_step(mesh, 1, h, w, levels, repeat_steps=reps)
    step, ref = trs.build_sharded_riesz_step(mesh, 1, h, w, levels)
    state, total = bench(state, frames, dyn)
    want = 0
    for t in range(reps):
        ref, out = step(ref, frames + (t % 3), dyn)
        want += int(out[:, :, ::64, ::64].to(torch.int64).sum())
    assert int(total) == want and state[0][0].count == reps
