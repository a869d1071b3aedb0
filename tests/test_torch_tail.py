"""The port's per-level tail kernels (ops/hopper/tail.py) on the CPU, where
they run their plain versions, against the reference package: each plain
version against the JAX Pallas kernel in interpret mode, the step and the
chain under each LVMT_TAIL / LVMT_PHASE_FUSED configuration against the JAX
step and chain under the same flags, and the dispatch rules of the step.

The JAX side reaches its kernels on the CPU as tests/test_pallas_kernels.py
does: every Pallas entry point forced to interpret mode, LVMT_PALLAS=1, the
MXU size gate lowered to 16, the dense conv9 formulation.

Bars: the reference suite's own kernel-against-jnp bars on standard-normal
inputs (K8 1e-5 abs + 1e-5 rel; K6/K7 2e-4 + 1e-4; K9 output 5e-4 + 1e-3,
state 1e-4 + 1e-4); per frame >= 40 dB and at most 1 u8 LSB. Filter state
after several frames is compared by the share of values off, as in
tests/test_torch_chain.py: at a phase singularity an ulp turns the
orientation by O(1).
"""

import functools
import math
from collections import namedtuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import live_video_magnification_tpu.ops.pallas.conv9_mxu as jc9
import live_video_magnification_tpu.ops.pallas.riesz_amplify as jra
import live_video_magnification_tpu.ops.pallas.riesz_amplify_mxu as jram
import live_video_magnification_tpu.ops.pallas.riesz_build as jrb
import live_video_magnification_tpu.ops.pallas.riesz_level_mxu as jrlm
import live_video_magnification_tpu.ops.pallas.riesz_phase_fused as jrpf
from live_video_magnification_tpu.models import params as jparams
from live_video_magnification_tpu.models import riesz as jriesz
from live_video_magnification_tpu.models.chain import MagnificationChain as JChain
from live_video_magnification_tpu.ops.temporal import butterworth_bandpass_coeffs
from live_video_magnification_tpu_torch.convert import (
    riesz_dyn_from_jax,
    riesz_state_from_jax,
    state_to_numpy,
)
from live_video_magnification_tpu_torch.export.batch import ClipProcessor
from live_video_magnification_tpu_torch.models import params as tparams
from live_video_magnification_tpu_torch.models import riesz as triesz
from live_video_magnification_tpu_torch.models.chain import MagnificationChain as TChain
from live_video_magnification_tpu_torch.ops.hopper import _build
from live_video_magnification_tpu_torch.ops.hopper import tail
from live_video_magnification_tpu_torch.utils.metrics import psnr_u8
from live_video_magnification_tpu_torch.utils.synthetic import moving_clip

torch.set_num_threads(2)

SHAPES = [(40, 72), (48, 64), (33, 257)]
ALPHA, THRESHOLD = 30.0, 1.2
# (LVMT_TAIL, LVMT_PHASE_FUSED) of every kernel configuration
CONFIGS = [("pallas", False), ("mxu", False), ("level", False), ("jnp", True),
           ("pallas", True)]
# the tail entry points each configuration runs on a level of 16 px and more
EXPECTED_ENTRIES = {("pallas", False): {"riesz_amplify_fused"},
                    ("mxu", False): {"riesz_amplify_mxu"},
                    ("level", False): {"riesz_level_mxu"},
                    ("jnp", True): {"riesz_phase_df2_fused"},
                    ("pallas", True): {"riesz_phase_df2_fused", "riesz_amplify_fused"}}


def _normal(rng, shape, n):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _coeffs():
    b_lo, a_lo = butterworth_bandpass_coeffs(0.7, 30.0)
    b_hi, a_hi = butterworth_bandpass_coeffs(3.0, 30.0)
    return [np.asarray(c, np.float32) for c in (b_lo, a_lo, b_hi, a_hi)]


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


J = lambda xs: [jnp.asarray(x) for x in xs]
T = lambda xs: [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------- per kernel


@pytest.mark.parametrize("rebuild", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_phase_df2_plain_matches_reference_kernel(shape, rebuild):
    """K8: rebuild selection, polynomial-arccos front, lo and hi DF-II."""
    rng = np.random.default_rng(17 + shape[1])
    planes = _normal(rng, shape, 18)
    coeffs = _coeffs()
    ja = J(planes)
    want = jrpf.riesz_phase_df2_fused(*ja[:6], tuple(ja[6:12]), tuple(ja[12:]),
                                      *J(coeffs), jnp.asarray(rebuild), interpret=True)
    ta = T(planes)
    got = tail.riesz_phase_df2_fused(*ta[:6], tuple(ta[6:12]), tuple(ta[12:]),
                                     *coeffs, rebuild)
    flat = lambda r: [r[0], r[1], r[2], *r[3], *r[4]]
    assert len(flat(got)) == 15
    for k, (g, w) in enumerate(zip(flat(got), flat(want))):
        _close(g, w, 1e-5, 1e-5, f"output {k}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("preweighted", [False, True])
@pytest.mark.parametrize("entry", ["riesz_amplify_fused", "riesz_amplify_mxu"])
def test_amplify_plain_matches_reference_kernel(entry, preweighted, shape):
    """K7 and K6: the same function, both preweighted arms. The amplitude is a
    square root, so its plane is the magnitude of a standard normal."""
    rng = np.random.default_rng(29 + shape[0])
    amp = np.abs(rng.standard_normal(shape)).astype(np.float32)
    cc, cs, lp, rr, ri = _normal(rng, shape, 5)
    if preweighted:
        cc, cs = cc * amp, cs * amp
    planes = [amp, cc, cs, lp, rr, ri]
    jmod = {"riesz_amplify_fused": jra, "riesz_amplify_mxu": jram}[entry]
    want = getattr(jmod, entry)(*J(planes), ALPHA, THRESHOLD, interpret=True,
                                preweighted=preweighted)
    got = getattr(tail, entry)(*T(planes), ALPHA, THRESHOLD, preweighted=preweighted)
    assert tuple(got.shape) == shape
    _close(got, want, 2e-4, 1e-4, entry)


@pytest.mark.parametrize("rebuild", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_level_plain_matches_reference_kernel(shape, rebuild):
    """K9: the whole per-level tail on the shared accumulator."""
    rng = np.random.default_rng(23 + shape[1])
    planes = _normal(rng, shape, 16)
    coeffs = _coeffs()
    ja, ta = J(planes), T(planes)
    want = jrlm.riesz_level_mxu(*ja[:6], tuple(ja[6:8]), tuple(ja[8:12]), tuple(ja[12:]),
                                *J(coeffs), jnp.asarray(rebuild), ALPHA, THRESHOLD,
                                interpret=True)
    got = tail.riesz_level_mxu(*ta[:6], tuple(ta[6:8]), tuple(ta[8:12]), tuple(ta[12:]),
                               *coeffs, rebuild, ALPHA, THRESHOLD)
    _close(got[0], want[0], 5e-4, 1e-3, "amplified lowpass")
    for k, (g, w) in enumerate(zip([*got[1], *got[2], *got[3]],
                                   [*want[1], *want[2], *want[3]])):
        _close(g, w, 1e-4, 1e-4, f"state plane {k}")


def test_wrappers_check_their_planes_and_run_the_plain_version_on_the_cpu():
    x = torch.zeros((20, 24))
    six = T(_normal(np.random.default_rng(3), (20, 24), 6))
    before = dict(tail.LAUNCHES)
    got = tail.riesz_amplify_mxu(*six, ALPHA, THRESHOLD)
    torch.testing.assert_close(got, tail.riesz_amplify_plain(*six, ALPHA, THRESHOLD),
                               rtol=0, atol=0)
    assert tail.LAUNCHES == before
    with pytest.raises(TypeError, match="float32"):
        tail.riesz_amplify_fused(*six[:5], x.double(), ALPHA, THRESHOLD)
    with pytest.raises(TypeError, match="float32"):
        tail.riesz_amplify_mxu(x.to(torch.bfloat16), *six[1:], ALPHA, THRESHOLD)
    with pytest.raises(ValueError, match="shapes"):
        tail.riesz_amplify_fused(*six[:5], torch.zeros((20, 25)), ALPHA, THRESHOLD)
    with pytest.raises(ValueError, match="contiguous"):
        tail.riesz_amplify_fused(*six[:5], torch.zeros((24, 20)).t(), ALPHA, THRESHOLD)
    with pytest.raises(ValueError, match="planes"):
        tail.riesz_amplify_fused(*six[:5], x[None], ALPHA, THRESHOLD)
    coeffs = _coeffs()
    with pytest.raises(ValueError, match="6 planes"):
        tail.riesz_phase_df2_fused(*six, (x,) * 5, (x,) * 6, *coeffs, False)
    with pytest.raises(ValueError, match="registers 4"):
        tail.riesz_level_mxu(*six, (x, x), (x,) * 4, (x,) * 3, *coeffs, False, ALPHA,
                             THRESHOLD)


def test_tail_source_builds_beside_the_stencils():
    assert _build.SOURCES["tail"] == "tail.cu"
    src = (_build.CSRC / "tail.cu").read_text()
    for fn in ("lvmt_phase_df2", "lvmt_amplify13", "lvmt_level_tail"):
        assert f"int {fn}(" in src
    assert _build.library_path("tail") != _build.library_path("stencils")
    assert "--use_fast_math" not in _build.NVCC_FLAGS


# ---------------------------------------------------------------- step and chain


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX step's kernels in interpret mode, gated on at small levels.
    Returns (monkeypatch, the names of the JAX tail kernels called)."""
    called = []
    for mod, name in [(jc9, "conv9_mxu"), (jc9, "band5_mxu"), (jc9, "lp9_decimate_mxu"),
                      (jc9, "lp9_inject_mxu"), (jra, "riesz_amplify_fused"),
                      (jram, "riesz_amplify_mxu"), (jrb, "riesz_build_level_fused"),
                      (jrpf, "riesz_phase_df2_fused"), (jrlm, "riesz_level_mxu")]:
        def interpreted(*args, _fn=getattr(mod, name), _name=name, **kw):
            called.append(_name)
            return _fn(*args, interpret=True, **kw)

        monkeypatch.setattr(mod, name, interpreted)
    monkeypatch.setattr(jc9, "MIN_MXU_DIM", 16)
    monkeypatch.setenv("LVMT_PALLAS", "1")
    monkeypatch.setenv("LVMT_CONV9", "dense")
    monkeypatch.delenv("LVMT_TAIL", raising=False)
    monkeypatch.delenv("LVMT_PHASE_FUSED", raising=False)
    return monkeypatch, called


def _jax_dyn():
    b_lo, a_lo = butterworth_bandpass_coeffs(0.5, 30.0)
    b_hi, a_hi = butterworth_bandpass_coeffs(3.0, 30.0)
    f = lambda v: jnp.asarray(v, jnp.float32)
    return jriesz.RieszDynParams(f(30.0), f(0.4 * math.pi), f(b_lo), f(a_lo), f(b_hi),
                                 f(a_hi), jnp.asarray(False), jnp.asarray(False))


def _assert_frame_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    db = psnr_u8(got, ref)
    lsb = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
    assert db >= 40.0 and lsb <= 1, f"{what}: {db:.2f} dB, max {lsb} LSB"


def _assert_state_close(tstate, jstate, levels):
    jleaves = [np.asarray(x) for x in jax.tree.flatten(jstate)[0]]
    tleaves = state_to_numpy(tstate)
    assert len(jleaves) == len(tleaves) and int(tleaves[0]) == int(jleaves[0])
    n_old = 1 + 3 * levels
    for a, b in zip(tleaves[1:n_old], jleaves[1:n_old]):
        np.testing.assert_allclose(a, b, atol=3e-4)
    for a, b in zip(tleaves[n_old:], jleaves[n_old:]):
        off = ~np.isclose(a, b, atol=2e-3, rtol=1e-4, equal_nan=True)
        assert off.mean() <= 5e-3, f"{off.sum()} of {off.size} filter-state values differ"


def _frames(t, h, w, seed):
    return [np.ascontiguousarray(f.transpose(2, 0, 1)) for f in moving_clip(t, h, w, seed=seed)]


@pytest.mark.parametrize("tail_name,phase_fused", CONFIGS)
def test_step_matches_reference_step_under_each_tail(jax_kernels, tail_name, phase_fused):
    h, w, levels = 48, 64, 2
    monkeypatch, called = jax_kernels
    monkeypatch.setenv("LVMT_TAIL", tail_name)
    jstep = functools.partial(jriesz.step, levels=levels, phase_fused=phase_fused)
    jdyn = _jax_dyn()
    tdyn = riesz_dyn_from_jax(jdyn)
    jstate = jriesz.init_state(h, w, levels)
    tstate = triesz.init_state(h, w, levels, device="cpu")
    for i, f in enumerate(_frames(4, h, w, seed=44)):
        jstate, jout = jstep(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels,
                                   tail=tail_name, phase_fused=phase_fused)
        _assert_frame_close(tout.numpy(), jout, f"{tail_name}/{phase_fused} frame {i}")
    _assert_state_close(tstate, jstate, levels)
    assert set(called) & set(tail.LAUNCHES) == EXPECTED_ENTRIES[(tail_name, phase_fused)]


def _cfg_pair(levels=3):
    mag = dict(amplification=30.0, co_wavelength=40.0, co_low=0.5, co_high=3.0,
               levels=levels, framerate=30.0)
    return [mod.ProcessorConfig(magnification=mod.MagnificationParams(
        mode=mod.MagnificationMode.PHASE, **mag)) for mod in (jparams, tparams)]


def test_chain_and_clip_processor_match_reference_chain_under_level_tail(jax_kernels):
    h, w = 64, 96
    monkeypatch, called = jax_kernels
    monkeypatch.setenv("LVMT_TAIL", "level")
    jcfg, tcfg = _cfg_pair()
    jc, tc = JChain(), TChain(device="cpu")
    clip = moving_clip(4, h, w, seed=5)
    outs = []
    for i, f in enumerate(clip):
        jp, _ = jc.process(f, jcfg)
        tp, _ = tc.process(f, tcfg)
        _assert_frame_close(tp.numpy(), jp, f"level chain frame {i}")
        outs.append(tp.numpy())
    assert tc._key.tail == "level" and not tc._key.phase_fused
    assert "riesz_level_mxu" in called
    proc = ClipProcessor(tcfg, h, w, 3, device="cpu")
    assert proc.key == tc._key
    processed, _ = proc.process_chunk(np.ascontiguousarray(clip.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(processed.transpose(0, 2, 3, 1), np.stack(outs))


def test_jax_state_carried_into_a_level_run(jax_kernels):
    h, w, levels, k = 48, 64, 3, 2
    jax_kernels[0].setenv("LVMT_TAIL", "level")
    frames = _frames(5, h, w, seed=7)
    jdyn = _jax_dyn()
    jstep = functools.partial(jriesz.step, levels=levels)
    jstate = jriesz.init_state(h, w, levels)
    for f in frames[:k]:
        jstate, _ = jstep(jstate, jnp.asarray(f), jdyn)
    tstate = riesz_state_from_jax([np.asarray(x) for x in jax.tree.flatten(jstate)[0]],
                                  device="cpu")
    assert tstate.count == k
    tdyn = riesz_dyn_from_jax(jdyn)
    for i, f in enumerate(frames[k:]):
        jstate, jout = jstep(jstate, jnp.asarray(f), jdyn)
        tstate, tout = triesz.step(tstate, torch.from_numpy(f), tdyn, levels=levels,
                                   tail="level")
        assert np.any(tout.numpy() != f)  # carried state: no passthrough
        _assert_frame_close(tout.numpy(), jout, f"carried level frame {k + i}")


# ---------------------------------------------------------------- dispatch rules


def test_unknown_tail_raises(monkeypatch):
    _, tcfg = _cfg_pair()
    monkeypatch.setenv("LVMT_TAIL", "vpu")
    with pytest.raises(ValueError, match="unknown tail 'vpu'"):
        TChain(device="cpu").process(moving_clip(1, 32, 32, seed=1)[0], tcfg)
    with pytest.raises(ValueError, match="unknown tail"):
        ClipProcessor(tcfg, 32, 32, 3, device="cpu")
    state = triesz.init_state(32, 32, 2, device="cpu")
    dyn = riesz_dyn_from_jax(_jax_dyn())
    with pytest.raises(ValueError, match="unknown tail"):
        triesz.step(state, torch.zeros((3, 32, 32), dtype=torch.uint8), dyn, levels=2,
                    tail="Level")


@pytest.mark.parametrize("tail_name,phase_fused", CONFIGS)
def test_levels_under_16_take_the_plain_tail(monkeypatch, tail_name, phase_fused):
    """At 24x40, levels=3, the active levels are 24x40 and 12x20: only the
    first runs a tail entry point; the output equals the plain tail's."""
    calls = []
    for name in tail.LAUNCHES:
        fn = getattr(tail, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(args[0].shape)))
            return _fn(*args, **kw)

        monkeypatch.setattr(tail, name, spy)
    h, w, levels = 24, 40, 3
    tdyn = riesz_dyn_from_jax(_jax_dyn())
    plain = triesz.init_state(h, w, levels, device="cpu")
    state = triesz.init_state(h, w, levels, device="cpu")
    for f in _frames(3, h, w, seed=9):
        plain, ref = triesz.step(plain, torch.from_numpy(f), tdyn, levels=levels)
        state, out = triesz.step(state, torch.from_numpy(f), tdyn, levels=levels,
                                 tail=tail_name, phase_fused=phase_fused)
        _assert_frame_close(out.numpy(), ref.numpy(), f"{tail_name}/{phase_fused}")
    assert calls and all(shape == (h, w) for _, shape in calls), calls
    assert {name for name, _ in calls} == EXPECTED_ENTRIES[(tail_name, phase_fused)]
    assert len(calls) == 3 * len(EXPECTED_ENTRIES[(tail_name, phase_fused)])


def test_checkpoint_digest_of_the_default_tail_is_the_earlier_keys(monkeypatch):
    """A checkpoint written before the static key had its tail fields (the
    same state layout) still loads under the default tail; one written under
    another tail does not load under the default."""
    import hashlib

    _, tcfg = _cfg_pair()
    proc = ClipProcessor(tcfg, 64, 96, 3, device="cpu")
    flags = ("phase_fused", "tail", "build", "mxu_dtype", "pyr_io", "tail_io")
    fields = [f for f in proc.key._fields if f not in flags]
    earlier = namedtuple("_StaticKey", fields)(*(getattr(proc.key, f) for f in fields))
    digest = hashlib.sha256((repr(earlier) + repr(tcfg)).encode()).hexdigest()[:16]
    assert proc._config_digest() == digest
    monkeypatch.setenv("LVMT_TAIL", "level")
    level = ClipProcessor(tcfg, 64, 96, 3, device="cpu")
    assert level._config_digest() != digest
    monkeypatch.setenv("LVMT_TAIL", "jnp")
    monkeypatch.setenv("LVMT_PHASE_FUSED", "1")
    assert ClipProcessor(tcfg, 64, 96, 3, device="cpu")._config_digest() not in (
        digest, level._config_digest())
