"""The four stencil functions of the port (ops/hopper/stencils.py) on the CPU,
where they run their plain versions, against the reference JAX package: its
plain ops and its Pallas entry points in interpret mode, as
tests/test_pallas_kernels.py runs them. The CUDA kernels themselves are held
against the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: 2e-4 / 3e-4 absolute for inputs of magnitude 5 / 100, the
reference suite's own bars for these kernels; the Pallas side computes the
9x9 stencils in their exact rank-5 separable form, which rounds differently.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from live_video_magnification_tpu.ops import conv as jconv
from live_video_magnification_tpu.ops import riesz as jriesz
from live_video_magnification_tpu.ops.kernels import (
    RIESZ_BAND_KERNEL,
    RIESZ_HIGHPASS_9x9,
    RIESZ_LOWPASS_9x9,
)
from live_video_magnification_tpu.ops.pallas import conv9_mxu as jpallas
from live_video_magnification_tpu.ops.resize import resize_nearest_even_inject
from live_video_magnification_tpu_torch.ops import riesz as triesz
from live_video_magnification_tpu_torch.ops.hopper import stencils

torch.set_num_threads(2)

LP2 = 2.0 * RIESZ_LOWPASS_9x9
ODD_SHAPES = [(33, 257), (97, 201), (135, 241), (128, 128)]
REPO = Path(__file__).resolve().parents[1]


def _input(h, w, scale, offset=0.0, seed=0):
    return (np.random.default_rng(seed + 7 * h + w).random((h, w)).astype(np.float32)
            * scale + offset)


@pytest.mark.parametrize("h,w", ODD_SHAPES)
def test_conv9_matches_reference_plain_and_pallas(h, w):
    x = _input(h, w, 10.0, -5.0)
    got = stencils.conv9(torch.from_numpy(x), RIESZ_HIGHPASS_9x9).numpy()
    ref = np.asarray(jconv.correlate2d(jnp.asarray(x), RIESZ_HIGHPASS_9x9))
    np.testing.assert_allclose(got, ref, atol=2e-4)
    pallas = np.asarray(jpallas.conv9_mxu(jnp.asarray(x), RIESZ_HIGHPASS_9x9, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-4)


@pytest.mark.parametrize("h,w", ODD_SHAPES)
def test_band5_matches_reference_plain_and_pallas(h, w):
    hp = _input(h, w, 100.0, -50.0)
    r, i = stencils.band5(torch.from_numpy(hp), RIESZ_BAND_KERNEL)
    jhp = jnp.asarray(hp)
    np.testing.assert_allclose(r.numpy(), np.asarray(jconv.correlate_rows(jhp, RIESZ_BAND_KERNEL)),
                               atol=3e-4)
    np.testing.assert_allclose(i.numpy(), np.asarray(jconv.correlate_cols(jhp, RIESZ_BAND_KERNEL)),
                               atol=3e-4)
    pr, pi = jpallas.band5_mxu(jhp, RIESZ_BAND_KERNEL, interpret=True)
    np.testing.assert_allclose(r.numpy(), np.asarray(pr), atol=3e-4)
    np.testing.assert_allclose(i.numpy(), np.asarray(pi), atol=3e-4)


@pytest.mark.parametrize("h,w", ODD_SHAPES)
def test_lp9_decimate_matches_reference_plain_and_pallas(h, w):
    x = _input(h, w, 100.0)
    got = stencils.lp9_decimate(torch.from_numpy(x), LP2)
    assert tuple(got.shape) == ((h + 1) // 2, (w + 1) // 2) and got.is_contiguous()
    ref = np.asarray(jconv.correlate2d(jnp.asarray(x), LP2))[::2, ::2]
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4)
    pallas = np.asarray(jpallas.lp9_decimate_mxu(jnp.asarray(x), LP2, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=3e-4)


@pytest.mark.parametrize("small,out", [((64, 64), (128, 128)), ((48, 100), (96, 200))])
def test_lp9_inject_matches_reference_pallas_even_targets(small, out):
    s = _input(*small, 10.0, -5.0)
    got = stencils.lp9_inject(torch.from_numpy(s), LP2, out).numpy()
    pallas = np.asarray(jpallas.lp9_inject_mxu(jnp.asarray(s), LP2, out, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-4)


@pytest.mark.parametrize("small,out", [((17, 129), (33, 257)), ((49, 101), (97, 201)),
                                       ((68, 121), (135, 241)), ((68, 120), (135, 240)),
                                       ((64, 64), (128, 128))])
def test_lp9_inject_matches_zero_inject_then_correlate(small, out):
    """Odd and even targets: the reflect-101 border of the injected array is
    what JAX's resize_nearest_even_inject + correlate2d compute."""
    s = _input(*small, 10.0, -5.0)
    got = stencils.lp9_inject(torch.from_numpy(s), LP2, out).numpy()
    ref = np.asarray(jconv.correlate2d(resize_nearest_even_inject(jnp.asarray(s), out), LP2))
    assert got.shape == out
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_stencils_reject_what_the_kernels_do_not_take():
    x = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="below 5"):
        stencils.conv9(torch.zeros((4, 16)), RIESZ_HIGHPASS_9x9)
    with pytest.raises(ValueError, match="below 5"):
        stencils.band5(torch.zeros((16, 3)), RIESZ_BAND_KERNEL)
    with pytest.raises(ValueError, match="contiguous"):
        stencils.lp9_decimate(x.t()[:, :15], LP2)
    with pytest.raises(TypeError):
        stencils.conv9(x.double(), RIESZ_HIGHPASS_9x9)
    with pytest.raises(ValueError, match="plane"):
        stencils.conv9(x[None], RIESZ_HIGHPASS_9x9)
    with pytest.raises(ValueError, match="does not fit"):
        stencils.lp9_inject(torch.zeros((8, 8)), LP2, (17, 16))
    with pytest.raises(ValueError, match="81 taps"):
        stencils.conv9(x, RIESZ_BAND_KERNEL)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    before = dict(stencils.LAUNCHES)
    x = torch.from_numpy(_input(20, 30, 1.0))
    torch.testing.assert_close(stencils.conv9(x, LP2), stencils.conv9_plain(x, LP2),
                               rtol=0, atol=0)
    assert stencils.LAUNCHES == before


@pytest.mark.parametrize("h,w,levels", [(64, 96, 3), (45, 71, 4), (33, 257, 2)])
def test_pyramid_build_and_collapse_match_reference(h, w, levels):
    x = _input(h, w, 100.0)
    tp = triesz.build_riesz_pyramid(torch.from_numpy(x), levels)
    jp = jriesz.build_riesz_pyramid(jnp.asarray(x), levels)
    for t_lvl, j_lvl in zip(tp, jp):
        np.testing.assert_allclose(t_lvl.lowpass.numpy(), np.asarray(j_lvl.lowpass), atol=3e-4)
        np.testing.assert_allclose(t_lvl.riesz.cos.numpy(), np.asarray(j_lvl.riesz.cos), atol=3e-4)
        np.testing.assert_allclose(t_lvl.riesz.sin.numpy(), np.asarray(j_lvl.riesz.sin), atol=3e-4)
    lows = [lvl.lowpass for lvl in tp]
    got = triesz.collapse_riesz_pyramid(lows).numpy()
    ref = np.asarray(jriesz.collapse_riesz_pyramid([jnp.asarray(v.numpy()) for v in lows]))
    np.testing.assert_allclose(got, ref, atol=3e-4)
    # collapse of an untouched pyramid reconstructs the frame (Riesz filters
    # are a near-tight frame; the bar is loose on purpose)
    assert np.abs(got - x).mean() < 1.0


# The port's file I/O needs cv2, which a GPU host may lack: these modules
# import it inside the calls that use it (decode and encode, the file and
# camera sources, the HighGUI renderer), and nothing else imports it at all.
CV2_AT_CALL = {"live_video_magnification_tpu_torch/io/video.py",
               "live_video_magnification_tpu_torch/export/exporter.py",
               "live_video_magnification_tpu_torch/export/sources.py",
               "live_video_magnification_tpu_torch/engine/source.py",
               "live_video_magnification_tpu_torch/engine/display.py"}


def test_port_imports_no_jax_and_nothing_of_the_reference_package():
    files = sorted((REPO / "live_video_magnification_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax)\b|^(import cv2|from cv2)\b"
                     r"|live_video_magnification_tpu\.", re.M)
    cv2_in_a_call = re.compile(r"^\s+(import cv2|from cv2)\b", re.M)
    for f in files:
        text, name = f.read_text(), f.relative_to(REPO).as_posix()
        hits = [m.group(0).strip() for m in bad.finditer(text)]
        if name not in CV2_AT_CALL:
            hits += [m.group(0).strip() for m in cv2_in_a_call.finditer(text)]
        assert not hits, f"{name} imports {hits}"
    # every module of the port imports where cv2, tk and the GL packages are
    # missing (the front ends import them inside the calls that use them)
    probe = ("import importlib, pkgutil, sys; "
             "sys.modules.update(dict.fromkeys(['cv2', 'tkinter', 'OpenGL', 'glfw'])); "
             "import live_video_magnification_tpu_torch as p; "
             "[importlib.import_module(m.name) for m in "
             "pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
             "sys.exit('jax' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", probe], cwd=REPO).returncode == 0


def test_kernel_build_is_keyed_by_source_and_lazy():
    from live_video_magnification_tpu_torch.ops.hopper import _build

    p = _build.library_path("stencils")
    assert p.parent == REPO / "build" / "lvmt_torch_kernels"
    assert p == _build.library_path("stencils") and p.suffix == ".so"
    assert (_build.CSRC / "stencils.cu").exists()
    src = (_build.CSRC / "stencils.cu").read_text()
    for fn in ("lvmt_conv9", "lvmt_band5", "lvmt_lp9_decimate", "lvmt_lp9_inject"):
        assert f"int {fn}(" in src
    # importing the package builds and loads nothing (a fresh process)
    probe = ("import live_video_magnification_tpu_torch.models.chain, sys; "
             "from live_video_magnification_tpu_torch.ops.hopper import _build; "
             "sys.exit(_build.load_library.cache_info().currsize)")
    assert subprocess.run([sys.executable, "-c", probe], cwd=REPO).returncode == 0
