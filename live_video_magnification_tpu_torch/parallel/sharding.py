"""Frame-tile + batch sharding of the magnification step.

The counterpart of the reference package's ``parallel/sharding.py``. Frames
[B, C, H, W] lay B over the 'batch' mesh axis and split the frame over the
'tile' axis. Phase mode takes the explicit lane-sharded step
(parallel/riesz_sharded.py: W over 'tile', the port's kernels on
halo-exchanged strips). What the reference does besides is not ported yet
and raises NotImplementedError, naming its ROADMAP item: the GSPMD
row-sharded fallback for widths that do not lane-shard, and the sharded
motion (LAPLACE) and colour (COLOR) steps.
"""

from __future__ import annotations

from typing import Callable, Tuple

from live_video_magnification_tpu_torch.models.params import MagnificationMode
from live_video_magnification_tpu_torch.parallel.mesh import Mesh
from live_video_magnification_tpu_torch.parallel.riesz_sharded import (
    build_sharded_riesz_step,
    make_plan,
)


def build_sharded_step(
    mesh: Mesh,
    mode: MagnificationMode,
    batch: int,
    h: int,
    w: int,
    levels: int,
) -> Tuple[Callable, object]:
    """(step, initial state) of a batched, sharded mode step:
    step(state, frames_u8 [B,C,H,W], dyn) -> (state, outs [B,C,H,W]).

    Phase mode with a width that lane-shards at level 0 takes
    build_sharded_riesz_step. The reference's ``framerate`` and ``channels``
    (arguments of its motion and colour steps) come with those modes."""
    if mode is MagnificationMode.PHASE:
        if make_plan(h, w, levels, mesh.shape["tile"]).sharded[0]:
            return build_sharded_riesz_step(mesh, batch, h, w, levels)
        raise NotImplementedError(
            f"W={w} does not lane-shard {mesh.shape['tile']}-way: the GSPMD row-sharded "
            "fallback is not ported yet (ROADMAP.md, queue 1 item 2)")
    if mode is MagnificationMode.LAPLACE:
        raise NotImplementedError(
            "the sharded motion (LAPLACE) step is not ported yet (ROADMAP.md, queue 1 "
            "item 2)")
    if mode is MagnificationMode.COLOR:
        raise NotImplementedError(
            "the sharded colour (COLOR) step is not ported yet (ROADMAP.md, queue 1 "
            "item 2)")
    raise ValueError(f"no sharded step for mode {mode}")
